"""Synthetic circuit-hypergraph generators (port of ``repro.data.hypergraphs``).

Numpy only and copied from the reference: each named design draws from
the same seeds, so ``ispd_like("ibm08_like")`` is the same CSR hypergraph
in both packages, byte for byte (``tests/test_torch_hypergraph.py``).

The instances match the published structural statistics of ISPD98 and
Titan23: Rent's-rule module locality, 2-4-pin-dominated nets with a
heavy fanout tail, unit vertex and edge weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.hypergraph import Hypergraph


def random_hypergraph(n: int, m: int, seed: int = 0, max_pins: int = 6
                      ) -> Hypergraph:
    """Uniform random hypergraph (no locality) — worst case, for tests."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, max_pins + 1, size=m)
    edges = [rng.choice(n, size=s, replace=False) for s in sizes]
    return Hypergraph.from_edge_lists(edges, n=n)


def _modular_netlist(n: int, m: int, seed: int, n_modules: int,
                     p_local: float, fanout_tail: float) -> Hypergraph:
    """Rent-style modular netlist generator (shared by both suites)."""
    rng = np.random.default_rng(seed)
    # hierarchical module structure: two levels
    module = rng.integers(0, n_modules, size=n)
    order = np.argsort(module, kind="stable")  # cells grouped by module
    mod_of = module[order]
    # index cells contiguously within modules for locality
    starts = np.searchsorted(mod_of, np.arange(n_modules))
    counts = np.bincount(mod_of, minlength=n_modules)

    # net sizes: 2-pin dominated, power-law tail
    u = rng.random(m)
    sizes = np.where(
        u < 0.55, 2,
        np.where(u < 0.8, 3,
                 np.where(u < 0.92, 4,
                          np.minimum(3 + rng.pareto(fanout_tail, m).astype(
                              np.int64), 48))))
    sizes = np.maximum(sizes, 2).astype(np.int64)

    edges = []
    local = rng.random(m) < p_local
    driver_mod = rng.integers(0, n_modules, size=m)
    for e in range(m):
        s = int(sizes[e])
        md = int(driver_mod[e])
        if local[e] and counts[md] >= s:
            # intra-module net: contiguous window + jitter
            base = starts[md] + rng.integers(0, max(counts[md] - s + 1, 1))
            pins = order[base: base + s]
        else:
            # global net: driver in one module, sinks mostly in 2-3 others
            k_span = min(1 + rng.poisson(1.2), n_modules)
            mods = rng.choice(n_modules, size=max(k_span, 1), replace=False)
            pool = np.concatenate([
                order[starts[mm]: starts[mm] + counts[mm]] for mm in mods
                if counts[mm] > 0]) if len(mods) else np.arange(n)
            if len(pool) < s:
                pool = np.arange(n)
            pins = rng.choice(pool, size=s, replace=False)
        edges.append(np.unique(pins))
    edges = [e for e in edges if len(e) >= 2]
    return Hypergraph.from_edge_lists(edges, n=n)


def titan_like(name: str, scale: float = 1.0) -> Hypergraph:
    """Titan23-like FPGA netlist.  ``scale`` shrinks the instance for CI
    budgets while keeping the structure."""
    spec = BENCH_TITAN[name]
    n = max(int(spec["n"] * scale), 256)
    m = max(int(spec["m"] * scale), 256)
    return _modular_netlist(n, m, seed=spec["seed"],
                            n_modules=max(int(np.sqrt(n) / 2), 8),
                            p_local=0.82, fanout_tail=1.6)


def ispd_like(name: str, scale: float = 1.0) -> Hypergraph:
    spec = BENCH_ISPD[name]
    n = max(int(spec["n"] * scale), 256)
    m = max(int(spec["m"] * scale), 256)
    return _modular_netlist(n, m, seed=spec["seed"],
                            n_modules=max(int(np.sqrt(n) / 3), 8),
                            p_local=0.78, fanout_tail=1.4)


# name -> structural size (scaled-down from the real suites so the full
# benchmark set runs on a CPU box; relative ordering preserved)
BENCH_TITAN: Dict[str, Dict] = {
    "sparcT1_core_like": {"n": 22000, "m": 28000, "seed": 101},
    "neuron_like": {"n": 18000, "m": 22000, "seed": 102},
    "stereo_vision_like": {"n": 16000, "m": 20000, "seed": 103},
    "des90_like": {"n": 24000, "m": 30000, "seed": 104},
    "cholesky_mc_like": {"n": 12000, "m": 15000, "seed": 105},
    "segmentation_like": {"n": 14000, "m": 18000, "seed": 106},
    "dart_like": {"n": 20000, "m": 25000, "seed": 107},
    "openCV_like": {"n": 15000, "m": 19000, "seed": 108},
    "minres_like": {"n": 13000, "m": 16000, "seed": 109},
    "gsm_switch_like": {"n": 30000, "m": 38000, "seed": 110},
    "denoise_like": {"n": 17000, "m": 21000, "seed": 111},
    "sparcT2_core_like": {"n": 28000, "m": 35000, "seed": 112},
}

BENCH_ISPD: Dict[str, Dict] = {
    "ibm01_like": {"n": 12752, "m": 14111, "seed": 201},
    "ibm02_like": {"n": 19601, "m": 19584, "seed": 202},
    "ibm03_like": {"n": 23136, "m": 27401, "seed": 203},
    "ibm04_like": {"n": 27507, "m": 31970, "seed": 204},
    "ibm05_like": {"n": 29347, "m": 28446, "seed": 205},
    "ibm06_like": {"n": 32498, "m": 34826, "seed": 206},
    "ibm07_like": {"n": 45926, "m": 48117, "seed": 207},
    "ibm08_like": {"n": 51309, "m": 50513, "seed": 208},
}
