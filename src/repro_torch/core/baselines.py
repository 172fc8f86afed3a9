"""Baseline partitioners the paper compares against (port of
``repro.core.baselines``).

* ``multilevel_partition`` — the KaHyPar stand-in: one multilevel pass
  (host coarsening -> initial partition -> uncoarsen with the scalar
  two-tier refinement) plus optional V-cycles.
* ``multilevel_best_of`` — the best of several independent runs under a
  shared budget (paper Sec. 4.1, "same total execution time").
* ``external_memetic`` — the KaHyPar-E stand-in: a population evolved
  where every recombination and mutation runs a complete multilevel
  partitioner on the original hypergraph.

Every refinement runs on ``device``; the scalar LP tier's gains come
from the one-member gain kernels there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .budget import exhausted
from .hypergraph import Hypergraph
from .coarsen import coarsen
from .initial_partition import initial_partition
from . import refine as refine_mod
from .recombine import overlay_clustering
from .vcycle import vcycle


@dataclasses.dataclass
class MultilevelResult:
    part: np.ndarray
    cut: float
    wall_s: float
    trace: List[tuple]


def multilevel_partition(hg: Hypergraph, k: int, eps: float, seed: int = 0,
                         n_vcycles: int = 0, fm_node_limit: int = 4096,
                         contraction_limit_factor: int = 64,
                         init_part: Optional[np.ndarray] = None,
                         restrict_overlay: Optional[np.ndarray] = None,
                         device: str | torch.device = "cuda"
                         ) -> MultilevelResult:
    """One full multilevel pass on ``device``.  ``restrict_overlay``
    (cluster ids) makes coarsening respect an overlay — the KaHyPar-E
    recombination device."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    hier = coarsen(hg, k, seed=seed,
                   contraction_limit_factor=contraction_limit_factor,
                   restrict_part=restrict_overlay)
    coarsest = hier.coarsest
    trace = []
    if init_part is not None:
        # project the given fine partition onto the coarsest level
        cur = np.asarray(init_part, np.int32)
        for lv in hier.levels[1:]:
            newp = np.zeros(lv.hg.n, np.int32)
            newp[lv.cluster_id] = cur
            cur = newp
        part, cut = refine_mod.refine(coarsest.arrays(device=dev), cur, k,
                                      eps, fm_node_limit=fm_node_limit)
        part = part[: coarsest.n]
    else:
        part, cut = initial_partition(coarsest, k, eps, seed=seed,
                                      device=dev)
    trace.append((coarsest.n, cut))

    for li in range(len(hier.levels) - 1, -1, -1):
        lv = hier.levels[li]
        if li < len(hier.levels) - 1:
            part = part[hier.levels[li + 1].cluster_id]
        part, cut = refine_mod.refine(lv.hg.arrays(device=dev), part, k, eps,
                                      fm_node_limit=fm_node_limit)
        part = part[: lv.hg.n]
        trace.append((lv.hg.n, cut))

    for v in range(n_vcycles):
        part, cut = vcycle(hg, part, k, eps, seed=seed * 31 + v, device=dev)
        trace.append((hg.n, cut))
    return MultilevelResult(part=np.asarray(part, np.int32), cut=float(cut),
                            wall_s=time.perf_counter() - t0, trace=trace)


def multilevel_best_of(hg: Hypergraph, k: int, eps: float, seed: int = 0,
                       repetitions: int = 7,
                       time_budget_s: Optional[float] = None,
                       device: str | torch.device = "cuda"
                       ) -> MultilevelResult:
    """Best of ``repetitions`` independent multilevel runs."""
    t0 = time.perf_counter()
    best = None
    trace = []
    for r in range(repetitions):
        res = multilevel_partition(hg, k, eps, seed=seed * 131 + r,
                                   device=device)
        trace.extend(res.trace)
        if best is None or res.cut < best.cut:
            best = res
        if exhausted(t0, time_budget_s):
            break
    return MultilevelResult(part=best.part, cut=best.cut,
                            wall_s=time.perf_counter() - t0, trace=trace)


def external_memetic(hg: Hypergraph, k: int, eps: float, seed: int = 0,
                     population: int = 7, generations: int = 6,
                     time_budget_s: Optional[float] = None,
                     device: str | torch.device = "cuda"
                     ) -> MultilevelResult:
    """KaHyPar-E stand-in: every evolutionary operation re-runs a
    complete multilevel partitioner on the original hypergraph."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    pop: List[Tuple[np.ndarray, float]] = []
    trace = []
    for i in range(population):
        res = multilevel_partition(hg, k, eps, seed=seed * 271 + i,
                                   device=device)
        pop.append((res.part, res.cut))
        trace.append((hg.n, res.cut))
        if exhausted(t0, time_budget_s):
            break
    for g in range(generations):
        if exhausted(t0, time_budget_s):
            break
        # tournament-select two parents
        idx = rng.choice(len(pop), size=min(4, len(pop)), replace=False)
        idx = sorted(idx, key=lambda i: pop[i][1])[:2]
        pa, ca = pop[idx[0]]
        pb, cb = pop[idx[1]]
        cid, _ = overlay_clustering(pa[: hg.n], pb[: hg.n], k)
        # full multilevel run with overlay-restricted coarsening,
        # warm-started from the better parent (KaHyPar-E recombine)
        res = multilevel_partition(
            hg, k, eps, seed=seed * 997 + g,
            restrict_overlay=cid, init_part=pa if ca <= cb else pb,
            device=device)
        worst = int(np.argmax([c for _, c in pop]))
        if res.cut < pop[worst][1]:
            pop[worst] = (res.part, res.cut)
        trace.append((hg.n, res.cut))
        # occasional mutation: V-cycle restart of a random member
        if rng.random() < 0.3:
            m = int(rng.integers(len(pop)))
            mp, mc = vcycle(hg, pop[m][0], k, eps, seed=seed * 577 + g,
                            device=device)
            pop[m] = (mp, mc)
    best = min(range(len(pop)), key=lambda i: pop[i][1])
    return MultilevelResult(part=pop[best][0], cut=float(pop[best][1]),
                            wall_s=time.perf_counter() - t0, trace=trace)
