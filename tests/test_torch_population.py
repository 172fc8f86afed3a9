"""Port parity of the distributed population step
(``repro_torch.core.population``; DESIGN.md §3, §6): LP sweeps, greedy
ring recombination and reweighted mutation over the ("pop", "model")
mesh, the pins split over "model".

* On one device (a (1, 1) mesh) the port's step is the reference's:
  partition and cut bit for bit (``tests/test_hypergraph_population.py``'s
  single-device step), balanced, no worse than the warm start.
* Over (pop 4, model 2) logical shards of the CPU, four steps are
  bit-equal to the port's own (pop 4, model 1) run, parts and cuts at
  every step (``tests/test_distributed.py``'s 4 x 2 step): the
  refinement and recombination sums are integer-valued, and mutation's
  reweighted sweep gives the same decisions here.  The cuts do not grow
  over the steps, every member stays balanced, and each reported cut is
  its partition's recomputed cut.
* ``make_local_population_step`` runs on the refinement engine's mesh
  (``tests/test_pop_shard.py``'s ring on the ("pop", "model") mesh).
"""
import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays

import jax.numpy as jnp

from repro.core import metrics as jmetrics
from repro.core import refine as jrefine
from repro.core.population import make_population_step as ref_step
from repro.data import hypergraphs as jdata
from repro.jaxcompat import make_mesh, use_mesh
import repro_torch.core as core
from repro_torch.core import metrics, popshard
from repro_torch.core.population import (make_local_population_step,
                                         make_population_step)

K, EPS = 8, 0.08


@pytest.fixture(scope="module")
def netlist():
    hg = jdata._modular_netlist(600, 800, seed=9, n_modules=8, p_local=0.8,
                                fanout_tail=1.5)
    hga = hg.arrays()
    args = [np.asarray(x) for x in (hga.pin_vertex, hga.pin_edge,
                                    hga.vertex_weights, hga.edge_weights,
                                    hga.edge_sizes)]
    return hg, hga, args


def _members(hg, n_pad, count, seed):
    rng = np.random.default_rng(seed)
    parts = np.zeros((count, n_pad), np.int32)
    for i in range(count):
        parts[i, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, K, hg.n).astype(np.int32), K,
            EPS, rng)
    return parts


@pytest.fixture
def pool(monkeypatch):
    """``pool(shards, model)``: the CPU pool as logical shards in a (pop,
    model) grid; restored after."""
    def make(shards, model):
        monkeypatch.setenv("REPRO_POP_MESH_MODEL", str(model))
        popshard.set_logical_shards(shards, CPU)
        return popshard.pop_mesh(CPU)
    yield make
    popshard.set_logical_shards(None)


def test_population_step_single_device_equals_reference(netlist):
    """Mesh (1, 1): the ring degenerates to self-loops, the whole step
    (refine, recombine, mutate) runs; the port's partition and cut are
    the reference's bit for bit, balanced and no worse than the start."""
    hg, hga, args = netlist
    parts = _members(hg, hga.n_pad, 1, seed=0)
    mesh = make_mesh((1, 1), ("data", "model"))
    step = ref_step(mesh, n=hg.n, m=hg.m, k=K, eps=EPS, refine_rounds=2)
    with use_mesh(mesh):
        want_p, want_c = step(*[jnp.asarray(a) for a in args],
                              jnp.asarray(parts))
    pmesh = popshard.PopMesh(((CPU,),))
    got_p, got_c = make_population_step(pmesh, n=hg.n, m=hg.m, k=K, eps=EPS,
                                        refine_rounds=2)(*args, parts)
    assert_bit_equal(got_p, want_p, "parts")
    assert_bit_equal(got_c, want_c, "cuts")
    ph = port_arrays(hga)
    cut0 = float(metrics.cutsize(ph, torch.from_numpy(parts[0]), K))
    assert float(got_c[0]) <= cut0 + 1e-6
    assert float(got_c[0]) == float(metrics.cutsize(ph, got_p[0], K))
    assert bool(metrics.is_balanced(ph, got_p[0], K, EPS))


def test_model_axis_step_equals_model_one(netlist, pool):
    """Four steps of 4 members over (pop 4, model 2) against (pop 4,
    model 1): parts and cuts bit-equal at every step; the mean cut does
    not grow, members stay balanced, cuts are the partitions' own."""
    hg, hga, args = netlist
    start = _members(hg, hga.n_pad, 4, seed=1)
    runs = {}
    for shards, model in ((4, 1), (8, 2)):
        mesh = pool(shards, model)
        assert mesh.shape == {"pop": 4, "model": model}
        step = make_population_step(mesh, n=hg.n, m=hg.m, k=K, eps=EPS,
                                    refine_rounds=3)
        parts, trail = start, []
        for _ in range(4):
            parts, cuts = step(*args, parts)
            trail.append((parts.clone(), cuts.clone()))
        runs[model] = trail
    for (p1, c1), (p2, c2) in zip(runs[1], runs[2]):
        assert_bit_equal(p2, p1, "parts")
        assert_bit_equal(c2, c1, "cuts")
    means = [float(c.mean()) for _, c in runs[2]]
    assert means[-1] <= means[0]
    ph = port_arrays(hga)
    parts, cuts = runs[2][-1]
    for i in range(4):
        assert bool(metrics.is_balanced(ph, parts[i], K, EPS))
        assert float(cuts[i]) == float(metrics.cutsize(ph, parts[i], K))
        assert float(cuts[i]) == float(jmetrics.cutsize_jit(
            hga, jnp.asarray(parts[i].numpy()), K))


def test_population_ring_on_pop_model_mesh(netlist, pool):
    """The ring operators on the refinement engine's mesh
    (``make_local_population_step``), 8 members over 8 pop shards:
    balanced, the mean cut no worse after three steps."""
    hg, hga, args = netlist
    pool(8, 1)
    step, mesh = make_local_population_step(n=hg.n, m=hg.m, k=K, eps=EPS,
                                            refine_rounds=3, device=CPU)
    assert mesh.shape == {"pop": 8, "model": 1}
    assert core.make_population_step is make_population_step
    parts = _members(hg, hga.n_pad, 8, seed=2)
    first = None
    for _ in range(3):
        parts, cuts = step(*args, parts)
        first = float(cuts.mean()) if first is None else first
    assert float(cuts.mean()) <= first
    ph = port_arrays(hga)
    assert all(bool(metrics.is_balanced(ph, parts[i], K, EPS))
               for i in range(8))
