"""Port parity of recombination, the exact solver and the V-cycle.

All bars are bit for bit, under host coarsening: the numpy coarsener is
the same in both packages, the weights are integer-valued, the ILS draws
its perturbations in the reference's order from the same
``default_rng(seed)``, and the refinement trajectories follow the
reference's tie-breaks.
"""
import importlib

import numpy as np
import pytest

from port_parity import CPU, assert_bit_equal, port_hg

from repro.core import ilp as jilp
from repro.core import metrics as jmetrics
from repro.core import refine as jrefine
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.hypergraph import contract as ref_contract
from repro.data.hypergraphs import _modular_netlist
from repro_torch.core import ilp, metrics, popshard, recombine, refine
from repro_torch.core.hypergraph import contract
from repro_torch.core.vcycle import vcycle

# ``repro.core`` re-exports functions under these module names
jrecombine = importlib.import_module("repro.core.recombine")
jvcycle = importlib.import_module("repro.core.vcycle")


def _rand_hg(rng, n, m):
    edges = [rng.choice(n, size=int(rng.integers(2, min(6, n))),
                        replace=False) for _ in range(m)]
    return RefHypergraph.from_edge_lists(edges, n=n)


def _population(hg, k, eps, alpha, seed):
    """Refined partitions and cuts from the reference's scalar LP."""
    rng = np.random.default_rng(seed)
    hga = hg.arrays()
    parts, cuts = [], []
    for _ in range(alpha):
        p = jrefine.rebalance(hg.vertex_weights,
                              rng.integers(0, k, hg.n).astype(np.int32), k,
                              eps, rng)
        p, c = jrefine.lp_refine(hga, p, k, eps, max_iters=3)
        parts.append(np.asarray(p)[: hg.n])
        cuts.append(c)
    return np.stack(parts), np.asarray(cuts)


def test_overlay_clustering_and_ring_partners():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 5, 300).astype(np.int32)
    b = rng.integers(0, 5, 300).astype(np.int32)
    got = recombine.overlay_clustering(a, b, 5)
    want = jrecombine.overlay_clustering(a, b, 5)
    assert_bit_equal(got[0], want[0])
    assert got[1] == want[1]
    stacked = np.stack([a, b, a + 1])
    assert_bit_equal(popshard.ring_partners(stacked, shard="off"),
                     np.roll(stacked, -1, axis=0))
    assert_bit_equal(popshard.ring_partners(stacked, shard="mesh",
                                            device="cpu"),
                     np.roll(stacked, -1, axis=0))


@pytest.mark.parametrize("seed,k,eps", [(1, 2, 0.0), (2, 3, 0.34),
                                        (3, 4, 0.5)])
def test_solve_exact_same_part_and_cut(seed, k, eps):
    rng = np.random.default_rng(seed)
    hg = _rand_hg(rng, 12, 24)
    warm = jrefine.rebalance(hg.vertex_weights,
                             rng.integers(0, k, hg.n).astype(np.int32), k,
                             max(eps, 0.34))
    for kw in (dict(), dict(warm_start=warm, node_budget=5000)):
        want_p, want_c = jilp.solve_exact(hg, k, eps, **kw)
        got_p, got_c = ilp.solve_exact(port_hg(hg), k, eps, **kw)
        assert got_c == want_c
        assert_bit_equal(got_p, want_p)


@pytest.mark.parametrize("seed,restarts", [(3, 6), (4, 2)])
def test_ils_clustered_bit_equal(seed, restarts, small_hg):
    """Clustered instance of two parents, ILS from the better one."""
    k, eps = 8, 0.08
    parts, cuts = _population(small_hg, k, eps, 2, seed)
    cid, n_prime = jrecombine.overlay_clustering(parts[0], parts[1], k)
    chg, _ = ref_contract(small_hg, cid, n_prime)
    first = np.zeros(n_prime, np.int64)
    first[cid[::-1]] = np.arange(small_hg.n - 1, -1, -1)
    warm = parts[int(np.argmin(cuts))][first].astype(np.int32)
    want_p, want_c = jrecombine._ils_clustered(chg, k, eps, warm, seed,
                                               restarts=restarts)
    pchg, _ = contract(port_hg(small_hg), cid, n_prime)
    got_p, got_c = recombine._ils_clustered(pchg, k, eps, warm, seed,
                                            restarts=restarts, device=CPU)
    assert got_c == want_c
    assert_bit_equal(got_p, want_p)


@pytest.mark.parametrize("k", [4, 8])
def test_ring_recombination_bit_equal(k, small_hg, monkeypatch):
    """k = 4 takes the exact branch and bound, k = 8 the ILS branch.
    k = 4 runs on a netlist of n 150: its overlay has at most k^2 = 16
    clusters at any n, so the branch is the same, and the branch and
    bound's node budget, not n, sets its time."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hg = small_hg if k == 8 else _modular_netlist(
        150, 200, seed=11, n_modules=8, p_local=0.8, fanout_tail=1.5)
    branches = []
    exact, ils = recombine.ilp_mod.solve_exact, recombine._ils_clustered
    monkeypatch.setattr(recombine.ilp_mod, "solve_exact", lambda *a, **kw: (
        branches.append("exact"), exact(*a, **kw))[1])
    monkeypatch.setattr(recombine, "_ils_clustered", lambda *a, **kw: (
        branches.append("ils"), ils(*a, **kw))[1])
    eps = 0.08
    parts, cuts = _population(hg, k, eps, 3, seed=20 + k)
    want_p, want_c = jrecombine.ring_recombination(hg, parts, cuts, k,
                                                   eps, seed=5)
    got_p, got_c = recombine.ring_recombination(port_hg(hg), parts,
                                                cuts, k, eps, seed=5,
                                                device=CPU)
    assert_bit_equal(got_c, want_c, "cuts")
    assert_bit_equal(got_p, want_p, "offspring")
    for i in range(3):
        assert got_c[i] <= min(cuts[i], cuts[(i + 1) % 3]) + 1e-6
    assert set(branches) == ({"exact"} if k == 4 else {"ils"})


@pytest.mark.parametrize("k", [4, 8])
def test_vcycle_bit_equal(k, small_hg, monkeypatch):
    """The V-cycle (recombination's branch for n' > 40 k, mutation's
    re-partition and the driver's final cycle) under host coarsening."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    eps = 0.08
    rng = np.random.default_rng(k)
    part = jrefine.rebalance(small_hg.vertex_weights,
                             rng.integers(0, k, small_hg.n).astype(np.int32),
                             k, eps)
    want_p, want_c = jvcycle.vcycle(small_hg, part, k, eps, seed=3)
    got_p, got_c = vcycle(port_hg(small_hg), part, k, eps, seed=3,
                          device=CPU)
    assert got_c == want_c
    assert_bit_equal(got_p, want_p)
    hga = small_hg.arrays()
    assert got_c <= float(jmetrics.cutsize_jit(
        hga, jrefine.pad_part(part, hga.n_pad), k))
    # elitism measured on other weights (a reweighted copy of the level)
    w = (1 + np.arange(small_hg.m) % 3).astype(np.float32)
    want_p, want_c = jvcycle.vcycle(small_hg, part, k, eps, seed=4,
                                    eval_weights=w)
    got_p, got_c = vcycle(port_hg(small_hg), part, k, eps, seed=4,
                          eval_weights=w, device=CPU)
    assert got_c == want_c
    assert_bit_equal(got_p, want_p)
    # with a scheduler each level's tier is chosen through it, under
    # SCHED_VCYCLE_PHASE: replaying the reference's decisions gives its
    # partition and cut
    from repro.core.scheduler import OperatorScheduler as RefScheduler
    from repro_torch.core.scheduler import (SCHED_VCYCLE_PHASE,
                                            OperatorScheduler,
                                            SchedulerTrace)
    live = RefScheduler(seed=5)
    want_p, want_c = jvcycle.vcycle(small_hg, part, k, eps, seed=3,
                                    scheduler=live)
    replay = OperatorScheduler(
        replay=SchedulerTrace.from_json(live.trace.to_json()))
    got_p, got_c = vcycle(port_hg(small_hg), part, k, eps, seed=3,
                          scheduler=replay, device=CPU)
    assert got_c == want_c
    assert_bit_equal(got_p, want_p)
    assert replay.trace.arm_sequence() == live.trace.arm_sequence()
    assert {d.phase for d in replay.trace.decisions} == {SCHED_VCYCLE_PHASE}


def test_recombine_elitism_and_true_cut(small_hg, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    k, eps = 4, 0.08
    parts, cuts = _population(small_hg, k, eps, 2, seed=7)
    phg = port_hg(small_hg)
    off, cut = recombine.recombine(phg, parts[0], parts[1], cuts[0], cuts[1],
                                   k, eps, seed=1, device=CPU)
    assert cut <= min(cuts) + 1e-6
    hga = phg.arrays(device=CPU)
    padded = refine.pad_part(off, hga.n_pad)
    assert bool(metrics.is_balanced(hga, padded, k, eps))
    assert cut == float(metrics.cutsize(hga, padded, k))
