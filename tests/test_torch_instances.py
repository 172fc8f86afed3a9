"""Port parity of the instance axis (DESIGN.md §12): the stacked
refinement (``core.instances``), ``vcycle_instances``,
``impart_partition_instances`` and its bandit driver, and
``request_stream``.

The bar is bit equality everywhere: each request refined inside a
stack must get the partition and cut of its solo run in the port, and,
where both packages build the same hierarchy (host coarsening, no
mutation, whose device coarsening draws its own jitter), the
reference's.  Edge and vertex weights are integer-valued f32, so every
sum is exact in any order and no tolerance is needed.  Sizes are the
reference's own test sizes (modular netlists of n 200-600, alpha 2-3,
``lp_iters`` 3 or 4, ``contraction_limit_factor`` 16, and beta 1 where
mutation or the bandit run: the file must stay within two minutes on
one core).
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_arrays, port_hg

from repro.core import instances as jinstances
from repro.core import refine as jrefine
from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition_instances as ref_instances
from repro.core.vcycle import vcycle_instances as ref_vcycle_instances
from repro.data import hypergraphs as jdata
from repro_torch.core import instances, refine
from repro_torch.core.hypergraph import _arrays_to_host
from repro_torch.core.impart import (ImpartConfig, impart_partition,
                                     impart_partition_instances)
from repro_torch.core.scheduler import SchedulerTrace
from repro_torch.core.vcycle import vcycle, vcycle_instances
from repro_torch.data import hypergraphs as tdata

ALPHA = 3


def _netlist(n, m, seed, modules=5):
    return jdata._modular_netlist(n, m, seed=seed, n_modules=modules,
                                  p_local=0.8, fanout_tail=1.5)


def _population(hg, k, eps, seed, alpha=ALPHA):
    rng = np.random.default_rng(seed)
    return [jrefine.rebalance(hg.vertex_weights,
                              rng.integers(0, k, hg.n).astype(np.int32),
                              k, eps) for _ in range(alpha)]


@pytest.fixture(scope="module")
def pair():
    """Two netlists with different natural paddings (512 and 1024)."""
    return [_netlist(260, 340, 1), _netlist(600, 800, 2, modules=8)]


@pytest.fixture(scope="module")
def duo():
    """The reference's driver-test pair (n 260 and 350)."""
    return [_netlist(260, 340, 5), _netlist(350, 450, 6)]


# --------------------------------------------------------------------------
# buckets and stacking
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 16, 33])
def test_k_bucket_matches_reference(k):
    assert instances.k_bucket(k) == jinstances.k_bucket(k)


@pytest.mark.parametrize("n_pad,grid", [
    (300, (1024, 4096)), (1024, (1024, 4096)), (2000, (4096, 1024)),
    (8192, (1024, 4096)), (512, None), (512, ())])
def test_bucket_n_pad_matches_reference(n_pad, grid):
    assert (instances.bucket_n_pad(n_pad, grid)
            == jinstances.bucket_n_pad(n_pad, grid))


def test_stack_instances_bit_equal_to_reference(pair):
    hgas = [hg.arrays() for hg in pair]
    want = jinstances.stack_instances(hgas, [3, 8], [0.08, 0.10],
                                      grid=(2048,))
    mine = [port_arrays(h) for h in hgas]
    got = instances.stack_instances(mine, [3, 8], [0.08, 0.10],
                                    grid=(2048,))
    assert (got.n_pad, got.k_pad, got.n_instances) == (2048, 8, 2)
    assert got.ns == want.ns and got.ks == want.ks
    assert got.orig_n_pads == want.orig_n_pads
    for f in ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
              "edge_sizes", "n", "m"):
        assert_bit_equal(getattr(got.hga, f), getattr(want.hga, f), f)
    for f in ("k_live", "cap", "fm_steps"):
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    for h, hg, k in zip(mine, pair, (3, 8)):
        assert (instances.group_key(h, k, (2048,))
                == jinstances.group_key(hg.arrays(), k, (2048,)))


def test_dispatch_groups_split_at_the_gain_kernels_int32_extents():
    """Three k-32 entries of one bucket whose union would pass 2**31
    table entries (alpha 7 x 3 x 2**22 x 32) split into stacks of two and
    one, in order; a bucket of another k stays apart."""
    big = SimpleNamespace(n_pad=2 ** 22, m_pad=2 ** 22, incident=None)
    small = SimpleNamespace(n_pad=512, m_pad=512, incident=None)
    parts = np.zeros((7, 1), np.int32)
    entries = [(big, parts, 32, 0.03), (small, parts, 4, 0.03),
               (big, parts, 20, 0.03), (big, parts, 32, 0.03)]
    assert instances.dispatch_groups(entries) == [[0, 2], [3], [1]]


def test_stack_parts_requires_shared_alpha():
    with pytest.raises(ValueError, match="share alpha"):
        instances.stack_parts(
            [np.zeros((2, 8), np.int32), np.zeros((3, 8), np.int32)], 16)


# --------------------------------------------------------------------------
# the grouped refinement == solo, == the reference's
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parity_case():
    """The reference's parity specs (k 3, 8, 5): under ``grid=(1024,)``
    one n bucket and the k buckets 4 and 8, so both a stack (k 5 masked
    under k 8) and re-padding are exercised.  Returns the port's entries,
    its solo results and the reference's grouped results."""
    specs = [(280, 380, 1, 3, 0.08), (400, 520, 2, 8, 0.10),
             (330, 430, 3, 5, 0.12)]
    entries, jentries, solos = [], [], []
    for i, (n, m, seed, k, eps) in enumerate(specs):
        hg = _netlist(n, m, seed, modules=6)
        hga = hg.arrays()
        parts = jrefine.pad_parts(_population(hg, k, eps, 10 + i), hga.n_pad)
        jentries.append((hga, parts, k, eps))
        mine = port_arrays(hga)
        entries.append((mine, torch.from_numpy(np.array(parts)), k, eps))
        solos.append(refine.refine_population(mine, np.array(parts), k,
                                              eps, max_iters=4, device="cpu"))
    ref = jinstances.refine_grouped(jentries, grid=(1024,), max_iters=4,
                                    shard="off")
    return entries, solos, ref


def test_refine_grouped_bit_equal_to_solo_and_reference(parity_case,
                                                        monkeypatch):
    """On the card's gain path (``table``, here the kernel's plain
    version on the union's incidence layout); the drivers' tests below
    take the CPU's (segsum)."""
    monkeypatch.setenv("REPRO_GAIN_PATH", "table")
    entries, solos, ref = parity_case
    entries = [(_with_layout(h), p, k, e) for h, p, k, e in entries]
    outs = instances.refine_grouped(entries, grid=(1024,), max_iters=4,
                                    device="cpu")
    for i, ((gp, gc), (sp, sc), (rp, rc)) in enumerate(zip(outs, solos,
                                                          ref)):
        assert_bit_equal(gp, sp, f"instance {i} parts vs solo")
        assert_bit_equal(gc, sc, f"instance {i} cuts vs solo")
        assert_bit_equal(gp, rp, f"instance {i} parts vs reference")
        assert_bit_equal(gc, rc, f"instance {i} cuts vs reference")


def _with_layout(h):
    """The level with its dense incidence layout, as the card builds it."""
    if h.incident is not None:
        return h
    host = _arrays_to_host(h, h.n, h.m)
    return dataclasses.replace(h, incident=torch.from_numpy(
        host.incidence_matrix(h.n_pad)))


def test_lp_and_fm_refine_instances_masks_bit_equal_to_solo():
    """k 3 and 6 stacked at k_pad 8 (``k_live`` < ``k_pad`` for both),
    natural paddings 256 and 512 in one bucket (FM budgets 256 and
    512): each tier bit-equal to its solo loop."""
    hgs = [tdata._modular_netlist(200, 260, seed=7, n_modules=4,
                                  p_local=0.8, fanout_tail=1.5),
           tdata._modular_netlist(300, 390, seed=8, n_modules=5,
                                  p_local=0.8, fanout_tail=1.5)]
    ks, epss = [3, 6], [0.08, 0.12]
    hgas = [hg.arrays(device="cpu") for hg in hgs]
    pops = [_population(hg, k, eps, 20 + i, alpha=2)
            for i, (hg, k, eps) in enumerate(zip(hgs, ks, epss))]
    batch = instances.stack_instances(hgas, ks, epss)
    assert batch.k_pad == 8 and batch.n_pad == 512
    assert batch.fm_steps.tolist() == [256, 512]
    parts = instances.stack_parts(pops, batch.n_pad)
    lp_p, lp_c = instances.lp_refine_instances(batch, parts, max_iters=3)
    fm_p, fm_c = instances.fm_refine_instances(batch, lp_p)
    assert_bit_equal(instances._cutsize_instances(batch, fm_p).double(),
                     fm_c, "stack cuts")
    for i, (h, pop, k, eps) in enumerate(zip(hgas, pops, ks, epss)):
        n_pad = h.n_pad
        sp, sc = refine.lp_refine_population(h, pop, k, eps, max_iters=3)
        assert_bit_equal(lp_p[i][:, :n_pad], sp, f"LP parts {i}")
        assert_bit_equal(lp_c[i], sc, f"LP cuts {i}")
        fp, fc = refine.fm_refine_population(h, sp, k, eps)
        assert_bit_equal(fm_p[i][:, :n_pad], fp, f"FM parts {i}")
        assert_bit_equal(fm_c[i], fc, f"FM cuts {i}")
        # padded columns stay untouched
        assert not fm_p[i][:, n_pad:].any()


# --------------------------------------------------------------------------
# batched drivers == solo, == the reference's
# --------------------------------------------------------------------------
def _vcycle_inputs(hgs, ks, epss):
    parts = []
    for hg, k, eps in zip(hgs, ks, epss):
        rng = np.random.default_rng(42)
        parts.append(jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32),
            k, eps))
    return parts


def test_vcycle_instances_bit_equal(monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hgs = [_netlist(260 + 90 * i, 340 + 110 * i, 5 + i) for i in range(2)]
    ks, epss = [4, 6], [0.08, 0.10]
    parts = _vcycle_inputs(hgs, ks, epss)
    mine = [port_hg(hg) for hg in hgs]
    got = vcycle_instances(mine, parts, ks, epss, seeds=[3, 3],
                           device="cpu")
    want = ref_vcycle_instances(hgs, parts, ks, epss, seeds=[3, 3])
    for i, (hg, p, k, eps) in enumerate(zip(mine, parts, ks, epss)):
        solo = vcycle(hg, p, k, eps, seed=3, device="cpu")
        for other, what in ((solo, "solo"), (want[i], "reference")):
            assert_bit_equal(got[i][0], other[0], f"instance {i} vs {what}")
            assert got[i][1] == other[1]


def _cfgs(ks, epss, **kw):
    base = dict(alpha=2, beta=2, lp_iters=3, contraction_limit_factor=16,
                final_vcycles=1)
    base.update(kw)
    return [dict(k=k, eps=e, seed=7 + i, **base)
            for i, (k, e) in enumerate(zip(ks, epss))]


def _assert_same_results(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g.part, w.part, f"{what}: instance {i}")
        assert g.cut == w.cut, (what, i)
        assert g.population_cuts == w.population_cuts, (what, i)
        assert [t[2] for t in g.trace] == [t[2] for t in w.trace], (what, i)
        assert g.degraded == w.degraded


@pytest.mark.parametrize("mutation", [True, False])
def test_impart_instances_bit_equal_to_solo(duo, mutation):
    """With mutation on the cohorts coarsen on the device engine; the
    port's grouped and solo runs draw the same jitter."""
    cfgs = _cfgs([4, 8], [0.08, 0.10], mutation_enabled=mutation,
                 beta=1 if mutation else 2)
    mine = [port_hg(hg) for hg in duo]
    got = impart_partition_instances(mine, [ImpartConfig(**c) for c in cfgs],
                                     device="cpu")
    solo = [impart_partition(hg, ImpartConfig(**c), device="cpu")
            for hg, c in zip(mine, cfgs)]
    _assert_same_results(got, solo, "grouped vs solo")


def test_impart_instances_bit_equal_to_reference(duo, monkeypatch):
    """Recombination on, no final V-cycle (``vcycle_instances`` is held
    to the reference above): the reference's compile time is most of
    this file's."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    cfgs = _cfgs([4, 8], [0.08, 0.10], mutation_enabled=False,
                 final_vcycles=0)
    got = impart_partition_instances([port_hg(hg) for hg in duo],
                                     [ImpartConfig(**c) for c in cfgs],
                                     device="cpu")
    want = ref_instances([hg.structural_copy() for hg in duo],
                         [RefConfig(**c) for c in cfgs])
    _assert_same_results(got, want, "port vs reference")
    assert [r.levels for r in got] == [r.levels for r in want]


def test_level_budget_is_batch_invariant(duo):
    cfgs = _cfgs([4, 4], [0.08, 0.08], level_budget=2, beta=7)
    mine = [port_hg(hg) for hg in duo]
    got = impart_partition_instances(mine, [ImpartConfig(**c) for c in cfgs],
                                     device="cpu")
    solo = [impart_partition(hg, ImpartConfig(**c), device="cpu")
            for hg, c in zip(mine, cfgs)]
    assert all(r.degraded for r in got)
    _assert_same_results(got, solo, "level budget")


def test_time_budget_degrades(duo):
    res = impart_partition_instances(
        [port_hg(duo[0])], [ImpartConfig(k=4, eps=0.08, alpha=2, seed=7,
                                         lp_iters=3, time_budget_s=1e-9)],
        device="cpu")[0]
    assert res.degraded and res.trace[-1][2] == "budget-exhausted"
    assert res.part.shape == (duo[0].n,)
    assert 0 <= res.part.min() and res.part.max() < 4
    assert np.isfinite(res.cut)


@pytest.mark.parametrize("kw,match", [
    (dict(n_cfgs=1), "one config per hypergraph"),
    (dict(alpha=(2, 3)), "equal alpha"),
    (dict(lp_iters=(3, 4)), "equal alpha"),
    (dict(fm_node_limit=(4096, 0)), "equal alpha"),
    (dict(sched=("bandit", "static")), "uniform sched")],
    ids=["count", "alpha", "lp_iters", "fm_node_limit", "sched"])
def test_impart_instances_validation(kw, match, duo):
    cfgs = []
    for i in range(kw.get("n_cfgs", 2)):
        c = dict(k=2, alpha=2, lp_iters=3)
        for f in ("alpha", "lp_iters", "fm_node_limit", "sched"):
            if f in kw:
                c[f] = kw[f][i]
        cfgs.append(ImpartConfig(**c))
    with pytest.raises(ValueError, match=match):
        impart_partition_instances([port_hg(hg) for hg in duo], cfgs,
                                   device="cpu")


@pytest.mark.parametrize("how", ["incumbent entry", "incumbents",
                                 "shard mesh", "shard chunk",
                                 "model_shard mesh", "pop_shard config"])
def test_later_slices_raise(how, duo):
    """The model axis belongs to a later slice and raises; the mesh and
    chunk routes are ported (over the CPU's pool of one device they give
    the single-device bits), and so are the incumbent entries and stacks
    (bounded migration): an incumbent entry equals its solo budgeted
    refinement, and a stack carries its incumbent and an infinite budget
    for a None one."""
    hga = port_hg(duo[0]).arrays(device="cpu")
    parts = np.zeros((2, hga.n_pad), np.int32)
    if how == "incumbent entry":
        inc = np.zeros(hga.n, np.int32)
        (got_p, got_c), = instances.refine_grouped(
            [(hga, parts, 2, 0.1, inc, 5.0)], device="cpu")
        want_p, want_c = refine.refine_population(
            hga, parts, 2, 0.1, incumbent=inc, mig_budget=5.0, device="cpu")
        assert_bit_equal(got_p, want_p, "parts")
        assert_bit_equal(got_c, want_c, "cuts")
        return
    if how == "incumbents":
        batch = instances.stack_instances([hga], [2], [0.1],
                                          incumbents=[np.zeros(hga.n)])
        assert batch.incumbent.shape == (1, hga.n_pad)
        assert bool(torch.isinf(batch.mig_budget).all())
        return
    if how == "pop_shard config":
        got, = impart_partition_instances(
            [port_hg(duo[0])], [ImpartConfig(k=2, pop_shard="mesh")],
            device="cpu")
        want, = impart_partition_instances(
            [port_hg(duo[0])], [ImpartConfig(k=2)], device="cpu")
        assert_bit_equal(got.part, want.part, "part")
        assert got.cut == want.cut
        return
    arg, route = how.split()
    entries = [(hga, parts, 2, 0.1), (hga, parts + 1, 2, 0.1)]
    if arg == "model_shard":
        with pytest.raises(NotImplementedError, match="later slice"):
            instances.refine_grouped(entries, device="cpu", **{arg: route})
        return
    got = instances.refine_grouped(entries, device="cpu", **{arg: route})
    want = instances.refine_grouped(entries, device="cpu")
    for (gp, gc), (wp, wc) in zip(got, want):
        assert_bit_equal(gp, wp, "parts")
        assert_bit_equal(gc, wc, "cuts")


@pytest.mark.parametrize("entry", ["refine_grouped", "vcycle_instances",
                                   "impart_partition_instances"])
def test_entry_points_default_to_the_card(entry, duo):
    """Without ``device=`` the instance entry points ask for the card,
    and raise where there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hg = port_hg(duo[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "refine_grouped":
            hga = hg.arrays(device="cpu")
            instances.refine_grouped(
                [(hga, np.zeros((2, hga.n_pad), np.int32), 2, 0.1)])
        elif entry == "vcycle_instances":
            vcycle_instances([hg], [np.zeros(hg.n, np.int32)], [2], [0.1])
        else:
            impart_partition_instances([hg], [ImpartConfig(k=2, alpha=2)])


def test_grouped_bandit_trace_replays_solo_and_grouped(duo):
    """A live grouped bandit run, then each request's trace (after a
    JSON round trip) replayed through the grouped driver and solo: both
    give the live partition and cut bit for bit."""
    cfgs = _cfgs([4, 8], [0.08, 0.10], sched="bandit", beta=1)
    mine = [port_hg(hg) for hg in duo]
    live = impart_partition_instances(
        mine, [ImpartConfig(**c) for c in cfgs], device="cpu")
    replays = [dict(c, sched_replay=SchedulerTrace.from_json(json.loads(
        json.dumps(r.sched_trace.to_json())))) for c, r in zip(cfgs, live)]
    grouped = impart_partition_instances(
        mine, [ImpartConfig(**c) for c in replays], device="cpu")
    solo = [impart_partition(hg, ImpartConfig(**c), device="cpu")
            for hg, c in zip(mine, replays)]
    for what, runs in (("grouped replay", grouped), ("solo replay", solo)):
        for i, (r, w) in enumerate(zip(runs, live)):
            assert_bit_equal(r.part, w.part, f"{what}: instance {i}")
            assert r.cut == w.cut
            assert (r.sched_trace.arm_sequence()
                    == w.sched_trace.arm_sequence())


def test_request_stream_matches_reference():
    got = tdata.request_stream(12, tag="bench")
    want = jdata.request_stream(12, tag="bench")
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g["name"], g["k"], g["eps"]) == (w["name"], w["k"], w["eps"])
        for f in ("pins", "edge_offsets", "vertex_weights", "edge_weights"):
            assert_bit_equal(getattr(g["hg"], f), getattr(w["hg"], f), f)
    assert {g["hg"].n for g in got} <= {280, 400, 620, 900}
