"""Port parity of incremental repartitioning (DESIGN.md §14): the
bounded-migration branch of both refinement tiers and of stacks
(``refine``, ``instances``), ``core.incremental`` and
``data.hypergraphs.drift_stream``.

Sizes are the reference's own test sizes (``tests/test_incremental.py``:
a modular netlist of n 500, k 8, eps 0.08), with
``contraction_limit_factor`` 16 where a hierarchy of several levels is
needed.  The incumbent is computed once, by the port, and shared by
both packages.

The bar: with integer-valued weights every sum is exact in any order,
so the budgeted refinement, ``refine_grouped`` with incumbent entries
and ``incremental_partition`` under host coarsening equal the reference
bit for bit, and an infinite budget equals the program without the
branch.  Drifted weights (``drift_stream``) are real-valued; the test of
the exact-sum case rounds them to integers.  On real-valued drift the
two packages add in different orders, so the answer is held to its
guarantees (budget, balance, no worse than the incumbent) and its cut to
within ``REAL_DRIFT_CUT_RATIO`` of the reference's.  Assertions are
structural, never timings.
"""
import os

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_arrays, port_hg

from repro.core import incremental as jinc
from repro.core import instances as jinstances
from repro.core import refine as jrefine
from repro.core.dcoarsen import build_hierarchy as jbuild_hierarchy
from repro.data import hypergraphs as jdata
from repro_torch.core import incremental as tinc
from repro_torch.core import instances, metrics, refine
from repro_torch.core.dcoarsen import build_hierarchy
from repro_torch.core import hypergraph
from repro_torch.core.hypergraph import contract_arrays
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.data import hypergraphs as tdata

K, EPS = 8, 0.08
CLF = 16  # contraction limit factor giving a hierarchy of several levels

#: Real-valued drift: the reference and the port add the drifted weights
#: in different orders (XLA's segment sums against the port's), so an LP
#: or FM tie can break the other way.  The answer must keep its
#: guarantees; its cut stays within this ratio of the reference's.
REAL_DRIFT_CUT_RATIO = 1.10


def _netlist(n=500, m=700, seed=11, modules=8):
    return jdata._modular_netlist(n, m, seed=seed, n_modules=modules,
                                  p_local=0.8, fanout_tail=1.5)


@pytest.fixture(scope="module")
def base():
    """The reference tests' netlist and one incumbent for both packages:
    the port's memetic-off partition under host coarsening."""
    hg = _netlist()
    old = os.environ.get("REPRO_COARSEN_PATH")
    os.environ["REPRO_COARSEN_PATH"] = "host"
    try:
        res = impart_partition(
            port_hg(hg), ImpartConfig(k=K, eps=EPS, alpha=2, lp_iters=4,
                                      recombination_enabled=False,
                                      mutation_enabled=False,
                                      final_vcycles=0,
                                      contraction_limit_factor=CLF),
            device="cpu")
    finally:
        if old is None:
            del os.environ["REPRO_COARSEN_PATH"]
        else:
            os.environ["REPRO_COARSEN_PATH"] = old
    return hg, np.asarray(res.part, np.int32)


@pytest.fixture
def host_engine(monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")


def _random_incumbent(hg, seed=5):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, K, hg.n).astype(np.int32)
    return jrefine.rebalance(hg.vertex_weights, part, K, EPS).astype(
        np.int32)


def _seeds(hg, inc, budget, seed=3, alpha=4):
    """Members that start within half the budget: the incumbent with
    random moves, as the reference's migration-cap test builds them."""
    rng = np.random.default_rng(seed)
    vw = np.asarray(hg.vertex_weights, np.float64)
    parts = []
    for _ in range(alpha):
        p = inc.copy()
        spent = 0.0
        for v in rng.permutation(hg.n):
            if spent + vw[v] > 0.5 * budget:
                break
            p[v] = rng.integers(0, K)
            spent += vw[v] if p[v] != inc[v] else 0.0
        parts.append(p)
    return parts


def _moved(hg, parts, inc):
    vw = np.asarray(hg.vertex_weights, np.float64)
    return [float(vw[p[: hg.n] != inc].sum()) for p in np.asarray(parts)]


# --------------------------------------------------------------------------
# accept_moves and the budgeted tiers
# --------------------------------------------------------------------------
def test_accept_moves_with_incumbent_equals_reference():
    """Every row of the port's batched acceptance equals the reference's
    one-row ``accept_moves`` with the same incumbent and remaining
    budget, at budgets that bind, that do not, and are exhausted."""
    rng = np.random.default_rng(7)
    alpha, n_pad, k = 4, 256, 6
    part = rng.integers(0, k, (alpha, n_pad)).astype(np.int32)
    target = rng.integers(0, k, (alpha, n_pad)).astype(np.int32)
    gain = rng.integers(-3, 8, (alpha, n_pad)).astype(np.float32)
    propose = (gain > 0) & (target != part)
    vw = rng.integers(1, 4, n_pad).astype(np.float32)
    inc = rng.integers(0, k, n_pad).astype(np.int32)
    bw = np.stack([np.bincount(p, weights=vw, minlength=k)
                   for p in part]).astype(np.float32)
    cap = np.float32(bw.max() + 20.0)
    frac = np.array([1.0, 0.5, 0.25, 1.0], np.float32)
    remaining = np.array([40.0, 5.0, 0.0, np.inf], np.float32)
    got = refine.accept_moves(
        torch.from_numpy(part), torch.from_numpy(target),
        torch.from_numpy(gain), torch.from_numpy(propose),
        torch.from_numpy(vw), torch.from_numpy(bw), torch.tensor(cap),
        torch.from_numpy(frac), k, incumbent=torch.from_numpy(inc),
        mig_remaining=torch.from_numpy(remaining))
    for a in range(alpha):
        want = jrefine.accept_moves(
            part[a], target[a], gain[a], propose[a], vw, bw[a], cap,
            frac[a], k, incumbent=inc, mig_remaining=remaining[a])
        assert_bit_equal(got[a], want, f"row {a}")


@pytest.mark.parametrize("which", ["refined", "random"])
def test_budgeted_refine_population_equals_reference(which, base):
    """Budgeted LP + FM refinement (n 500 is under ``fm_node_limit``, so
    both tiers run) equals the reference bit for bit, and every member
    stays within budget; against a random incumbent the budget binds."""
    hg, inc = base
    if which == "random":
        inc = _random_incumbent(hg)
    budget = 0.05 * float(np.sum(hg.vertex_weights, dtype=np.float64))
    parts = _seeds(hg, inc, budget)
    hga_j = hg.arrays()
    want_p, want_c = jrefine.refine_population(
        hga_j, [p.copy() for p in parts], K, EPS, incumbent=inc,
        mig_budget=budget)
    got_p, got_c = refine.refine_population(
        port_arrays(hga_j), [p.copy() for p in parts], K, EPS,
        incumbent=inc, mig_budget=budget, device="cpu")
    assert_bit_equal(got_p, np.asarray(want_p), "parts")
    assert_bit_equal(got_c, np.asarray(want_c), "cuts")
    moved = _moved(hg, got_p, inc)
    assert max(moved) <= budget + 1e-4, (moved, budget)
    if which == "random":
        assert max(moved) > 0.9 * budget, (moved, budget)


@pytest.mark.parametrize("budget", [None, np.inf], ids=["None", "inf"])
@pytest.mark.parametrize("tier", ["refine_population", "lp"])
def test_unbounded_budget_is_the_program_without_branch(tier, budget,
                                                        base):
    """LP alone, and LP then FM (n 500 is under ``fm_node_limit``)."""
    hg, inc = base
    hga = port_hg(hg).arrays(device="cpu")
    parts = _seeds(hg, inc, 60.0, alpha=3)
    fn = {"refine_population": refine.refine_population,
          "lp": refine.lp_refine_population}[tier]
    kw = dict(device="cpu") if tier == "refine_population" else {}
    p0, c0 = fn(hga, [p.copy() for p in parts], K, EPS, **kw)
    p1, c1 = fn(hga, [p.copy() for p in parts], K, EPS, incumbent=inc,
                mig_budget=budget, **kw)
    assert_bit_equal(p1, p0, "parts")
    assert_bit_equal(c1, c0, "cuts")


def test_refine_grouped_mixed_entries_equal_solo_and_reference(base):
    """A stack of an incumbent entry (6-tuple) and a cold one (4-tuple):
    each equals its solo ``refine_population`` and the reference's
    ``refine_grouped``; a one-entry call takes the solo path."""
    hg, _ = base
    inc = _random_incumbent(hg)
    budget = 0.05 * float(np.sum(hg.vertex_weights, dtype=np.float64))
    other = _netlist(260, 340, seed=21, modules=5)
    # the generator numbers cells module by module: contiguous blocks
    # with a few random moves are near a local optimum, so FM is short
    blocks = (np.arange(other.n) * K // other.n).astype(np.int32)
    parts_a = np.stack(_seeds(hg, inc, budget, alpha=3))
    parts_b = np.stack(_seeds(other, blocks, 20.0, seed=9, alpha=3))
    ha_j, hb_j = hg.arrays(), other.arrays()
    ha_t, hb_t = port_arrays(ha_j), port_arrays(hb_j)
    got = instances.refine_grouped(
        [(ha_t, parts_a, K, EPS, inc, budget), (hb_t, parts_b, K, EPS)],
        device="cpu")
    want = jinstances.refine_grouped(
        [(ha_j, parts_a, K, EPS, inc, budget), (hb_j, parts_b, K, EPS)])
    solo = [refine.refine_population(ha_t, parts_a, K, EPS, incumbent=inc,
                                     mig_budget=budget, device="cpu"),
            refine.refine_population(hb_t, parts_b, K, EPS, device="cpu")]
    for i in range(2):
        assert_bit_equal(got[i][0], solo[i][0], f"entry {i} vs solo")
        assert_bit_equal(got[i][1], solo[i][1], f"entry {i} cuts vs solo")
        assert_bit_equal(got[i][0], np.asarray(want[i][0]),
                         f"entry {i} vs reference")
        assert_bit_equal(got[i][1], np.asarray(want[i][1]),
                         f"entry {i} cuts vs reference")
    assert max(_moved(hg, got[0][0], inc)) <= budget + 1e-4
    (one_p, one_c), = instances.refine_grouped(
        [(ha_t, parts_a, K, EPS, inc, budget)], device="cpu")
    assert_bit_equal(one_p, solo[0][0], "one entry")
    assert_bit_equal(one_c, solo[0][1], "one entry cuts")


# --------------------------------------------------------------------------
# the host helpers and the drift stream
# --------------------------------------------------------------------------
def test_host_helpers_equal_reference(base, host_engine):
    """``structure_token``, ``project_incumbent``,
    ``seed_incumbent_population`` and ``select_best`` on one host
    hierarchy of both packages (built around an older assignment, so
    the residuals are not zero)."""
    hg, inc = base
    older = _random_incumbent(hg, seed=8)
    assert tinc.structure_token(port_hg(hg)) == jinc.structure_token(hg)
    edited = jdata.drift_stream(hg, 1, pin_edit_frac=0.05, tag="tok")[0]
    assert tinc.structure_token(port_hg(edited)) \
        == jinc.structure_token(edited) != jinc.structure_token(hg)
    hier_j = jbuild_hierarchy(hg, K, seed=0, restrict_part=older,
                              contraction_limit_factor=CLF)
    hier_t = build_hierarchy(port_hg(hg), K, seed=0, restrict_part=older,
                             contraction_limit_factor=CLF, device="cpu")
    assert hier_t.num_levels == hier_j.num_levels > 2
    budget = 40.0
    incs_t, buds_t = tinc.project_incumbent(hier_t, inc, K, budget)
    incs_j, buds_j = jinc.project_incumbent(hier_j, inc, K, budget)
    for a, b in zip(incs_t, incs_j):
        assert_bit_equal(a, b, "projected incumbent")
    assert buds_t == buds_j and buds_t[-1] < budget
    cfg_t = tinc.IncrementalConfig(k=K, eps=EPS, alpha=4, seed=3)
    cfg_j = jinc.IncrementalConfig(k=K, eps=EPS, alpha=4, seed=3)
    seeds_t = tinc.seed_incumbent_population(hier_t, incs_t[-1], 40.0,
                                             cfg_t)
    assert_bit_equal(seeds_t, jinc.seed_incumbent_population(
        hier_j, incs_j[-1], 40.0, cfg_j), "seeds")
    assert (seeds_t[1:] != seeds_t[0]).any()
    vw = np.asarray(hg.vertex_weights, np.float64)
    parts0 = np.stack([inc, older, inc])
    for cuts, inc_cut, bud in (([5.0, 3.0, 5.0], 4.0, 1e9),
                               ([5.0, 3.0, 5.0], 4.0, 10.0),
                               ([5.0, 3.0, 5.0], 4.5, 10.0)):
        got = tinc.select_best(parts0, np.array(cuts), inc, inc_cut, vw,
                               bud)
        want = jinc.select_best(parts0, np.array(cuts), inc, inc_cut, vw,
                                bud)
        assert_bit_equal(got[0], want[0], "selected part")
        assert got[1:] == want[1:]


@pytest.mark.parametrize("kw", [
    dict(magnitude=0.25), dict(magnitude=0.25, vertex_magnitude=0.1),
    dict(magnitude=0.1, pin_edit_frac=0.05)],
    ids=["edges", "vertices", "pin_edits"])
def test_drift_stream_equals_reference(kw):
    hg = jdata.random_hypergraph(300, 450, seed=9)
    got = tdata.drift_stream(port_hg(hg), 3, tag="det", **kw)
    want = jdata.drift_stream(hg, 3, tag="det", **kw)
    for g, w in zip(got, want):
        for f in ("pins", "edge_offsets", "edge_weights", "vertex_weights"):
            assert_bit_equal(getattr(g, f), getattr(w, f), f)
    if "pin_edit_frac" not in kw:
        # pure weight drift shares the base's structure outright
        assert got[0].pins is got[2].pins


# --------------------------------------------------------------------------
# incremental_partition
# --------------------------------------------------------------------------
def _integer_drift(hg, tag):
    """A drift step with its weights rounded to integers (at least 1):
    the parity bar's exact-sum case."""
    d = jdata.drift_stream(hg, 1, magnitude=0.6, tag=tag)[0]
    return d.with_edge_weights(np.maximum(np.rint(d.edge_weights * 3), 1.0))


@pytest.mark.parametrize("drift", ["zero", "integer"])
def test_incremental_partition_equals_reference(drift, base, host_engine):
    hg, inc = base
    if drift == "integer":
        hg = _integer_drift(hg, "int")
    cfg = dict(k=K, eps=EPS, alpha=4, migration_frac=0.1, seed=0,
               contraction_limit_factor=CLF)
    got = tinc.incremental_partition(port_hg(hg), inc,
                                     tinc.IncrementalConfig(**cfg),
                                     device="cpu")
    want = jinc.incremental_partition(hg, inc, jinc.IncrementalConfig(**cfg))
    assert_bit_equal(got.part, want.part, "part")
    assert_bit_equal(got.cuts, want.cuts, "member cuts")
    assert (got.cut, got.migration_weight, got.budget_weight, got.reused,
            got.levels) == (want.cut, want.migration_weight,
                            want.budget_weight, want.reused, want.levels)


def test_real_drift_keeps_guarantees_and_tracks_reference(base,
                                                          host_engine):
    hg, inc = base
    drifted = jdata.drift_stream(hg, 1, magnitude=0.3, tag="cap")[0]
    cfg = dict(k=K, eps=EPS, alpha=4, migration_frac=0.05, seed=0,
               contraction_limit_factor=CLF)
    got = tinc.incremental_partition(port_hg(drifted), inc,
                                     tinc.IncrementalConfig(**cfg),
                                     device="cpu")
    want = jinc.incremental_partition(drifted, inc,
                                      jinc.IncrementalConfig(**cfg))
    vw = np.asarray(hg.vertex_weights, np.float64)
    moved = float(vw[got.part != inc].sum())
    assert moved <= got.budget_weight + 1e-4
    assert abs(moved - got.migration_weight) <= 1e-4
    hga = port_hg(drifted).arrays(device="cpu")
    assert bool(metrics.is_balanced(hga, refine.pad_part(got.part,
                                                         hga.n_pad), K, EPS))
    inc_cut = float(metrics.cutsize(hga, refine.pad_part(inc, hga.n_pad),
                                    K))
    assert got.cut <= inc_cut + 1e-4
    assert got.cut <= REAL_DRIFT_CUT_RATIO * want.cut, (got.cut, want.cut)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_class_sequence_and_resident_equals_cold(engine, base, monkeypatch):
    """cold -> resident (bit-equal to a solve without state), then a pin
    edit -> patched, then weight drift -> replayed; a k-change on the
    same weights -> resident, on either coarsening engine."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", engine)
    hg, inc = base
    thg = port_hg(hg)
    cfg = tinc.IncrementalConfig(k=K, eps=EPS, alpha=2, lp_iters=3,
                                 migration_frac=0.2, seed=0,
                                 contraction_limit_factor=CLF)
    st = tinc.IncrementalState()
    r0 = tinc.incremental_partition(thg, inc, cfg, state=st, device="cpu")
    r1 = tinc.incremental_partition(thg, inc, cfg, state=st, device="cpu")
    cold = tinc.incremental_partition(thg, inc, cfg, device="cpu")
    assert (r0.reused, r1.reused, cold.reused) == ("cold", "resident",
                                                   "cold")
    assert r1.levels > 2
    assert_bit_equal(r1.part, cold.part, "resident vs cold")
    assert (r1.cut, r1.migration_weight) == (cold.cut,
                                             cold.migration_weight)
    edited = tdata.drift_stream(thg, 1, magnitude=0.1, pin_edit_frac=0.05,
                                tag="edit")[0]
    r2 = tinc.incremental_partition(edited, r1.part, cfg, state=st,
                                    device="cpu")
    drifted = tdata.drift_stream(edited, 1, magnitude=0.2, tag="edit2")[0]
    r3 = tinc.incremental_partition(drifted, r2.part, cfg, state=st,
                                    device="cpu")
    assert (r2.reused, r3.reused) == ("patched", "replayed")
    assert r3.migration_weight <= r3.budget_weight + 1e-6
    rk = tinc.repartition_k_change(drifted, r3.part, K // 2, cfg, state=st,
                                   device="cpu")
    assert rk.reused == "resident" and rk.part.max() < K // 2
    assert rk.migration_weight <= rk.budget_weight + 1e-6


@pytest.mark.parametrize("engine", ["host", "device"])
def test_replay_weights_bit_exact_at_zero_drift(engine, base):
    """Replaying every stored contraction on equal (but distinct) weight
    arrays gives every level's weight leaves bit for bit; weight drift
    flags every level real-valued."""
    hg, inc = base
    thg = port_hg(hg)
    hier = build_hierarchy(thg, K, seed=0, restrict_part=inc,
                           contraction_limit_factor=CLF, path=engine,
                           device="cpu")
    rep = tinc._replay_weights(hier, thg.with_edge_weights(
        thg.edge_weights.copy()))
    assert rep.num_levels == hier.num_levels > 2
    for li in range(hier.num_levels):
        a, b = hier.level_arrays(li), rep.level_arrays(li)
        assert_bit_equal(b.edge_weights, a.edge_weights, f"level {li} ew")
        assert_bit_equal(b.vertex_weights, a.vertex_weights, f"level {li} vw")
        assert not b.real_edge_weights
    drifted = tdata.drift_stream(thg, 1, magnitude=0.2, tag="r")[0]
    rep = tinc._replay_weights(hier, drifted)
    assert all(rep.level_arrays(li).real_edge_weights
               for li in range(rep.num_levels))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(base):
    hg, inc = base
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tinc.IncrementalConfig(k=K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinc.incremental_partition(port_hg(hg), inc, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinc.repartition_k_change(port_hg(hg), inc, 4, cfg)


# --------------------------------------------------------------------------
# F3: real-valued weights take the fixed-order sums
# --------------------------------------------------------------------------
def _pair_clusters(hga, size):
    """Clusters of ``size`` consecutive vertices (pads -> the ghost)."""
    ar = torch.arange(hga.n_pad)
    cid = torch.where(ar < hga.n, ar // size, hga.n_pad - 1)
    return cid, (hga.n - 1) // size + 1


def test_real_weight_flags_decided_on_the_host(base):
    hg, inc = base
    thg = port_hg(hg)
    lv = thg.arrays(device="cpu")
    assert not (lv.real_edge_weights or lv.real_vertex_weights)
    drifted = tdata.drift_stream(thg, 1, magnitude=0.2,
                                 vertex_magnitude=0.1, tag="f")[0]
    dl = drifted.arrays(device="cpu")
    assert dl.real_edge_weights and dl.real_vertex_weights
    cid, n_new = _pair_clusters(dl, 2)
    coarse, _ = contract_arrays(dl, cid, n_new)
    assert coarse.real_edge_weights and coarse.real_vertex_weights
    assert hypergraph.is_real_valued(torch.from_numpy(
        drifted.edge_weights)) and not hypergraph.is_real_valued(
            lv.edge_weights)
    ints = drifted.with_edge_weights(np.rint(drifted.edge_weights) + 1,
                                     np.rint(drifted.vertex_weights) + 1)
    il = ints.arrays(device="cpu")
    assert not (il.real_edge_weights or il.real_vertex_weights)


@pytest.mark.parametrize("site", ["segsum", "compact", "block_weights",
                                  "contract_arrays"])
def test_fixed_order_sums_of_drifted_levels_keep_cpu_bits(site, base):
    """On the CPU the fixed-order sums add each segment in the order
    ``index_add_``/``scatter_add_`` add it there, so a drifted level
    gives the same bits through either route."""
    hg, inc = base
    drifted = tdata.drift_stream(port_hg(hg), 1, magnitude=0.3,
                                 vertex_magnitude=0.2, tag="s")[0]
    real = drifted.arrays(device="cpu")
    plain = real.__class__(**{**real.__dict__, "real_edge_weights": False,
                              "real_vertex_weights": False,
                              "pin_sort": None, "pin_sort_edge": None})
    rng = np.random.default_rng(4)
    parts = torch.from_numpy(rng.integers(0, 40, (3, real.n_pad))
                             .astype(np.int32))
    k = 40
    if site in ("segsum", "compact"):
        got = metrics._gain_matrix_population_impl(real, parts, k,
                                                   assemble=site)
        want = metrics._gain_matrix_population_impl(plain, parts, k,
                                                    assemble=site)
    elif site == "block_weights":
        got = metrics.block_weights_population(real, parts, k)
        want = metrics.block_weights_population(plain, parts, k)
    else:
        cid, n_new = _pair_clusters(real, 3)
        got = contract_arrays(real, cid, n_new)[0]
        want = contract_arrays(plain, cid, n_new)[0]
        assert_bit_equal(got.vertex_weights, want.vertex_weights, "vw")
        got, want = got.edge_weights, want.edge_weights
    assert_bit_equal(got, want, site)
