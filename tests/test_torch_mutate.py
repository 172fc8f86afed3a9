"""Port parity of mutation: the population metrics, per-member edge
weights through contraction, gains and refinement, population
coarsening and the cohort V-cycle.

Bars and tolerances:

* connectivity, edge distances and similarity sets are exact (integer);
* per-member reweights ``w_e * (1 + 0.1 * C(e))`` are not integers, so
  the stages that add them (contracted parallel edges, weighted cuts,
  gains, pair ratings) hold to rtol 1e-6: the reference and the port add
  in different orders.  Given integer-valued rows, the same stages are
  bit-equal, and so is the refinement that consumes them;
* the population matching is exact when the reference's ``jax.random``
  jitter and ratings are injected (the port draws its own jitter);
* within the port, the cohort's ``batch`` and ``loop`` paths are
  bit-equal per member.
"""
import importlib

import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays, port_hg, to_np

import jax
import jax.numpy as jnp

from repro.core import dcoarsen as jd
from repro.core import metrics as jmetrics
from repro.core import refine as jrefine
from repro.core.hypergraph import contract_arrays as ref_contract_arrays
from repro_torch.core import dcoarsen, metrics, refine
from repro_torch.core.hypergraph import contract_arrays
from repro_torch.core.mutate import (MUTATE_PATHS, mutate_path,
                                     mutate_population, similarity_sets)
from repro_torch.core.vcycle import vcycle_population

# ``repro.core`` re-exports a function under this module name
jmutate = importlib.import_module("repro.core.mutate")

STRIDE = dict(max_stride=jd.MAX_STRIDE, max_edge_size=jd.MAX_EDGE_SIZE)


def _parts(hg, k, alpha, seed, n_pad=None):
    """Balanced random partitions, padded to ``n_pad`` when given."""
    rng = np.random.default_rng(seed)
    out = np.zeros((alpha, n_pad or hg.n), np.int32)
    for a in range(alpha):
        out[a, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
            0.08)
    return out


def _reweights(hg, alpha, seed, m_pad=None, mu=0.1):
    """Mutation-style rows ``w * (1 + mu * C)``, C in 0..3."""
    rng = np.random.default_rng(seed)
    out = np.zeros((alpha, m_pad or hg.m), np.float32)
    out[:, : hg.m] = hg.edge_weights * (
        1.0 + mu * rng.integers(0, 4, (alpha, hg.m)))
    return out


@pytest.mark.parametrize("k", [4, 8])
def test_population_metrics_exact(k, small_hg):
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    parts = _parts(small_hg, k, 4, seed=k, n_pad=hga.n_pad)
    parts[3] = parts[1]                                  # a twin
    jp, tp = jnp.asarray(parts), torch.from_numpy(parts)
    assert_bit_equal(metrics.connectivity_population(ph, tp, k),
                     jmetrics.connectivity_population(hga, jp, k))
    assert_bit_equal(metrics.edge_distance_matrix(ph, tp, k),
                     jmetrics.edge_distance_matrix(hga, jp, k))
    cuts = np.asarray(jmetrics.cutsize_population(hga, jp, k))
    for thr in (20.0, 400.0):
        assert similarity_sets(ph, parts, cuts, k, thr) == \
            jmutate.similarity_sets(hga, parts, cuts, k, thr)
    ew = _reweights(small_hg, 4, seed=k, m_pad=hga.m_pad)
    np.testing.assert_allclose(
        to_np(metrics.cutsize_population_weighted(ph, tp,
                                                  torch.from_numpy(ew), k)),
        np.asarray(jmetrics.cutsize_population_weighted(
            hga, jp, jnp.asarray(ew), k)), rtol=1e-6)
    ew_int = _reweights(small_hg, 4, seed=k, m_pad=hga.m_pad, mu=1.0)
    assert_bit_equal(
        metrics.cutsize_population_weighted(ph, tp, torch.from_numpy(ew_int),
                                            k),
        jmetrics.cutsize_population_weighted(hga, jp, jnp.asarray(ew_int),
                                             k))
    p0 = tp[0]
    assert float(metrics.km1(ph, p0, k)) == float(
        jmetrics.km1(hga, jp[0], k))
    assert bool(metrics.is_balanced(ph, p0, k, 0.08)) == bool(
        jmetrics.is_balanced(hga, jp[0], k, 0.08))
    assert float(metrics.imbalance(ph, p0, k)) == float(
        jmetrics.imbalance(hga, jp[0], k))


@pytest.mark.parametrize("path", ["segsum", "compact", "table", "stream"])
def test_gain_matrix_member_weights(path, small_hg, monkeypatch):
    """Per-member tables through every gain path: rtol 1e-6 on
    reweighted rows, exact on integer rows."""
    monkeypatch.setenv("REPRO_GAIN_PATH", path)
    k = 40 if path in ("compact", "stream") else 8
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    parts = _parts(small_hg, k, 3, seed=1, n_pad=hga.n_pad)
    for mu, exact in ((0.1, False), (1.0, True)):
        ew = _reweights(small_hg, 3, seed=2, m_pad=hga.m_pad, mu=mu)
        want = jmetrics._gain_matrix_population_impl(
            hga, jnp.asarray(parts), k, ew_pop=jnp.asarray(ew))
        got = metrics._gain_matrix_population_impl(
            ph, torch.from_numpy(parts), k, ew_pop=torch.from_numpy(ew))
        if exact:
            assert_bit_equal(got, want, f"{path} integer rows")
        else:
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-5)


def test_refine_population_member_weights_bit_equal(small_hg):
    """LP + FM with integer-valued member rows: parts and cuts per
    member equal the reference's."""
    k = 4
    hga = small_hg.structural_copy().arrays()
    parts = _parts(small_hg, k, 3, seed=6, n_pad=hga.n_pad)
    ew = _reweights(small_hg, 3, seed=6, m_pad=hga.m_pad, mu=1.0)
    want_p, want_c = jrefine.refine_population(hga, parts, k, 0.08,
                                               max_iters=6,
                                               edge_weights_pop=ew,
                                               shard="off")
    got_p, got_c = refine.refine_population(port_arrays(hga), parts, k,
                                            0.08, max_iters=6,
                                            edge_weights_pop=ew, device=CPU)
    assert_bit_equal(got_c, want_c, "cuts")
    assert_bit_equal(got_p, want_p, "parts")


@pytest.mark.parametrize("seed,n_new", [(0, 60), (2, 100)])
def test_contract_arrays_ew_pop(seed, n_new, small_hg):
    """Structure exact, member weights allclose (rtol 1e-6)."""
    hga = small_hg.structural_copy().arrays()
    rng = np.random.default_rng(seed)
    cid = np.full(hga.n_pad, hga.n_pad - 1, np.int32)
    cid[: small_hg.n] = rng.integers(0, n_new, small_hg.n)
    ew = _reweights(small_hg, 3, seed=seed, m_pad=hga.m_pad)
    want, want_p, want_ew = ref_contract_arrays(
        hga, jnp.asarray(cid), jnp.int32(n_new), ew_pop=jnp.asarray(ew))
    got, got_p, got_ew = contract_arrays(
        port_arrays(hga), torch.from_numpy(cid), n_new,
        ew_pop=torch.from_numpy(ew))
    assert got_p == int(want_p) and got.m == int(want.m)
    for f in ("pin_vertex", "pin_edge", "edge_sizes", "edge_weights",
              "vertex_weights"):
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(to_np(got_ew), np.asarray(want_ew),
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_population_matching_with_reference_jitter(seed, small_hg):
    """Candidates and ratings of the cohort's round, then the consensus
    matching with the reference's jitter and ratings injected."""
    k, alpha = 4, 3
    hga = small_hg.structural_copy().arrays()
    parts = _parts(small_hg, k, alpha, seed=seed, n_pad=hga.n_pad)
    parts[1] = parts[0]
    parts[2] = parts[0]
    flips = np.random.default_rng(seed).integers(0, small_hg.n, 20)
    parts[1, flips] = (parts[1, flips] + 1) % k
    ew = _reweights(small_hg, alpha, seed=seed, m_pad=hga.m_pad)
    lo, hi, r_pop = jd._pair_ratings_population(
        hga, jnp.asarray(parts), jnp.asarray(ew), batch=True, **STRIDE)
    ph = port_arrays(hga)
    tparts, tew = torch.from_numpy(parts), torch.from_numpy(ew)
    for batch in (True, False):
        g_lo, g_hi, g_r = dcoarsen._pair_ratings_population(
            ph, tparts, tew, batch=batch, **STRIDE)
        assert_bit_equal(g_lo, lo, "representative lo")
        assert_bit_equal(g_hi, hi, "representative hi")
        np.testing.assert_allclose(to_np(g_r), np.asarray(r_pop),
                                   rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(to_np(dcoarsen._member_sum(g_r)),
                               np.asarray(r_pop.sum(axis=0)), rtol=1e-6)
    c_max = float(np.float32(jd.round_schedule(small_hg, k).c_max))
    key = jax.random.PRNGKey(seed)
    rating = r_pop.sum(axis=0)
    want_cid, want_n = jd._mutual_match_dev(hga, lo, hi, rating, key,
                                            jnp.float32(c_max))
    jitter = np.array(jax.random.uniform(key, (2 * lo.shape[0],)))
    got_cid, got_n = dcoarsen._mutual_match_dev(
        ph, torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)),
        torch.from_numpy(np.array(rating)), torch.from_numpy(jitter), c_max)
    assert int(got_n) == int(want_n)
    assert_bit_equal(got_cid, want_cid, "cluster ids")


def test_population_hierarchy_and_vcycle_batch_equals_loop(small_hg):
    """The port's cohort V-cycle: batch and loop bit-equal per member,
    exact projection of every member's cut through the hierarchy, and
    per-member elitism on the member's own weights."""
    k, eps, alpha = 4, 0.08, 3
    # a cohort of near-twins, as mutation flags: one base, a few flips
    parts = np.repeat(_parts(small_hg, k, 1, seed=5), alpha, axis=0)
    flips = np.random.default_rng(5).integers(0, small_hg.n, (alpha, 10))
    for a in range(1, alpha):
        parts[a, flips[a]] = (parts[a, flips[a]] + 1) % k
    ew = _reweights(small_hg, alpha, seed=5)
    phg = port_hg(small_hg)
    hier = dcoarsen.population_coarsen(phg, parts, ew, k, seed=7,
                                       contraction_limit_factor=8,
                                       device=CPU)
    loop = dcoarsen.population_coarsen(phg, parts, ew, k, seed=7,
                                       contraction_limit_factor=8,
                                       batch=False, device=CPU)
    assert hier.num_levels >= 2 and hier.sizes() == loop.sizes()
    for li, (lb, ll) in enumerate(zip(hier.levels, loop.levels)):
        assert_bit_equal(lb.hga.pin_vertex, ll.hga.pin_vertex)
        assert_bit_equal(lb.parts, ll.parts)
        assert_bit_equal(lb.ew_pop, ll.ew_pop)
        cuts = to_np(metrics.cutsize_population_weighted(
            lb.hga, lb.parts, lb.ew_pop, k))
        if li == 0:
            cuts0 = cuts
        np.testing.assert_allclose(cuts, cuts0, rtol=1e-5)
    got_b = vcycle_population(phg, parts, ew, k, eps, seed=9, path="batch",
                              device=CPU)
    got_l = vcycle_population(phg, parts, ew, k, eps, seed=9, path="loop",
                              device=CPU)
    assert_bit_equal(got_b[0], got_l[0], "parts")
    assert_bit_equal(got_b[1], got_l[1], "cuts")
    hga = phg.arrays(device=CPU)
    ew_pad = torch.zeros((alpha, hga.m_pad))
    ew_pad[:, : small_hg.m] = torch.from_numpy(ew)
    warm = to_np(metrics.cutsize_population_weighted(
        hga, refine.pad_parts(parts, hga.n_pad), ew_pad, k))
    assert (got_b[1] <= warm + 1e-4).all()
    with pytest.raises(ValueError, match="mutation path"):
        vcycle_population(phg, parts, ew, k, eps, path="bogus", device=CPU)


def test_mutate_population_twins(small_hg, monkeypatch):
    """Identical offspring are flagged and re-partitioned; results are
    balanced and report their true cuts, on both cohort paths."""
    k, eps = 4, 0.08
    hga = small_hg.structural_copy().arrays()
    base = _parts(small_hg, k, 1, seed=8)[0]
    base, _ = jrefine.lp_refine(hga, base, k, eps, max_iters=3)
    parts = np.stack([np.asarray(base)[: small_hg.n]] * 3)
    cuts = np.asarray(jmetrics.cutsize_population(
        hga, jnp.asarray(jrefine.pad_parts(parts, hga.n_pad)), k),
        np.float64)
    phg = port_hg(small_hg)
    ph = phg.arrays(device=CPU)
    results = []
    for path in MUTATE_PATHS:
        monkeypatch.setenv("REPRO_MUTATE_PATH", path)
        assert mutate_path() == path
        new_parts, new_cuts = mutate_population(phg, parts, cuts, k, eps,
                                                seed=1, device=CPU)
        padded = refine.pad_parts(new_parts, ph.n_pad)
        assert_bit_equal(new_cuts, metrics.cutsize_population(ph, padded, k))
        for p in padded:
            assert bool(metrics.is_balanced(ph, p, k, eps))
        results.append((new_parts, new_cuts))
    assert_bit_equal(results[0][0], results[1][0])
    assert_bit_equal(results[0][1], results[1][1])
    assert_bit_equal(results[0][0][0], parts[0])     # the best is exempt
    monkeypatch.setenv("REPRO_MUTATE_PATH", "bogus")
    with pytest.warns(UserWarning, match="REPRO_MUTATE_PATH"):
        assert mutate_path() == "batch"


# --------------------------------------------------------------------------
# the fixed-order sums of member rows, run here through their plain versions
# --------------------------------------------------------------------------
def _index_add_gains(ph, parts, k, path, ew):
    """The gain assembly of member rows with ``index_add_`` in pin order,
    the sums the fixed-order path replaced: on the CPU it must give the
    same bits."""
    alpha, n_pad = parts.shape
    phi = metrics.pins_in_block_population(ph, parts, k)
    pe, pv = ph.pin_edge.long(), ph.pin_vertex.long()
    if path == "segsum":
        bi, wi = metrics._edge_gain_terms(ph, phi, ew)
        g = torch.zeros((alpha, n_pad, k)).index_add_(1, pv, bi[:, pe])
    else:
        s = ph.edge_sizes[:, None]
        multi = ph.edge_sizes >= 2
        mask = (phi == s - 1) & multi[:, None]
        cols = torch.arange(k)
        c1 = torch.where(mask, cols, k).amin(-1)
        c2 = torch.where(mask & (cols != c1[..., None]), cols, k).amin(-1)
        wi = torch.where((phi == s) & multi[:, None], ew[..., None],
                         0.0).sum(-1)
        rows = (torch.arange(alpha)[:, None] * n_pad + pv[None]) * (k + 1)
        wp = ew[:, pe].reshape(-1)
        g = torch.zeros(alpha * n_pad * (k + 1))
        g.index_add_(0, (rows + c1[:, pe]).reshape(-1), wp)
        g.index_add_(0, (rows + c2[:, pe]).reshape(-1), wp)
        g = g.reshape(alpha, n_pad, k + 1)[..., :k]
    l = torch.zeros((alpha, n_pad)).index_add_(1, pv, wi[:, pe])
    return (g - l[..., None]).scatter_(2, parts.long()[..., None], 0.0)


@pytest.mark.parametrize("path,k", [("segsum", 8), ("compact", 40)])
def test_fixed_order_gain_sums_match_reference(path, k, small_hg):
    """The fixed-order assembly of reweighted rows (pins sorted by vertex
    through the rating sum): rtol 1e-6 against the reference on
    reweighted rows, exact on integer rows."""
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    parts = _parts(small_hg, k, 3, seed=11, n_pad=hga.n_pad)
    for mu, exact in ((0.1, False), (1.0, True)):
        ew = _reweights(small_hg, 3, seed=12, m_pad=hga.m_pad, mu=mu)
        want = jmetrics._gain_matrix_population_impl(
            hga, jnp.asarray(parts), k, assemble=path,
            ew_pop=jnp.asarray(ew))
        got = metrics._gain_matrix_population_impl(
            ph, torch.from_numpy(parts), k, assemble=path,
            ew_pop=torch.from_numpy(ew))
        assert ph.pin_sort is not None
        order, vertex = ph.pin_sort
        assert bool((vertex[1:] >= vertex[:-1]).all())
        if exact:
            assert_bit_equal(got, want, f"{path} integer rows")
        else:
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("path,k", [("segsum", 8), ("compact", 40)])
def test_fixed_order_gain_sums_keep_cpu_bits(path, k, small_hg):
    """On CPU tensors the fixed-order sums of reweighted rows give the
    bits of ``index_add_`` in pin order, the CPU's sums before them."""
    ph = port_arrays(small_hg.structural_copy().arrays())
    parts = torch.from_numpy(_parts(small_hg, k, 3, seed=13,
                                    n_pad=ph.n_pad))
    ew = torch.from_numpy(_reweights(small_hg, 3, seed=14, m_pad=ph.m_pad))
    got = metrics._gain_matrix_population_impl(ph, parts, k, assemble=path,
                                               ew_pop=ew)
    assert_bit_equal(got, _index_add_gains(ph, parts, k, path, ew),
                     f"{path} reweighted rows")


def test_fixed_order_contract_and_fm_match_reference(small_hg):
    """``contract_arrays(ew_pop=)`` and FM with member rows through the
    fixed-order sums: member weights within rtol 1e-6 of the reference;
    with integer rows, FM's parts and cuts equal the reference's."""
    hga = small_hg.structural_copy().arrays()
    rng = np.random.default_rng(5)
    cid = np.full(hga.n_pad, hga.n_pad - 1, np.int32)
    cid[: small_hg.n] = rng.integers(0, 80, small_hg.n)
    ew = _reweights(small_hg, 3, seed=5, m_pad=hga.m_pad)
    _, _, want_ew = ref_contract_arrays(
        hga, jnp.asarray(cid), jnp.int32(80), ew_pop=jnp.asarray(ew))
    _, _, got_ew = contract_arrays(port_arrays(hga), torch.from_numpy(cid),
                                   80, ew_pop=torch.from_numpy(ew))
    np.testing.assert_allclose(to_np(got_ew), np.asarray(want_ew),
                               rtol=1e-6, atol=0.0)
    k = 4
    parts = _parts(small_hg, k, 3, seed=7, n_pad=hga.n_pad)
    iew = _reweights(small_hg, 3, seed=7, m_pad=hga.m_pad, mu=1.0)
    want_p, want_c = jrefine.fm_refine_population(hga, parts, k, 0.08,
                                                  edge_weights_pop=iew,
                                                  shard="off")
    got_p, got_c = refine.fm_refine_population(port_arrays(hga), parts, k,
                                               0.08, edge_weights_pop=iew)
    assert_bit_equal(got_c, want_c, "cuts")
    assert_bit_equal(got_p, want_p, "parts")
