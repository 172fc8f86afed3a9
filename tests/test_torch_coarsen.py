"""Port parity of both coarsening engines.

* Host engine (numpy, copied): identical hierarchies, level for level.
* Device engine, stage by stage:
  - the sorted candidate keys are exact;
  - the aggregated pair ratings are allclose (rtol=1e-6): they are sums
    of w_e / (|e| - 1), which are not integers, added in another order
    than the reference's unstable sort leaves them;
  - the matching is exact when the reference's ``jax.random`` jitter is
    injected (the port draws its own jitter from a ``torch.Generator``);
  - the dense incidence layout built on the device is exact.
* A whole device-coarsening run at the same seed: different jitter bits,
  so only the level sizes are compared — within 5% on the first two
  coarsened levels, and the number of levels within one.
"""
import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays, port_hg, to_np

import jax
import jax.numpy as jnp

from repro.core import dcoarsen as jd
from repro.core.coarsen import (coarsen as ref_coarsen,
                                recombination_thresholds as ref_thresholds,
                                round_schedule as ref_schedule)
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro_torch.core import dcoarsen, metrics
from repro_torch.core.coarsen import (Hierarchy, coarsen,
                                      recombination_thresholds)
from repro_torch.core.hypergraph import HierarchyArrays

STRIDE = dict(max_stride=jd.MAX_STRIDE, max_edge_size=jd.MAX_EDGE_SIZE)


def _random_hg(seed, n=160, m=240, max_size=8, int_weights=True):
    rng = np.random.default_rng(seed)
    edges = [rng.choice(n, size=rng.integers(2, max_size + 1), replace=False)
             for _ in range(m)]
    ew = (rng.integers(1, 5, m).astype(np.float32) if int_weights
          else rng.random(m).astype(np.float32) + 0.5)
    hg = RefHypergraph.from_edge_lists(edges, n=n, edge_weights=ew)
    hg.vertex_weights[:] = rng.integers(1, 4, n).astype(np.float32)
    return hg


def test_host_coarsen_identical(small_hg):
    want = ref_coarsen(small_hg, 4, contraction_limit_factor=8, seed=1)
    got = coarsen(port_hg(small_hg), 4, contraction_limit_factor=8, seed=1)
    assert got.sizes() == want.sizes() and len(want.levels) > 2
    for lg, lw in zip(got.levels, want.levels):
        assert_bit_equal(lg.cluster_id, lw.cluster_id)
        for f in ("pins", "edge_offsets", "vertex_weights", "edge_weights"):
            assert_bit_equal(getattr(lg.hg, f), getattr(lw.hg, f), f)
    assert_bit_equal(recombination_thresholds(600, 40, 7),
                     ref_thresholds(600, 40, 7))


@pytest.mark.parametrize("seed,int_weights,restrict",
                         [(0, True, False), (1, False, False),
                          (2, True, True)])
def test_sorted_keys_exact_and_ratings_allclose(seed, int_weights, restrict):
    hg = _random_hg(seed, int_weights=int_weights)
    hga = hg.arrays()
    part_np = None
    if restrict:
        part_np = np.zeros(hga.n_pad, np.int32)
        part_np[: hg.n] = np.random.default_rng(seed).integers(0, 3, hg.n)
    jpart = None if part_np is None else jnp.asarray(part_np)
    tpart = None if part_np is None else torch.from_numpy(part_np)
    # the reference's sorted keys, rebuilt from its own candidate stage
    u, v, valid, _ = jd._stride_candidates(hga, **STRIDE)
    if restrict:
        valid = valid & (jpart[u] == jpart[v])
    ghost = hga.n_pad - 1
    lo = jnp.where(valid, jnp.minimum(u, v), ghost)
    hi = jnp.where(valid, jnp.maximum(u, v), ghost)
    want_lo, want_hi = jax.lax.sort((lo, hi), num_keys=2)
    ph = port_arrays(hga)
    got_lo, got_hi, _, _ = dcoarsen._sorted_candidates(ph, tpart, **STRIDE)
    assert_bit_equal(got_lo, want_lo, "sorted lo")
    assert_bit_equal(got_hi, want_hi, "sorted hi")

    want = jd._pair_ratings(hga, jpart, **STRIDE)
    got = dcoarsen._pair_ratings(ph, tpart, **STRIDE)
    assert_bit_equal(got[0], want[0], "representative lo")
    assert_bit_equal(got[1], want[1], "representative hi")
    np.testing.assert_allclose(to_np(got[2]), np.asarray(want[2]),
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("seed", [4, 5])
def test_mutual_match_exact_with_reference_jitter(seed):
    hg = _random_hg(seed, n=300, m=500)
    hga = hg.arrays()
    sched = ref_schedule(hg, 4)
    lo, hi, agg = jd._pair_ratings(hga, None, **STRIDE)
    key = jax.random.PRNGKey(seed)
    want_cid, want_n = jd._mutual_match_dev(hga, lo, hi, agg, key,
                                            jnp.float32(sched.c_max))
    # the reference draws uniform(key, [2C]) inside; inject the same bits
    jitter = np.asarray(jax.random.uniform(key, (2 * lo.shape[0],)))
    got_cid, got_n = dcoarsen._mutual_match_dev(
        port_arrays(hga), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), torch.from_numpy(np.array(agg)),
        torch.from_numpy(jitter), float(np.float32(sched.c_max)))
    assert int(got_n) == int(want_n)
    assert_bit_equal(got_cid, want_cid, "cluster ids")


def test_incidence_dev_exact(small_hg):
    hga = small_hg.structural_copy().arrays()
    want = jd._incidence_dev(hga, 16)
    got = dcoarsen._incidence_dev(port_arrays(hga), 16)
    assert_bit_equal(got, want)
    host = small_hg.incidence_matrix(hga.n_pad)
    assert_bit_equal(got[:, : host.shape[1]], host)


def test_device_coarsen_level_sizes_within_tolerance(small_hg):
    want = jd.device_coarsen(small_hg.structural_copy(), 4,
                             contraction_limit_factor=8, seed=0)
    got = dcoarsen.device_coarsen(port_hg(small_hg), 4,
                                  contraction_limit_factor=8, seed=0,
                                  device=CPU)
    assert isinstance(got, HierarchyArrays)
    ws, gs = want.sizes(), got.sizes()
    assert gs[0] == ws[0] and abs(len(gs) - len(ws)) <= 1, (gs, ws)
    for g, w in zip(gs[1:3], ws[1:3]):
        assert abs(g - w) <= 0.05 * w, (gs, ws)
    # a coarse partition projects down with its cut unchanged
    k = 4
    lc = got.num_levels - 1
    hga_c = got.level_arrays(lc)
    part_c = torch.from_numpy(np.random.default_rng(0).integers(
        0, k, (1, hga_c.n_pad)).astype(np.int32))
    cut_c = float(metrics.cutsize_population(hga_c, part_c, k)[0])
    cur = part_c
    for li in range(lc, 0, -1):
        cur = got.project_pop(cur, li)
    cut_0 = float(metrics.cutsize_population(got.level_arrays(0), cur, k)[0])
    assert cut_c == cut_0
    host = got.level_host(lc)
    assert (host.n, host.m) == (got.level_n(lc), got.levels[lc].m)


def test_coarsen_path_routing(tiny_hg, monkeypatch):
    monkeypatch.delenv("REPRO_COARSEN_PATH", raising=False)
    assert dcoarsen.coarsen_path("cpu") == "host"
    assert dcoarsen.coarsen_path("cuda") == "device"
    for forced, typ in (("host", Hierarchy), ("device", HierarchyArrays)):
        monkeypatch.setenv("REPRO_COARSEN_PATH", forced)
        assert dcoarsen.coarsen_path("cpu") == forced
        hier = dcoarsen.build_hierarchy(port_hg(tiny_hg), 2, seed=0,
                                        contraction_limit_factor=2,
                                        device=CPU)
        assert isinstance(hier, typ)
    monkeypatch.delenv("REPRO_COARSEN_PATH")
    assert isinstance(dcoarsen.build_hierarchy(port_hg(tiny_hg), 2,
                                               path="device", device=CPU),
                      HierarchyArrays)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dcoarsen.build_hierarchy(port_hg(tiny_hg), 2)
