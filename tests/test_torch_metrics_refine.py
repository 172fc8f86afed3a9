"""Port parity of the metrics, the gain assembly and both refinement tiers.

Every comparison is bit for bit: edge and vertex weights are
integer-valued f32, so Phi, cuts, block weights and gains are exact sums
in any order, and the refinement trajectories follow the reference's
tie-breaks (stable argsort, first-maximum argmax, NEG and the slacks).
"""
import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays

import jax
import jax.numpy as jnp

from repro.core import metrics as jmetrics
from repro.core import refine as jrefine
from repro_torch.core import metrics, refine


def _parts(hg, k, alpha, seed, n_pad):
    rng = np.random.default_rng(seed)
    parts = np.zeros((alpha, n_pad), np.int32)
    for a in range(alpha):
        parts[a, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
            0.08)
    return parts


@pytest.mark.parametrize("path", ["segsum", "compact", "table", "stream"])
@pytest.mark.parametrize("k", [2, 8, 40])
def test_gain_matrix_bit_equal(path, k, small_hg, monkeypatch):
    """Population and single gain matrices under every forced path
    (the kernel paths run the reference's Pallas kernels in interpret
    mode and the port's plain versions)."""
    monkeypatch.setenv("REPRO_GAIN_PATH", path)
    hga = small_hg.structural_copy().arrays()
    assert (hga.incident is not None) == (path in ("table", "stream"))
    parts = _parts(small_hg, k, 3, seed=k, n_pad=hga.n_pad)
    want = jmetrics._gain_matrix_population_impl(hga, jnp.asarray(parts), k)
    ph = port_arrays(hga)
    got = metrics._gain_matrix_population_impl(ph, torch.from_numpy(parts), k)
    assert_bit_equal(got, want, f"population gains {path} k={k}")
    want1 = jmetrics.gain_matrix(hga, jnp.asarray(parts[1]), k)
    got1 = metrics.gain_matrix(ph, torch.from_numpy(parts[1]), k)
    assert_bit_equal(got1, want1, f"gains {path} k={k}")


@pytest.mark.parametrize("k", [4, 40])
def test_partition_metrics_bit_equal(k, small_hg):
    hga = small_hg.structural_copy().arrays()
    ph = port_arrays(hga)
    parts = _parts(small_hg, k, 3, seed=k + 1, n_pad=hga.n_pad)
    pt = torch.from_numpy(parts)
    jp = jnp.asarray(parts)
    assert_bit_equal(metrics.pins_in_block_population(ph, pt, k),
                     jax.vmap(lambda p: jmetrics.pins_in_block(hga, p, k))(jp))
    assert_bit_equal(metrics.cutsize_population(ph, pt, k),
                     jmetrics.cutsize_population(hga, jp, k))
    assert_bit_equal(metrics.block_weights_population(ph, pt, k),
                     jmetrics.block_weights_population(hga, jp, k))
    assert_bit_equal(metrics.connectivity(ph, pt[0], k),
                     jmetrics.connectivity(hga, jp[0], k))
    cap = metrics.balance_cap(ph.total_weight, k, 0.03)
    assert_bit_equal(cap, jmetrics.balance_cap(hga.total_weight, k, 0.03))


def test_accept_moves_bit_equal():
    rng = np.random.default_rng(0)
    n, k, alpha = 512, 6, 3
    part = rng.integers(0, k, (alpha, n)).astype(np.int32)
    target = rng.integers(0, k, (alpha, n)).astype(np.int32)
    gain = rng.integers(-3, 6, (alpha, n)).astype(np.float32)  # many ties
    propose = gain > 0
    vw = rng.integers(1, 4, n).astype(np.float32)
    bw = np.stack([np.bincount(p, vw, minlength=k) for p in part]
                  ).astype(np.float32)
    cap = np.float32(1.03 * np.ceil(vw.sum() / k))
    fracs = np.array([1.0, 0.25, 0.0625], np.float32)
    got = refine.accept_moves(*(torch.from_numpy(x) for x in (
        part, target, gain, propose, vw, bw)), torch.tensor(cap),
        torch.from_numpy(fracs), k)
    for a in range(alpha):
        want = jrefine.accept_moves(
            jnp.asarray(part[a]), jnp.asarray(target[a]), jnp.asarray(gain[a]),
            jnp.asarray(propose[a]), jnp.asarray(vw), jnp.asarray(bw[a]),
            jnp.float32(cap), jnp.float32(fracs[a]), k)
        assert_bit_equal(got[a], want, f"member {a}")


@pytest.mark.parametrize("k", [4, 8])
def test_refine_population_bit_equal(k, small_hg):
    """LP + FM on a 3-member population: parts and cuts per member equal
    ``refine_population(..., shard="off")``."""
    hga = small_hg.structural_copy().arrays()
    parts = _parts(small_hg, k, 3, seed=10 + k, n_pad=hga.n_pad)
    want_p, want_c = jrefine.refine_population(hga, parts, k, 0.08,
                                               max_iters=6, shard="off")
    got_p, got_c = refine.refine_population(port_arrays(hga), parts, k, 0.08,
                                            max_iters=6, device="cpu")
    assert_bit_equal(got_c, want_c, "cuts")
    assert_bit_equal(got_p, want_p, "parts")


def test_fm_pass_bit_equal(small_hg):
    """One FM pass of one partition: best prefix and its cut."""
    k = 4
    hga = small_hg.structural_copy().arrays()
    part = _parts(small_hg, k, 1, seed=3, n_pad=hga.n_pad)[0]
    cap = jmetrics.balance_cap(hga.total_weight, k, 0.08)
    want_p, want_c = jrefine._fm_pass(hga, jnp.asarray(part), k, cap, 256)
    ph = port_arrays(hga)
    got_p, got_c = refine._fm_pass_impl(
        ph, torch.from_numpy(part), k,
        metrics.balance_cap(ph.total_weight, k, 0.08), 256)
    assert_bit_equal(got_c, want_c, "best cut")
    assert_bit_equal(got_p, want_p, "best prefix")


def test_rebalance_equal(small_hg):
    rng = np.random.default_rng(3)
    part = np.zeros(small_hg.n, np.int32)
    part[: small_hg.n // 3] = rng.integers(0, 6, small_hg.n // 3)
    assert_bit_equal(refine.rebalance(small_hg.vertex_weights, part, 6, 0.03),
                     jrefine.rebalance(small_hg.vertex_weights, part, 6, 0.03))


@pytest.mark.parametrize("kw", [
    dict(edge_weights_pop=np.ones((1, 8), np.float32)),
    dict(shard="mesh"), dict(model_shard="mesh"),
    dict(incumbent=np.zeros(4, np.int32), mig_budget=1.0)],
    ids=["edge_weights_pop", "shard", "model_shard", "incumbent"])
def test_later_slice_options_raise(kw, tiny_hg):
    hga = port_arrays(tiny_hg.structural_copy().arrays())
    parts = np.zeros((1, hga.n_pad), np.int32)
    with pytest.raises(NotImplementedError, match="later slice"):
        refine.refine_population(hga, parts, 2, 0.1, device=CPU, **kw)
    with pytest.raises(ValueError, match="lives on"):
        refine.refine_population(hga, parts, 2, 0.1, device="meta")
