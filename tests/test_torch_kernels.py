"""Port parity of the kernels' plain versions and of the dispatcher.

On the CPU the port's kernel wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); here those are held against the
reference's Pallas kernels run as the reference's own tests run them
(``interpret=True``).  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances: the gain assemblies are compared bit for bit on
integer-valued tables (every f32 sum is exact in any order).  The rating
sums of non-integer values are compared with rtol=1e-6: the Pallas
kernel sums through a one-hot matmul, the port in index order, so the
last bits may differ.
"""
import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.gain import (gain_gather_batch_pallas,
                                gain_stream_batch_pallas)
from repro.kernels.rating import rating_scatter_pallas
from repro_torch.kernels import gain, ops, rating, ref

# (alpha, N, D, M, k): N off the 256-row block, degree-0 rows, k around
# the warp width
GAIN_SHAPES = [(1, 100, 8, 64, 2), (3, 300, 8, 200, 33),
               (3, 200, 16, 700, 64), (1, 257, 8, 130, 40)]


def _gain_inputs(alpha, n, d, m, k, seed):
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, m, (n, d)).astype(np.int32)
    inc[rng.random((n, d)) < 0.3] = -1
    inc[rng.random(n) < 0.1] = -1                       # degree-0 vertices
    bi = rng.integers(0, 5, (alpha, m, k)).astype(np.float32)
    wi = rng.integers(0, 5, (alpha, m)).astype(np.float32)
    return inc, bi, wi


@pytest.mark.parametrize("shape", GAIN_SHAPES)
def test_gain_gather_batch_ref_matches_pallas(shape):
    inc, bi, wi = _gain_inputs(*shape, seed=sum(shape))
    want = gain_gather_batch_pallas(jnp.asarray(inc), jnp.asarray(bi),
                                    jnp.asarray(wi), interpret=True)
    got = ref.gain_gather_batch_ref(torch.from_numpy(inc),
                                    torch.from_numpy(bi),
                                    torch.from_numpy(wi))
    assert_bit_equal(got, want)


@pytest.mark.parametrize("shape", GAIN_SHAPES)
def test_gain_stream_batch_ref_matches_pallas(shape):
    inc, bi, wi = _gain_inputs(*shape, seed=sum(shape) + 1)
    want = gain_stream_batch_pallas(jnp.asarray(inc), jnp.asarray(bi),
                                    jnp.asarray(wi), interpret=True)
    args = (torch.from_numpy(inc), torch.from_numpy(bi), torch.from_numpy(wi))
    assert_bit_equal(ref.gain_stream_batch_ref(*args), want)
    # a narrow edge tile (many partial sums) gives the same bits
    assert_bit_equal(ref.gain_stream_batch_ref(*args, block_m=32), want)


@pytest.mark.parametrize("c,s", [(512, 512), (3000, 700), (130, 1000),
                                 (4096, 64)])
def test_rating_ref_matches_pallas(c, s):
    rng = np.random.default_rng(c + s)
    segs = np.sort(rng.integers(0, s, c)).astype(np.int32)
    vals = rng.normal(size=c).astype(np.float32)
    nin = min(c // 8, 7)
    segs[:nin] = -1                      # invalid candidates are dropped
    vals[:nin] = 0.0
    want = rating_scatter_pallas(jnp.asarray(vals), jnp.asarray(segs), s,
                                 interpret=True)
    got = ref.rating_segment_sum_ref(torch.from_numpy(vals),
                                     torch.from_numpy(segs), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # integer-valued ratings: exact against the reference's oracle
    ivals = rng.integers(0, 9, c).astype(np.float32)
    want = jref.rating_segment_sum_ref(jnp.asarray(ivals), jnp.asarray(segs),
                                       s)
    got = ref.rating_segment_sum_ref(torch.from_numpy(ivals),
                                     torch.from_numpy(segs), s)
    assert_bit_equal(got, want)


def test_cpu_wrappers_run_plain_versions_without_launching():
    ops.reset_launch_counts()
    inc, bi, wi = (torch.from_numpy(a)
                   for a in _gain_inputs(2, 50, 8, 40, 8, seed=0))
    assert_bit_equal(gain.gain_gather_batch(inc, bi, wi),
                     ref.gain_gather_batch_ref(inc, bi, wi))
    assert_bit_equal(gain.gain_stream_batch(inc, bi, wi),
                     ref.gain_stream_batch_ref(inc, bi, wi))
    segs = torch.tensor([-1, 0, 0, 2, 2, 2], dtype=torch.int32)
    vals = torch.arange(6, dtype=torch.float32)
    assert rating.rating_segment_sum(vals, segs, 4).tolist() == \
        [3.0, 0.0, 12.0, 0.0]
    assert ops.launch_counts() == {"gain_table": 0, "gain_stream": 0,
                                   "rating_segment_sum": 0}


@pytest.mark.parametrize("forced", ["table", "stream", "segsum", "compact",
                                    "auto"])
def test_gain_routing(forced, monkeypatch):
    monkeypatch.setenv("REPRO_GAIN_PATH", forced)
    inc_cpu = torch.zeros((4, 8), dtype=torch.int32)
    for k in (2, 32, 33, 1024):
        auto_cpu = "segsum" if k <= 32 else "compact"
        if forced == "auto":
            assert ops.gain_path(1024, k, None) == auto_cpu
            assert ops.gain_path(1024, k, inc_cpu) == auto_cpu
        elif forced in ("segsum", "compact"):
            assert ops.gain_path(1024, k, inc_cpu) == forced
        else:
            # kernel paths need the layout; without it the XLA-style
            # paths take over
            assert ops.gain_path(1024, k, inc_cpu) == forced
            assert ops.gain_path(1024, k, None) == auto_cpu
    assert ops.gain_layout_enabled("cpu") == (forced in ("table", "stream"))
    assert ops.gain_layout_enabled("cuda") == (forced not in ("segsum",
                                                              "compact"))
    with pytest.raises(ValueError):
        ops.gain_assemble_batch(inc_cpu, torch.zeros(1, 1, 2),
                                torch.zeros(1, 1), "segsum")


def test_gain_routing_on_cuda_layout(monkeypatch):
    """Auto routing on a CUDA-resident layout is decided from the layout's
    device and k alone (a stand-in object plays the card's tensor)."""
    monkeypatch.delenv("REPRO_GAIN_PATH", raising=False)

    class FakeCuda:
        is_cuda = True
    assert ops.gain_path(1 << 20, 16, FakeCuda()) == "table"
    assert ops.gain_path(1 << 20, 32, FakeCuda()) == "table"
    assert ops.gain_path(1 << 20, 33, FakeCuda()) == "stream"
    assert ops.gain_path(1 << 20, 1024, FakeCuda()) == "stream"


def test_rating_routing(monkeypatch):
    segs = torch.tensor([0, 0, 1], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 4.0])
    for forced in ops.RATING_PATHS:
        monkeypatch.setenv("REPRO_RATING_PATH", forced)
        assert ops.rating_path(10 ** 7) == forced
        assert ops.rating_segment_sum(vals, segs, 2).tolist() == [3.0, 4.0]
    monkeypatch.setenv("REPRO_RATING_PATH", "bogus")
    with pytest.warns(UserWarning, match="REPRO_RATING_PATH"):
        assert ops.rating_path(10) == "kernel"
    monkeypatch.delenv("REPRO_RATING_PATH")
    # linear kernel: no size cut-off
    assert ops.rating_path(10 ** 9) == "kernel"
