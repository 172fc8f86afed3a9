"""The port's CUDA kernels on the card, held against their plain versions.

This module imports neither ``jax`` nor ``repro``: the machine with the
card has no JAX, so the tests marked ``cuda`` run there without the
suite's ``conftest.py`` (which imports the reference):

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_card.py

``python3 chip_smoke.py --phases=cardtests`` runs that command and fails
on any failure, error or skip.  Without a card or ``nvcc`` the ``cuda``
tests skip; the import guard at the end runs everywhere.

Tolerances: connectivity is integer arithmetic and compared bit for
bit; the cut of integer weights exactly (every f32 sum below 2**24 is
exact in any order), of real weights with rel 1e-5 (the reference's own
bar) and bit-equal over two launches; the embedding bag with 1e-5 in
f32 and 2e-2 in bf16 (the kernel sums in f32 and rounds once); the
rating sums rtol 1e-6 of the plain version (another order of addition),
exact on integers; the gain kernels exactly (integer tables).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal
from repro_torch.kernels import (build, connectivity, embedding_bag, gain,
                                 rating, ref)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    """The CUDA device, or a skip that says what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    try:
        build.nvcc()
    except RuntimeError as err:
        pytest.skip(str(err))
    return torch.device("cuda")


def _pins_part(m, s, n, k, seed):
    rng = np.random.default_rng(seed)
    pins = rng.integers(-1, n, size=(m, s)).astype(np.int32)
    part = rng.integers(0, k, size=n).astype(np.int32)
    return rng, pins, part


def _gain_inputs(alpha, n, d, m, k, seed, trailing=False):
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, m, (n, d)).astype(np.int32)
    inc[rng.random((n, d)) < 0.3] = -1
    inc[rng.random(n) < 0.1] = -1                       # degree-0 vertices
    if trailing:                  # valid ids first, as the layout builder
        inc = -np.sort(-inc, axis=1)
    bi = rng.integers(0, 5, (alpha, m, k)).astype(np.float32)
    wi = rng.integers(0, 5, (alpha, m)).astype(np.float32)
    return inc, bi, wi


# --------------------------------------------------------------------------
# connectivity and cut size (#7, #8)
# --------------------------------------------------------------------------
def _assert_cut_kernels(pins, part, k, rng):
    """#7 bit-equal to its plain version; #8 equal on integer weights,
    rel 1e-5 and bit-stable over two launches on real weights."""
    m, dev = pins.shape[0], pins.device
    assert_bit_equal(connectivity.connectivity(pins, part, k),
                     ref.connectivity_ref(pins, part, k))
    iw = torch.from_numpy(rng.integers(0, 9, m).astype(np.float32)).to(dev)
    assert torch.equal(connectivity.cutsize(pins, part, iw, k),
                       ref.cutsize_ref(pins, part, iw, k))
    w = torch.from_numpy((rng.random(m) + 0.5).astype(np.float32)).to(dev)
    got = connectivity.cutsize(pins, part, w, k)
    assert torch.equal(got, connectivity.cutsize(pins, part, w, k))
    assert float(got) == pytest.approx(
        float(ref.cutsize_ref(pins, part, w, k)), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,n,k", [(130, 8, 300, 5), (50_000, 64, 51_000,
                                                        32)])
def test_connectivity_kernels_on_card(card, m, s, n, k):
    rng, pins, part = _pins_part(m, s, n, k, seed=m)
    pins_t, part_t = (torch.from_numpy(x).to(card) for x in (pins, part))
    _assert_cut_kernels(pins_t, part_t, k, rng)


# (M, S, N, k, layout): S = 1, 5 and 12 (one id a lane where S is not a
# multiple of 4; 12 on the 16-byte path with a lane of four idle) and S =
# 8, 64, 128 and 256 (16-byte loads, 256 in two rounds of a 32-lane
# group); M = 1, and M off the group, block and one-wave sizes (33,799 is
# one ibm08-shaped step of the whole grid plus 7 rows); pins as the
# layout builder leaves them ("trailing": valid ids first), pads
# anywhere ("mid"), rows all pad, ids >= N, and block ids outside [0, k)
# ("bad blocks") at k = 1 and 32
CUT_CASES = [
    (1, 1, 10, 2, "mid"), (1001, 1, 500, 3, "mid"), (3001, 5, 2000, 7, "mid"),
    (2049, 12, 1000, 32, "mid"), (1, 64, 10, 4, "trailing"),
    (4097, 8, 3000, 16, "trailing"), (33_799, 64, 40_000, 32, "trailing"),
    (777, 128, 5000, 32, "mid"), (515, 256, 5000, 32, "trailing"),
    (2000, 64, 800, 1, "bad blocks"), (2000, 8, 800, 32, "bad blocks")]


def _cut_case(m, s, n, k, layout, seed):
    rng = np.random.default_rng(seed)
    pins = rng.integers(0, n + n // 10 + 1, (m, s)).astype(np.int32)  # >= N
    pins[rng.random((m, s)) < 0.4] = -1
    pins[rng.random(m) < 0.1] = -1                         # rows all pad
    if layout == "trailing":
        pins = -np.sort(-pins, axis=1)
    lo, hi = (-3, k + 3) if layout == "bad blocks" else (0, k)
    part = rng.integers(lo, hi, n).astype(np.int32)
    return rng, pins, part


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,n,k,layout", CUT_CASES)
def test_cut_kernels_odd_shapes_on_card(card, m, s, n, k, layout):
    rng, pins, part = _cut_case(m, s, n, k, layout, seed=m + s)
    pins_t, part_t = (torch.from_numpy(x).to(card) for x in (pins, part))
    _assert_cut_kernels(pins_t, part_t, k, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [8, 12, 64])
def test_cut_kernels_off_alignment_on_card(card, s):
    """A ``pins`` view 4 bytes into its storage is contiguous but off the
    16-byte alignment: it takes the one-id path and stays exact, and the
    cut replays bit for bit in a CUDA graph."""
    rng, pins, part = _cut_case(3001, s, 2000, 32, "trailing", seed=s)
    flat = torch.from_numpy(np.concatenate([[-1], pins.ravel()]).astype(
        np.int32)).to(card)
    view = flat[1:].view(pins.shape)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    part_t = torch.from_numpy(part).to(card)
    _assert_cut_kernels(view, part_t, 32, rng)
    w = torch.from_numpy(rng.random(3001).astype(np.float32)).to(card)
    eager = connectivity.cutsize(view, part_t, w, 32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        connectivity.cutsize(view, part_t, w, 32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = connectivity.cutsize(view, part_t, w, 32)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


# --------------------------------------------------------------------------
# embedding bag (#9)
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,combiner", [("float32", "sum"),
                                            ("float32", "mean"),
                                            ("bfloat16", "sum")])
def test_embedding_bag_kernel_on_card(card, dtype, combiner):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(1000, 128)).astype(
        np.float32)).to(card, getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(-1, 1000, (333, 26)).astype(
        np.int32)).to(card)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        embedding_bag.embedding_bag(table, idx, combiner).float(),
        ref.embedding_bag_ref(table, idx, combiner).float(),
        rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# the rating (#3, #4) and gain (#1, #2, #5, #6) kernels
# --------------------------------------------------------------------------
def _rating_card_case(label):
    """(segs, vals, S, exact) of the rating kernels' odd shapes: every
    segment of length 1, a run longer than a tile (integer values, so
    any order is exact), every id dropped, C = 1 and off the warp width,
    and the FM step's 119 rows."""
    rng = np.random.default_rng(len(label))

    def real(alpha, c):
        return (rng.random((alpha, c)) + 0.1).astype(np.float32)

    if label == "length 1":
        return np.arange(3001, dtype=np.int32), real(3, 3001), 3001, False
    if label == "long run":
        segs = np.concatenate([np.sort(rng.integers(0, 40, 900)),
                               np.full(40_000, 40),
                               np.sort(rng.integers(41, 90, 1001))])
        return (segs.astype(np.int32),
                rng.integers(0, 4, (2, segs.size)).astype(np.float32), 90,
                True)
    if label == "ids below 0":
        return np.full(777, -1, np.int32), real(2, 777), 500, False
    if label == "ids >= S":
        return np.full(777, 900, np.int32), real(2, 777), 500, False
    if label == "C = 1":
        return np.full(1, 3, np.int32), real(3, 1), 10, False
    if label == "C = 1001":
        segs = np.sort(rng.integers(-5, 950, 1001)).astype(np.int32)
        return segs, real(4, 1001), 900, False
    segs = np.sort(rng.integers(0, 1024, 4097)).astype(np.int32)
    return segs, real(119, 4097), 1024, False


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["length 1", "long run", "ids below 0",
                                   "ids >= S", "C = 1", "C = 1001",
                                   "alpha 119"])
def test_rating_kernels_on_card(card, label):
    """#4 and #3 at odd shapes: rtol 1e-6 of the plain version (equal on
    integers), batch rows bit-equal to the scalar entry, reruns
    bit-equal."""
    segs, vals, s, exact = _rating_card_case(label)
    segs_t, vals_t = torch.from_numpy(segs).to(card), \
        torch.from_numpy(vals).to(card)
    got = rating.rating_segment_sum_batch(vals_t, segs_t, s)
    assert torch.equal(got, rating.rating_segment_sum_batch(vals_t, segs_t,
                                                            s))
    assert torch.equal(got, torch.stack([
        rating.rating_segment_sum(row, segs_t, s) for row in vals_t]))
    want = ref.rating_segment_sum_batch_ref(vals_t, segs_t, s)
    if exact:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,trailing", [
    ((3, 1001, 8, 700, 1), False), ((2, 999, 24, 513, 3), False),
    ((1, 777, 1, 300, 8), False), ((2, 601, 1, 400, 16), True),
    ((3, 1003, 16, 900, 16), True), ((2, 517, 24, 700, 31), False),
    ((3, 1000, 8, 700, 32), True), ((1, 300, 24, 513, 1024), False)])
def test_gain_table_kernel_on_card(card, shape, trailing):
    """#1 and #5 (entry ``table``): equal to the plain versions and to a
    rerun at k from 1 to 32 (and 1024, which ``REPRO_GAIN_PATH=table``
    may send there), D = 1, 8 and 24, N off every group and block size,
    trailing pads as the layout builder leaves them, pads mid-row and
    degree-0 rows."""
    inc, bi, wi = (torch.from_numpy(a).to(card) for a in _gain_inputs(
        *shape, seed=sum(shape), trailing=trailing))
    got = gain.gain_gather_batch(inc, bi, wi)
    assert torch.equal(got, ref.gain_gather_batch_ref(inc, bi, wi))
    assert torch.equal(got, gain.gain_gather_batch(inc, bi, wi))
    # the last member's tables, off the 16-byte alignment when M*k is odd
    one = gain.gain_gather(inc, bi[-1].contiguous(), wi[-1].contiguous())
    assert torch.equal(one, ref.gain_gather_ref(inc, bi[-1], wi[-1]))
    assert torch.equal(one, gain.gain_gather(inc, bi[-1].contiguous(),
                                             wi[-1].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,trailing", [
    ((3, 500, 1, 300, 64), False), ((3, 777, 16, 1500, 64), True),
    ((3, 300, 8, 200, 33), False), ((2, 600, 16, 900, 100), False),
    ((1, 300, 24, 513, 1024), False)])
def test_gain_stream_kernel_on_card(card, shape, trailing):
    """#2 and #6 (entry ``stream``): equal to the plain versions and to a
    rerun, with D = 1, trailing pads as the layout builder leaves them,
    pads mid-row, degree-0 rows and k from 33 to 1024."""
    inc, bi, wi = (torch.from_numpy(a).to(card) for a in _gain_inputs(
        *shape, seed=sum(shape), trailing=trailing))
    got = gain.gain_stream_batch(inc, bi, wi)
    assert torch.equal(got, ref.gain_stream_batch_ref(inc, bi, wi))
    assert torch.equal(got, gain.gain_stream_batch(inc, bi, wi))
    one = gain.gain_stream(inc, bi[-1].contiguous(), wi[-1].contiguous())
    assert torch.equal(one, ref.gain_stream_ref(inc, bi[-1], wi[-1]))


# --------------------------------------------------------------------------
# the import guard (runs everywhere)
# --------------------------------------------------------------------------
def _imported_modules(path: Path):
    """Absolute module names imported anywhere in the source at ``path``
    (relative imports stay inside their package and are left out)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_card_side_code_imports_neither_jax_nor_reference():
    """The port, ``chip_smoke.py`` and this module run on a machine
    without JAX: none of them may import ``jax`` or the reference package
    ``repro`` (or a submodule of either)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    files += [ROOT / "chip_smoke.py", Path(__file__)]
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_modules(f)
           if name.split(".")[0] in ("jax", "repro")]
    assert bad == []
