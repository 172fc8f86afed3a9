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
f32 and 2e-2 in bf16 (the kernel sums in f32 and rounds once), and bit
for bit to a sequential f32 sum in bag order; the
rating sums rtol 1e-6 of the plain version (another order of addition),
exact on integers; the gain kernels exactly (integer tables).  The
stacked refinement of the instance axis (``core.instances``) is held bit
for bit too: its gains are integer-valued sums.  So is bounded migration
(DESIGN.md §14) on integer weights; on drifted, real-valued weights two
runs on the card must give the same bits (their sums take fixed-order
paths), and an integer-weighted level must take none of those paths.
A drifted refresh stacked with other requests, or split over logical
shards of the card (the population axis, DESIGN.md §11), is held to
its solo run bit for bit, and so are the LP and FM routes over 4
shards to the single-device route; the model axis over a (2, 2) grid of
logical shards (LP and FM on integer-valued member rows, the sharded
contraction) is bit-equal to the replicated route.
The partition service on the card is held to its solo runs bit for bit,
through a device loss too, and checkpoints round-trip CUDA tensors
exactly.  The LM's SMOKE models (f32, TF32 off) are held to their CPU
runs with rtol and atol 1e-5 (f32 sums over widths of 64 to 256 in
another order on the card), and the MoE's routing masks bit for bit.
Training: the flash backward is held to autograd of the plain
attention in f64 and to the CPU with rtol 1e-5, atol 1e-5; AdamW's
moments (int8 ones included) bit for bit to the CPU under the clip, its
parameters rtol 1e-6; the DLRM sparse step gives the same bits twice
(its duplicate-row sums go through #4).
"""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import incremental, instances, metrics, popshard, refine
from repro_torch.core.dcoarsen import build_hierarchy, population_coarsen
from repro_torch.core.hypergraph import HypergraphArrays, contract_arrays
from repro_torch.core.vcycle import vcycle, vcycle_instances
from repro_torch.data.hypergraphs import (_modular_netlist, drift_stream,
                                          random_hypergraph)
from repro_torch.kernels import (build, connectivity, embedding_bag, gain,
                                 ops, rating, ref)
from repro_torch.runtime.elastic import restore_device_pool
from repro_torch.serve import FaultPlan, PartitionRequest, PartitionService

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


# (rows, D, bags, L, dtype, combiner, offset of the table in its buffer
# in elements): D off the 16-byte pieces and an unaligned table take the
# one-value path; D 64 gives a bag half a warp, D 256 two passes of a
# warp; L 1 and L 100 (longer than a warp's ids) bound the id loop
EB_CASES = {
    "d30": (500, 30, 257, 26, "float32", "sum", 0),
    "unaligned": (500, 32, 129, 26, "float32", "sum", 1),
    "bf16_d36": (400, 36, 100, 7, "bfloat16", "sum", 0),
    "l1": (1000, 128, 333, 1, "float32", "sum", 0),
    "l100": (1000, 128, 97, 100, "float32", "sum", 0),
    "d64": (700, 64, 301, 26, "float32", "sum", 0),
    "d256": (300, 256, 65, 13, "float32", "mean", 0),
    "bf16_mean": (1000, 128, 333, 26, "bfloat16", "mean", 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EB_CASES))
def test_embedding_bag_kernel_bag_order_on_card(card, case):
    """Every 5th bag all pads, ids up to R + 4 (read as row R - 1): the
    kernel equals, bit for bit, an f32 sum in bag order (``mean`` then
    divides by L) rounded once to the table's dtype; it is allclose to
    the plain version and gives the same bits on two launches."""
    r, d, b, l, dtype, combiner, offset = EB_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    buf = torch.from_numpy(rng.normal(size=r * d + offset).astype(
        np.float32)).to(card, getattr(torch, dtype))
    table = buf[offset:].view(r, d)
    idx = rng.integers(-1, r + 5, (b, l)).astype(np.int32)
    idx[::5] = -1
    idx = torch.from_numpy(idx).to(card)
    got = embedding_bag.embedding_bag(table, idx, combiner)
    again = embedding_bag.embedding_bag(table, idx, combiner)
    acc = torch.zeros((b, d), dtype=torch.float32, device=card)
    for j in range(l):
        ids = idx[:, j]
        rows = table[ids.clamp(0, r - 1).long()].float()
        acc = torch.where((ids >= 0)[:, None], acc + rows, acc)
    if combiner == "mean":
        # a correctly rounded division, as the kernel's (torch divides by
        # a Python number through its reciprocal on the card)
        acc = acc / torch.full_like(acc, l)
    assert torch.equal(got, acc.to(table.dtype))
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        got.float(), ref.embedding_bag_ref(table, idx, combiner).float(),
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
# the instance axis: stacked refinement on the card
# --------------------------------------------------------------------------
def _netlist(n, m, seed):
    return _modular_netlist(n, m, seed=seed, n_modules=max(n // 64, 4),
                            p_local=0.8, fanout_tail=1.5)


def _pad_only_level(n_pad, m_pad, p_pad, dev):
    """A level with no vertex, edge or pin, only padding (its incidence
    rows all pads)."""
    return HypergraphArrays(
        pin_vertex=torch.full((p_pad,), n_pad - 1, dtype=torch.int32,
                              device=dev),
        pin_edge=torch.full((p_pad,), m_pad - 1, dtype=torch.int32,
                            device=dev),
        vertex_weights=torch.zeros(n_pad, device=dev),
        edge_weights=torch.zeros(m_pad, device=dev),
        edge_sizes=torch.zeros(m_pad, dtype=torch.int32, device=dev),
        n=0, m=0,
        incident=torch.full((n_pad, 8), -1, dtype=torch.int32, device=dev))


def _random_parts(hgas, ks, alpha, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, k, (alpha, h.n_pad)).astype(np.int32)
            for h, k in zip(hgas, ks)]


@pytest.mark.cuda
def test_stacked_lp_gains_through_gain_kernel_on_card(card):
    """One LP round's gains of a stack (k 5, 12 and 3 under k_pad 16, a
    modular netlist and a random hypergraph whose layouts differ in D, and
    a pad-only instance) come from ONE launch of the ``table`` kernel on
    the union's layout, bit-equal to the segsum assembly and, row by row,
    to each level's own gains; the masked LP round agrees too."""
    hgas = [_netlist(300, 400, 3).arrays(device=card),
            random_hypergraph(200, 500, seed=4).arrays(device=card)]
    hgas.append(_pad_only_level(256, 256, 256, card))
    assert hgas[0].incident.shape[1] != hgas[1].incident.shape[1]
    ks = [5, 12, 3]
    batch = instances.stack_instances(hgas, ks, [0.08, 0.1, 0.1])
    assert batch.k_pad == 16 and batch.hga.incident is not None
    alpha, k = 2, batch.k_pad
    parts = instances.stack_parts(_random_parts(hgas, ks, alpha, 5),
                                  batch.n_pad, card)
    rows_geo = batch.rows(alpha)
    rows = instances._to_rows(batch, parts)
    union = batch.union()
    assert ops.gain_path(union.m_pad, k, union.incident) == "table"
    before = ops.launch_counts()["gain_table"]
    got = rows_geo.gains(rows, k)
    assert ops.launch_counts()["gain_table"] == before + 1
    assert torch.equal(got, rows_geo.gains(rows, k, assemble="segsum"))
    per_instance = got.reshape(alpha, len(hgas), batch.n_pad, k)
    for i, h in enumerate(hgas[:2]):
        own = metrics._gain_matrix_population_impl(
            h, parts[i][:, : h.n_pad].contiguous(), k, assemble="segsum")
        assert torch.equal(per_instance[:, i, : h.n], own[:, : h.n]), i
    assert not per_instance[:, 2].any()
    fracs = torch.ones(rows.shape[0], device=card)
    moved = [refine._lp_round_from_gains(rows_geo, rows, k, rows_geo.cap,
                                         fracs, g, k_live=rows_geo.k_live)
             for g in (got, rows_geo.gains(rows, k, assemble="segsum"))]
    assert torch.equal(*moved)
    # blocks a row's instance does not have are never targets
    assert bool((moved[0].long()
                 < rows_geo.k_live[:, None].long()).logical_or(
                     moved[0] == rows).all())


@pytest.mark.cuda
def test_stacked_fm_pass_in_cuda_graph_equals_eager_on_card(card):
    """A stacked FM pass with mixed step budgets (256 and 512), k_live
    below k_pad and one frozen row, replayed as CUDA graphs on the card,
    bit-equal to the same steps run eagerly (on the CPU)."""
    hgs = [_netlist(200, 260, 7), _netlist(300, 390, 8)]
    out = []
    for dev in (card, torch.device("cpu")):
        hgas = [hg.arrays(device=dev) for hg in hgs]
        batch = instances.stack_instances(hgas, [3, 6], [0.08, 0.12])
        parts = instances.stack_parts(_random_parts(hgas, [3, 6], 2, 9),
                                      batch.n_pad, dev)
        geo = batch.rows(2)
        live = torch.tensor([True, True, False, True], device=dev)
        out.append(refine._fm_pass_population_impl(
            geo, instances._to_rows(batch, parts), batch.k_pad, geo.cap,
            geo.fm_steps, k_live=geo.k_live, live=live))
    assert batch.fm_steps.tolist() == [256, 512]
    for got, want in zip(*out):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_refine_grouped_matches_solo_on_card(card):
    """The reference's parity specs (k 3, 8 and 5 under ``grid=(1024,)``):
    each entry's grouped refinement bit-equal to its solo
    ``refine_population`` on the card, the stack's LP on the ``table``
    kernel."""
    specs = [(280, 380, 1, 3, 0.08), (400, 520, 2, 8, 0.10),
             (330, 430, 3, 5, 0.12)]
    entries, solos = [], []
    for i, (n, m, seed, k, eps) in enumerate(specs):
        hg = _netlist(n, m, seed)
        hga = hg.arrays(device=card)
        rng = np.random.default_rng(10 + i)
        parts = np.stack([refine.rebalance(
            hg.vertex_weights, rng.integers(0, k, n).astype(np.int32), k,
            eps) for _ in range(3)])
        parts = refine.pad_parts(parts, hga.n_pad, card)
        entries.append((hga, parts, k, eps))
        solos.append(refine.refine_population(hga, parts.clone(), k, eps,
                                              max_iters=4, device=card))
    ops.reset_launch_counts()
    outs = instances.refine_grouped(entries, grid=(1024,), max_iters=4,
                                    device=card)
    assert ops.launch_counts()["gain_table"] > 0
    for i, ((gp, gc), (sp, sc)) in enumerate(zip(outs, solos)):
        assert torch.equal(gp, sp), f"instance {i}"
        assert np.array_equal(gc, sc), f"instance {i}"


@pytest.mark.cuda
def test_vcycle_instances_matches_solo_on_card(card):
    """``vcycle_instances`` on the card: the parity specs' three requests
    (k 3, 8 and 5 under ``grid=(1024,)``), each bit-equal in partition
    and cut to ``vcycle`` on that request alone on the card."""
    specs = [(280, 380, 1, 3, 0.08), (400, 520, 2, 8, 0.10),
             (330, 430, 3, 5, 0.12)]
    hgs, parts = [], []
    for i, (n, m, seed, k, eps) in enumerate(specs):
        hg = _netlist(n, m, seed)
        rng = np.random.default_rng(20 + i)
        hgs.append(hg)
        parts.append(refine.rebalance(
            hg.vertex_weights, rng.integers(0, k, n).astype(np.int32), k,
            eps))
    ks, epss = [s[3] for s in specs], [s[4] for s in specs]
    ops.reset_launch_counts()
    got = vcycle_instances(hgs, parts, ks, epss, seeds=[3, 3, 3],
                           grid=(1024,), device=card)
    assert ops.launch_counts()["gain_table"] > 0
    for i, (hg, part, k, eps) in enumerate(zip(hgs, parts, ks, epss)):
        solo_part, solo_cut = vcycle(hg, part, k, eps, seed=3, device=card)
        assert np.array_equal(got[i][0], solo_part), f"request {i}"
        assert got[i][1] == solo_cut, f"request {i}"


# --------------------------------------------------------------------------
# bounded migration and drifted weights on the card (DESIGN.md §14)
# --------------------------------------------------------------------------
MIG_K, MIG_EPS = 8, 0.08


def _migration_case(seed=11):
    """A netlist of n 500, a balanced random incumbent, a 5% budget and
    three members that start within half of it."""
    hg = _netlist(500, 700, seed)
    rng = np.random.default_rng(seed)
    inc = refine.rebalance(hg.vertex_weights,
                           rng.integers(0, MIG_K, hg.n).astype(np.int32),
                           MIG_K, MIG_EPS).astype(np.int32)
    budget = 0.05 * float(hg.vertex_weights.sum())
    parts = []
    for _ in range(3):
        p = inc.copy()
        idx = rng.choice(hg.n, 6, replace=False)
        p[idx] = rng.integers(0, MIG_K, 6)
        parts.append(p)
    return hg, inc, budget, np.stack(parts)


def _count_captures(monkeypatch) -> list:
    """Count the FM CUDA-graph captures (``refine._capture_fm_steps``)."""
    seen = []
    real = refine._capture_fm_steps

    def counted(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(refine, "_capture_fm_steps", counted)
    return seen


@pytest.mark.cuda
def test_budgeted_refinement_equals_cpu_on_card(card, monkeypatch):
    """Budgeted LP + FM on integer weights: the card (LP on the ``table``
    kernel, FM replayed as CUDA graphs) equals the CPU bit for bit, and
    every member stays within budget."""
    hg, inc, budget, parts = _migration_case()
    captures = _count_captures(monkeypatch)
    out = {}
    for dev in (card, torch.device("cpu")):
        out[dev.type] = refine.refine_population(
            hg.arrays(device=dev), parts.copy(), MIG_K, MIG_EPS,
            incumbent=inc, mig_budget=budget, device=dev)
    assert captures, "the FM tier ran no CUDA graph"
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    moved = [float(hg.vertex_weights[p[: hg.n] != inc].sum())
             for p in out["cuda"][0].cpu().numpy()]
    assert max(moved) <= budget + 1e-4


@pytest.mark.cuda
def test_drifted_level_gives_the_same_bits_twice_on_card(card):
    """A level whose edge and vertex weights drifted (real-valued): its
    contraction, its LP gains without a layout (segsum, compact), its
    block weights and a budgeted refinement with graphed FM give the
    same bits in two runs on the card, through the rating kernels."""
    hg, inc, budget, parts = _migration_case(12)
    drifted = drift_stream(hg, 1, magnitude=0.3, vertex_magnitude=0.2,
                           tag="card")[0]
    lv = drifted.arrays(device=card)
    assert lv.real_edge_weights and lv.real_vertex_weights
    ar = torch.arange(lv.n_pad, device=card)
    cid = torch.where(ar < lv.n, ar // 2, lv.n_pad - 1)
    parts_t = refine.pad_parts(parts, lv.n_pad, card)
    plain = HypergraphArrays(**{**lv.__dict__, "incident": None})

    def run():
        coarse, _ = contract_arrays(lv, cid, (lv.n - 1) // 2 + 1)
        return (coarse.edge_weights, coarse.vertex_weights,
                metrics._gain_matrix_population_impl(plain, parts_t, MIG_K,
                                                     assemble="segsum"),
                metrics._gain_matrix_population_impl(plain, parts_t, 40,
                                                     assemble="compact"),
                metrics.block_weights_population(lv, parts_t, MIG_K),
                *refine.refine_population(lv, parts.copy(), MIG_K, MIG_EPS,
                                          incumbent=inc, mig_budget=budget,
                                          device=card))
    ops.reset_launch_counts()
    first = run()
    counts = ops.launch_counts()
    assert counts["rating_segment_sum"] and counts["rating_segment_sum_batch"]
    for a, b in zip(first, run()):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert np.array_equal(a, b)


@pytest.mark.cuda
def test_integer_level_keeps_its_sum_paths_on_card(card):
    """An integer-weighted level carries no real-weight flag, and its
    budgeted refinement and contraction launch neither rating kernel:
    the sums it took before drifted weights had their own paths."""
    hg, inc, budget, parts = _migration_case(13)
    lv = hg.arrays(device=card)
    assert not (lv.real_edge_weights or lv.real_vertex_weights)
    ops.reset_launch_counts()
    refine.refine_population(lv, parts, MIG_K, MIG_EPS, incumbent=inc,
                             mig_budget=budget, device=card)
    ar = torch.arange(lv.n_pad, device=card)
    coarse, _ = contract_arrays(
        lv, torch.where(ar < lv.n, ar // 2, lv.n_pad - 1),
        (lv.n - 1) // 2 + 1)
    assert not coarse.real_edge_weights
    counts = ops.launch_counts()
    assert counts["rating_segment_sum"] == 0
    assert counts["rating_segment_sum_batch"] == 0
    assert counts["gain_table"] > 0


@pytest.mark.cuda
def test_refine_grouped_incumbent_entries_match_solo_on_card(card):
    """A stack of two incumbent entries (6-tuples) and a cold one
    (4-tuple): each equal to its solo ``refine_population`` on the card,
    within its budget."""
    entries, solos = [], []
    for i, seed in enumerate((21, 22, 23)):
        hg, inc, budget, parts = _migration_case(seed)
        hga = hg.arrays(device=card)
        parts = refine.pad_parts(parts, hga.n_pad, card)
        kw = dict(incumbent=inc, mig_budget=budget) if i < 2 else {}
        entries.append((hga, parts, MIG_K, MIG_EPS, *kw.values()))
        solos.append((refine.refine_population(
            hga, parts.clone(), MIG_K, MIG_EPS, max_iters=4, device=card,
            **kw), inc, budget, hg))
    outs = instances.refine_grouped(entries, max_iters=4, device=card)
    for i, ((gp, gc), ((sp, sc), inc, budget, hg)) in enumerate(
            zip(outs, solos)):
        assert torch.equal(gp, sp), f"entry {i}"
        assert np.array_equal(gc, sc), f"entry {i}"
        if i < 2:
            moved = [float(hg.vertex_weights[p[: hg.n] != inc].sum())
                     for p in gp.cpu().numpy()]
            assert max(moved) <= budget + 1e-4


@pytest.mark.cuda
def test_replayed_drift_is_bit_stable_on_card(card, monkeypatch):
    """Two ``IncrementalState``s on the device engine fed one drifted
    stream with the same incumbents: every step is replayed, and both
    give the same parts and cuts."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "device")
    hg, inc, _, _ = _migration_case(14)
    cfg = incremental.IncrementalConfig(
        k=MIG_K, eps=MIG_EPS, alpha=3, lp_iters=4, migration_frac=0.15,
        contraction_limit_factor=16)
    stream = drift_stream(hg, 2, magnitude=0.15, tag="card-incr")
    runs = []
    for _ in range(2):
        st = incremental.IncrementalState()
        assert incremental.incremental_partition(
            hg, inc, cfg, state=st, device=card).reused == "cold"
        prev, out = inc, []
        for step in stream:
            res = incremental.incremental_partition(step, prev, cfg,
                                                    state=st, device=card)
            assert res.reused == "replayed"
            assert res.migration_weight <= res.budget_weight + 1e-4
            out.append(res)
            prev = runs[0][len(out) - 1].part if runs else res.part
        runs.append(out)
    for a, b in zip(*runs):
        assert np.array_equal(a.part, b.part) and a.cut == b.cut


# --------------------------------------------------------------------------
# F5 and the population axis over a pool of logical shards of the card
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _f5_case(card):
    """A drifted level (real-valued edge and vertex weights) of n 300
    as a budgeted refresh entry, its solo run, and two cold entries of
    its shape bucket."""
    base = _netlist(300, 400, 31)
    drifted = drift_stream(base, 1, magnitude=0.15, vertex_magnitude=0.1,
                           tag="card-f5")[0]
    lv = drifted.arrays(device=card)
    assert lv.real_edge_weights and lv.real_vertex_weights
    rng = np.random.default_rng(31)
    inc = refine.rebalance(base.vertex_weights,
                           rng.integers(0, MIG_K, base.n).astype(np.int32),
                           MIG_K, MIG_EPS).astype(np.int32)
    parts = np.stack([refine.rebalance(
        base.vertex_weights, rng.integers(0, MIG_K, base.n).astype(np.int32),
        MIG_K, MIG_EPS) for _ in range(3)]).astype(np.int32)
    budget = 0.15 * float(drifted.vertex_weights.sum())
    entry = (lv, parts, MIG_K, MIG_EPS, inc, budget)
    solo = refine.refine_population(lv, parts, MIG_K, MIG_EPS, max_iters=6,
                                    incumbent=inc, mig_budget=budget,
                                    device=card)
    cold = base.arrays(device=card)
    others = [(cold, parts[::-1].copy(), MIG_K, MIG_EPS),
              (cold, parts, MIG_K, MIG_EPS)]
    return entry, solo, others


@pytest.mark.cuda
@pytest.mark.parametrize("stacked,p", [(1, 1), (1, 2), (1, 4), (3, 1),
                                       (3, 2), (3, 4)])
def test_drifted_refresh_keeps_its_bits_stacked_and_sharded_on_card(
        card, stacked, p):
    """F5's gate at small size: the drifted refresh alone or stacked with
    two cold requests of its bucket, its rows or the stack split over p
    logical shards of the card, gives its solo parts and cut bit for
    bit."""
    entry, solo, others = _f5_case(card)
    popshard.set_logical_shards(p, card)
    try:
        got = instances.refine_grouped([entry] + others[: stacked - 1],
                                       max_iters=6, shard="mesh",
                                       device=card)[0]
    finally:
        popshard.set_logical_shards(None)
    assert torch.equal(got[0], solo[0])
    assert np.array_equal(got[1], solo[1])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mesh", "chunk"])
@pytest.mark.parametrize("tier", ["lp", "fm"])
def test_population_routes_over_four_shards_on_card(card, route, tier):
    """LP (integer weights, the table gain kernel on every shard) and FM
    (mutation's real-valued member rows, the batched rating kernel on
    every shard) of 5 members over 4 logical shards of the card: parts
    and cuts bit-equal to the ``off`` route."""
    hg = _netlist(250, 330, 41)
    hga = hg.arrays(device=card)
    k = 8
    rng = np.random.default_rng(41)
    parts = np.stack([refine.rebalance(
        hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
        0.08) for _ in range(5)]).astype(np.int32)
    ew = np.zeros((5, hga.m_pad), np.float32)
    ew[:, : hg.m] = hg.edge_weights * (1.0 + 0.1 * rng.integers(
        0, 4, (5, hg.m)))
    if tier == "lp":
        run = lambda shard: refine.lp_refine_population(
            hga, parts, k, 0.08, max_iters=6, shard=shard)
    else:
        run = lambda shard: refine.fm_refine_population(
            hga, parts, k, 0.08, edge_weights_pop=ew, shard=shard)
    want = run("off")
    popshard.set_logical_shards(4, card)
    try:
        ops.reset_launch_counts()
        got = run(route)
        counts = ops.launch_counts()
    finally:
        popshard.set_logical_shards(None)
    assert torch.equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert counts["gain_table" if tier == "lp"
                  else "rating_segment_sum_batch"] > 0


# --------------------------------------------------------------------------
# the model axis over a (pop 2, model 2) grid of logical shards (13c), and
# the service over a pool (13b)
# --------------------------------------------------------------------------
def _model_grid(card, monkeypatch):
    monkeypatch.setenv("REPRO_POP_MESH_MODEL", "2")
    popshard.set_logical_shards(4, card)
    assert popshard.pop_mesh(card).shape == {"pop": 2, "model": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["lp", "fm"])
def test_model_route_on_member_rows_on_card(card, tier, monkeypatch):
    """LP and FM of 4 members on integer-valued member rows, the pins in
    two blocks over "model": parts and cuts bit-equal to ``off``; the
    member-row gain sums launch #4 on every block, and no gain kernel
    (#1/#2) runs (the blocks carry no incidence layout)."""
    hg = _netlist(250, 330, 43)
    hga = hg.arrays(device=card)
    k = 8
    rng = np.random.default_rng(43)
    parts = np.stack([refine.rebalance(
        hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
        0.08) for _ in range(4)]).astype(np.int32)
    ew = np.zeros((4, hga.m_pad), np.float32)
    ew[:, : hg.m] = hg.edge_weights * rng.integers(1, 4, (4, hg.m))
    tier_fn = (refine.lp_refine_population if tier == "lp"
               else refine.fm_refine_population)
    run = lambda **kw: tier_fn(hga, parts, k, 0.08, edge_weights_pop=ew,
                               **kw)
    want = run(shard="off")
    _model_grid(card, monkeypatch)
    try:
        ops.reset_launch_counts()
        got = run(shard="mesh", model_shard="mesh")
        counts = ops.launch_counts()
    finally:
        popshard.set_logical_shards(None)
    assert torch.equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert counts["rating_segment_sum_batch"] >= 4
    assert counts["gain_table"] == counts["gain_stream"] == 0


@pytest.mark.cuda
def test_sharded_contraction_on_card(card, monkeypatch):
    """The device engine's hierarchy and the cohort's shared hierarchy,
    contracted over "model": every level's leaves bit-equal to the
    replicated contraction's on the card."""
    hg = _netlist(600, 800, 44)
    rng = np.random.default_rng(44)
    base = (np.arange(hg.n) * 4 // hg.n).astype(np.int32)
    parts = np.stack([np.where(rng.random(hg.n) < 0.02,
                               rng.integers(0, 4, hg.n), base)
                      for _ in range(3)]).astype(np.int32)
    w_pop = np.stack([hg.edge_weights * (1.0 + 0.1 * rng.integers(
        0, 3, hg.m)) for _ in range(3)]).astype(np.float32)

    def builds(model):
        return (build_hierarchy(hg, 4, seed=3, path="device",
                                contraction_limit_factor=16,
                                model_shard=model, device=card),
                population_coarsen(hg, parts, w_pop, 4, seed=7,
                                   contraction_limit_factor=8,
                                   model_shard=model, device=card))
    want = builds("off")
    _model_grid(card, monkeypatch)
    try:
        got = builds("mesh")
    finally:
        popshard.set_logical_shards(None)
    for g, w in zip(got, want):
        assert g.num_levels == w.num_levels > 2
        for lg, lw in zip(g.levels, w.levels):
            for f in ("pin_vertex", "pin_edge", "vertex_weights",
                      "edge_weights", "edge_sizes"):
                assert torch.equal(getattr(lg.hga, f), getattr(lw.hga, f)), f
        if hasattr(g.levels[0], "ew_pop"):
            for lg, lw in zip(g.levels, w.levels):
                assert torch.equal(lg.ew_pop, lw.ew_pop)
                assert torch.equal(lg.parts, lw.parts)


@pytest.mark.cuda
def test_service_device_loss_over_two_logical_shards_on_card(card):
    """The service on the ``mesh`` route over 2 logical shards of the
    card loses one at tick 2: the pool shrinks to one, every request
    resumes from its snapshot on the survivors' mesh, and every answer is
    bit-equal to solo (the chip script's service phase runs the soak's
    plan on both routes)."""
    reqs = _service_requests()
    popshard.set_logical_shards(2, card)
    try:
        svc = _card_service(card, shard="mesh", ckpt_every=1,
                            fault_plan=FaultPlan.parse("2:device_loss"))
        for r in reqs:
            svc.submit(r)
        svc.drain()
        assert len(popshard.local_devices(card)) == 1
    finally:
        restore_device_pool(card)
        popshard.set_logical_shards(None)
    loss = [e for e in svc.events if e["kind"] == "device_loss"]
    assert len(loss) == 1 and loss[0]["survivors"] == 1
    for r in reqs:
        part, cut = svc.solve_solo(r)
        got = svc.results[r.name]
        assert got.status == "recovered"
        assert np.array_equal(got.part, part) and got.cut == cut


# --------------------------------------------------------------------------
# the partition service and its fault handling on the card
# --------------------------------------------------------------------------
def _service_requests(count=2):
    """Modular netlists deep enough (``contraction_limit_factor`` 16) for
    a fault to land mid-flight."""
    return [PartitionRequest(
        name=f"card-svc-{i}", k=(3, 8)[i % 2], eps=0.08, seed=i,
        hg=_modular_netlist(360 + 60 * i, 460 + 70 * i, seed=30 + i,
                            n_modules=5, p_local=0.8, fanout_tail=1.5))
        for i in range(count)]


def _card_service(card, **kw):
    return PartitionService(slots=2, alpha=2, lp_iters=4,
                            contraction_limit_factor=16, device=card, **kw)


@pytest.mark.cuda
def test_service_equals_solo_on_card(card):
    """Two requests through two slots on the card (device coarsening,
    the gain kernels): each answer bit-equal to its solo run."""
    reqs = _service_requests()
    svc = _card_service(card)
    for r in reqs:
        svc.submit(r)
    svc.drain()
    for r in reqs:
        part, cut = svc.solve_solo(r)
        got = svc.results[r.name]
        assert got.status == "ok"
        assert np.array_equal(got.part, part) and got.cut == cut


@pytest.mark.cuda
@pytest.mark.parametrize("ckpt_every", [1, 0])
def test_device_loss_mid_flight_on_card(card, ckpt_every):
    """A device loss at tick 2 on the card: every slot drops its device
    state, the requests' level-0 arrays are built anew (not the cached
    tensors), and the resumed (or restarted) answers are bit-equal to
    solo."""
    reqs = _service_requests()
    svc = _card_service(card, ckpt_every=ckpt_every,
                        fault_plan=FaultPlan.parse("2:device_loss:survivors=1"))
    for r in reqs:
        svc.submit(r)
    svc.step()
    old = [s.hier.level_arrays(0) for s in svc.slots]
    assert all(s.li > 0 for s in svc.slots), "ladders too shallow"
    svc.step()
    loss = [e for e in svc.events if e["kind"] == "device_loss"]
    assert len(loss) == 1 and loss[0]["survivors"] == 1
    assert loss[0]["allocated_after"] < loss[0]["allocated_before"]
    assert loss[0]["recovery_s"] == pytest.approx(
        loss[0]["drop_s"] + loss[0]["rebuild_s"])
    for s, hga0 in zip(svc.slots, old):
        new = s.hier.level_arrays(0)
        assert new is not hga0
        assert new.pin_vertex is not hga0.pin_vertex
        assert new.vertex_weights is not hga0.vertex_weights
        assert torch.equal(new.pin_vertex, hga0.pin_vertex)
    del old
    svc.drain()
    restore_device_pool(card)
    for r in reqs:
        part, cut = svc.solve_solo(r)
        got = svc.results[r.name]
        assert got.status == "recovered"
        assert np.array_equal(got.part, part) and got.cut == cut


@pytest.mark.cuda
def test_device_hierarchy_rebuild_is_bit_stable_on_card(card):
    """The device engine's hierarchy rebuilt from the same seed, with
    the request's cached arrays dropped in between (what a device-loss
    resume does), equals the first build leaf for leaf."""
    hg = _service_requests(1)[0].hg
    builds = []
    for _ in range(2):
        hg._arrays_cache.clear()
        builds.append(build_hierarchy(hg, 3, seed=5,
                                      contraction_limit_factor=16,
                                      device=card))
    a, b = builds
    assert a.num_levels == b.num_levels > 2
    for la, lb in zip(a.levels, b.levels):
        assert (la.n, la.m, la.p) == (lb.n, lb.m, lb.p)
        if la.cluster_id is not None:
            assert torch.equal(la.cluster_id, lb.cluster_id)
        for f in ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
                  "edge_sizes", "incident"):
            x, y = getattr(la.hga, f), getattr(lb.hga, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f


@pytest.mark.cuda
@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_restore_onto_the_card(card, async_save, tmp_path):
    g = torch.Generator(device=card).manual_seed(2)
    state = {"parts": torch.randint(0, 8, (3, 50), device=card,
                                    dtype=torch.int32, generator=g),
             "w": (torch.randn(7, device=card, generator=g),
                   torch.arange(4, device=card))}
    ckpt = CheckpointManager(str(tmp_path), async_save=async_save)
    ckpt.save(1, state, extra={"tick": 1})
    ckpt.wait()
    for device in (card, None):
        back, extra = ckpt.restore(state, device=device)
        assert extra == {"tick": 1}
        for x, y in ((back["parts"], state["parts"]),
                     (back["w"][0], state["w"][0]),
                     (back["w"][1], state["w"][1])):
            assert x.device.type == "cuda" and x.dtype == y.dtype
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the substrate: DLRM's retrieval through #9, placement on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_dlrm_retrieval_bag_is_kernel_bits_on_card(card):
    """``DLRM.retrieval_scores`` at the SMOKE width: its user bag goes
    through #9 (one launch a call) and the scores equal, bit for bit, the
    same function with the bag summed in bag order by plain torch."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.data.recsys import click_batch
    from repro_torch.models import dlrm
    from repro_torch.models.layers import batch_to
    cfg = SMOKES["dlrm-mlperf"]
    model = dlrm.init_params(cfg, torch.Generator(card).manual_seed(3),
                             device=card)
    host = click_batch(cfg, 1, seed=3)
    host["cand_idx"] = np.random.default_rng(3).integers(
        0, cfg.total_rows, 4096).astype(np.int32)
    batch = batch_to({k: host[k] for k in ("dense", "sparse_idx",
                                           "cand_idx")}, card)
    before = embedding_bag.embedding_bag.launches
    with torch.no_grad():
        got = model.retrieval_scores(batch)
        tables = model.tables.detach()
        acc = torch.zeros((1, cfg.embed_dim), device=card)
        for j in range(cfg.n_sparse):
            acc = acc + tables[batch["sparse_idx"][:, j].long()]
        user = model.bot(batch["dense"]) + acc
        want = tables[batch["cand_idx"].long()] @ user[0]
    assert embedding_bag.embedding_bag.launches == before + 1
    assert got.shape == (4096,) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_placement_cut_equals_host_recount_on_card(card):
    """``partition_graph_for_mesh`` at n 600 on the card (``balanced``:
    ``impart_partition``; and ``fast``): each reported cut equals the
    host's count of distinct node pairs split across devices, and every
    device holds at most its balance cap."""
    from repro_torch.apps import placement
    from repro_torch.data.graphs import power_law_graph
    n, k, eps = 600, 8, 0.06
    ei = power_law_graph(n, 2400, seed=5)
    for quality in ("balanced", "fast"):
        res = placement.partition_graph_for_mesh(ei, n, k, eps=eps, seed=1,
                                                 quality=quality, device=card)
        part = res.assignment
        src, dst = ei
        keep = src != dst
        pairs = {(min(a, b), max(a, b)) for a, b in zip(src[keep], dst[keep])}
        host_cut = sum(part[a] != part[b] for a, b in pairs)
        assert res.cut == float(host_cut), quality
        assert np.bincount(part, minlength=k).max() <= \
            (1 + eps) * np.ceil(n / k), quality
        assert 0 < res.reduction < 1, quality


# --------------------------------------------------------------------------
# LM serving: the transformer on the card against its CPU run
# --------------------------------------------------------------------------
LM_TOL = dict(rtol=1e-5, atol=1e-5)


def _lm_on_card_and_cpu(card, aid: str, seed: int):
    """``aid``'s SMOKE model (f32) drawn on the card, and a CPU copy."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.models import transformer
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = SMOKES[aid]
    model = transformer.init_params(
        cfg, torch.Generator(card).manual_seed(seed), device=card)
    cpu = transformer.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cfg, model, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("aid", ["codeqwen1.5-7b", "phi3.5-moe-42b-a6.6b"])
def test_lm_prefill_and_decode_equal_cpu_on_card(card, aid):
    """A dense and a MoE SMOKE model: prefill logits (the MoE over 256
    groups of 2 tokens, capacity 1: tokens drop) and 4 decode steps on
    the card equal the CPU run, and so do the caches they write."""
    from repro_torch.models import transformer
    cfg, model, cpu = _lm_on_card_and_cpu(card, aid, seed=4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    torch.testing.assert_close(
        transformer.prefill_logits(model, toks.to(card)).cpu(),
        transformer.prefill_logits(cpu, toks), **LM_TOL)
    caches = [transformer.init_cache(cfg, 2, 8, dev) for dev in (card, "cpu")]
    for i in range(4):
        got, caches[0] = transformer.decode_step(
            model, caches[0], toks[:, i:i + 1].to(card), i)
        want, caches[1] = transformer.decode_step(cpu, caches[1],
                                                  toks[:, i:i + 1], i)
        torch.testing.assert_close(got.cpu(), want, **LM_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(caches[0][name].cpu(), caches[1][name],
                                   **LM_TOL)
        assert not bool(caches[0][name][:, :, 4:].any())


@pytest.mark.cuda
def test_lm_greedy_decode_equals_prefill_argmax_on_card(card):
    """The reference's decode-consistency bar on the card (f32, GQA)."""
    from repro_torch.models import transformer
    from repro_torch.serve import ServeSession
    cfg, model, _ = _lm_on_card_and_cpu(card, "stablelm-12b", seed=5)
    sess = ServeSession(cfg=cfg, params=model, max_seq=32, batch=3)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)).to(card)
    gen, logits = sess.generate(prompt, 12)
    assert gen.shape == (3, 12) and bool(torch.isfinite(logits).all())
    greedy = transformer.prefill_logits(
        model, torch.cat([prompt, gen], dim=1)).argmax(dim=-1)
    assert torch.equal(greedy[:, 7:-1].to(torch.int32), gen)
    scores = sess.score(torch.cat([prompt, gen], dim=1))
    assert scores.shape == (3,) and bool(torch.isfinite(scores).all())


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,e,cf", [(4, 16, 4, 0.5), (1, 16, 16, 1.25)])
def test_moe_dispatch_masks_on_card_equal_cpu(card, g, t, e, cf):
    """The MoE's routing masks on the card, bit for bit those of the
    CPU: from the same probabilities (with ties between experts 0 and
    1), and from integer-valued tokens and router weights (their f32
    logits are exact in any order of addition)."""
    from repro_torch.models import moe
    rng = np.random.default_rng(t + e)
    logits = rng.normal(size=(g, t, e)).astype(np.float32)
    logits[..., 1] = logits[..., 0]
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    cap = moe.capacity(2, t, cf, e)
    for got, want in zip(moe.route_masks(probs.to(card), 2, cap,
                                         torch.float32),
                         moe.route_masks(probs, 2, cap, torch.float32)):
        assert torch.equal(got.cpu(), want)
    x = torch.from_numpy(rng.integers(-3, 4, (g, t, 32)).astype(np.float32))
    rw = torch.from_numpy(rng.integers(-3, 4, (32, e)).astype(np.float32))
    got = moe.moe_route(x.to(card), rw.to(card), 2, cf)
    want = moe.moe_route(x, rw, 2, cf)
    assert torch.equal(got.logits.cpu(), want.logits)
    assert torch.equal(got.onehot.cpu(), want.onehot)
    assert torch.equal(got.dispatch.cpu(), want.dispatch)
    assert float(want.dispatch.sum()) < g * t * 2 or cf > 1


# --------------------------------------------------------------------------
# training: the flash backward, AdamW, the DLRM sparse step
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_on_card_equals_plain_attention(card, causal):
    """The flash backward (f32, TF32 off) on the card against autograd of
    the plain softmax attention in f64 on the card, and against the same
    function on the CPU: rtol 1e-5, atol 1e-5 (f32 sums in another order:
    ``dk``/``dv`` add up to 1,024 terms of order 1 over the queries and a
    KV head's 4 query heads)."""
    from repro_torch.models import attention
    rng = np.random.default_rng(3)
    b, s, h, kv, dh, blk = 2, 256, 8, 2, 64, 64
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                          (b, s, h, dh))]
    grads = []
    for dev in (card, torch.device("cpu")):
        q, k, v = (t.to(dev, copy=True).requires_grad_(True)
                   for t in host[:3])
        attention.flash_attention(q, k, v, causal=causal,
                                  block_kv=blk).backward(host[3].to(dev))
        grads.append([t.grad.cpu() for t in (q, k, v)])
    q, k, v = (t.to(card, torch.float64, copy=True).requires_grad_(True)
               for t in host[:3])
    kr, vr = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(dh)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                        device=card).tril(), float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vr).backward(
        host[3].to(card).double())
    plain = [t.grad.float().cpu() for t in (q, k, v)]
    for got, cpu, want in zip(grads[0], grads[1], plain):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_adamw_step_on_card_equals_cpu(card, quant):
    """Three AdamW steps on the card and on the CPU from one state: the
    moments (int8 ``q`` and its scales) bit for bit while the gradient
    norm stays under the clip (the same f32 products and sums, one op at
    a time), the parameters (bf16 leaf included) rtol 1e-6 (``b ** step``
    may differ by an ulp)."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(4)
    cfg = adamw.AdamWConfig(quantize_moments=quant)
    host = {"layers": {"w": rng.normal(size=(2, 64, 300))},
            "emb": rng.normal(size=(40, 16)), "s": rng.normal(size=())}
    runs = []
    for dev in (card, torch.device("cpu")):
        params = {"layers": {"w": torch.tensor(host["layers"]["w"],
                                               dtype=torch.float32,
                                               device=dev)},
                  "emb": torch.tensor(host["emb"], dtype=torch.bfloat16,
                                      device=dev),
                  "s": torch.tensor(host["s"], dtype=torch.float32,
                                    device=dev)}
        state = adamw.init(params, cfg)
        g_rng = np.random.default_rng(5)
        for _ in range(3):
            grads = adamw.tree_map(lambda p: torch.tensor(
                g_rng.normal(scale=1e-3, size=tuple(p.shape)),
                dtype=torch.float32, device=dev), params)
            params, state, m = adamw.update(grads, state, params, cfg, 0.5)
        assert float(m["grad_norm"]) < cfg.grad_clip
        runs.append((params, state))
    (pc, sc), (pp, sp) = runs
    for a, b in zip(adamw.tree_leaves(pc), adamw.tree_leaves(pp)):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=1e-6,
                                   atol=1e-7)
    for name in ("m", "v"):
        for a, b in zip(adamw.tree_leaves(sc[name]),
                        adamw.tree_leaves(sp[name])):
            if quant:
                assert torch.equal(a.q.cpu(), b.q)
                assert torch.equal(a.scale.cpu(), b.scale)
            else:
                assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_dlrm_sparse_step_is_bit_stable_through_rating_kernel(card):
    """The DLRM sparse train step (SMOKE config, batch 512) run twice on
    the card from one state gives the same bits, launches the batched
    rating kernel (#4) for its duplicate-row sums, and stays within rtol
    1e-5, atol 1e-7 of the CPU run (f32 products in another order)."""
    import dataclasses as dc
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.recsys import click_batch
    from repro_torch.models import dlrm
    from repro_torch.models.layers import batch_to
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    aid = "dlrm-mlperf"
    cfg = registry.SMOKES[aid]
    spec = dc.replace(registry.get_arch(aid), config=cfg)
    shape = ShapeSpec("t", "train_batch", (("batch", 512),))
    cell = steps.dlrm_train_cell(spec, shape, registry.get_opt(aid),
                                 sparse_update=True)
    base = dlrm.param_tree(dlrm.init_params(
        cfg, torch.Generator("cpu").manual_seed(1), device="cpu"))

    def run(dev):
        params = adamw.tree_map(lambda p: p.detach().clone().to(dev), base)
        state = {"params": params,
                 "opt": adamw.init(params, registry.get_opt(aid))}
        state["opt"]["step"].fill_(200)
        for i in range(2):
            state, m = cell.fn(state, batch_to(click_batch(cfg, 512,
                                                           seed=i), dev))
        return state, m

    ops.reset_launch_counts()
    a, _ = run(card)
    assert ops.launch_counts()["rating_segment_sum_batch"] == 2
    b, _ = run(card)
    cpu, _ = run(torch.device("cpu"))
    la, lb, lc = (adamw.tree_leaves(x) for x in (a, b, cpu))
    for x, y, z in zip(la, lb, lc):
        assert torch.equal(x, y)
        torch.testing.assert_close(x.cpu(), z, rtol=1e-5, atol=1e-7)
    idx = click_batch(cfg, 512, seed=0)["sparse_idx"]
    assert idx.size > np.unique(idx).size           # duplicate rows


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
