#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Run from the root of a checkout, with one CUDA device and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. print the device and its power limit;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at odd shapes: the gain kernels
   (population and one-member forms) must be exactly equal, the rating
   kernels allclose (rtol 1e-6) and bit-identical across two launches,
   and every row of the batched rating kernel bit-equal to the scalar
   kernel on that row, also at the shape of mutation's FM steps; time
   kernel (the gain and rating kernels replayed in a CUDA graph, as the
   FM steps run them; the connectivity and cut kernels in a CUDA graph
   that rotates over copies of the pin matrix larger than twice the L2,
   so their pins come from device memory), plain version and the
   library yardstick, and compute the least time the card could take;
4. the tests marked ``cuda`` in ``tests/test_torch_card.py``, run by
   pytest in a child process (``--noconftest``: the suite's conftest
   imports JAX, which this machine need not have); any failure, error or
   skip, or fewer passes than cases marked ``cuda``, fails the phase;
5. a small instance refined on the card and on the CPU under host
   coarsening must give the same partition and cut;
6. the memetic-off paths: ``impart_partition`` without recombination,
   mutation and V-cycle on ``ispd_like("ibm08_like")`` at k=64 (stream
   gain kernel) and on ``ispd_like("ibm01_like")`` at k=16 (table gain
   kernel);
7. the memetic path: ``impart_partition`` on ``ibm08_like`` at k=64 with
   the reference defaults (alpha 7, beta 7, recombination, mutation, one
   final V-cycle), with its recombination branches counted and its time
   split into recombination, mutation, final V-cycle and the rest;
8. the partition CLI: ``python -m repro_torch.launch.partition --method
   multilevel`` in a child process on ``ibm08_like`` (k=64, one-member
   stream kernel) and ``ibm01_like`` (k=16, one-member table kernel); its
   saved assignment is reloaded and checked;
9. the public kernel ops (``kernels.ops.connectivity``, ``cutsize`` and
   ``embedding_bag``): connectivity and cut of a k=32 partition of
   ``ibm08_like``'s pin matrix, and one DLRM embedding bag (26 sparse
   features x 65,536 bags, D=128, the MLPerf cardinalities capped at
   2**20 rows);
10. the bandit operator schedule on ``ibm01_like`` (k=16, the reference
   defaults): the static schedule's wall W, a ``sched="bandit"`` run with
   ``time_budget_s=W``, and the replay of its trace after a JSON
   round-trip, which must give the live partition, cut and arm sequence
   bit for bit.

The kernel phase also holds the connectivity and cut kernels (#7/#8, at
the reference's sweeps and at ``CUT_ODD``'s odd shapes) and the
embedding bag (#9) against their plain versions, and checks that
every sum of mutation's real-valued reweights gives the same bits in two
runs on the card (``contract_arrays(ew_pop=)``, the gain assembly on the
segsum and compact paths, one graphed FM pass with member rows).

Every main path runs with the launch counters zeroed just before it and
read just after it.  Its cut and balance are recomputed in numpy, and
its cut once more on the card through ``ops.connectivity`` and
``ops.cutsize`` (the kernels at k <= 32, the plain versions above, as
the ops route), which must agree with the host.

``--phases`` takes a comma list of
``kernels,cardtests,parity,off,memetic,cli,ops,sched`` (default: all;
empty for none) for runs that debug one phase; the kernels line is only printed
when every phase ran.  ``--repair-cost=DIR`` then times the static
memetic run of the ``sched`` phase with its mutation seconds on the
package under ``DIR`` (the ``src`` of a tree before the fixed-order sums
of mutation's reweights) and on this one, in child processes, in the
order DIR, this, this, DIR; ``--kernel-compare=DIR`` times the kernels
redesigned since such a tree (``kernel_times``: #1 to #8 at the kernel
phase's shapes, #4 also at the FM step's shape, #7 and #8 warm and cold,
all in a CUDA graph) on DIR and on this one, in the same order; it may
be given more than once.  With ``--profile`` the script
then splits each memetic-off run into its phases (coarsening, initial
partition, LP, FM; host clock around synchronized work) and traces the
ibm08 run with ``torch.profiler`` to report the device's busy share and
its top kernels.

The line before the last holds the kernels as JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): HBM3 rate and f32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

KERNEL_META = {
    "gain_table": ("src/repro_torch/kernels/csrc/gain.cu",
                   "src/repro/kernels/gain.py:124"),
    "gain_stream": ("src/repro_torch/kernels/csrc/gain.cu",
                    "src/repro/kernels/gain.py:257"),
    "rating_segment_sum": ("src/repro_torch/kernels/csrc/rating.cu",
                           "src/repro/kernels/rating.py:93"),
    "rating_segment_sum_batch": ("src/repro_torch/kernels/csrc/rating.cu",
                                 "src/repro/kernels/rating.py:157"),
    "gain_table_one": ("src/repro_torch/kernels/csrc/gain.cu",
                       "src/repro/kernels/gain.py:75"),
    "gain_stream_one": ("src/repro_torch/kernels/csrc/gain.cu",
                        "src/repro/kernels/gain.py:190"),
    "connectivity": ("src/repro_torch/kernels/csrc/connectivity.cu",
                     "src/repro/kernels/connectivity.py:64"),
    "cutsize": ("src/repro_torch/kernels/csrc/connectivity.cu",
                "src/repro/kernels/connectivity.py:111"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:66"),
}
PHASES = ("kernels", "cardtests", "parity", "off", "memetic", "cli", "ops",
          "sched")

# the largest level FM refines (``refine.refine_population``'s default)
FM_NODE_LIMIT = 4096

# MLPerf DLRM (Criteo 1TB): 26 sparse features, embed_dim 128, the table
# cardinalities of the reference's dlrm_mlperf config, each capped here
# at 2**20 rows; one training batch of 65,536 samples
DLRM_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)
DLRM_ROW_CAP = 2 ** 20
DLRM_BATCH = 65536
DLRM_DIM = 128


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """ms per call of ``fn``, captured ``calls`` times in one CUDA graph
    that is replayed ``replays`` times: the way FM's graphed move steps
    run their kernels (no host launch per call)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _graph_cold_ms(fn, operand) -> float:
    """``_graph_ms`` of ``fn(x)`` over enough copies ``x`` of ``operand``
    that together they hold at least twice the card's L2: the captured
    calls take the copies in turn, so each call finds its operand evicted
    and reads it from device memory, as the first touch does (a graph
    replaying one operand reads it from L2 when it fits there)."""
    copies = [operand.clone()
              for _ in range(-(-2 * L2_BYTES // operand.nbytes))]
    turn = itertools.cycle(copies)
    return _graph_ms(lambda: fn(next(turn)), calls=3 * len(copies))


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gain_inputs(hg, k: int, alpha: int, seed: int, dev):
    """Gain tables of a random population on ``hg``'s padded arrays."""
    return _gain_tables(hg.arrays(device=dev), k, alpha, seed, dev)


def _gain_tables(hga, k: int, alpha: int, seed: int, dev):
    """Gain tables of a random population on the level ``hga``: returns
    its incidence layout and the tables ``bi``, ``wi``."""
    import numpy as np
    import torch
    from repro_torch.core import metrics
    if hga.incident is None:
        raise AssertionError("the level has no dense incidence layout")
    rng = np.random.default_rng(seed)
    parts = torch.from_numpy(
        rng.integers(0, k, (alpha, hga.n_pad)).astype(np.int32)).to(dev)
    phi = metrics.pins_in_block_population(hga, parts, k)
    bi, wi = metrics._edge_gain_terms(hga, phi)
    return hga.incident, bi.contiguous(), wi.contiguous()


# odd shapes ((alpha, N, D, M, k), trailing pads) of the gain kernels: k
# from 1 to 1024 around the lane-group, warp and column-group widths,
# D = 1, 8, 16 and 24, N off every group and block size, pads mid-row or
# (trailing) after the valid ids
GAIN_ODD = [((1, 1000, 8, 700, 2), False), ((3, 1000, 8, 700, 33), False),
            ((3, 777, 16, 1500, 64), False), ((2, 600, 16, 900, 100), False),
            ((1, 300, 24, 513, 1024), False), ((3, 500, 1, 300, 64), False),
            ((3, 777, 16, 1500, 64), True), ((3, 1001, 8, 700, 1), False),
            ((2, 999, 24, 513, 3), False), ((1, 777, 1, 300, 8), False),
            ((2, 601, 1, 400, 16), True), ((3, 1003, 16, 900, 16), True),
            ((2, 517, 24, 700, 31), False), ((3, 1000, 8, 700, 32), True)]


def _odd_gain_inputs(alpha, n, d, m, k, seed, dev, trailing=False):
    """Random incidence with pads anywhere in a row (or, ``trailing``,
    after the valid ids, as the layout builder places them), degree-0
    rows and integer tables."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, m, (n, d)).astype(np.int32)
    inc[rng.random((n, d)) < 0.3] = -1
    inc[rng.random(n) < 0.1] = -1          # degree-0 vertices
    if trailing:
        inc = -np.sort(-inc, axis=1)        # valid ids first, pads last
    bi = rng.integers(0, 4, (alpha, m, k)).astype(np.float32)
    wi = rng.integers(0, 4, (alpha, m)).astype(np.float32)
    return (torch.from_numpy(inc).to(dev), torch.from_numpy(bi).to(dev),
            torch.from_numpy(wi).to(dev))


def _gain_bound(inc, bi) -> tuple:
    import torch
    alpha, _, k = bi.shape
    n, d = inc.shape
    valid = inc >= 0
    e_ref = int(torch.unique(inc[valid]).numel())
    nnz = int(valid.sum())
    nbytes = n * d * 4 + alpha * e_ref * (k + 1) * 4 + alpha * n * k * 4
    ops = alpha * (nnz * (k + 1) + n * k)
    return _bound_ms(nbytes, ops)


def check_gain_kernels(report, dev):
    import torch
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import gain, ref
    # the main-path shapes, each checked; the last k is timed
    cases = {
        "gain_stream": (gain.gain_stream_batch, ref.gain_stream_batch_ref,
                        ("ibm08_like", (64,))),
        "gain_table": (gain.gain_gather_batch, ref.gain_gather_batch_ref,
                       ("ibm01_like", (32, 16))),
    }
    for name, (kern, plain, (design, ks)) in cases.items():
        errs = []
        for i, (shape, trailing) in enumerate(GAIN_ODD):
            inc, bi, wi = _odd_gain_inputs(*shape, seed=i, dev=dev,
                                           trailing=trailing)
            got, want = kern(inc, bi, wi), plain(inc, bi, wi)
            again = kern(inc, bi, wi)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(or its rerun) at {shape}")
            errs.append(float((got - want).abs().max()))
        hg = ispd_like(design, 1.0)
        for k in ks:
            inc, bi, wi = _gain_inputs(hg, k, 7, 0, dev)
            got, want = kern(inc, bi, wi), plain(inc, bi, wi)
            again = kern(inc, bi, wi)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"on {design} k={k}")
            errs.append(float((got - want).abs().max()))
            del got, want, again
        ms = _graph_ms(lambda: kern(inc, bi, wi))
        plain_ms = _time_ms(lambda: plain(inc, bi, wi), iters=5)
        lib_ms = _time_ms(lambda: ref.gain_gather_embedding_bag(inc, bi))
        bound, by = _gain_bound(inc, bi)
        print(f"[kernel] {name} {design} incident={tuple(inc.shape)} "
              f"tables={tuple(bi.shape)}: exact at k in {ks} and at "
              f"{len(GAIN_ODD)} odd shapes")
        for label, val in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bound)):
            print(f"[kernel] {name} {label} {val!r}")
        report[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        torch.cuda.empty_cache()


def check_gain_one_kernels(report, dev):
    """The one-member gain kernels (#5/#6) against their plain versions,
    at the multilevel baseline's finest-level shapes and odd shapes."""
    import torch
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import gain, ref
    cases = {
        "gain_stream_one": (gain.gain_stream, ref.gain_stream_ref,
                            ("ibm08_like", 64)),
        "gain_table_one": (gain.gain_gather, ref.gain_gather_ref,
                           ("ibm01_like", 16)),
    }
    odd = [((1,) + shape[1:], trailing) for shape, trailing in GAIN_ODD]
    for name, (kern, plain, (design, k)) in cases.items():
        errs = []
        for i, (shape, trailing) in enumerate(odd):
            inc, bi, wi = _odd_gain_inputs(*shape, seed=10 + i, dev=dev,
                                           trailing=trailing)
            bi, wi = bi[0], wi[0]
            got, want = kern(inc, bi, wi), plain(inc, bi, wi)
            again = kern(inc, bi, wi)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(or its rerun) at {shape}")
            errs.append(float((got - want).abs().max()))
        inc, bi, wi = _gain_inputs(ispd_like(design, 1.0), k, 1, 0, dev)
        bi, wi = bi[0], wi[0]
        got, want = kern(inc, bi, wi), plain(inc, bi, wi)
        again = kern(inc, bi, wi)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{design} k={k}")
        errs.append(float((got - want).abs().max()))
        ms = _graph_ms(lambda: kern(inc, bi, wi))
        plain_ms = _time_ms(lambda: plain(inc, bi, wi), iters=5)
        lib_ms = _time_ms(
            lambda: ref.gain_gather_embedding_bag(inc, bi[None]))
        bound, by = _gain_bound(inc, bi[None])
        print(f"[kernel] {name} {design} incident={tuple(inc.shape)} "
              f"table={tuple(bi.shape)}: exact at main-path and "
              f"{len(odd)} odd shapes")
        for label, val in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bound)):
            print(f"[kernel] {name} {label} {val!r}")
        report[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        torch.cuda.empty_cache()


def _rating_batch_checked(vals, segs, s: int, what: str,
                          exact: bool = False) -> float:
    """One batched launch against the plain version (rtol 1e-6, or equal
    with ``exact`` for integer values), against alpha launches of the
    scalar kernel (bit for bit) and against a second launch (bit for
    bit); returns the largest absolute error."""
    import torch
    from repro_torch.kernels import rating, ref
    got = rating.rating_segment_sum_batch(vals, segs, s)
    again = rating.rating_segment_sum_batch(vals, segs, s)
    rows = torch.stack([rating.rating_segment_sum(row, segs, s)
                        for row in vals])
    want = ref.rating_segment_sum_batch_ref(vals, segs, s)
    torch.cuda.synchronize()
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"batched rating kernel differs from its "
                                 f"plain version on integers at {what}")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    if not torch.equal(got, rows):
        raise AssertionError(f"batched rating rows differ from the scalar "
                             f"kernel at {what}")
    if not torch.equal(got, again):
        raise AssertionError(f"batched rating kernel not bit-stable at "
                             f"{what}")
    return float((got - want).abs().max())


def _rating_odd_shapes(rng):
    """Odd shapes of the rating kernels, ``(segs, vals[alpha, C], S,
    exact, label)``: every segment of length 1, a run of 150,000 (longer
    than a tile, with integer values so that any order is exact), every
    id dropped (below 0, or at least S), C = 1 and C off the warp width,
    and alpha = 119 (the FM step's rows)."""
    import numpy as np
    out = []

    def real(alpha, c):
        return (rng.random((alpha, c)) + 0.1).astype(np.float32)

    c = 5001
    out.append((np.arange(c, dtype=np.int32), real(3, c), c, False,
                "every segment of length 1"))
    segs = np.concatenate([np.sort(rng.integers(0, 400, 20_000)),
                           np.full(150_000, 400),
                           np.sort(rng.integers(401, 1000, 20_003))])
    out.append((segs.astype(np.int32),
                rng.integers(0, 4, (2, segs.size)).astype(np.float32), 1000,
                True, "a run of 150,000"))
    out.append((np.full(777, -1, np.int32), real(2, 777), 500, False,
                "every id below 0"))
    out.append((np.full(777, 900, np.int32), real(2, 777), 500, False,
                "every id >= S"))
    out.append((np.zeros(1, np.int32), real(1, 1), 1, False, "C = 1"))
    out.append((np.full(1, 3, np.int32), real(3, 1), 10, False,
                "C = 1, S = 10"))
    segs = np.sort(rng.integers(-5, 950, 1001)).astype(np.int32)
    out.append((segs, real(4, 1001), 900, False, "C = 1001, ids both sides"))
    segs = np.sort(rng.integers(0, 4096, 16_385)).astype(np.int32)
    out.append((segs, real(119, 16_385), 4096, False, "alpha = 119"))
    return out


def _cohort_candidates(dev):
    """The mutation cohort's coarsening shape on ibm08_like: alpha 7
    reweighted rows ``w * (1 + 0.1 * C)`` over the finest level's
    C = 4 * p_pad sorted candidates.  Returns ``(r_pop, seg, C)``."""
    import numpy as np
    import torch
    from repro_torch.core import dcoarsen
    from repro_torch.data.hypergraphs import ispd_like
    rng = np.random.default_rng(1)
    hg = ispd_like("ibm08_like", 1.0)
    hga = hg.arrays(device=dev)
    alpha = 7
    parts = torch.zeros((alpha, hga.n_pad), dtype=torch.int32, device=dev)
    ew = np.zeros((alpha, hga.m_pad), np.float32)
    ew[:, : hg.m] = hg.edge_weights * (
        1.0 + 0.1 * rng.integers(0, alpha, (alpha, hg.m)))
    _, _, r_pop, seg = dcoarsen._sorted_candidates_population(
        hga, parts, torch.from_numpy(ew).to(dev),
        max_stride=dcoarsen.MAX_STRIDE, max_edge_size=dcoarsen.MAX_EDGE_SIZE)
    return r_pop, seg, r_pop.shape[1]


def _coarsen_candidates(dev):
    """The device coarsener's first round on ibm08_like: ``(r, seg, C)``."""
    from repro_torch.core import dcoarsen
    from repro_torch.data.hypergraphs import ispd_like
    hga = ispd_like("ibm08_like", 1.0).arrays(device=dev)
    _, _, r, seg = dcoarsen._sorted_candidates(
        hga, None, max_stride=dcoarsen.MAX_STRIDE,
        max_edge_size=dcoarsen.MAX_EDGE_SIZE)
    return r, seg, r.shape[0]


def _fm_level(dev):
    """The shape at which mutation's FM steps launch #4: an ibm01_like
    cohort (k 16, alpha 7, rows ``w * (1 + 0.1 * C)``) coarsened by
    ``population_coarsen`` on the card, at its finest level with at most
    ``FM_NODE_LIMIT`` vertices (the first level FM refines).  The members
    are one contiguous-block partition with 50 seeded moves each: a
    cohort's members agree on most vertices, so the hierarchy coarsens as
    a real cohort's does.  Returns ``(hga, phi, ew_pop, k)`` with the
    level's Phi of the cohort's projected parts."""
    import numpy as np
    from repro_torch.core import dcoarsen, metrics
    from repro_torch.data.hypergraphs import ispd_like
    hg = ispd_like("ibm01_like", 1.0)
    alpha, k = 7, 16
    rng = np.random.default_rng(5)
    parts = np.stack([(np.arange(hg.n) * k // hg.n).astype(np.int32)]
                     * alpha)
    for a in range(alpha):
        parts[a, rng.integers(0, hg.n, 50)] = rng.integers(0, k, 50)
    ew = (hg.edge_weights * (1.0 + 0.1 * rng.integers(
        0, alpha, (alpha, hg.m)))).astype(np.float32)
    hier = dcoarsen.population_coarsen(hg, parts, ew, k, seed=0, device=dev)
    li = next(i for i in range(hier.num_levels)
              if hier.level_arrays(i).n <= FM_NODE_LIMIT)
    hga = hier.level_arrays(li)
    phi = metrics.pins_in_block_population(hga, hier.level_parts(li), k)
    return hga, phi, hier.level_ew(li), k


def _fm_rows(hga, phi, ew_pop):
    """The [alpha * (k + 1), P] rows that ``metrics._gain_segsum`` sums
    per vertex with member rows (becomes_internal by column, then
    was_internal), with the pins in vertex order, and the vertex ids."""
    import torch
    from repro_torch.core import metrics
    bi, wi = metrics._edge_gain_terms(hga, phi, ew_pop)
    order, vertex = metrics.pins_by_vertex(hga)
    pe = hga.pin_edge.long()[order]
    alpha, _, k = bi.shape
    rows = torch.cat([bi.permute(0, 2, 1)[:, :, pe].reshape(alpha * k, -1),
                      wi[:, pe]]).contiguous()
    return rows, vertex


def check_rating_fm_shape(dev) -> float:
    """#4 at the FM step's shape (``_fm_level``): held like the other
    shapes, then timed in a CUDA graph beside the whole
    ``_gain_segsum`` with member rows and ``index_add_`` of the same
    sum.  Returns the largest absolute error."""
    import torch
    from repro_torch.core import metrics
    from repro_torch.kernels import rating
    hga, phi, ew, k = _fm_level(dev)
    rows, vertex = _fm_rows(hga, phi, ew)
    n_pad = hga.n_pad
    err = _rating_batch_checked(rows, vertex, n_pad, "FM step")
    r, p = rows.shape
    ms = _graph_ms(lambda: rating.rating_segment_sum_batch(rows, vertex,
                                                           n_pad))
    segsum_ms = _graph_ms(lambda: metrics._gain_segsum(hga, phi, ew))
    idx = vertex.long()
    lib_ms = _graph_ms(lambda: torch.zeros(
        (r, n_pad), dtype=torch.float32, device=dev).index_add_(1, idx, rows))
    bound, by = _bound_ms(r * p * 4 + p * 4 + r * n_pad * 4, r * p)
    lengths = torch.bincount(idx, minlength=n_pad)
    print(f"[kernel] rating_segment_sum_batch FM step ibm01_like cohort "
          f"alpha=7 k={k} level n={hga.n} n_pad={n_pad} rows={r} P={p} "
          f"(longest segment {int(lengths.max())}, the ghost vertex's "
          f"{int(lengths[-1])}): allclose rtol=1e-6, rows bit-equal to the "
          "scalar kernel, bit-stable")
    for label, val in (("fm_ms (graph)", ms),
                       ("fm_gain_segsum_ms (graph)", segsum_ms),
                       ("fm_library_ms (index_add_, graph)", lib_ms),
                       ("fm_bound_ms", bound)):
        print(f"[kernel] rating_segment_sum_batch {label} {val!r}")
    return err


def check_rating_batch_kernel(report, dev):
    """The batched rating kernel (#4) at odd shapes, at the mutation
    cohort's coarsening shape on ibm08_like (``_cohort_candidates``) and
    at the FM step's shape (``check_rating_fm_shape``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import rating, ref
    errs = []
    rng = np.random.default_rng(1)
    for alpha, c, s in ((1, 512, 512), (3, 1000, 300), (5, 130, 1000),
                        (3, 4099, 64), (5, 100_003, 20_000)):
        segs = np.sort(rng.integers(0, s, c)).astype(np.int32)
        segs[: min(c // 8, 7)] = -1          # ids < 0 are dropped
        vals = (rng.random((alpha, c)) + 0.1).astype(np.float32)
        # a long run of zeros at the end, like the ghost pairs' segment
        segs[-c // 3:] = s - 1
        vals[:, -c // 3:] = 0.0
        errs.append(_rating_batch_checked(
            torch.from_numpy(vals).to(dev), torch.from_numpy(segs).to(dev),
            s, (alpha, c, s)))
    odd = _rating_odd_shapes(rng)
    for segs, vals, s, exact, label in odd:
        errs.append(_rating_batch_checked(
            torch.from_numpy(vals).to(dev), torch.from_numpy(segs).to(dev),
            s, label, exact=exact))
    errs.append(check_rating_fm_shape(dev))
    r_pop, seg, c = _cohort_candidates(dev)
    alpha = r_pop.shape[0]
    errs.append(_rating_batch_checked(r_pop, seg, c, "ibm08_like"))
    ms = _graph_ms(lambda: rating.rating_segment_sum_batch(r_pop, seg, c))
    plain_ms = _time_ms(
        lambda: ref.rating_segment_sum_batch_ref(r_pop, seg, c))
    ids = (torch.arange(alpha, device=dev)[:, None] * c
           + seg.long()[None]).reshape(-1)
    flat = r_pop.reshape(-1)
    lib_ms = _time_ms(lambda: torch.zeros(
        alpha * c, dtype=torch.float32, device=dev).index_add_(0, ids, flat))
    bound, by = _bound_ms(4 * alpha * c + 4 * c + 4 * alpha * c, alpha * c)
    print(f"[kernel] rating_segment_sum_batch ibm08_like alpha={alpha} "
          f"C={c}: allclose rtol=1e-6, rows bit-equal to the scalar kernel, "
          f"bit-stable, at main-path, FM-step and {5 + len(odd)} odd "
          "shapes")
    for label, val in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
        print(f"[kernel] rating_segment_sum_batch {label} {val!r}")
    report["rating_segment_sum_batch"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)


def check_rating_kernel(report, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import rating, ref
    errs = []
    rng = np.random.default_rng(0)
    for c, s in ((512, 512), (3000, 700), (130, 1000), (4096, 64),
                 (100_003, 20_000)):
        segs = np.sort(rng.integers(0, s, c)).astype(np.int32)
        vals = (rng.random(c) + 0.1).astype(np.float32)
        segs[: min(c // 8, 7)] = -1
        segs_t, vals_t = (torch.from_numpy(segs).to(dev),
                          torch.from_numpy(vals).to(dev))
        got = rating.rating_segment_sum(vals_t, segs_t, s)
        again = rating.rating_segment_sum(vals_t, segs_t, s)
        want = ref.rating_segment_sum_ref(vals_t, segs_t, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        if not torch.equal(got, again):
            raise AssertionError(f"rating kernel not bit-stable at {(c, s)}")
        errs.append(float((got - want).abs().max()))
    r, seg, c = _coarsen_candidates(dev)
    got = rating.rating_segment_sum(r, seg, c)
    again = rating.rating_segment_sum(r, seg, c)
    want = ref.rating_segment_sum_ref(r, seg, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    if not torch.equal(got, again):
        raise AssertionError("rating kernel not bit-stable on ibm08_like")
    errs.append(float((got - want).abs().max()))
    lengths = torch.bincount(seg.long())
    ms = _graph_ms(lambda: rating.rating_segment_sum(r, seg, c))
    plain_ms = _time_ms(lambda: ref.rating_segment_sum_ref(r, seg, c))
    lib_ms = _time_ms(lambda: torch.segment_reduce(r, "sum", lengths=lengths))
    bound, by = _bound_ms(c * 8 + c * 4, c)
    print(f"[kernel] rating_segment_sum ibm08_like C={c}: allclose rtol=1e-6 "
          "and bit-stable at main-path and 5 odd shapes (the odd shapes of "
          "#4 run it row by row)")
    for label, val in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
        print(f"[kernel] rating_segment_sum {label} {val!r}")
    report["rating_segment_sum"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)


def _pin_inputs(design: str, k: int, seed: int, dev):
    """The design's padded pin matrix (``ops.edge_pin_matrix``), a seeded
    k-way partition, the instance's (integer) edge weights and seeded
    real weights, both zero on the pad rows."""
    import numpy as np
    import torch
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import ops
    hg = ispd_like(design, 1.0)
    pins = torch.from_numpy(ops.edge_pin_matrix(hg)).to(dev)
    rng = np.random.default_rng(seed)
    part = torch.from_numpy(rng.integers(0, k, hg.n).astype(np.int32)).to(dev)
    iw = np.zeros(pins.shape[0], np.float32)
    iw[: hg.m] = hg.edge_weights
    rw = np.zeros(pins.shape[0], np.float32)
    rw[: hg.m] = rng.random(hg.m) + 0.5
    return (hg, pins, part, torch.from_numpy(iw).to(dev),
            torch.from_numpy(rw).to(dev))


def _connectivity_checked(pins, part, iw, rw, k: int, what) -> float:
    """Kernels #7/#8 against their plain versions: lambda bit-equal, the
    cut of integer weights equal, of real weights within rel 1e-5 and
    bit-stable over two launches.  Returns the real cut's abs error."""
    import torch
    from repro_torch.kernels import connectivity, ref
    lam = connectivity.connectivity(pins, part, k)
    if not torch.equal(lam, ref.connectivity_ref(pins, part, k)):
        raise AssertionError(f"connectivity differs from its plain version "
                             f"at {what}")
    if not torch.equal(connectivity.cutsize(pins, part, iw, k),
                       ref.cutsize_ref(pins, part, iw, k)):
        raise AssertionError(f"cutsize (integer weights) differs from its "
                             f"plain version at {what}")
    got = connectivity.cutsize(pins, part, rw, k)
    again = connectivity.cutsize(pins, part, rw, k)
    want = ref.cutsize_ref(pins, part, rw, k)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"cutsize not bit-stable at {what}")
    err = abs(float(got) - float(want))
    if err > 1e-5 * abs(float(want)):
        raise AssertionError(f"cutsize {float(got)!r} vs plain "
                             f"{float(want)!r} at {what}")
    return err


# odd shapes (M, S, N, k, layout) of #7/#8 beyond the reference's
# sweeps: S = 1, 5 and 12 (one id a lane where S is not a multiple of 4)
# and 8, 64, 128 and 256 (16-byte loads, 256 in two rounds), M = 1 and M
# off the group, block and one-wave sizes, pins as the layout builder
# leaves them ("trailing") or pads anywhere ("mid"), rows all pad, ids
# >= N, block ids outside [0, k) ("bad blocks") at k = 1 and 32, and
# ("view") a pins view 4 bytes into its storage, off the 16-byte
# alignment
CUT_ODD = [
    (1, 1, 10, 2, "mid"), (1001, 1, 500, 3, "mid"), (3001, 5, 2000, 7, "mid"),
    (2049, 12, 1000, 32, "mid"), (1, 64, 10, 4, "trailing"),
    (4097, 8, 3000, 16, "trailing"), (33_799, 64, 40_000, 32, "trailing"),
    (777, 128, 5000, 32, "mid"), (515, 256, 5000, 32, "trailing"),
    (2000, 64, 800, 1, "bad blocks"), (2000, 8, 800, 32, "bad blocks"),
    (3001, 8, 2000, 32, "view"), (3001, 12, 2000, 32, "view"),
    (3001, 64, 2000, 32, "view")]


def _odd_cut_inputs(m, s, n, k, layout, rng, dev):
    import numpy as np
    import torch
    pins = rng.integers(0, n + n // 10 + 1, (m, s)).astype(np.int32)
    pins[rng.random((m, s)) < 0.4] = -1
    pins[rng.random(m) < 0.1] = -1                         # rows all pad
    if layout in ("trailing", "view"):
        pins = -np.sort(-pins, axis=1)
    lo, hi = (-3, k + 3) if layout == "bad blocks" else (0, k)
    part = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)
    if layout == "view":
        flat = torch.from_numpy(np.concatenate([[-1], pins.ravel()]).astype(
            np.int32)).to(dev)
        pins_t = flat[1:].view(m, s)
        if pins_t.data_ptr() % 16 != 4:
            raise AssertionError("the pins view is not 4 bytes off 16")
    else:
        pins_t = torch.from_numpy(pins).to(dev)
    iw = torch.from_numpy(rng.integers(0, 9, m).astype(np.float32)).to(dev)
    rw = torch.from_numpy((rng.random(m) + 0.5).astype(np.float32)).to(dev)
    return pins_t, part, iw, rw


def check_connectivity_kernels(report, dev):
    """Kernels #7/#8 at the reference's sweeps, at the odd shapes of
    ``CUT_ODD``, and at the pin matrices of ibm08_like (k=32) and
    ibm01_like (k=16); the cut also replayed in a CUDA graph.  Timed at
    ibm08_like: eager (20 launches between events), warm in a CUDA
    graph (the pins read from L2) and cold in one (``_graph_cold_ms``,
    the pins from device memory), which is ``ms``."""
    import numpy as np
    import torch
    from repro_torch.kernels import connectivity, ref
    rng = np.random.default_rng(7)
    errs = []
    sweep = [(512, 8, 300, 2), (512, 16, 1000, 8), (1024, 32, 4096, 32),
             (512, 128, 512, 17), (130, 8, 300, 5), (512, 8, 256, 4),
             (2048, 16, 2048, 16)]
    for m, s, n, k in sweep:
        pins = torch.from_numpy(rng.integers(-1, n, (m, s)).astype(
            np.int32)).to(dev)
        part = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)
        iw = torch.from_numpy(rng.integers(0, 9, m).astype(np.float32)).to(dev)
        rw = torch.from_numpy(rng.random(m).astype(np.float32)).to(dev)
        errs.append(_connectivity_checked(pins, part, iw, rw, k, (m, s, n, k)))
    for case in CUT_ODD:
        pins, part, iw, rw = _odd_cut_inputs(*case, rng, dev)
        errs.append(_connectivity_checked(pins, part, iw, rw, case[3], case))
    for design, k in (("ibm01_like", 16), ("ibm08_like", 32)):
        hg, pins, part, iw, rw = _pin_inputs(design, k, 0, dev)
        errs.append(_connectivity_checked(pins, part, iw, rw, k, design))
    # ibm08_like (the last one) is the timed shape; its cut replays bit
    # for bit in a CUDA graph
    eager = connectivity.cutsize(pins, part, rw, k)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = connectivity.cutsize(pins, part, rw, k)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(graphed, eager):
            raise AssertionError("cutsize replayed in a CUDA graph differs "
                                 "from its eager launch")
    del graph
    m, s = pins.shape
    valid = int((pins >= 0).sum())
    # each input read once, each output written once: the pin matrix, the
    # partition [n], then lambda [m] out, or w [m] in and the cut out
    in_bytes = m * s * 4 + part.shape[0] * 4
    cases = {
        "connectivity": (lambda x: connectivity.connectivity(x, part, k),
                         lambda: ref.connectivity_ref(pins, part, k),
                         in_bytes + m * 4, 0.0),
        "cutsize": (lambda x: connectivity.cutsize(x, part, rw, k),
                    lambda: ref.cutsize_ref(pins, part, rw, k),
                    in_bytes + m * 4 + 4, max(errs)),
    }
    for name, (kern, plain, nbytes, err) in cases.items():
        eager_ms = _time_ms(lambda: kern(pins))
        warm_ms = _graph_ms(lambda: kern(pins))
        ms = _graph_cold_ms(kern, pins)
        plain_ms = _time_ms(plain, iters=5)
        bound, by = _bound_ms(nbytes, valid)
        print(f"[kernel] {name} ibm08_like pins={tuple(pins.shape)} k={k}: "
              f"equal to its plain version at main-path, {len(sweep)} sweep "
              f"and {len(CUT_ODD)} odd shapes (cutsize: integer weights "
              "equal, real weights rel 1e-5, bit-stable over two launches "
              "and in a CUDA graph); ms is the cold graph time")
        for label, val in (("ms", ms), ("warm_graph_ms", warm_ms),
                           ("eager_ms", eager_ms), ("plain_ms", plain_ms),
                           ("library_ms", None), ("bound_ms", bound)):
            print(f"[kernel] {name} {label} {val!r}")
        report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=None)


def _dlrm_inputs(dev):
    """One DLRM embedding-bag batch: the concatenated table of the 26
    capped cardinalities (seeded normal values on the card) and ids drawn
    as the reference's click generator draws them (zipf 1.1 per table,
    offset into the concatenated table), about 5% of them set to -1."""
    import numpy as np
    import torch
    sizes = [min(t, DLRM_ROW_CAP) for t in DLRM_TABLE_SIZES]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rng = np.random.default_rng(0)
    idx = np.zeros((DLRM_BATCH, len(sizes)), np.int64)
    for t, size in enumerate(sizes):
        idx[:, t] = offs[t] + (rng.zipf(1.1, size=DLRM_BATCH) - 1) % size
    idx[rng.random(idx.shape) < 0.05] = -1
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((sum(sizes), DLRM_DIM), generator=gen, device=dev)
    return table, torch.from_numpy(idx.astype(np.int32)).to(dev)


def check_embedding_bag_kernel(report, dev):
    """Kernel #9 against its plain version at the DLRM shape (f32 sum and
    mean, bf16) and at the reference's sweep; timed at the DLRM shape
    beside ``torch.nn.functional.embedding_bag``."""
    import numpy as np
    import torch
    from repro_torch.kernels import embedding_bag, ref
    errs = []

    def checked(table, idx, combiner, what):
        tol = 1e-5 if table.dtype == torch.float32 else 2e-2
        got = embedding_bag.embedding_bag(table, idx, combiner)
        again = embedding_bag.embedding_bag(table, idx, combiner)
        want = ref.embedding_bag_ref(table, idx, combiner)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{what}: {m}")
        if not torch.equal(got, again):
            raise AssertionError(f"embedding_bag not bit-stable at {what}")
        if table.dtype == torch.float32:
            errs.append(float((got - want).abs().max()))

    rng = np.random.default_rng(9)
    sweep = [(100, 16, 8, 4, torch.float32, "sum"),
             (1000, 64, 32, 1, torch.float32, "sum"),
             (500, 32, 16, 8, torch.float32, "mean"),
             (100, 128, 8, 2, torch.bfloat16, "sum"),
             (300, 36, 7, 26, torch.bfloat16, "mean"),
             (257, 30, 1001, 5, torch.float32, "sum")]
    for r, d, b, l, dtype, combiner in sweep:
        table = torch.from_numpy(rng.normal(size=(r, d)).astype(
            np.float32)).to(dev, dtype)
        idx = torch.from_numpy(rng.integers(-1, r, (b, l)).astype(
            np.int32)).to(dev)
        checked(table, idx, combiner, (r, d, b, l, dtype, combiner))
    table, idx = _dlrm_inputs(dev)
    for combiner in ("sum", "mean"):
        checked(table, idx, combiner, f"DLRM {combiner}")
    half = table.to(torch.bfloat16)
    checked(half, idx, "sum", "DLRM bf16")
    del half
    b, l = idx.shape
    ms = _time_ms(lambda: embedding_bag.embedding_bag(table, idx))
    plain_ms = _time_ms(lambda: ref.embedding_bag_ref(table, idx), iters=3)
    ids = idx.clamp(min=0)
    weights = (idx >= 0).to(torch.float32)
    lib_ms = _time_ms(lambda: torch.nn.functional.embedding_bag(
        ids, table, mode="sum", per_sample_weights=weights))
    # each input read once: the distinct rows the valid ids name (the
    # skewed ids repeat rows, which a cache serves), the ids, the output
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    nbytes = distinct * DLRM_DIM * 4 + b * l * 4 + b * DLRM_DIM * 4
    bound, by = _bound_ms(nbytes, int((idx >= 0).sum()) * DLRM_DIM)
    print(f"[kernel] embedding_bag DLRM table={tuple(table.shape)} "
          f"idx={tuple(idx.shape)} ({distinct} distinct rows, "
          f"{float((idx < 0).float().mean())!r} pads): allclose 1e-5 (f32 "
          f"sum, mean), 2e-2 (bf16), bit-stable, at main-path and "
          f"{len(sweep)} sweep shapes")
    for label, val in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
        print(f"[kernel] embedding_bag {label} {val!r}")
    report["embedding_bag"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=lib_ms)
    del table, idx, ids, weights
    torch.cuda.empty_cache()


def check_fixed_order_sums(dev):
    """Every sum of mutation's real-valued reweights, twice on the card
    at ibm08_like shapes (alpha 7, rows ``w * (1 + 0.1 * C)``): the bits
    must agree.  ``index_add_``, which the fixed-order sums replace, is
    run twice too and reported."""
    import numpy as np
    import torch
    from repro_torch.core import hypergraph, metrics, refine
    from repro_torch.data.hypergraphs import ispd_like
    hg = ispd_like("ibm08_like", 1.0)
    hga = hg.arrays(device=dev)
    alpha, k = 7, 64
    rng = np.random.default_rng(3)
    ew = np.zeros((alpha, hga.m_pad), np.float32)
    ew[:, : hg.m] = hg.edge_weights * (
        1.0 + 0.1 * rng.integers(0, alpha, (alpha, hg.m)))
    ew = torch.from_numpy(ew).to(dev)
    parts = torch.from_numpy(rng.integers(0, k, (alpha, hga.n_pad)).astype(
        np.int32)).to(dev)

    def twice(what, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if not same:
            raise AssertionError(f"{what}: two runs on the card differ")
        return same

    cid = torch.arange(hga.n_pad, device=dev) // 2
    cid = torch.where(torch.arange(hga.n_pad, device=dev) < hg.n, cid,
                      hga.n_pad - 1)
    n_new = (hg.n + 1) // 2
    twice("contract_arrays(ew_pop=)", lambda: hypergraph.contract_arrays(
        hga, cid, n_new, ew_pop=ew)[2:])
    for path in ("segsum", "compact"):
        twice(f"gain assembly ({path}, ew_pop)",
              lambda: (metrics._gain_matrix_population_impl(
                  hga, parts, k, assemble=path, ew_pop=ew),))
    cap = refine._cap_for(hga, k, 0.03)
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    twice("graphed FM pass (edge_weights_pop)",
          lambda: refine._fm_pass_population_impl(
              hga, parts, k, cap, 2 * refine.FM_FLAG_EVERY, ew))
    # each pass: one eager warm-up step before the capture, then one #4
    # launch per step of every replay; the capture itself counts none
    n4 = ops.launch_counts()["rating_segment_sum_batch"]
    print(f"[determinism] two graphed FM passes of {2 * refine.FM_FLAG_EVERY}"
          f" steps: {n4} launches of rating_segment_sum_batch counted")
    if n4 % refine.FM_FLAG_EVERY != 2 or n4 < 2 + 2 * refine.FM_FLAG_EVERY:
        raise AssertionError(f"graphed FM passes counted {n4} launches of "
                             "#4, not 2 warm-ups plus 32 per replay")
    # the atomics the repair replaces, for the record: the segsum
    # assembly's per-vertex sums with ``index_add_``
    phi = metrics.pins_in_block_population(hga, parts, k)
    bi, _ = metrics._edge_gain_terms(hga, phi, ew)
    pe, pv = hga.pin_edge.long(), hga.pin_vertex.long()
    a, b = (torch.zeros((alpha, hga.n_pad, k), device=dev).index_add_(
        1, pv, bi[:, pe]) for _ in range(2))
    atomics_equal = bool(torch.equal(a, b))
    print("[determinism] ibm08_like alpha=7 k=64 reweighted rows: "
          "contract_arrays(ew_pop=), gain assembly (segsum, compact) and "
          "one graphed FM pass give equal bits in two runs; index_add_ "
          f"segsum gains equal in two runs: {atomics_equal}")
    del a, b
    torch.cuda.empty_cache()


CARD_TESTS = os.path.join("tests", "test_torch_card.py")


def run_card_tests() -> None:
    """Phase ``cardtests``: the tests marked ``cuda`` in
    ``tests/test_torch_card.py``, run by pytest in a child process on this
    card.  ``--noconftest`` keeps out ``tests/conftest.py``, which imports
    JAX (absent here).  Fails on any failure, error or skip, and when the
    run counts fewer passes than the module has cases marked ``cuda``
    (counted by a collection of the same selection)."""
    import xml.etree.ElementTree as ET
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p",
           "no:cacheprovider", "-m", "cuda", CARD_TESTS]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    listed = subprocess.run(cmd + ["--collect-only"], capture_output=True,
                            text=True, cwd=ROOT, env=env, timeout=300)
    marked = sum("::" in line for line in listed.stdout.splitlines())
    if listed.returncode != 0 or marked == 0:
        raise AssertionError(f"collecting {CARD_TESTS} exited "
                             f"{listed.returncode} with {marked} cases:\n"
                             f"{listed.stdout[-3000:]}{listed.stderr[-2000:]}")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        xml = os.path.join(tmp, "card.xml")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + [f"--junitxml={xml}"], capture_output=True,
                              text=True, cwd=ROOT, env=env, timeout=900)
        wall = time.perf_counter() - t0
        root = ET.parse(xml).getroot() if os.path.exists(xml) else None
    suite = root if root is None or root.tag == "testsuite" else root[0]
    count = {key: int(suite.get(key, 0)) if suite is not None else 0
             for key in ("tests", "failures", "errors", "skipped")}
    passed = (count["tests"] - count["failures"] - count["errors"]
              - count["skipped"])
    if (proc.returncode != 0 or count["failures"] or count["errors"]
            or count["skipped"] or passed < marked):
        raise AssertionError(
            f"card tests: exit {proc.returncode}, {count}, {marked} cases "
            f"marked cuda:\n{proc.stdout[-6000:]}{proc.stderr[-2000:]}")
    print(f"[cardtests] {passed} passed, {count['skipped']} skipped "
          f"({marked} cases marked cuda in {CARD_TESTS}; {wall!r} s)")


def check_small_parity():
    """A 600-vertex instance under host coarsening: the card (kernel gain
    path) and the CPU (plain path) must agree on every member."""
    import numpy as np
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.data.hypergraphs import _modular_netlist
    hg = _modular_netlist(600, 800, seed=11, n_modules=8, p_local=0.8,
                          fanout_tail=1.5)
    cfg = dict(k=8, eps=0.08, alpha=3, beta=2, seed=1,
               recombination_enabled=False, mutation_enabled=False,
               final_vcycles=0)
    os.environ["REPRO_COARSEN_PATH"] = "host"
    try:
        gpu = impart_partition(hg.structural_copy(), ImpartConfig(**cfg),
                               device="cuda")
        cpu = impart_partition(hg.structural_copy(), ImpartConfig(**cfg),
                               device="cpu")
    finally:
        os.environ.pop("REPRO_COARSEN_PATH")
    if not (np.array_equal(gpu.part, cpu.part) and gpu.cut == cpu.cut
            and gpu.population_cuts == cpu.population_cuts):
        raise AssertionError(f"card and CPU disagree: {gpu.population_cuts} "
                             f"vs {cpu.population_cuts}")
    print(f"[parity] 600-vertex k=8 host coarsening: card == CPU, cut "
          f"{gpu.cut!r}, gain paths card {gpu.gain_paths} cpu "
          f"{cpu.gain_paths}")


def host_lambda(hg, part, k: int):
    """lambda(e) of ``part`` in numpy."""
    import numpy as np
    eids = hg.pin_edge_ids().astype(np.int64)
    pairs = np.unique(eids * k + part[hg.pins].astype(np.int64))
    return np.bincount(pairs // k, minlength=hg.m)


def host_cut_and_balance(hg, part, k: int, eps: float):
    """Cut and balance of ``part`` recomputed in numpy."""
    import numpy as np
    lam = host_lambda(hg, part, k)
    cut = float(hg.edge_weights.astype(np.float64)[lam > 1].sum())
    bw = np.bincount(part, weights=hg.vertex_weights, minlength=k)
    cap = (1.0 + eps) * np.ceil(hg.vertex_weights.sum() / k)
    return cut, bool((bw <= cap + 1e-6).all() and part.max() < k
                     and part.min() >= 0), float(bw.max()), float(cap)


def card_cut_check(hg, part, k: int, host_cut: float, tag: str) -> dict:
    """The result's lambda and cut once more on the card, through the
    public ops on the design's pin matrix (kernels #7/#8 at k <= 32, the
    plain versions above, as ``ops`` routes them); both must equal the
    host's.  Zeroes the launch counters first (the caller has read its
    path's) and returns the check's own launches, which must include #7
    and #8 on the kernel route."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import KERNEL_MAX_K
    dev = torch.device("cuda")
    pins = torch.from_numpy(ops.edge_pin_matrix(hg)).to(dev)
    w = np.zeros(pins.shape[0], np.float32)
    w[: hg.m] = hg.edge_weights
    part_t = torch.from_numpy(np.asarray(part, np.int32)).to(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lam = ops.connectivity(pins, part_t, k)[: hg.m].cpu().numpy()
    cut = float(ops.cutsize(pins, part_t, torch.from_numpy(w).to(dev), k))
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    route = "kernel" if k <= KERNEL_MAX_K else "plain (k > KERNEL_MAX_K)"
    print(f"[cutcheck] {tag} k={k} ops.connectivity/ops.cutsize route "
          f"{route}: card cut {cut!r} host cut {host_cut!r}; the check's "
          f"launches {counts}")
    if cut != host_cut or not np.array_equal(lam, host_lambda(hg, part, k)):
        raise AssertionError(f"{tag}: card cut {cut} (or lambda) differs "
                             f"from the host's {host_cut}")
    if k <= KERNEL_MAX_K and not (counts.get("connectivity")
                                  and counts.get("cutsize")):
        raise AssertionError(f"{tag}: the check did not launch #7 and #8")
    return counts


def _add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def run_main_path(design: str, k: int, must_launch, eps: float = 0.03):
    import torch
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import ops
    hg = ispd_like(design, 1.0)
    cfg = ImpartConfig(k=k, eps=eps, alpha=7, beta=7,
                       recombination_enabled=False, mutation_enabled=False,
                       final_vcycles=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = impart_partition(hg, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    cut, balanced, bw_max, cap = host_cut_and_balance(hg, res.part, k, eps)
    check = card_cut_check(hg, res.part, k, cut, f"{design} memetic off")
    print(f"[main] {design} n={hg.n} m={hg.m} pins={hg.num_pins} k={k} "
          f"alpha={cfg.alpha}: levels {res.levels}")
    print(f"[main] {design} gain path per level (coarsest first): "
          f"{res.gain_paths}")
    print(f"[main] {design} wall_s {wall!r} cut {res.cut!r} host cut {cut!r} "
          f"max block weight {bw_max!r} cap {cap!r} launches {counts}")
    if cut != res.cut or not balanced:
        raise AssertionError(f"{design}: host cut {cut} vs {res.cut}, "
                             f"balanced={balanced}")
    missing = [n for n in must_launch if counts[n] == 0]
    if missing:
        raise AssertionError(f"{design}: kernels never launched on the main "
                             f"path: {missing}")
    _add_counts(counts, check)
    return counts, res.cut


class _Timed:
    """Wrap ``module.name`` so that every call is counted and timed on
    the host clock around synchronized work; ``restore`` undoes it."""

    def __init__(self, module, name: str):
        import torch
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls, self.seconds = 0, 0.0

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t
                self.calls += 1
        setattr(module, name, wrapped)

    def restore(self) -> None:
        setattr(self.module, self.name, self.fn)


def run_memetic_path(design: str, k: int, off_cut, must_launch,
                     cohort_launch=(), eps: float = 0.03, beta: int = 7):
    """``impart_partition`` with the reference defaults (recombination,
    mutation, one final V-cycle) on the card.  Counts the recombination
    branches by wrapping the module functions, and splits the wall time
    into recombination, mutation, final V-cycle and the rest.  The
    kernels of ``cohort_launch`` run only in a mutation cohort's V-cycle,
    so they are required when a mutation event re-partitioned one."""
    import torch
    from repro_torch.core import ilp, impart, mutate, recombine
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import ops
    hg = ispd_like(design, 1.0)
    cfg = ImpartConfig(k=k, eps=eps, alpha=7, beta=beta)
    wraps = {
        "recombine": _Timed(recombine, "recombine"),
        "exact": _Timed(ilp, "solve_exact"),
        "ils": _Timed(recombine, "_ils_clustered"),
        "vcycle": _Timed(recombine, "vcycle"),
        "mutation cohorts": _Timed(mutate, "vcycle_population"),
        "phase recombination": _Timed(impart, "ring_recombination"),
        "phase mutation": _Timed(impart, "mutate_population"),
        "phase final V-cycle": _Timed(impart, "vcycle"),
    }
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = impart_partition(hg, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for w in wraps.values():
            w.restore()
    counts = ops.launch_counts()
    cut, balanced, bw_max, cap = host_cut_and_balance(hg, res.part, k, eps)
    check = card_cut_check(hg, res.part, k, cut, f"{design} memetic")
    events = [t[2] for t in res.trace]
    n_rec = wraps["recombine"].calls
    branches = dict(exact=wraps["exact"].calls, ils=wraps["ils"].calls,
                    vcycle=wraps["vcycle"].calls)
    branches["identical parents"] = n_rec - sum(branches.values())
    phases = {n[len("phase "):]: w.seconds for n, w in wraps.items()
              if n.startswith("phase ")}
    phases["levels (coarsening, initial, refinement)"] = (
        wall - sum(phases.values()))
    print(f"[memetic] {design} n={hg.n} m={hg.m} k={k} eps={eps} alpha="
          f"{cfg.alpha} beta={cfg.beta} final_vcycles={cfg.final_vcycles}: "
          f"levels {res.levels}")
    print(f"[memetic] {design} wall_s {wall!r} cut {res.cut!r} host cut "
          f"{cut!r} memetic-off cut {off_cut!r} max block weight "
          f"{bw_max!r} cap {cap!r}")
    print(f"[memetic] {design} events {events}")
    print(f"[memetic] {design} recombinations {n_rec}: {branches}; "
          f"mutation events that re-partitioned a cohort: "
          f"{wraps['mutation cohorts'].calls} of {cfg.beta}")
    print(f"[memetic] {design} phase split (s): "
          + ", ".join(f"{n} {v!r}" for n, v in phases.items()))
    print(f"[memetic] {design} launches {counts}")
    if cut != res.cut or not balanced:
        raise AssertionError(f"{design}: host cut {cut} vs {res.cut}, "
                             f"balanced={balanced}")
    for tag in ("recombine@", "mutate@", "final-vcycle@0"):
        if not any(e.startswith(tag) for e in events):
            raise AssertionError(f"{design}: no {tag} event in the trace")
    if wraps["mutation cohorts"].calls:
        must_launch = tuple(must_launch) + tuple(cohort_launch)
    else:
        print(f"[memetic] {design}: no mutation event re-partitioned a "
              f"cohort, so {list(cohort_launch)} had nothing to run here")
    missing = [n for n in must_launch if counts[n] == 0]
    if missing:
        raise AssertionError(f"{design}: kernels never launched on the "
                             f"memetic path: {missing}")
    _add_counts(counts, check)
    return counts


_CLI_CHILD = """
import json, sys
from repro_torch.kernels import ops
from repro_torch.launch import partition
ops.reset_launch_counts()
partition.main(sys.argv[1:])
print("[launches] " + json.dumps(ops.launch_counts()), flush=True)
"""


def run_cli(design: str, k: int, must_launch, eps: float = 0.08):
    """The partition CLI's ``multilevel`` method in a child process (the
    CLI's ``main``, with the child's launch counters zeroed just before
    it and printed just after), then its saved assignment reloaded and
    its cut and balance recomputed in numpy."""
    import numpy as np
    from repro_torch.data.hypergraphs import ispd_like
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = os.path.join(tmp, "part.npy")
        args = ["--method", "multilevel", "--alpha", "1", "--scale", "1.0",
                "--design", design, "--k", str(k), "--eps", str(eps),
                "--out", out]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _CLI_CHILD, *args],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"[cli] {design} k={k} | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        part = np.load(out)
    counts = json.loads([ln for ln in proc.stdout.splitlines()
                         if ln.startswith("[launches] ")][-1][11:])
    printed = [ln for ln in proc.stdout.splitlines()
               if "multilevel: cut=" in ln][-1]
    printed_cut = float(printed.split("cut=")[1].split()[0])
    hg = ispd_like(design, 1.0)
    cut, balanced, bw_max, cap = host_cut_and_balance(hg, part, k, eps)
    print(f"[cli] {design} k={k} child wall_s {wall!r} host cut {cut!r} "
          f"printed cut {printed_cut!r} max block weight {bw_max!r} cap "
          f"{cap!r}")
    # the saved assignment's cut on the card, counted with the child's
    check = card_cut_check(hg, part, k, cut, f"CLI {design}")
    if cut != printed_cut or not balanced:
        raise AssertionError(f"CLI {design}: host cut {cut} vs printed "
                             f"{printed_cut}, balanced={balanced}")
    missing = [n for n in must_launch if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"CLI {design}: kernels never launched: "
                             f"{missing}")
    _add_counts(counts, check)
    return counts


def run_ops_path(must_launch):
    """The public kernel ops as a caller of ``repro_torch.kernels.ops``
    uses them: connectivity and cut of a seeded k=32 partition of
    ibm08_like's pin matrix, and one DLRM embedding bag.  Results are
    checked against numpy (lambda, cut) and the plain version (bag)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.common import KERNEL_MAX_K
    dev = torch.device("cuda")
    k = 32
    hg, pins, part, iw, _ = _pin_inputs("ibm08_like", k, 1, dev)
    table, idx = _dlrm_inputs(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lam = ops.connectivity(pins, part, k)
    cut = ops.cutsize(pins, part, iw, k)
    bag = ops.embedding_bag(table, idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    part_h = part.cpu().numpy()
    lam_h = host_lambda(hg, part_h, k)
    cut_h = float(hg.edge_weights.astype(np.float64)[lam_h > 1].sum())
    print(f"[ops] ibm08_like k={k} pins={tuple(pins.shape)}: "
          f"ops.connectivity and ops.cutsize route "
          f"{'kernel' if k <= KERNEL_MAX_K else 'plain'}; cut {float(cut)!r} "
          f"host cut {cut_h!r}")
    print(f"[ops] DLRM ops.embedding_bag route kernel: out "
          f"{tuple(bag.shape)} {bag.dtype}; wall_s of the three calls "
          f"{wall!r}; launches {counts}")
    if not (np.array_equal(lam[: hg.m].cpu().numpy(), lam_h)
            and bool((lam[hg.m:] == 0).all()) and float(cut) == cut_h):
        raise AssertionError("ops.connectivity/ops.cutsize disagree with "
                             "the host")
    if not bool(torch.isfinite(bag).all()):
        raise AssertionError("ops.embedding_bag returned non-finite values")
    torch.testing.assert_close(bag, ref.embedding_bag_ref(table, idx),
                               rtol=1e-5, atol=1e-5)
    # above KERNEL_MAX_K the ops take the plain versions, as the
    # reference's ops do
    part64 = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, hg.n).astype(np.int32)).to(dev)
    lam64 = ops.connectivity(pins, part64, 64)[: hg.m].cpu().numpy()
    if not np.array_equal(lam64, host_lambda(hg, part64.cpu().numpy(), 64)):
        raise AssertionError("ops.connectivity at k=64 disagrees with the "
                             "host")
    print("[ops] ibm08_like k=64: ops.connectivity route plain "
          "(k > KERNEL_MAX_K), lambda equal to the host's")
    missing = [n for n in must_launch if counts[n] == 0]
    if missing:
        raise AssertionError(f"ops path: kernels never launched: {missing}")
    del table, idx, bag
    torch.cuda.empty_cache()
    return counts


def run_sched_path(design: str, k: int, must_launch, cohort_launch=(),
                   eps: float = 0.03, beta: int = 7):
    """The bandit operator schedule, following the reference's
    equal-wall-clock protocol: the static schedule's wall W, a bandit run
    with ``time_budget_s=W``, and the replay of its trace after a JSON
    round-trip, which must give the live partition, cut, arm sequence and
    final V-cycle count bit for bit.  Every result's cut is recomputed on
    the host (balanced) and on the card (``card_cut_check``)."""
    import numpy as np
    import torch
    from repro_torch.core import impart, mutate
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.core.scheduler import SchedulerTrace
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import ops
    hg = ispd_like(design, 1.0)
    common = dict(k=k, eps=eps, alpha=7, beta=beta, seed=0, final_vcycles=1)
    total, path_total = {}, {}

    def drive(label, cfg):
        cohorts = _Timed(mutate, "vcycle_population")
        split = {"recombination": _Timed(impart, "ring_recombination"),
                 "mutation": _Timed(impart, "mutate_population"),
                 "final V-cycle": _Timed(impart, "vcycle")}
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = impart_partition(hg.structural_copy(), cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cohorts.restore()
            for w in split.values():
                w.restore()
        counts = ops.launch_counts()
        secs = {n: w.seconds for n, w in split.items()}
        secs["the rest (coarsening, initial, refinement)"] = (
            wall - sum(secs.values()))
        print(f"[sched] {design} {label} wall split (s): "
              + ", ".join(f"{n} {v!r}" for n, v in secs.items()))
        cut, balanced, bw_max, cap = host_cut_and_balance(hg, res.part, k,
                                                          eps)
        check = card_cut_check(hg, res.part, k, cut,
                               f"{design} sched {label}")
        _add_counts(total, counts)
        _add_counts(total, check)
        _add_counts(path_total, counts)
        print(f"[sched] {design} {label}: wall_s {wall!r} cut {res.cut!r} "
              f"host cut {cut!r} max block weight {bw_max!r} cap {cap!r} "
              f"degraded {res.degraded} mutation cohorts re-partitioned "
              f"{cohorts.calls} launches {counts}")
        if cut != res.cut or not balanced:
            raise AssertionError(f"sched {label}: host cut {cut} vs "
                                 f"{res.cut}, balanced={balanced}")
        return res, wall, cohorts.calls

    print(f"[sched] {design} n={hg.n} m={hg.m} k={k} eps={eps} alpha=7 "
          f"beta={beta} final_vcycles=1 seed=0")
    static, w_static, cohorts_static = drive(
        "static", ImpartConfig(sched="static", **common))
    live, w_live, cohorts = drive("bandit", ImpartConfig(
        sched="bandit", time_budget_s=w_static, **common))
    trace = live.sched_trace
    wire = json.loads(json.dumps(trace.to_json()))
    replay, w_replay, cohorts_replay = drive("replay", ImpartConfig(
        sched="bandit", sched_replay=SchedulerTrace.from_json(wire),
        **common))
    arms = trace.arm_sequence()
    mutate_pulls = arms.count("mutate")
    print(f"[sched] {design} decisions {len(arms)} final_vcycles "
          f"{trace.final_vcycles} histogram {json.dumps(trace.histogram())}")
    print(f"[sched] {design} arms {arms}")
    arm_walls = {}
    for d in trace.decisions:
        arm_walls[d.arm] = arm_walls.get(d.arm, 0.0) + d.wall_s
    print(f"[sched] {design} bandit wall per arm (s, from the trace): "
          f"{json.dumps(arm_walls)}")
    print(f"[sched] {design} walls static {w_static!r} bandit {w_live!r} "
          f"replay {w_replay!r}; cuts static {static.cut!r} bandit "
          f"{live.cut!r} replay {replay.cut!r}; mutate pulls {mutate_pulls}, "
          f"of which re-partitioned a cohort: {cohorts} (replay "
          f"{cohorts_replay})")
    if not (np.array_equal(replay.part, live.part) and replay.cut == live.cut
            and replay.sched_trace.arm_sequence() == arms
            and replay.sched_trace.final_vcycles == trace.final_vcycles):
        raise AssertionError("the replayed bandit run differs from the live "
                             "one")
    print(f"[sched] {design} replay == live: partition, cut, arm sequence "
          "and final V-cycles bit-equal")
    if cohorts_static + cohorts + cohorts_replay:
        must_launch = tuple(must_launch) + tuple(cohort_launch)
    missing = [n for n in must_launch if path_total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"sched path: kernels never launched: "
                             f"{missing}")
    return total


_COST_CHILD = """
import json, sys, time
import torch
from repro_torch.core import impart, mutate
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.data.hypergraphs import ispd_like
spans = {"mutation": 0.0, "cohorts": 0}
inner, cohort = impart.mutate_population, mutate.vcycle_population

def timed(*a, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        return inner(*a, **kw)
    finally:
        torch.cuda.synchronize()
        spans["mutation"] += time.perf_counter() - t

def counted(*a, **kw):
    spans["cohorts"] += 1
    return cohort(*a, **kw)

impart.mutate_population, mutate.vcycle_population = timed, counted
hg = ispd_like("ibm01_like", 1.0)
cfg = ImpartConfig(k=16, eps=0.03, alpha=7, beta=7, seed=0)
torch.cuda.synchronize()
t0 = time.perf_counter()
res = impart_partition(hg, cfg, device="cuda")
torch.cuda.synchronize()
spans["wall"] = time.perf_counter() - t0
spans["cut"] = res.cut
print("[cost] " + json.dumps(spans), flush=True)
"""


def run_repair_cost(parent_src: str) -> None:
    """What the fixed-order sums of mutation's reweighted rows cost: the
    static memetic run of the ``sched`` phase (ibm01_like, k 16, the
    reference defaults, seed 0) with its mutation seconds, in child
    processes on the package at ``parent_src`` (a tree before the repair,
    whose card sums use ``index_add_``) and on this one, in the order
    parent, this, this, parent."""
    here = os.path.join(ROOT, "src")
    for label, src in (("parent", parent_src), ("this", here),
                       ("this", here), ("parent", parent_src)):
        proc = subprocess.run([sys.executable, "-c", _COST_CHILD],
                              capture_output=True, text=True, cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=src),
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"repair-cost run on {src} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("[cost] ")][-1]
        print(f"[cost] ibm01_like k=16 static memetic, {label} ({src}): "
              f"{line[7:]}")


_LEVEL_FIELDS = ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
                 "edge_sizes")


def _gain_level(dev):
    """The first level with at most ``FM_NODE_LIMIT`` vertices of the
    ibm01_like hierarchy (k 16, seed 0) that the device coarsener builds
    with its dense incidence layout: a coarse level of the LP rounds that
    launch #1."""
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.data.hypergraphs import ispd_like
    hier = build_hierarchy(ispd_like("ibm01_like", 1.0), 16, seed=0,
                           path="device", device=dev)
    return next(hga for hga in map(hier.level_arrays,
                                   range(hier.num_levels))
                if hga.n <= FM_NODE_LIMIT and hga.incident is not None)


def _level_dict(hga) -> dict:
    return dict({f: getattr(hga, f).cpu() for f in _LEVEL_FIELDS},
                incident=(None if hga.incident is None
                          else hga.incident.cpu()), n=hga.n, m=hga.m)


def _level_arrays(d: dict, dev):
    from repro_torch.core.hypergraph import HypergraphArrays
    inc = d["incident"]
    return HypergraphArrays(*(d[f].to(dev) for f in _LEVEL_FIELDS),
                            n=d["n"], m=d["m"],
                            incident=None if inc is None else inc.to(dev))


def save_fm_level(path: str) -> None:
    """``_fm_level``'s level, Phi and rows, and ``_gain_level``'s level,
    to ``path``: the hierarchies depend on the rating kernel's bits, so
    trees compared on one card read the levels built once, here."""
    import torch
    dev = torch.device("cuda")
    hga, phi, ew, k = _fm_level(dev)
    torch.save(dict(fm=_level_dict(hga), phi=phi.cpu(), ew=ew.cpu(), k=k,
                    gain=_level_dict(_gain_level(dev))), path)


def load_fm_level(path: str, dev):
    import torch
    d = torch.load(path)
    return (_level_arrays(d["fm"], dev), d["phi"].to(dev), d["ew"].to(dev),
            d["k"])


def load_gain_level(path: str, dev):
    import torch
    return _level_arrays(torch.load(path)["gain"], dev)


def kernel_times(level_path: str) -> dict:
    """Times of the kernels this tree's ``repro_torch`` redesigned (#1 to
    #8) at the shapes the kernel phase times them, #4 at the FM step's
    shape (the level saved by ``save_fm_level``; the kernel alone and the
    whole ``_gain_segsum`` with member rows), and #1 at k 32 and at the
    coarse level saved there, all in a CUDA graph (``_graph_ms``); #7 and
    #8 both warm (the pins read from L2) and cold (``_graph_cold_ms``).
    Uses only calls that older trees of the port have too."""
    import torch
    from repro_torch.core import metrics
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import connectivity, gain, rating
    dev = torch.device("cuda")
    out = {}
    _, pins, part, _, rw = _pin_inputs("ibm08_like", 32, 0, dev)
    for name, kern in (
            ("connectivity", lambda x: connectivity.connectivity(x, part,
                                                                 32)),
            ("cutsize", lambda x: connectivity.cutsize(x, part, rw, 32))):
        out[f"{name} warm (graph)"] = _graph_ms(lambda: kern(pins))
        out[f"{name} cold (graph)"] = _graph_cold_ms(kern, pins)
    del pins, part, rw
    hga, phi, ew, _ = load_fm_level(level_path, dev)
    rows, vertex = _fm_rows(hga, phi, ew)
    n_pad = hga.n_pad
    out["rating_segment_sum_batch FM step (graph)"] = _graph_ms(
        lambda: rating.rating_segment_sum_batch(rows, vertex, n_pad))
    out["_gain_segsum FM step (graph)"] = _graph_ms(
        lambda: metrics._gain_segsum(hga, phi, ew))
    r_pop, seg, c = _cohort_candidates(dev)
    out["rating_segment_sum_batch"] = _graph_ms(
        lambda: rating.rating_segment_sum_batch(r_pop, seg, c))
    r, seg1, c1 = _coarsen_candidates(dev)
    out["rating_segment_sum"] = _graph_ms(
        lambda: rating.rating_segment_sum(r, seg1, c1))
    hg = ispd_like("ibm08_like", 1.0)
    inc, bi, wi = _gain_inputs(hg, 64, 7, 0, dev)
    out["gain_stream"] = _graph_ms(
        lambda: gain.gain_stream_batch(inc, bi, wi))
    del bi, wi
    inc, bi, wi = _gain_inputs(hg, 64, 1, 0, dev)
    bi, wi = bi[0], wi[0]
    out["gain_stream_one"] = _graph_ms(lambda: gain.gain_stream(inc, bi, wi))
    hg = ispd_like("ibm01_like", 1.0)
    for k in (16, 32):
        inc, bi, wi = _gain_inputs(hg, k, 7, 0, dev)
        out[f"gain_table k={k}"] = _graph_ms(
            lambda: gain.gain_gather_batch(inc, bi, wi))
    inc, bi, wi = _gain_inputs(hg, 16, 1, 0, dev)
    bi, wi = bi[0], wi[0]
    out["gain_table_one"] = _graph_ms(lambda: gain.gain_gather(inc, bi, wi))
    inc, bi, wi = _gain_tables(load_gain_level(level_path, dev), 16, 7, 0,
                               dev)
    out[f"gain_table coarse n={inc.shape[0]} D={inc.shape[1]}"] = _graph_ms(
        lambda: gain.gain_gather_batch(inc, bi, wi))
    return out


_TIMES_CHILD = """
import json, sys
import chip_smoke
print("[times] " + json.dumps(chip_smoke.kernel_times(sys.argv[1])),
      flush=True)
"""


def run_kernel_compare(parent_src: str) -> None:
    """``kernel_times`` on the package at ``parent_src`` (an older tree)
    and on this one, in child processes on this card, in the order
    parent, this, this, parent; then each time's mean per tree and the
    parent's mean over this tree's."""
    import torch
    from repro_torch.data.hypergraphs import ispd_like
    here = os.path.join(ROOT, "src")
    runs = {"parent": [], "this": []}
    level = tempfile.NamedTemporaryFile(suffix=".pt", dir=ROOT, delete=False)
    level.close()
    try:
        save_fm_level(level.name)
        dev = torch.device("cuda")
        inc, bi, _ = _gain_tables(load_gain_level(level.name, dev), 16, 7,
                                  0, dev)
        print(f"[compare] gain_table coarse n={inc.shape[0]} "
              f"D={inc.shape[1]} bound_ms {_gain_bound(inc, bi)[0]!r}")
        inc, bi, _ = _gain_inputs(ispd_like("ibm01_like", 1.0), 32, 7, 0, dev)
        print(f"[compare] gain_table k=32 bound_ms "
              f"{_gain_bound(inc, bi)[0]!r}")
        del inc, bi
        _, pins, part, _, _ = _pin_inputs("ibm08_like", 32, 0, dev)
        m, s = pins.shape
        nbytes = m * s * 4 + part.shape[0] * 4 + m * 4
        valid = int((pins >= 0).sum())
        print(f"[compare] connectivity bound_ms "
              f"{_bound_ms(nbytes, valid)[0]!r}, cutsize bound_ms "
              f"{_bound_ms(nbytes + 4, valid)[0]!r}")
        del pins, part
        for label, src in (("parent", parent_src), ("this", here),
                           ("this", here), ("parent", parent_src)):
            proc = subprocess.run(
                [sys.executable, "-c", _TIMES_CHILD, level.name],
                capture_output=True, text=True, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=src), timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"kernel times on {src} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[times] ")][-1]
            print(f"[compare] {label} ({src}): {line[8:]}")
            runs[label].append(json.loads(line[8:]))
    finally:
        os.unlink(level.name)
    for name in runs["this"][0]:
        mean = {lab: sum(r[name] for r in rs) / len(rs)
                for lab, rs in runs.items()}
        print(f"[compare] {name}: parent {mean['parent']!r} ms, this "
              f"{mean['this']!r} ms, parent/this "
              f"{mean['parent'] / mean['this']!r}")


def profile_main_path(design: str, k: int, eps: float = 0.03,
                      device: str = "cuda") -> None:
    """Phase breakdown of one main-path run, mirroring the driver's loop
    (``impart_partition``) step by step with a synchronize around each
    phase."""
    import torch
    from repro_torch.core import refine
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.core.initial_partition import \
        initial_partition_population
    from repro_torch.data.hypergraphs import ispd_like
    hg = ispd_like(design, 1.0)
    spans = {"coarsen": 0.0, "initial": 0.0, "lp": 0.0, "fm": 0.0}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spans[name] += time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    hier = timed("coarsen", build_hierarchy, hg, k, seed=0, device=device)
    top = hier.num_levels - 1
    parts, _ = timed("initial", initial_partition_population,
                     hier.level_host(top), k, eps, seeds=list(range(7)),
                     tries_per_strategy=1, hga=hier.level_arrays(top))
    fm_levels = 0
    for li in range(top, -1, -1):
        if li < top:
            parts = hier.project_pop(parts, li + 1)
        hga = hier.level_arrays(li)
        parts, cuts = timed("lp", refine.lp_refine_population, hga, parts,
                            k, eps, max_iters=16)
        if hga.n <= 4096:
            fm_levels += 1
            parts, cuts = timed("fm", refine.fm_refine_population, hga,
                                parts, k, eps)
    wall = time.perf_counter() - t0
    print(f"[profile] {design} k={k} wall_s {wall!r} best cut "
          f"{float(min(cuts))!r} FM levels {fm_levels}: "
          + ", ".join(f"{n} {v!r} s" for n, v in spans.items()))


def trace_main_path(design: str, k: int, eps: float = 0.03,
                    device: str = "cuda") -> None:
    """``torch.profiler`` trace of one main-path run: the device's busy
    time (sum of kernel self times) against the wall, and the kernels
    that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.data.hypergraphs import ispd_like
    hg = ispd_like(design, 1.0)
    cfg = ImpartConfig(k=k, eps=eps, alpha=7, beta=7,
                       recombination_enabled=False, mutation_enabled=False,
                       final_vcycles=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        impart_partition(hg, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator's device time repeats its kernels'
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[trace] {design} k={k} wall_s (traced) {wall!r} device busy s "
          f"{busy!r} busy share {busy / wall!r}")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        print(f"[trace] {design} {dev_us / 1e3:.3f} ms  {count} calls  "
              f"{key[:90]}")


def main() -> int:
    import torch
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"[build] {time.perf_counter() - t0!r} s "
          f"({', '.join(f'{k}: {v:.1f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        log = build.lib_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"[build] {name}: {line.strip()}")

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    phases = PHASES
    for arg in sys.argv[1:]:
        if arg.startswith("--phases="):
            phases = tuple(p for p in arg.split("=", 1)[1].split(",") if p)
    unknown = set(phases) - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2

    report = {}
    if "kernels" in phases:
        check_gain_kernels(report, dev)
        check_gain_one_kernels(report, dev)
        check_rating_kernel(report, dev)
        check_rating_batch_kernel(report, dev)
        check_connectivity_kernels(report, dev)
        check_embedding_bag_kernel(report, dev)
        check_fixed_order_sums(dev)
    if "cardtests" in phases:
        run_card_tests()
    if "parity" in phases:
        check_small_parity()
    launches = {name: 0 for name in KERNEL_META}

    def add(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)

    off_cut = None
    if "off" in phases or "memetic" in phases:
        for design, k, must in (("ibm08_like", 64, ("gain_stream",
                                                     "rating_segment_sum")),
                                ("ibm01_like", 16, ("gain_table",
                                                    "rating_segment_sum"))):
            if design != "ibm08_like" and "off" not in phases:
                continue
            counts, cut = run_main_path(design, k, must)
            add(counts)
            if design == "ibm08_like":
                off_cut = cut
    if "memetic" in phases:
        add(run_memetic_path("ibm08_like", 64, off_cut,
                             ("rating_segment_sum", "gain_stream"),
                             ("rating_segment_sum_batch",)))
    if "cli" in phases:
        for design, k, must in (("ibm08_like", 64, ("gain_stream_one",)),
                                ("ibm01_like", 16, ("gain_table_one",))):
            add(run_cli(design, k, must))
    if "ops" in phases:
        add(run_ops_path(("connectivity", "cutsize", "embedding_bag")))
    if "sched" in phases:
        # #8 comes from the phase's card-side cut checks, which fail
        # unless they launch it
        add(run_sched_path("ibm01_like", 16, ("gain_table",
                                              "rating_segment_sum"),
                           ("rating_segment_sum_batch",)))
    if "--profile" in sys.argv[1:]:
        for design, k in (("ibm08_like", 64), ("ibm01_like", 16)):
            profile_main_path(design, k)
        trace_main_path("ibm08_like", 64)
    for arg in sys.argv[1:]:
        if arg.startswith("--repair-cost="):
            run_repair_cost(os.path.abspath(arg.split("=", 1)[1]))
        if arg.startswith("--kernel-compare="):
            run_kernel_compare(os.path.abspath(arg.split("=", 1)[1]))
    if set(phases) != set(PHASES):
        print(f"[smoke] ran phases {list(phases)} only: no result line")
        return 3

    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        print(f"chip_smoke: kernels no main path launched: {idle}",
              file=sys.stderr)
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **report[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
