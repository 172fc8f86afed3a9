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
   imports JAX, which this machine need not have) beside phases 5 to 9;
   any failure, error or skip, or fewer passes than cases marked
   ``cuda``, fails the phase;
5. a small instance refined on the card and on the CPU under host
   coarsening must give the same partition and cut;
6. the memetic-off paths: ``impart_partition`` without recombination,
   mutation and V-cycle on ``ispd_like("ibm08_like")`` at k=64 (stream
   gain kernel) and on ``ispd_like("ibm01_like")`` at k=16 (table gain
   kernel);
7. the memetic path: ``impart_partition`` on ``ibm08_like`` at k=64 with
   the reference defaults (alpha 7, recombination, mutation, one final
   V-cycle) but beta ``MEMETIC_BETA`` (1, not 7), with its recombination
   branches counted and its time split into recombination, mutation,
   final V-cycle and the rest;
8. the partition CLI: ``python -m repro_torch.launch.partition --method
   multilevel`` in two child processes started at once, on
   ``ibm08_like`` (k=64, one-member stream kernel) and ``ibm01_like``
   (k=16, one-member table kernel); each saved assignment is reloaded
   and checked;
9. the public kernel ops (``kernels.ops.connectivity``, ``cutsize`` and
   ``embedding_bag``): connectivity and cut of a k=32 partition of
   ``ibm08_like``'s pin matrix, and one DLRM embedding bag (26 sparse
   features x 65,536 bags, D=128, the MLPerf cardinalities capped at
   2**20 rows);
10. the bandit operator schedule on ``ibm01_like`` (k=16, the reference
   defaults but beta ``SCHED_BETA``, 1): the static schedule's wall W, a ``sched="bandit"`` run with
   ``time_budget_s=W``, and the replay of its trace after a JSON
   round-trip, which must give the live partition, cut and arm sequence
   bit for bit;
11. the instance axis (``impart_partition_instances``, DESIGN.md §12):
   the reference service benchmark's mixed request stream (its first
   ``INSTANCE_STREAM`` requests of ``request_stream(tag="bench")``,
   alpha 4, lp_iters 8, the reference defaults otherwise) and three ISPD98-sized requests
   (ibm01/02/03_like at k 16/12/32, memetic operators off), grouped by
   shape bucket on ``grid=(1024, 4096, 16384, 65536)``, every request
   bit-equal to its solo ``impart_partition``; one ``refine_grouped``
   call alone, which must launch the ``table`` gain kernel; and the
   grouped bandit on the stream's first ``INSTANCE_BANDIT`` (2) requests,
   its traces replayed grouped and solo, bit for bit;
12. incremental repartitioning (``incremental_partition``, DESIGN.md
   §14) on ``ibm08_like`` at k=64 with the knobs of the reference's
   incremental benchmark (alpha 4, lp_iters 8, migration_frac 0.15,
   drift magnitude 0.15): a zero-drift refresh (cold, then resident,
   bit-equal to a solve without state), four weight-drift steps
   (replayed, with no coarsening round; a second state fed the same
   stream must give the same bits), a pin edit (patched) and the weight
   drift after it (replayed), and a k-change to 32 (resident, launching
   the ``table`` gain kernel); every answer balanced, within its
   migration budget and no worse than its incumbent;
13. the partition service (``PartitionService``, DESIGN.md §12-13): the
   reference service benchmark's 12 requests (4 slots, alpha 4,
   lp_iters 8) in a warm pass and at offered loads of 1 and 4
   requests/s, every answer bit-equal to its ``solve_solo`` (run in child
   processes beside the warm pass), with p50/p99 latency per load;
   ibm01/02/03_like, ibm08_like at k 64 and an incremental refresh of
   ibm08 in one 4-slot service, each bit-equal to solo and checked on the
   host and on the card; and the reference's robustness soak (six fault
   plans, device loss included), every fault fired, every request in a
   terminal state and every completed answer bit-equal to solo, and its
   device-loss plan once more over 2 logical shards of the card on the
   ``mesh`` and ``chunk`` routes (the pool shrinks to one in mid-run);
   and F5's grouping (ibm01_like beside ibm08_like cold and its refresh,
   admitted at once), each answer bit-equal to solo;
13b. the population axis over a pool of logical shards of the card
   (``popshard.set_logical_shards``, the counterpart of the reference's
   forced host devices; DESIGN.md §11): ``refine_population`` under the
   ``mesh`` route at a pool of 1 and the ``mesh`` and ``chunk`` routes at
   pools of 2 and 4, on ibm01_like (k 16, the finest level and the first
   FM level) and ibm08_like (k 64), with integer weights and mutation's
   real-valued member rows; ``ring_partners`` over the shards; the
   memetic ``impart_partition`` on ibm01_like over 4 shards; and
   ``impart_partition_instances`` on the three ISPD98-sized requests
   under both routes over 4 shards; all bit-equal to the ``off`` route,
   each route's wall printed beside the card;
13c. the model axis (``model_shard="mesh"``, DESIGN.md §15) over (pop,
   model) grids of logical shards: both refinement tiers on ibm01_like
   and ibm08_like levels (#4 on every pin block for member rows, no
   #1/#2), the sharded contraction of ``device_coarsen`` (ibm08_like) and
   ``population_coarsen`` (ibm01_like, 7 members), the n = 10**6
   ``giant_netlist`` that exceeds a device-memory budget unsharded and
   completes sharded (its cut recounted through #7/#8), and the
   population step over (pop 4, model 2); all bit-equal to the
   replicated route;
14. the placement substrate's serving path (``repro_torch.models``,
   ``repro_torch.apps.placement``): DLRM at the MLPerf width (each table
   capped at ``SUBSTRATE_ROW_CAP`` rows) at serve_p99, serve_bulk and
   retrieval_cand, its user bag through #9 bit-equal to the bag-order
   sum and its p99 logits equal to a CPU run; the three placements
   (DLRM rows into 64 shards, a GNN graph into 16 devices, MoE experts
   into 4 pods) on the card, each cut equal to its host recount and
   balanced; the GNN zoo at its published widths on full_graph_sm
   (equal to a CPU run), molecule and graphsage-reddit's sampled
   minibatch;
15. LM serving (``repro_torch.models.transformer``,
   ``repro_torch.serve.ServeSession``; no kernel of the port on its
   path): (i) codeqwen1.5-7b and phi3.5-moe-42b-a6.6b at full width
   with 2 layers in f32, prefill logits and decode steps on the card
   equal to the same module on the CPU; (ii) greedy ``generate`` of that
   dense model equal to prefill's argmax at every generated position;
   (iii) each in bf16 at its published widths (codeqwen whole, phi with
   16 of its 32 layers; ``LM_RUNS``): ``generate`` on a ``TokenStream``
   prompt, every logit finite and each step's cache row written at
   ``pos`` with later rows zero, with time to first token, decode ms a
   step, tokens/s beside the step's byte bound; ``score`` with [B] finite
   values, its ms and TFLOP/s (``launch.analytic.model_flops``); the
   peak device memory of each;
16. training (``repro_torch.train.steps``, ``optim.adamw``, the flash
   backward; ``launch.train``): (i) one train step of codeqwen1.5-7b
   and phi3.5-moe-42b-a6.6b at full width with 1 layer in f32, and of
   grok-1's SMOKE config with int8 moments, on the card equal to the
   same step on the CPU (loss, grad_norm, lr, every parameter and
   moment); (ii)-(iii) codeqwen with 8 of its 32 layers and phi with 2
   in bf16 at train_4k's 4,096 tokens (``TRAIN_LM``: global batch 8 and
   4 in the config's 4 microbatches), a warm-up, 3 timed steps and a
   traced one, with ms, tokens/s, TFLOP/s (``model_flops``) against the
   bf16 peak, peak memory, the device's busy share and top kernels;
   (iv) the GNN zoo's train cells (full_graph_sm, molecule,
   graphsage-reddit's minibatch_lg); (v) DLRM at the MLPerf widths
   (tables capped at 2**20 rows) at train_batch's 65,536 samples, the
   dense and the sparse step, the sparse one run twice from one state
   to the same bits, its duplicate-row sums through #4 (held against
   its plain version at that shape); (vi) the train CLI in child
   processes, a run resumed from its checkpoint equal to an unbroken
   one bit for bit.  Every loss and grad_norm finite, every leaf moved.

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
``kernels,cardtests,parity,off,memetic,cli,ops,sched,instances,incremental,service,popshard,modelshard,substrate,lm,train``
(default: all; empty for none) for runs that debug one phase; the kernels line is only printed
when every phase ran.  ``--repair-cost=DIR`` then times the static
memetic run of the ``sched`` phase with its mutation seconds on the
package under ``DIR`` (the ``src`` of a tree before the fixed-order sums
of mutation's reweights) and on this one, in child processes, in the
order DIR, this, this, DIR; ``--kernel-compare=DIR`` times the kernels
redesigned since such a tree (``kernel_times``: #1 to #8 at the kernel
phase's shapes, #4 also at the FM step's shape, #7 and #8 warm and cold,
all in a CUDA graph) on DIR and on this one, in the same order; it may
be given more than once.  ``--solo-compare=DIR`` runs the ``off`` and
``cli`` phases of the script of the tree at ``DIR`` and of this one, in
child processes, in the same order, and prints their walls.  With
``--profile`` the script
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

import atexit
import gc
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
          "sched", "instances", "incremental", "service", "popshard",
          "modelshard", "substrate", "lm", "train")

# the largest level FM refines (``refine.refine_population``'s default)
FM_NODE_LIMIT = 4096

# recombination rounds of the memetic path (the reference default is 7)
# and of the sched phase's three runs (static, bandit, replay), cut to
# keep the whole script well inside its 1,200 s with the substrate
# phase: on one H100 host it took 1,199 s of command at 7 and 7, and
# 1,128 s at 5 and 3; both went to 1 beside the popshard phase (the
# script took 1,386 s at 1 and 3 with it on one H100 host; at 3 the
# memetic ibm08 run took 104.3 s, 102.5 s of it recombination, and a
# sched run 44.8-49.2 s)
MEMETIC_BETA = 1
SCHED_BETA = 1

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


def _dlrm_draws(idx, rows: int) -> dict:
    """The probe's id draws at the DLRM shape, each with ``idx``'s pads:
    every id the same row (L1 hits after the first: latency and issue
    only), ids uniform over all ``rows`` (no reuse: each read from device
    memory) and the zipf draw ``idx`` itself."""
    import torch
    pads = idx < 0
    gen = torch.Generator(device=idx.device).manual_seed(1)
    uniform = torch.randint(0, rows, idx.shape, generator=gen,
                            device=idx.device, dtype=torch.int32)
    return {"same row": torch.full_like(idx, rows // 2).masked_fill(pads, -1),
            "uniform": uniform.masked_fill(pads, -1), "zipf": idx}


def _embedding_bag_bound(table, idx):
    """(bound ms, what bounds it): each input read once, the distinct rows
    the valid ids name (the skewed ids repeat rows, which a cache serves),
    the ids and the output; one add per value of a valid id."""
    import torch
    b, l = idx.shape
    d, elem = table.shape[1], table.element_size()
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    nbytes = distinct * d * elem + b * l * 4 + b * d * elem
    return _bound_ms(nbytes, int((idx >= 0).sum()) * d)


def embedding_bag_times(table, idx) -> dict:
    """#9 at the DLRM shape in a CUDA graph with the ids rotated over
    copies that exceed twice the L2 (``_graph_cold_ms``; the 3.8 GB table
    exceeds it anyway): f32 and bf16 sums of the zipf draw, then the f32
    sum of the probe's other draws (``_dlrm_draws``)."""
    import torch
    from repro_torch.kernels import embedding_bag
    out = {}
    half = table.to(torch.bfloat16)
    for label, tab in (("f32", table), ("bf16", half)):
        out[f"embedding_bag {label} sum zipf (graph, cold ids)"] = \
            _graph_cold_ms(lambda x: embedding_bag.embedding_bag(tab, x), idx)
    del half
    for draw, ids in _dlrm_draws(idx, table.shape[0]).items():
        if draw != "zipf":
            out[f"embedding_bag f32 sum {draw} (graph, cold ids)"] = \
                _graph_cold_ms(
                    lambda x: embedding_bag.embedding_bag(table, x), ids)
    torch.cuda.empty_cache()
    return out


def _bag_order_sum(table, idx, combiner: str):
    """The f32 sum over each bag's valid ids in bag order, rounded once to
    the table's dtype (``mean``: then divided by L, correctly rounded):
    what #9 computes, bit for bit."""
    import torch
    r, l = table.shape[0], idx.shape[1]
    acc = torch.zeros((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(l):
        ids = idx[:, j]
        acc = torch.where((ids >= 0)[:, None],
                          acc + table[ids.clamp(0, r - 1).long()].float(), acc)
    if combiner == "mean":
        acc = acc / torch.full_like(acc, l)
    return acc.to(table.dtype)


def check_embedding_bag_kernel(report, dev):
    """Kernel #9 against its plain version and, bit for bit, the bag-order
    sum at the DLRM shape (f32 sum and mean, bf16) and at the reference's
    sweep; timed at the DLRM shape eagerly and in a CUDA graph with the
    ids cold (``embedding_bag_times``), beside
    ``torch.nn.functional.embedding_bag`` timed the same way."""
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
        if not torch.equal(got, _bag_order_sum(table, idx, combiner)):
            raise AssertionError(f"embedding_bag differs from the bag-order "
                                 f"sum at {what}")
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
    eager_ms = _time_ms(lambda: embedding_bag.embedding_bag(table, idx))
    graph = embedding_bag_times(table, idx)
    ms = graph["embedding_bag f32 sum zipf (graph, cold ids)"]
    plain_ms = _time_ms(lambda: ref.embedding_bag_ref(table, idx), iters=3)
    # the library call's operands, rotated as the kernel's ids are: the
    # clamped ids and, bit-cast, the 0/1 weights that drop the pads
    lib_in = torch.stack([idx.clamp(min=0),
                          (idx >= 0).to(torch.float32).view(torch.int32)])
    lib_ms = _graph_cold_ms(lambda x: torch.nn.functional.embedding_bag(
        x[0], table, mode="sum", per_sample_weights=x[1].view(
            torch.float32)), lib_in)
    bound, by = _embedding_bag_bound(table, idx)
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    print(f"[kernel] embedding_bag DLRM table={tuple(table.shape)} "
          f"idx={tuple(idx.shape)} ({distinct} distinct rows, "
          f"{float((idx < 0).float().mean())!r} pads): allclose 1e-5 (f32 "
          f"sum, mean), 2e-2 (bf16), bit-equal to the bag-order sum and "
          f"bit-stable, at main-path and "
          f"{len(sweep)} sweep shapes; ms is the f32 sum in a CUDA graph "
          "with the ids cold (library_ms the same way)")
    for label, val in (("ms", ms), ("eager_ms", eager_ms),
                       ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", bound), ("share_of_bound", bound / ms)):
        print(f"[kernel] embedding_bag {label} {val!r}")
    for label, val in graph.items():
        print(f"[kernel] {label} {val!r}")
    report["embedding_bag"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=lib_ms)
    del table, idx, lib_in
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
    # each pass: one launch for its starting cut (the fixed-order sum of
    # the member rows), one eager warm-up step before the capture, then
    # one #4 launch per step of every replay; the capture counts none
    n4 = ops.launch_counts()["rating_segment_sum_batch"]
    print(f"[determinism] two graphed FM passes of {2 * refine.FM_FLAG_EVERY}"
          f" steps: {n4} launches of rating_segment_sum_batch counted")
    if n4 % refine.FM_FLAG_EVERY != 4 or n4 < 4 + 2 * refine.FM_FLAG_EVERY:
        raise AssertionError(f"graphed FM passes counted {n4} launches of "
                             "#4, not 2 starting cuts, 2 warm-ups and 32 "
                             "per replay")
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


class CardTests:
    """Phase ``cardtests``: the tests marked ``cuda`` in
    ``tests/test_torch_card.py``, run by pytest in a child process on this
    card, started by the constructor and checked by ``finish``, so the
    phases between run beside it.  ``--noconftest`` keeps out
    ``tests/conftest.py``, which imports JAX (absent here).  Fails on any
    failure, error or skip, and when the run counts fewer passes than the
    module has cases marked ``cuda`` (counted by a collection of the same
    selection)."""

    def __init__(self):
        cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p",
               "no:cacheprovider", "-m", "cuda", CARD_TESTS]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        listed = subprocess.run(cmd + ["--collect-only"],
                                capture_output=True, text=True, cwd=ROOT,
                                env=env, timeout=300)
        self.marked = sum("::" in line for line in listed.stdout.splitlines())
        if listed.returncode != 0 or self.marked == 0:
            raise AssertionError(
                f"collecting {CARD_TESTS} exited {listed.returncode} with "
                f"{self.marked} cases:\n{listed.stdout[-3000:]}"
                f"{listed.stderr[-2000:]}")
        self.tmp = tempfile.TemporaryDirectory(dir=ROOT)
        self.xml = os.path.join(self.tmp.name, "card.xml")
        self.log = open(os.path.join(self.tmp.name, "card.log"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd + [f"--junitxml={self.xml}"],
                                     cwd=ROOT, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        # a phase that fails before ``finish`` must not leave it running
        atexit.register(self.stop)

    def finish(self) -> None:
        import xml.etree.ElementTree as ET
        try:
            rc = self.proc.wait(timeout=900)
            wall = time.perf_counter() - self.t0
            self.log.seek(0)
            out = self.log.read()
            root = (ET.parse(self.xml).getroot()
                    if os.path.exists(self.xml) else None)
        finally:
            self.stop()
        suite = root if root is None or root.tag == "testsuite" else root[0]
        count = {key: int(suite.get(key, 0)) if suite is not None else 0
                 for key in ("tests", "failures", "errors", "skipped")}
        passed = (count["tests"] - count["failures"] - count["errors"]
                  - count["skipped"])
        if (rc != 0 or count["failures"] or count["errors"]
                or count["skipped"] or passed < self.marked):
            raise AssertionError(
                f"card tests: exit {rc}, {count}, {self.marked} cases "
                f"marked cuda:\n{out[-8000:]}")
        print(f"[cardtests] {passed} passed, {count['skipped']} skipped "
              f"({self.marked} cases marked cuda in {CARD_TESTS}; {wall!r} "
              "s, beside the phases parity to ops)")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()
            self.tmp.cleanup()


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


def card_cut_check(hg, part, k: int, host_cut: float, tag: str,
                   rel: float = 0.0) -> dict:
    """The result's lambda and cut once more on the card, through the
    public ops on the design's pin matrix (kernels #7/#8 at k <= 32, the
    plain versions above, as ``ops`` routes them); lambda must equal the
    host's, and the cut too, or be within ``rel`` of it for real-valued
    weights (the card adds f32, the host float64).  Zeroes the launch
    counters first (the caller has read its path's) and returns the
    check's own launches, which must include #7 and #8 on the kernel
    route."""
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
    if (abs(cut - host_cut) > rel * abs(host_cut)
            or not np.array_equal(lam, host_lambda(hg, part, k))):
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


def run_cli(runs, eps: float = 0.08):
    """The partition CLI's ``multilevel`` method in a child process per
    ``(design, k, must_launch)`` of ``runs``, all started at once (the
    CLI's ``main``, with the child's launch counters zeroed just before
    it and printed just after), then each saved assignment reloaded and
    its cut and balance recomputed in numpy.  Returns the launches of
    every run and of its cut check."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    started = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        try:
            for design, k, _ in runs:
                out = os.path.join(tmp, f"{design}.npy")
                args = ["--method", "multilevel", "--alpha", "1", "--scale",
                        "1.0", "--design", design, "--k", str(k), "--eps",
                        str(eps), "--out", out]
                started.append((subprocess.Popen(
                    [sys.executable, "-c", _CLI_CHILD, *args],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=env, cwd=ROOT), out, time.perf_counter()))
            total = {}
            for (design, k, must), (proc, out, t0) in zip(runs, started):
                stdout, stderr = proc.communicate(timeout=600)
                _add_counts(total, _cli_result(
                    design, k, must, eps, proc.returncode, stdout, stderr,
                    out, time.perf_counter() - t0))
        finally:
            for proc, _, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return total


def _cli_result(design: str, k: int, must_launch, eps: float, rc: int,
                stdout: str, stderr: str, out: str, wall: float) -> dict:
    """One CLI child's output, its saved assignment at ``out`` and its
    cut on the host and on the card, checked; returns its launches."""
    import numpy as np
    from repro_torch.data.hypergraphs import ispd_like
    for line in stdout.splitlines():
        print(f"[cli] {design} k={k} | {line}")
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {stderr[-2000:]}")
    part = np.load(out)
    counts = json.loads([ln for ln in stdout.splitlines()
                         if ln.startswith("[launches] ")][-1][11:])
    printed = [ln for ln in stdout.splitlines()
               if "multilevel: cut=" in ln][-1]
    printed_cut = float(printed.split("cut=")[1].split()[0])
    hg = ispd_like(design, 1.0)
    cut, balanced, bw_max, cap = host_cut_and_balance(hg, part, k, eps)
    print(f"[cli] {design} k={k} child wall_s {wall!r} (beside the other "
          f"child) host cut {cut!r} printed cut {printed_cut!r} max block "
          f"weight {bw_max!r} cap {cap!r}")
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
    _SHARED_RUNS[("sched static", design, k, eps, beta)] = static
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


# the instance phase: the reference service benchmark's request stream
# (``BENCH_service.json``: 12 requests, alpha 4, lp_iters 8), of which
# (a) groups the first INSTANCE_STREAM and (d) the first INSTANCE_BANDIT,
# to keep the script inside its time limit beside the service, substrate,
# lm and train phases (the 12 took 770 s grouped and solo on the H100,
# and the first 6 191.6 s grouped, almost all of it in each request's own
# recombinations and mutations; (d) on the first 4 took 65.0 s live and
# 60.9 s replayed; (a) on the first 3 took 102.8 s grouped, most of it
# the third, bench-2's 620 vertices at k 6, so (a) takes 2 beside the
# train phase), and the serving buckets of its grid
INSTANCE_REQUESTS = 6
# single-device runs that a later phase holds its routes to: the static
# memetic run of ``sched`` (``popshard`` (c))
_SHARED_RUNS: dict = {}
INSTANCE_STREAM = 2
INSTANCE_BANDIT = 2
INSTANCE_GRID = (1024, 4096, 16384, 65536)
INSTANCE_ISPD = (("ibm01_like", 16), ("ibm02_like", 12), ("ibm03_like", 32))
# child processes that run the stream's solo comparisons beside the
# grouped run they are compared with
INSTANCE_CHILDREN = 3


class _GroupLog:
    """Wrap ``instances.refine_grouped`` as the ladder drivers of
    ``core.impart`` call it (not the V-cycles), so that each call (one
    lockstep step, or one bandit arm's group) records its requests, the
    stacks ``dispatch_groups`` makes of them, and the gain path of each
    stack's union; ``restore`` undoes it."""

    def __init__(self, grid):
        import types
        from repro_torch.core import impart, instances
        from repro_torch.kernels import ops
        self.module, self.steps = impart, []
        self.fn = instances.refine_grouped

        def wrapped(entries, *a, **kw):
            stacks = []
            for idx in instances.dispatch_groups(entries, grid):
                inc = [entries[i][0].incident for i in idx]
                k_pad = max(instances.k_bucket(entries[i][2]) for i in idx)
                layout = None if any(x is None for x in inc) else inc[0]
                stacks.append((len(idx), ops.gain_path(0, k_pad, layout)))
            self.steps.append((len(entries), stacks))
            return self.fn(entries, *a, **kw)
        impart.instances_mod = types.SimpleNamespace(refine_grouped=wrapped)

    def restore(self) -> None:
        from repro_torch.core import instances
        self.module.instances_mod = instances

    def summary(self) -> str:
        return "; ".join(
            f"step {t}: {n} requests in {len(st)} stacks "
            + "+".join(f"{c}({p})" for c, p in st)
            for t, (n, st) in enumerate(self.steps))


_SOLO_CHILD = """
import json, sys, time
import torch
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.core.scheduler import SchedulerTrace
from repro_torch.data.hypergraphs import request_stream
spec = json.load(open(sys.argv[1]))
reqs = request_stream(spec["count"], tag="bench", scale=1.0)
out = []
for job in spec["jobs"]:
    cfg = dict(job["cfg"])
    if cfg.get("sched_replay") is not None:
        cfg["sched_replay"] = SchedulerTrace.from_json(cfg["sched_replay"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = impart_partition(reqs[job["index"]]["hg"], ImpartConfig(**cfg),
                           device="cuda")
    torch.cuda.synchronize()
    out.append(dict(index=job["index"], wall=time.perf_counter() - t0,
                    part=res.part.tolist(), cut=res.cut,
                    population_cuts=res.population_cuts,
                    arms=(None if res.sched_trace is None
                          else res.sched_trace.arm_sequence())))
json.dump(out, open(sys.argv[2], "w"))
"""


# the solo ISPD98 runs of the instances phase's (b): ``cfg`` names the
# design beside the config's keywords
_ISPD_SOLO_CHILD = """
import json, sys, time
import torch
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.data.hypergraphs import ispd_like
spec = json.load(open(sys.argv[1]))
out = []
for job in spec["jobs"]:
    cfg = dict(job["cfg"])
    hg = ispd_like(cfg.pop("design"), 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = impart_partition(hg, ImpartConfig(**cfg), device="cuda")
    torch.cuda.synchronize()
    out.append(dict(index=job["index"], wall=time.perf_counter() - t0,
                    part=res.part.tolist(), cut=res.cut,
                    population_cuts=res.population_cuts))
json.dump(out, open(sys.argv[2], "w"))
"""


class _SoloChildren:
    """Solo runs of stream requests on the card, in ``procs`` child
    processes started at once (request j in child j % procs), so they run
    beside the grouped run they are compared with.  ``code`` is the
    child's program (default ``impart_partition`` runs), ``count`` the
    length of the ``request_stream`` it draws from; ``jobs`` holds
    ``(request index, config keywords)``; ``results`` waits and returns
    ``{index: result dict}``; ``stop`` ends any child still running and
    removes the children's files."""

    def __init__(self, jobs, procs: int, label: str, code: str = _SOLO_CHILD,
                 count: int = INSTANCE_REQUESTS):
        import tempfile
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="solo-", dir=os.path.join(
            ROOT, "build"))
        self.label, self.procs = label, []
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        for c in range(min(procs, len(jobs))):
            spec = os.path.join(self.dir, f"{c}.json")
            with open(spec, "w") as f:
                json.dump(dict(count=count, jobs=[
                    dict(index=i, cfg=cfg) for i, cfg in jobs[c::procs]]), f)
            out = os.path.join(self.dir, f"{c}.out.json")
            log = open(os.path.join(self.dir, f"{c}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", code, spec, out], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT), out, log))

    def results(self, timeout: float = 900.0) -> dict:
        got = {}
        for proc, out, log in self.procs:
            rc = proc.wait(timeout=timeout)
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"{self.label}: a solo child exited "
                                     f"{rc}: {tail}")
            with open(out) as f:
                got.update({r["index"]: r for r in json.load(f)})
        return got

    def stop(self) -> None:
        import shutil
        for proc, _, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def run_instances_path(must_launch):
    """Phase ``instances``: the instance axis on the card (DESIGN.md §12).

    (a) the first ``INSTANCE_STREAM`` requests of the reference service
    benchmark's mixed stream through
    ``impart_partition_instances`` (static schedule, the reference
    defaults with alpha 4 and lp_iters 8), every request bit-equal to its
    solo ``impart_partition`` and checked on the host and on the card;
    the solo runs go in ``INSTANCE_CHILDREN`` child processes on the
    card beside the grouped run, so their walls are not walls alone;
    (b) three ISPD98-sized requests at full published size, memetic
    operators off, the same bar, the solo runs in ``INSTANCE_CHILDREN``
    child processes beside the grouped run (so neither wall is a wall
    alone); (c) one
    ``refine_grouped`` call on the first levels with n <= 4,096 of the
    three requests' hierarchies, which must launch the ``table`` gain
    kernel and equal each entry's solo ``refine_population``; (d) the
    grouped bandit live on the first ``INSTANCE_BANDIT`` requests of (a),
    each request's trace replayed through the grouped driver and solo (in child
    processes beside the grouped replay), both bit-equal to the live
    run.  Returns the launches of (a), (b) and (d) and of their cut
    checks."""
    import numpy as np
    import torch
    from repro_torch.core import instances, refine
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.core.impart import (ImpartConfig, impart_partition,
                                         impart_partition_instances)
    from repro_torch.core.scheduler import SchedulerTrace
    from repro_torch.data.hypergraphs import ispd_like, request_stream
    from repro_torch.kernels import ops
    total, path_total = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts()

    def grouped(label, hgs, cfgs):
        log = _GroupLog(INSTANCE_GRID)
        try:
            res, wall, counts = timed(lambda: impart_partition_instances(
                hgs, cfgs, grid=list(INSTANCE_GRID), device="cuda"))
        finally:
            log.restore()
        _add_counts(total, counts)
        _add_counts(path_total, counts)
        print(f"[instances] {label} grouped: wall_s {wall!r}, "
              f"{len(log.steps)} lockstep steps, launches {counts}")
        print(f"[instances] {label} stacks per step: {log.summary()}")
        return res, wall

    def check_request(label, i, hg, cfg, res, solo, w):
        cut, balanced, bw_max, cap = host_cut_and_balance(
            hg, res.part, cfg.k, cfg.eps)
        _add_counts(total, card_cut_check(hg, res.part, cfg.k, cut,
                                          f"{label} request {i}"))
        same = (np.array_equal(res.part, np.asarray(solo["part"]))
                and res.cut == solo["cut"]
                and res.population_cuts == solo["population_cuts"])
        print(f"[instances] {label} request {i} n={hg.n} m={hg.m} "
              f"k={cfg.k} eps={cfg.eps}: levels {res.levels} cut "
              f"{res.cut!r} host cut {cut!r} max block weight {bw_max!r} "
              f"cap {cap!r}; solo wall_s {w!r} cut {solo['cut']!r}; "
              f"grouped == solo (part, cut, population cuts): {same}")
        if not same or cut != res.cut or not balanced:
            raise AssertionError(f"{label} request {i}: grouped {res.cut} "
                                 f"vs solo {solo['cut']}, host {cut}, "
                                 f"balanced={balanced}")

    # (a) the mixed request stream, its solo runs in child processes
    reqs = request_stream(INSTANCE_REQUESTS, tag="bench", scale=1.0)
    hgs = [r["hg"] for r in reqs]
    kws = [dict(k=r["k"], eps=r["eps"], alpha=4, lp_iters=8, sched="static")
           for r in reqs]
    children = _SoloChildren(list(enumerate(kws[:INSTANCE_STREAM])),
                             INSTANCE_CHILDREN, "stream")
    try:
        res_a, wall_a = grouped("stream", hgs[:INSTANCE_STREAM],
                                [ImpartConfig(**kw)
                                 for kw in kws[:INSTANCE_STREAM]])
        solos = children.results()
    finally:
        children.stop()
    for i, (hg, kw, res) in enumerate(zip(hgs, kws, res_a)):
        check_request("stream", i, hg, ImpartConfig(**kw), res, solos[i],
                      solos[i]["wall"])
    print(f"[instances] stream walls: grouped {wall_a!r} s; solo runs in "
          f"{INSTANCE_CHILDREN} child processes beside it, sum "
          f"{sum(s['wall'] for s in solos.values())!r} s (not walls alone)")

    # (b) ISPD98-sized requests, memetic operators off, solo runs in
    # child processes beside the grouped run
    ispd = [ispd_like(name, 1.0) for name, _ in INSTANCE_ISPD]
    ispd_kw = [dict(k=k, eps=0.03, alpha=7, sched="static",
                    recombination_enabled=False, mutation_enabled=False)
               for _, k in INSTANCE_ISPD]
    ispd_cfgs = [ImpartConfig(**kw) for kw in ispd_kw]
    children = _SoloChildren(
        [(i, dict(design=name, **kw))
         for i, ((name, _), kw) in enumerate(zip(INSTANCE_ISPD, ispd_kw))],
        INSTANCE_CHILDREN, "instances ispd", _ISPD_SOLO_CHILD)
    try:
        res_b, wall_b = grouped("ispd", ispd, ispd_cfgs)
        solos_b = children.results()
    finally:
        children.stop()
    for i, (hg, cfg, res) in enumerate(zip(ispd, ispd_cfgs, res_b)):
        check_request("ispd", i, hg, cfg, res, solos_b[i],
                      solos_b[i]["wall"])
    print(f"[instances] ispd walls: grouped {wall_b!r} s; solo runs in "
          f"{INSTANCE_CHILDREN} child processes beside it, sum "
          f"{sum(s['wall'] for s in solos_b.values())!r} s (not walls "
          "alone)")

    # (c) one grouped refinement on its own
    entries, solos_c = [], []
    for (name, k), hg in zip(INSTANCE_ISPD, ispd):
        hier = build_hierarchy(hg, k, seed=0, device="cuda")
        li = min(i for i in range(hier.num_levels)
                 if hier.level_n(i) <= FM_NODE_LIMIT)
        hga = hier.level_arrays(li)
        rng = np.random.default_rng(li)
        vw = hga.vertex_weights[: hga.n].cpu().numpy()
        parts = refine.pad_parts(np.stack([refine.rebalance(
            vw, rng.integers(0, k, hga.n).astype(np.int32), k, 0.03)
            for _ in range(7)]), hga.n_pad, "cuda")
        entries.append((hga, parts, k, 0.03))
        solos_c.append(refine.refine_population(hga, parts.clone(), k, 0.03,
                                                device="cuda"))
        print(f"[instances] refine_grouped input {name} k={k}: level {li} "
              f"n={hga.n} n_pad={hga.n_pad} layout "
              f"{None if hga.incident is None else tuple(hga.incident.shape)}")
    outs, wall, counts = timed(lambda: instances.refine_grouped(
        entries, grid=INSTANCE_GRID, device="cuda"))
    stacks = [[entries[i][2] for i in idx]
              for idx in instances.dispatch_groups(entries, INSTANCE_GRID)]
    same = all(torch.equal(gp, sp) and np.array_equal(gc, sc)
               for (gp, gc), (sp, sc) in zip(outs, solos_c))
    print(f"[instances] refine_grouped alone: stacks by k {stacks}, wall_s "
          f"{wall!r}, launches {counts}; == solo refine_population: {same}")
    if not same or not counts["gain_table"]:
        raise AssertionError("refine_grouped alone: differs from solo or "
                             "launched no gain_table")

    # (d) the grouped bandit, replayed grouped and solo (children)
    bandit = [dict(kw, sched="bandit") for kw in kws[:INSTANCE_BANDIT]]
    live, wall, counts = timed(lambda: impart_partition_instances(
        hgs[:INSTANCE_BANDIT], [ImpartConfig(**kw) for kw in bandit],
        grid=list(INSTANCE_GRID), device="cuda"))
    _add_counts(total, counts)
    _add_counts(path_total, counts)
    traces = [json.loads(json.dumps(r.sched_trace.to_json())) for r in live]
    replay_kws = [dict(kw, sched_replay=tr) for kw, tr in zip(bandit, traces)]
    children = _SoloChildren(list(enumerate(replay_kws)), 2, "bandit")
    try:
        again, wall_r, _ = timed(lambda: impart_partition_instances(
            hgs[:INSTANCE_BANDIT], [ImpartConfig(**dict(
                kw, sched_replay=SchedulerTrace.from_json(tr)))
                for kw, tr in zip(bandit, traces)],
            grid=list(INSTANCE_GRID), device="cuda"))
        solos = children.results()
    finally:
        children.stop()
    for i, (res, rep) in enumerate(zip(live, again)):
        arms, solo = res.sched_trace.arm_sequence(), solos[i]
        ok = (np.array_equal(rep.part, res.part) and rep.cut == res.cut
              and rep.sched_trace.arm_sequence() == arms
              and np.array_equal(np.asarray(solo["part"]), res.part)
              and solo["cut"] == res.cut and solo["arms"] == arms)
        print(f"[instances] bandit request {i}: live cut {res.cut!r}, "
              f"{len(arms)} decisions; grouped replay cut {rep.cut!r}, solo "
              f"replay cut {solo['cut']!r}; replays == live: {ok}")
        if not ok:
            raise AssertionError(f"bandit request {i}: a replay differs "
                                 "from the live grouped run")
    print(f"[instances] bandit walls: live grouped {wall!r} s, grouped "
          f"replay {wall_r!r} s (beside the solo replays); launches of the "
          f"live run {counts}")
    missing = [n for n in must_launch if path_total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"instances path: kernels never launched: "
                             f"{missing}")
    return total


# the incremental phase: ISPD98 ibm08 at its published counts, and the
# knobs of the reference's incremental benchmark (BENCH_incremental.json)
INCR_DESIGN, INCR_K, INCR_EPS, INCR_K_LOSS = "ibm08_like", 64, 0.08, 32
INCR_DRIFT, INCR_STEPS = 0.15, 4
# drifted weights are real-valued: the card adds the cut in f32, the host
# in float64
INCR_REL = 1e-5


def sum_route_cost(hg, inc) -> None:
    """What the fixed-order sums of drifted weights cost: one
    ``refine_population`` of an incumbent population (alpha 4) on the
    coarsest level of a hierarchy of ``hg`` (drifted) built around
    ``inc``, timed with the level's real-weight flags (rating kernels
    #3/#4) and with them cleared (``index_add_``, whose order of addition
    varies between runs), in the order fixed, plain, plain, fixed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import refine
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.kernels import ops
    hier = build_hierarchy(hg, INCR_K, seed=0, restrict_part=inc,
                           device="cuda")
    li = hier.num_levels - 1
    real = hier.level_arrays(li)
    plain = dataclasses.replace(real, real_edge_weights=False,
                                real_vertex_weights=False)
    part = torch.as_tensor(hier.level_part(li)).cpu().numpy()
    parts = refine.pad_parts(np.stack([part] * 4), real.n_pad, "cuda")
    walls = []
    for lv in (real, plain, plain, real):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine.refine_population(lv, parts.clone(), INCR_K, INCR_EPS,
                                 max_iters=8, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    path = ops.gain_path(real.m_pad, INCR_K, real.incident)
    layouts = [hier.level_arrays(i).incident is not None
               for i in range(hier.num_levels)]
    print(f"[incremental] hierarchy of a drifted step: sizes {hier.sizes()}, "
          f"incidence layout per level {layouts}")
    print(f"[incremental] refinement of the coarsest drifted level {li} "
          f"(n={real.n}, LP gain path {path}, FM "
          f"{'on' if real.n <= FM_NODE_LIMIT else 'off'}): wall_s "
          f"fixed-order {walls[0]!r}, index_add_ {walls[1]!r}, index_add_ "
          f"{walls[2]!r}, fixed-order {walls[3]!r} (real flags "
          f"{real.real_edge_weights}; single runs)")


def run_incremental_path(must_launch):
    """Phase ``incremental``: incremental repartitioning on the card
    (DESIGN.md §14), through ``incremental_partition`` and
    ``repartition_k_change`` with one ``IncrementalState``.

    (a) the incumbent: ``impart_partition`` at k 64, eps 0.08, alpha 4,
    lp_iters 8, recombination, mutation and V-cycle off; (b) zero drift:
    cold, then resident, bit-equal to a solve without state; (c) four
    steps of ``drift_stream`` (magnitude 0.15), each warm with the
    previous answer as its incumbent: replayed, with no round of the
    device coarsener, beside a solve without state of the same step
    (walls printed, not gated), and fed again through a second state
    primed at zero drift, which must give the same parts and cuts bit
    for bit; (d) a pin edit (patched) and the weight drift after it
    (replayed); (e) a k-change to 32 (resident, the same budget, the
    ``table`` gain kernel).  Every answer is balanced, within its budget,
    no worse than its incumbent on its weights, and its cut agrees on
    the host, in the result and on the card.  Returns the launches of
    the solves and of their cut checks."""
    import numpy as np
    import torch
    from repro_torch.core import dcoarsen
    from repro_torch.core.hypergraph import is_real_valued
    from repro_torch.core.impart import ImpartConfig, impart_partition
    from repro_torch.core.incremental import (IncrementalConfig,
                                              IncrementalState,
                                              incremental_partition,
                                              repartition_k_change)
    from repro_torch.data.hypergraphs import drift_stream, ispd_like
    from repro_torch.kernels import ops
    total = {}
    rounds = [0]
    real_round = dcoarsen._coarsen_round

    def counted_round(*a, **kw):
        rounds[0] += 1
        return real_round(*a, **kw)

    def solve(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rounds[0] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        _add_counts(total, counts)
        return out, wall, counts, rounds[0]

    def short(counts):
        return {n: counts[n] for n in ("gain_table", "gain_stream",
                                       "rating_segment_sum",
                                       "rating_segment_sum_batch")}

    def check(tag, hg_i, inc_i, res, k, budget):
        cut, balanced, bw_max, cap = host_cut_and_balance(hg_i, res.part, k,
                                                          INCR_EPS)
        inc_cut = host_cut_and_balance(hg_i, inc_i, k, INCR_EPS)[0]
        vw = hg_i.vertex_weights.astype(np.float64)
        moved = float(vw[res.part != inc_i].sum())
        _add_counts(total, card_cut_check(hg_i, res.part, k, cut, tag,
                                          rel=INCR_REL))
        print(f"[incremental] {tag}: {res.reused}, cut {res.cut!r} host cut "
              f"{cut!r} incumbent cut {inc_cut!r}, migration {moved!r} of "
              f"budget {res.budget_weight!r}, max block weight {bw_max!r} "
              f"cap {cap!r}, levels {res.levels}")
        if (not balanced or abs(cut - res.cut) > INCR_REL * cut
                or res.cut > inc_cut * (1 + INCR_REL)
                or moved > budget + 1e-3
                or abs(moved - res.migration_weight) > 1e-3):
            raise AssertionError(f"incremental {tag}: balanced={balanced}, "
                                 f"cut {res.cut} host {cut} incumbent "
                                 f"{inc_cut}, migration {moved} budget "
                                 f"{budget}")

    hg = ispd_like(INCR_DESIGN, 1.0)
    cfg = IncrementalConfig(k=INCR_K, eps=INCR_EPS, alpha=4, lp_iters=8,
                            migration_frac=0.15, seed=0)
    budget = 0.15 * float(hg.vertex_weights.sum())
    dcoarsen._coarsen_round = counted_round
    try:
        # (a) the incumbent
        base, wall, counts, _ = solve(lambda: impart_partition(
            hg, ImpartConfig(k=INCR_K, eps=INCR_EPS, alpha=4, lp_iters=8,
                             recombination_enabled=False,
                             mutation_enabled=False, final_vcycles=0),
            device="cuda"))
        inc = base.part.astype(np.int32)
        cut, balanced = host_cut_and_balance(hg, inc, INCR_K, INCR_EPS)[:2]
        _add_counts(total, card_cut_check(hg, inc, INCR_K, cut,
                                          "incremental incumbent"))
        print(f"[incremental] {INCR_DESIGN} n={hg.n} m={hg.m} "
              f"pins={hg.num_pins} k={INCR_K}: incumbent wall_s {wall!r} "
              f"cut {base.cut!r} host cut {cut!r}; launches {short(counts)}")
        if cut != base.cut or not balanced:
            raise AssertionError("incremental incumbent: host cut or balance")

        # (b) zero drift: cold, resident, and a solve without state
        st = IncrementalState()
        out = {}
        for tag, state in (("cold", st), ("resident", st), ("none", None)):
            res, wall, counts, nr = solve(lambda: incremental_partition(
                hg, inc, cfg, state=state, device="cuda"))
            out[tag] = res
            print(f"[incremental] zero drift {tag}: reused {res.reused}, "
                  f"wall_s {wall!r}, coarsening rounds {nr}, launches "
                  f"{short(counts)}")
            check(f"zero drift {tag}", hg, inc, res, INCR_K, budget)
        same = (np.array_equal(out["resident"].part, out["none"].part)
                and out["resident"].cut == out["none"].cut
                and out["resident"].migration_weight
                == out["none"].migration_weight)
        print(f"[incremental] zero drift resident == no state: {same}")
        if ((out["cold"].reused, out["resident"].reused)
                != ("cold", "resident") or not same):
            raise AssertionError("incremental zero drift: classes or bits")

        # (c) weight drift through the state, a second state beside it
        stream = drift_stream(hg, INCR_STEPS, magnitude=INCR_DRIFT,
                              tag="chip-incr")
        # what deciding the sum routing costs: the host check a level
        # made from host weights runs, and the same check of weights on
        # the card (one reduction and one read per leaf)
        t0 = time.perf_counter()
        flags = (is_real_valued(stream[0].edge_weights),
                 is_real_valued(stream[0].vertex_weights))
        host_ms = (time.perf_counter() - t0) * 1e3
        lv0 = hg.arrays(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        is_real_valued(lv0.edge_weights)
        is_real_valued(lv0.vertex_weights)
        dev_ms = (time.perf_counter() - t0) * 1e3
        print(f"[incremental] real-weight check of a drifted step (edge, "
              f"vertex): {flags}; host numpy over its {hg.m} + {hg.n} "
              f"weights {host_ms!r} ms, device check of level 0 "
              f"{dev_ms!r} ms")
        sum_route_cost(stream[0], inc)
        prev, chain, warm_res = inc, [], []
        for i, step in enumerate(stream):
            res, wall, counts, nr = solve(lambda: incremental_partition(
                step, prev, cfg, state=st, device="cuda"))
            _, wall_cold, _, nr_cold = solve(lambda: incremental_partition(
                step, prev, cfg, state=None, device="cuda"))
            print(f"[incremental] drift step {i}: warm wall_s {wall!r} "
                  f"(coarsening rounds {nr}), no-state wall_s "
                  f"{wall_cold!r} (rounds {nr_cold}); warm launches "
                  f"{short(counts)}")
            check(f"drift step {i}", step, prev, res, INCR_K, budget)
            if res.reused != "replayed" or nr:
                raise AssertionError(f"drift step {i}: {res.reused}, {nr} "
                                     "coarsening rounds")
            chain.append(prev)
            warm_res.append(res)
            prev = res.part
        st2 = IncrementalState()
        solve(lambda: incremental_partition(hg, inc, cfg, state=st2,
                                            device="cuda"))
        for i, (step, inc_i) in enumerate(zip(stream, chain)):
            again = solve(lambda: incremental_partition(
                step, inc_i, cfg, state=st2, device="cuda"))[0]
            same = (again.reused == "replayed"
                    and np.array_equal(again.part, warm_res[i].part)
                    and again.cut == warm_res[i].cut
                    and np.array_equal(again.cuts, warm_res[i].cuts))
            print(f"[incremental] drift step {i}, second state: "
                  f"{again.reused}, cut {again.cut!r}; == first state "
                  f"(parts, cut, member cuts): {same}")
            if not same:
                raise AssertionError(f"drift step {i}: the second state's "
                                     "replay differs")

        # (d) a pin edit, then weight drift on the edited structure
        edited = drift_stream(stream[-1], 1, magnitude=0.1,
                              pin_edit_frac=0.05, tag="chip-incr-edit")[0]
        res, wall, counts, nr = solve(lambda: incremental_partition(
            edited, prev, cfg, state=st, device="cuda"))
        print(f"[incremental] pin edit: wall_s {wall!r}, coarsening rounds "
              f"{nr}, launches {short(counts)}")
        check("pin edit", edited, prev, res, INCR_K, budget)
        after = drift_stream(edited, 1, magnitude=INCR_DRIFT,
                             tag="chip-incr-after")[0]
        res2, wall, counts, nr = solve(lambda: incremental_partition(
            after, res.part, cfg, state=st, device="cuda"))
        print(f"[incremental] drift after the edit: wall_s {wall!r}, "
              f"coarsening rounds {nr}, launches {short(counts)}")
        check("drift after the edit", after, res.part, res2, INCR_K, budget)
        if (res.reused, res2.reused) != ("patched", "replayed") or nr:
            raise AssertionError(f"pin edit: {res.reused}, then "
                                 f"{res2.reused} with {nr} rounds")

        # (e) device loss: k 64 -> 32 on the same state
        inc_k = res2.part % INCR_K_LOSS
        res3, wall, counts, nr = solve(lambda: repartition_k_change(
            after, res2.part, INCR_K_LOSS, cfg, state=st, device="cuda"))
        print(f"[incremental] k-change {INCR_K} -> {INCR_K_LOSS}: wall_s "
              f"{wall!r}, coarsening rounds {nr}, launches {short(counts)}")
        check("k-change", after, inc_k, res3, INCR_K_LOSS, budget)
        if (res3.reused != "resident" or res3.budget_weight
                != res2.budget_weight or not counts["gain_table"]):
            raise AssertionError(f"k-change: {res3.reused}, budget "
                                 f"{res3.budget_weight}, launches {counts}")
    finally:
        dcoarsen._coarsen_round = real_round
    missing = [n for n in must_launch if total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"incremental path: kernels never launched: "
                             f"{missing}")
    return total


# the service phase: the reference service benchmark's workload
# (``benchmarks/service.py``, ``BENCH_service.json``: 12 requests of
# ``request_stream(tag="bench")``, 4 slots, alpha 4, lp_iters 8, no
# coalescing, offered loads 1 and 4 requests/s), full-width requests, and
# the reference's robustness soak (``BENCH_robustness.json``)
SERVICE_REQUESTS = 12
SERVICE_LOADS = (1.0, 4.0)
SERVICE_CFG = dict(slots=4, alpha=4, lp_iters=8, coalesce_ms=0.0,
                   sched="static")
SERVICE_CHILDREN = 3
SERVICE_ISPD = (("ibm01_like", 16), ("ibm02_like", 12), ("ibm03_like", 32))
SOAK_REQUESTS = 6
SOAK_PLANS = (
    ("none", None),
    ("straggler", "2:straggler:delay_ms=60"),
    ("crash", "2:crash"),
    ("corrupt", "3:corrupt:slot=0,mode=block_range"),
    ("device_loss", "3:device_loss:survivors=2"),
    ("chaos", "2:straggler:delay_ms=40;3:device_loss:survivors=2;"
              "4:corrupt:slot=0,mode=block_range;5:crash"),
)
# the events each plan must show (its faults fired and were handled)
# the device-loss plan of the pooled soak: one of 2 logical shards lost
SOAK_POOL_PLAN = "3:device_loss"
SOAK_EVENTS = {
    "none": set(), "straggler": {"straggler_injected"}, "crash": {"crash"},
    "corrupt": {"corrupt_injected", "quarantine"},
    "device_loss": {"device_loss"},
    "chaos": {"straggler_injected", "device_loss", "corrupt_injected",
              "quarantine", "crash"},
}

_SERVICE_SOLO_CHILD = """
import json, sys, time
import torch
from repro_torch.data.hypergraphs import request_stream
from repro_torch.serve import PartitionRequest, PartitionService
spec = json.load(open(sys.argv[1]))
reqs = request_stream(spec["count"], tag="bench", scale=1.0)
out = []
for job in spec["jobs"]:
    r = reqs[job["index"]]
    svc = PartitionService(device="cuda", **job["cfg"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part, cut = svc.solve_solo(PartitionRequest(name=r["name"], hg=r["hg"],
                                                k=r["k"], eps=r["eps"]))
    torch.cuda.synchronize()
    out.append(dict(index=job["index"], wall=time.perf_counter() - t0,
                    part=part.tolist(), cut=cut))
json.dump(out, open(sys.argv[2], "w"))
"""


def _pct(xs, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def run_service_path(must_launch):
    """Phase ``service``: the partition service on the card (DESIGN.md
    §12-13), through ``PartitionService`` as a caller submits to it.

    (a) the reference service benchmark: 12 requests of
    ``request_stream(tag="bench")``, 4 slots, alpha 4, lp_iters 8, static
    schedule; their ``solve_solo`` runs in ``SERVICE_CHILDREN`` child
    processes beside a warm pass through one service, then a service per
    offered load (1 and 4 requests/s, request i arriving at i / load s),
    each answer bit-equal to solo; completed, throughput, p50, p99 and
    makespan per load.  (b) full width in one 4-slot service: ibm01/02/03
    _like at published size (k 16/12/32, eps 0.03), ibm08_like at k 64
    (eps 0.08) cold, and ibm08's first drift step as an incremental
    request (the solo cold ibm08 answer as incumbent, migration_frac
    0.15); each bit-equal to ``solve_solo``, balanced, its cut equal on
    the host and on the card, the refresh within its budget and no worse
    than its incumbent.  (c) the reference's robustness soak: 6 modular
    netlists (k 3), 4 slots, alpha 2, lp_iters 4, snapshots every tick,
    under the plans none, straggler, crash, corrupt, device loss (2
    survivors asked, one card) and chaos: every fault fired, every
    request terminal, every completed answer bit-equal to solo.  Returns
    the launches of the service runs and of their cut checks."""
    import numpy as np
    import torch
    from repro_torch.data.hypergraphs import (_modular_netlist, drift_stream,
                                              ispd_like, request_stream)
    from repro_torch.core import popshard
    from repro_torch.kernels import ops
    from repro_torch.runtime.elastic import restore_device_pool
    from repro_torch.serve import (FaultPlan, PartitionRequest,
                                   PartitionService)
    total, path_total = {}, {}

    def timed(fn, serve=True):
        # the launches of a service run feed the phase's gate and the
        # kernels line; those of a solo reference run feed neither
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if serve:
            _add_counts(total, counts)
            _add_counts(path_total, counts)
        return out, time.perf_counter() - t0, counts

    def short(counts):
        return {n: counts[n] for n in ("gain_table", "gain_stream",
                                       "rating_segment_sum",
                                       "rating_segment_sum_batch")}

    def same(res, part, cut):
        return (res.part is not None and np.array_equal(res.part, part)
                and res.cut == cut)

    # (a) the reference service workload
    reqs = request_stream(SERVICE_REQUESTS, tag="bench", scale=1.0)

    def make(r):
        return PartitionRequest(name=r["name"], hg=r["hg"], k=r["k"],
                                eps=r["eps"])

    def drain_all(svc):
        for r in reqs:
            svc.submit(make(r))
        svc.drain()
        return svc

    def check_stream(label, svc, solos):
        bad = [r["name"] for i, r in enumerate(reqs)
               if svc.results[r["name"]].status != "ok"
               or not same(svc.results[r["name"]],
                           np.asarray(solos[i]["part"]), solos[i]["cut"])]
        if bad:
            raise AssertionError(f"service {label}: answers differ from "
                                 f"solve_solo: {bad}")

    children = _SoloChildren([(i, SERVICE_CFG) for i in range(len(reqs))],
                             SERVICE_CHILDREN, "service", _SERVICE_SOLO_CHILD,
                             SERVICE_REQUESTS)
    try:
        warm, wall, counts = timed(lambda: drain_all(PartitionService(
            device="cuda", **SERVICE_CFG)))
        solos = children.results()
    finally:
        children.stop()
    check_stream("warm pass", warm, solos)
    for i, r in enumerate(reqs):
        hg, res = r["hg"], warm.results[r["name"]]
        cut, balanced = host_cut_and_balance(hg, res.part, r["k"],
                                             r["eps"])[:2]
        _add_counts(total, card_cut_check(hg, res.part, r["k"], cut,
                                          f"service request {i}"))
        if cut != res.cut or not balanced:
            raise AssertionError(f"service request {i}: host cut {cut} vs "
                                 f"{res.cut}, balanced={balanced}")
    print(f"[service] stream n {sorted({r['hg'].n for r in reqs})} k "
          f"{sorted({r['k'] for r in reqs})}: warm pass wall_s {wall!r}, "
          f"{warm.tick} ticks, launches {short(counts)}; solo runs in "
          f"{SERVICE_CHILDREN} child processes beside it, sum "
          f"{sum(s['wall'] for s in solos.values())!r} s (not walls "
          "alone); every answer == solo, host and card cuts equal")
    for load in SERVICE_LOADS:
        def offered():
            svc = PartitionService(device="cuda", **SERVICE_CFG)
            gap = 1.0 / load
            t0 = time.perf_counter()
            nxt = 0
            while nxt < len(reqs) or svc.busy:
                now = time.perf_counter() - t0
                while nxt < len(reqs) and now >= nxt * gap:
                    # latency runs from the scheduled arrival, not from
                    # the submit a long tick may have delayed
                    req = make(reqs[nxt])
                    svc.submit(req)
                    req.submitted_s = t0 + nxt * gap
                    nxt += 1
                if svc.busy:
                    svc.step()
                else:
                    time.sleep(min(gap / 8, 0.002))
            return svc, time.perf_counter() - t0
        (svc, makespan), _, counts = timed(offered)
        check_stream(f"at {load} requests/s", svc, solos)
        lats = [res.latency_s for res in svc.results.values()]
        print(f"[service] offered {load!r} requests/s: completed "
              f"{len(lats)}, throughput {len(lats) / makespan!r} requests/s, "
              f"p50 {_pct(lats, 50) * 1e3!r} ms, p99 {_pct(lats, 99) * 1e3!r} "
              f"ms, makespan {makespan!r} s, {svc.tick} ticks; every answer "
              f"== solo; launches {short(counts)}")

    # (b) full width: ISPD98-sized requests, ibm08 cold and a refresh
    ibm08 = ispd_like("ibm08_like", 1.0)
    full = [PartitionRequest(name=name, hg=ispd_like(name, 1.0), k=k,
                             eps=0.03) for name, k in SERVICE_ISPD]
    full.append(PartitionRequest(name="ibm08_like", hg=ibm08, k=INCR_K,
                                 eps=INCR_EPS))
    svc = PartitionService(slots=4, alpha=4, lp_iters=8, sched="static",
                           device="cuda")
    (inc, inc_cut_solo), wall, _ = timed(lambda: svc.solve_solo(full[-1]),
                                         serve=False)
    print(f"[service] ibm08_like k={INCR_K} solo cold (the refresh's "
          f"incumbent): wall_s {wall!r} cut {inc_cut_solo!r}")
    step0 = drift_stream(ibm08, 1, magnitude=INCR_DRIFT,
                         tag="chip-incr")[0]
    full.append(PartitionRequest(name="ibm08_like refresh", hg=step0,
                                 k=INCR_K, eps=INCR_EPS, incumbent=inc,
                                 migration_frac=0.15))

    def serve_full():
        for req in full:
            svc.submit(req)
        svc.drain()
        return svc
    _, wall, counts = timed(serve_full)
    print(f"[service] full width, {len(full)} requests in 4 slots: wall_s "
          f"{wall!r}, {svc.tick} ticks, launches {short(counts)}")
    # only the ibm08 requests (k 64, and the refresh's drifted weights)
    # can launch #2 and #4: the served run itself must have
    idle = [n for n in ("gain_stream", "rating_segment_sum_batch")
            if counts.get(n, 0) == 0]
    if idle:
        raise AssertionError(f"service full width: kernels never launched "
                             f"by the served run: {idle}")
    solo_walls, solo_full = [], {}
    for req in full:
        res = svc.results[req.name]
        (part, cut), w, _ = timed(lambda: svc.solve_solo(req), serve=False)
        solo_walls.append(w)
        solo_full[req.name] = (part, cut)
        hg = req.hg
        rel = INCR_REL if req.incumbent is not None else 0.0
        hcut, balanced, bw_max, cap = host_cut_and_balance(
            hg, res.part, req.k, req.eps)
        _add_counts(total, card_cut_check(hg, res.part, req.k, hcut,
                                          f"service {req.name}", rel=rel))
        ok = (res.status == "ok" and same(res, part, cut) and balanced
              and abs(hcut - res.cut) <= rel * abs(hcut))
        extra = ""
        if req.incumbent is not None:
            vw = hg.vertex_weights.astype(np.float64)
            moved = float(vw[res.part != inc].sum())
            budget = 0.15 * float(vw.sum())
            inc_cut = host_cut_and_balance(hg, inc, req.k, req.eps)[0]
            extra = (f", migration {moved!r} of budget {budget!r}, "
                     f"incumbent cut on the new weights {inc_cut!r}")
            ok = (ok and moved <= budget + 1e-3
                  and abs(moved - res.migration_weight) <= 1e-3
                  and res.cut <= inc_cut * (1 + INCR_REL))
        print(f"[service] {req.name} n={hg.n} m={hg.m} k={req.k} eps="
              f"{req.eps}: cut {res.cut!r} host cut {hcut!r} max block "
              f"weight {bw_max!r} cap {cap!r}; solo wall_s {w!r} cut "
              f"{cut!r}; == solo: {same(res, part, cut)}{extra}")
        if not ok:
            raise AssertionError(f"service full width {req.name}: status "
                                 f"{res.status}, cut {res.cut} solo {cut} "
                                 f"host {hcut}, balanced={balanced}")
    print(f"[service] full width: served {wall!r} s, solo sum "
          f"{sum(solo_walls)!r} s (single runs, no claim)")

    # the F5 gate: ibm01_like beside ibm08_like cold and its refresh,
    # admitted at once, so the refresh (real-valued drifted weights)
    # shares a stack with ibm08's cold solve
    f5 = [full[0], full[3], full[4]]
    svc_f5 = PartitionService(slots=4, alpha=4, lp_iters=8, sched="static",
                              device="cuda")

    def serve_f5():
        for req in f5:
            svc_f5.submit(req)
        svc_f5.drain()
    _, wall, counts = timed(serve_f5)
    bad = [req.name for req in f5
           if svc_f5.results[req.name].status != "ok"
           or not same(svc_f5.results[req.name], *solo_full[req.name])]
    print(f"[service] F5 grouping ({', '.join(r.name for r in f5)} "
          f"admitted at once): wall_s {wall!r}, {svc_f5.tick} ticks, "
          f"refresh cut {svc_f5.results[f5[2].name].cut!r} solo "
          f"{solo_full[f5[2].name][1]!r}; every answer == solo (parts and "
          f"cut): {not bad}; launches {short(counts)}")
    if bad:
        raise AssertionError(f"service F5 grouping: answers differ from "
                             f"solve_solo: {bad}")

    # (c) the robustness soak
    soak = []
    for i in range(SOAK_REQUESTS):
        hg = _modular_netlist(360 + 40 * i, 460 + 50 * i, seed=50 + i,
                              n_modules=5, p_local=0.8, fanout_tail=1.5)
        soak.append(PartitionRequest(name=f"fault-bench-{i}", hg=hg, k=3,
                                     eps=0.08, seed=i))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        def svc_for(plan, tag):
            return PartitionService(slots=4, alpha=2, lp_iters=4,
                                    contraction_limit_factor=16,
                                    ckpt_every=1, fault_plan=plan,
                                    ckpt_dir=os.path.join(tmp, tag),
                                    device="cuda")
        ref = svc_for(None, "solo")
        solo = {}
        for req in soak:
            solo[req.name], w, _ = timed(lambda: ref.solve_solo(req),
                                         serve=False)
        for name, spec in SOAK_PLANS:
            plan = FaultPlan.parse(spec) if spec else None

            def run():
                svc = svc_for(plan, name)
                for req in soak:
                    svc.submit(PartitionRequest(
                        name=req.name, hg=req.hg, k=req.k, eps=req.eps,
                        seed=req.seed))
                svc.drain()
                return svc
            try:
                svc, wall, counts = timed(run)
            finally:
                restore_device_pool("cuda")
            kinds = sorted({e["kind"] for e in svc.events})
            terminal = all(svc.results[r.name].status in (
                "ok", "degraded", "rejected", "timed_out", "recovered",
                "quarantined") for r in soak)
            equal = all(same(svc.results[r.name], *solo[r.name])
                        for r in soak if svc.results[r.name].ok)
            losses = [e for e in svc.events if e["kind"] == "device_loss"]
            print(f"[service] soak {name}: wall_s {wall!r}, outcomes "
                  f"{svc.outcome_counts()}, events {kinds}, pending "
                  f"{0 if plan is None else plan.pending}; every completed "
                  f"answer == solo: {equal}")
            for e in losses:
                print(f"[service] soak {name} device loss at tick "
                      f"{e['tick']}: survivors {e['survivors']}, resumed "
                      f"{e['resumed_from_ckpt']}, restarted "
                      f"{e['restarted_from_scratch']}, recovery_s "
                      f"{e['recovery_s']!r} (drop_s {e['drop_s']!r}, "
                      f"rebuild_s {e['rebuild_s']!r}), "
                      "torch.cuda.memory_allocated "
                      f"{e['allocated_before']} -> {e['allocated_after']} "
                      "bytes across the drop")
            fired = plan is None or plan.pending == 0
            if (not fired or not terminal or not equal
                    or len(svc.results) != len(soak)
                    or not SOAK_EVENTS[name] <= set(kinds)
                    or any(e["allocated_after"] >= e["allocated_before"]
                           for e in losses)):
                raise AssertionError(f"service soak {name}: fired={fired}, "
                                     f"terminal={terminal}, equal={equal}, "
                                     f"events {kinds}, losses {losses}")
        # the device-loss plan over a pool of 2 logical shards: the loss
        # shrinks the pool to one and the survivors' mesh serves on
        for route in ("mesh", "chunk"):
            plan = FaultPlan.parse(SOAK_POOL_PLAN)

            def run():
                svc = PartitionService(
                    slots=4, alpha=2, lp_iters=4, contraction_limit_factor=16,
                    ckpt_every=1, fault_plan=plan, shard=route,
                    ckpt_dir=os.path.join(tmp, f"pool-{route}"),
                    device="cuda")
                for req in soak:
                    svc.submit(PartitionRequest(
                        name=req.name, hg=req.hg, k=req.k, eps=req.eps,
                        seed=req.seed))
                svc.drain()
                return svc, len(popshard.local_devices("cuda"))
            popshard.set_logical_shards(2, "cuda")
            try:
                (svc, left), wall, counts = timed(run)
            finally:
                restore_device_pool("cuda")
                popshard.set_logical_shards(None, "cuda")
            losses = [e for e in svc.events if e["kind"] == "device_loss"]
            # requests in flight at the loss resume ("recovered"), queued
            # ones run on the survivors' mesh ("ok")
            equal = all(same(svc.results[r.name], *solo[r.name])
                        for r in soak)
            states = {svc.results[r.name].status for r in soak}
            print(f"[service] soak device_loss over 2 logical shards, "
                  f"shard={route}: wall_s {wall!r}, outcomes "
                  f"{svc.outcome_counts()}, survivors "
                  f"{[e['survivors'] for e in losses]} (pool left {left}), "
                  f"recovery_s {[e['recovery_s'] for e in losses]!r}; every "
                  f"answer == solo: {equal}")
            if not (equal and plan.pending == 0 and left == 1
                    and "recovered" in states
                    and states <= {"ok", "recovered"}
                    and [e["survivors"] for e in losses] == [1]):
                raise AssertionError(f"service pooled soak {route}: "
                                     f"equal={equal}, losses {losses}")
    missing = [n for n in must_launch if path_total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"service path: kernels never launched: "
                             f"{missing}")
    return total


# the popshard phase: the population axis over pools of P logical shards
# of the card, the counterpart of the reference's forced host devices
# (``popshard.set_logical_shards``); every route is held to the ``off``
# route bit for bit
POPSHARD_ALPHA = 7
POPSHARD_ITERS = 16
POPSHARD_ROUTES = (("mesh", 1), ("mesh", 2), ("mesh", 4), ("chunk", 2),
                   ("chunk", 4))
# (design, k, level, weights): the finest level (LP only, n >
# FM_NODE_LIMIT) with integer weights and mutation's member rows, and the
# first level with n <= FM_NODE_LIMIT (LP and FM; its FM runs over 4
# shards took 7.4-8.5 s a run) with member rows, whose FM gain sums run #4
POPSHARD_LEVELS = (("ibm01_like", 16, "finest", ("integer", "member")),
                   ("ibm01_like", 16, "coarse", ("member",)),
                   ("ibm08_like", 64, "finest", ("integer", "member")))
# the memetic run's beta: the sched phase's, whose static run it is held
# to (beta 3 did not fit the script's 1,200 s)
POPSHARD_BETA = SCHED_BETA
# the instance check's depth: the ISPD98 trio at full size, with alpha 2,
# LP iterations 2 and FM on levels of at most 1,200 vertices (ibm01's two
# coarsest), no final V-cycle (the instances phase's config, alpha 7 and
# all FM levels, took 119.1 s over 4 shards on ``mesh`` and 91.0 s on
# ``chunk``; alpha 4 and 4 iterations 35.7 and 29.9 s)
POPSHARD_INSTANCE_CFG = dict(eps=0.03, alpha=2, lp_iters=2,
                             fm_node_limit=1200, final_vcycles=0,
                             sched="static", recombination_enabled=False,
                             mutation_enabled=False)


def run_popshard_path(must_launch, smi: str):
    """Phase ``popshard``: the population axis over a pool of logical
    shards of the card (DESIGN.md §11), every route bit-equal to
    ``off``.

    (a) ``refine_population`` (LP, and FM on the coarse level) of
    ``POPSHARD_ALPHA`` members on the levels of ``POPSHARD_LEVELS`` (the
    ``table`` gain kernel on ibm01_like at k 16, ``stream`` on ibm08_like
    at k 64), with integer weights and with mutation's real-valued
    member rows as that table says, under ``mesh`` at a pool of 1 and
    ``mesh`` and ``chunk`` at pools of 2 and 4; a mesh route must launch the LP gain kernel P
    times as often as ``off`` (once per shard and attempt).  (b)
    ``ring_partners`` under ``mesh`` against the roll.  (c)
    ``impart_partition`` on ibm01_like at k 16, memetic at beta
    ``POPSHARD_BETA``, with ``pop_shard="mesh"`` over 4 shards against
    the ``sched`` phase's static run (or its own ``off`` run).  (d)
    ``impart_partition_instances`` on the ``instances`` phase's ISPD98
    requests (``POPSHARD_INSTANCE_CFG``) under ``mesh`` and ``chunk``
    over 4 shards, each request against its solo run.  Each route's wall is printed beside the card;
    the walls show what the split costs on one card and claim nothing.
    Returns the launches of the routed runs."""
    import numpy as np
    import torch
    from repro_torch.core import popshard, refine
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.core.impart import (ImpartConfig, impart_partition,
                                         impart_partition_instances)
    from repro_torch.data.hypergraphs import ispd_like
    from repro_torch.kernels import ops
    total = {}

    def timed(fn, pool=None, routed=True):
        popshard.set_logical_shards(pool, "cuda")
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            popshard.set_logical_shards(None, "cuda")
        counts = ops.launch_counts()
        if routed:
            _add_counts(total, counts)
        return out, wall, counts

    # (a) both tiers on single levels
    hiers = {}
    for design, k, which, kinds in POPSHARD_LEVELS:
        if design not in hiers:
            hiers[design] = build_hierarchy(ispd_like(design, 1.0), k,
                                            seed=0, device="cuda")
            _SHARED_RUNS[("hier", design)] = hiers[design]
        hier = hiers[design]
        li = 0 if which == "finest" else min(
            i for i in range(hier.num_levels)
            if hier.level_n(i) <= FM_NODE_LIMIT)
        hga, host = hier.level_arrays(li), hier.level_host(li)
        rng = np.random.default_rng(100 + li)
        parts = np.stack([refine.rebalance(
            host.vertex_weights, rng.integers(0, k, host.n).astype(np.int32),
            k, 0.03) for _ in range(POPSHARD_ALPHA)]).astype(np.int32)
        ew = np.zeros((POPSHARD_ALPHA, hga.m_pad), np.float32)
        ew[:, : host.m] = host.edge_weights * (1.0 + 0.1 * rng.integers(
            0, 4, (POPSHARD_ALPHA, host.m)))
        gain = "gain_stream" if k > 32 else "gain_table"
        for weights in kinds:
            ew_arg = ew if weights == "member" else None
            def run(shard):
                return refine.refine_population(
                    hga, parts, k, 0.03, fm_node_limit=FM_NODE_LIMIT,
                    max_iters=POPSHARD_ITERS, edge_weights_pop=ew_arg,
                    shard=shard, device="cuda")
            (want_p, want_c), w_off, c_off = timed(lambda: run("off"),
                                                   routed=False)
            walls, launches, bad = [f"off {w_off!r}"], [], []
            for route, pool in POPSHARD_ROUTES:
                (got_p, got_c), w, counts = timed(lambda: run(route), pool)
                walls.append(f"{route}/{pool} {w!r}")
                launches.append(f"{route}/{pool} {counts[gain]} "
                                f"#4 {counts['rating_segment_sum_batch']}")
                per_shard = pool if route == "mesh" else 1
                if not (torch.equal(got_p, want_p)
                        and np.array_equal(got_c, want_c)
                        and counts[gain] == per_shard * c_off[gain] > 0):
                    bad.append(f"{route}/{pool}")
            print(f"[popshard] {design} k={k} level {li} n={hga.n} "
                  f"{weights} weights, alpha {POPSHARD_ALPHA}: walls (s) "
                  f"{', '.join(walls)} | {smi}")
            print(f"[popshard] {design} level {li} {weights}: {gain} "
                  f"launches off {c_off[gain]} #4 "
                  f"{c_off['rating_segment_sum_batch']}, "
                  f"{', '.join(launches)}; every route == off (parts, "
                  f"cuts; mesh launches = pool x off): {not bad}")
            if bad:
                raise AssertionError(f"popshard {design} level {li} "
                                     f"{weights}: routes differ from off "
                                     f"or skip shards: {bad}")

    # (b) the ring exchange
    host = hiers["ibm01_like"].level_host(0)
    rng = np.random.default_rng(7)
    pop8 = rng.integers(0, 16, (8, host.n)).astype(np.int32)
    for pool in (2, 4):
        got, w, _ = timed(lambda: popshard.ring_partners(
            pop8, shard="mesh", device="cuda"), pool, routed=False)
        odd, _, _ = timed(lambda: popshard.ring_partners(
            pop8[:7], shard="mesh", device="cuda"), pool, routed=False)
        ok = (np.array_equal(got, np.roll(pop8, -1, axis=0))
              and np.array_equal(odd, np.roll(pop8[:7], -1, axis=0)))
        print(f"[popshard] ring_partners mesh over {pool} shards, 8 x "
              f"{host.n}: == roll {ok} (7 members: host roll), wall_s {w!r}")
        if not ok:
            raise AssertionError(f"popshard ring over {pool} shards")

    # (c) the memetic driver over 4 shards
    hg = ispd_like("ibm01_like", 1.0)
    common = dict(k=16, eps=0.03, alpha=7, beta=POPSHARD_BETA, seed=0,
                  final_vcycles=1, sched="static")
    want = _SHARED_RUNS.get(("sched static", "ibm01_like", 16, 0.03,
                             POPSHARD_BETA))
    w_off = "(the sched phase's static run)"
    if want is None:
        want, w_off, _ = timed(lambda: impart_partition(
            hg.structural_copy(), ImpartConfig(**common), device="cuda"),
            routed=False)
    got, w, counts = timed(lambda: impart_partition(
        hg.structural_copy(), ImpartConfig(pop_shard="mesh", **common),
        device="cuda"), 4)
    ok = np.array_equal(got.part, want.part) and got.cut == want.cut
    print(f"[popshard] ibm01_like k=16 memetic beta {POPSHARD_BETA} "
          f"pop_shard=mesh over 4 shards: wall_s {w!r} (off {w_off!r}), cut "
          f"{got.cut!r}, off cut {want.cut!r}, == off {ok}; launches "
          f"{counts} | {smi}")
    if not ok:
        raise AssertionError("popshard memetic run differs from off")

    # (d) the instance axis over 4 shards
    ispd = [ispd_like(name, 1.0) for name, _ in INSTANCE_ISPD]
    cfgs = [dict(k=k, **POPSHARD_INSTANCE_CFG) for _, k in INSTANCE_ISPD]
    solos, w_solo = [], 0.0
    for hg, cfg in zip(ispd, cfgs):
        solo, w, _ = timed(lambda: impart_partition(
            hg, ImpartConfig(**cfg), device="cuda"), routed=False)
        solos.append(solo)
        w_solo += w
    for route in ("mesh", "chunk"):
        res, w, counts = timed(lambda: impart_partition_instances(
            ispd, [ImpartConfig(pop_shard=route, **c) for c in cfgs],
            grid=list(INSTANCE_GRID), device="cuda"), 4)
        ok = all(np.array_equal(r.part, s.part) and r.cut == s.cut
                 and r.population_cuts == s.population_cuts
                 for r, s in zip(res, solos))
        print(f"[popshard] instances {[n for n, _ in INSTANCE_ISPD]} "
              f"{route} over 4 shards: wall_s {w!r} (solo sum {w_solo!r}), "
              f"cuts "
              f"{[r.cut for r in res]}, each == solo {ok}; launches "
              f"{counts} | {smi}")
        if not ok:
            raise AssertionError(f"popshard instances {route}: requests "
                                 "differ from their solo runs")
    missing = [n for n in must_launch if total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"popshard path: kernels never launched: "
                             f"{missing}")
    return total


# the modelshard phase: the model axis (13c) over (pop, model) grids of
# logical shards of the card: pin tables in row blocks over "model", the
# pin-level sums added over the blocks; every result held to the
# replicated (``off``) route bit for bit
MODELSHARD_GRIDS = ((1, 2), (2, 2), (1, 4))   # (pop, model)
# (design, k, level, weights): the finest ibm01 level (LP) with integer
# weights and integer-valued member rows (their gain sums run #4 on every
# block), ibm01's first level with n <= FM_NODE_LIMIT (LP and FM) on
# member rows, ibm08's finest level (LP) at k 64
MODELSHARD_LEVELS = (("ibm01_like", 16, "finest", ("integer", "member")),
                     ("ibm01_like", 16, "coarse", ("member",)),
                     ("ibm08_like", 64, "finest", ("integer",)))
# the giant instance of the reference's OOM test: n 10**6, m 1.3 * 10**6,
# k 8, two members, one LP iteration
MODELSHARD_GIANT = (1_000_000, 1_300_000, 5, 8)
MODELSHARD_POP_STEPS = 4


def _grid(pop: int, model: int):
    """Make the card's pool ``pop * model`` logical shards in a (pop,
    model) grid; returns the mesh."""
    from repro_torch.core import popshard
    os.environ["REPRO_POP_MESH_MODEL"] = str(model)
    popshard.set_logical_shards(pop * model, "cuda")
    mesh = popshard.pop_mesh("cuda")
    if mesh.shape != {"pop": pop, "model": model}:
        raise AssertionError(f"modelshard grid {mesh.shape}")
    return mesh


def run_modelshard_path(must_launch, smi: str):
    """Phase ``modelshard``: the model axis (DESIGN.md §15) on the card
    over (pop, model) grids of logical shards, every result bit-equal to
    the replicated route, each wall printed as a multiple of ``off``'s.

    (a) ``refine_population`` (LP; LP and FM on the coarse level) of
    ``POPSHARD_ALPHA`` members on the levels of ``MODELSHARD_LEVELS``
    with ``shard="mesh", model_shard="mesh"`` over the grids of
    ``MODELSHARD_GRIDS``: #4 launches on every pin block for the member
    rows' gain sums, #1/#2 never (the blocks carry no incidence layout).
    (b) ``build_hierarchy`` (device engine) of ibm08_like and
    ``population_coarsen`` of ibm01_like with 7 members, contracted over
    a (2, 2) grid, every level against the replicated contraction.  (c)
    ``giant_netlist`` (n 10**6) at k 8 with two members under a
    ``REPRO_DEVICE_MEM_BUDGET`` between its 1-way and 2-way structure
    bytes: the replicated mesh dispatch raises, the model route
    completes, and its cut, recomputed on the card through #7/#8, is the
    reported one.  (d) ``make_population_step`` over (pop 4, model 2) on
    ibm01_like, ``MODELSHARD_POP_STEPS`` steps against (pop 4, model 1):
    parts and cuts equal, the mean cut not growing, every member
    balanced.  Returns the launches of the model routes."""
    import numpy as np
    import torch
    from repro_torch.core import metrics, popshard, refine
    from repro_torch.core.dcoarsen import build_hierarchy, population_coarsen
    from repro_torch.core.population import make_population_step
    from repro_torch.data.hypergraphs import giant_netlist, ispd_like
    from repro_torch.kernels import ops
    total = {}

    def timed(fn, grid=None, routed=True):
        try:
            if grid is not None:
                _grid(*grid)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("REPRO_POP_MESH_MODEL", None)
            popshard.set_logical_shards(None, "cuda")
        counts = ops.launch_counts()
        if routed:
            _add_counts(total, counts)
        return out, wall, counts

    def same_levels(a, b, cohort):
        if a.num_levels != b.num_levels:
            return False
        for la, lb in zip(a.levels, b.levels):
            for f in ("pin_vertex", "pin_edge", "vertex_weights",
                      "edge_weights", "edge_sizes"):
                if not torch.equal(getattr(la.hga, f), getattr(lb.hga, f)):
                    return False
            if cohort and not (torch.equal(la.ew_pop, lb.ew_pop)
                               and torch.equal(la.parts, lb.parts)):
                return False
        return True

    # (a) both tiers on single levels
    hiers = {}
    for design, k, which, kinds in MODELSHARD_LEVELS:
        if design not in hiers:
            hiers[design] = _SHARED_RUNS.get(("hier", design)) or \
                build_hierarchy(ispd_like(design, 1.0), k, seed=0,
                                device="cuda")
        hier = hiers[design]
        li = 0 if which == "finest" else min(
            i for i in range(hier.num_levels)
            if hier.level_n(i) <= FM_NODE_LIMIT)
        hga, host = hier.level_arrays(li), hier.level_host(li)
        rng = np.random.default_rng(200 + li)
        parts = np.stack([refine.rebalance(
            host.vertex_weights, rng.integers(0, k, host.n).astype(np.int32),
            k, 0.03) for _ in range(POPSHARD_ALPHA)]).astype(np.int32)
        ew = np.zeros((POPSHARD_ALPHA, hga.m_pad), np.float32)
        ew[:, : host.m] = host.edge_weights * rng.integers(
            1, 4, (POPSHARD_ALPHA, host.m))
        for weights in kinds:
            ew_arg = ew if weights == "member" else None

            def run(**kw):
                return refine.refine_population(
                    hga, parts, k, 0.03, fm_node_limit=FM_NODE_LIMIT,
                    max_iters=POPSHARD_ITERS, edge_weights_pop=ew_arg,
                    device="cuda", **kw)
            (want_p, want_c), w_off, c_off = timed(
                lambda: run(shard="off"), routed=False)
            walls, launches, bad = [f"off {w_off!r}"], [], []
            for grid in MODELSHARD_GRIDS:
                (got_p, got_c), w, counts = timed(
                    lambda: run(shard="mesh", model_shard="mesh"), grid)
                tag = f"({grid[0]}, {grid[1]})"
                walls.append(f"{tag} {w!r} ({w / w_off:.2f} x off)")
                r4 = counts["rating_segment_sum_batch"]
                r4_off = c_off["rating_segment_sum_batch"]
                launches.append(f"{tag} #4 {r4} (off {r4_off}), #1/#2 "
                                f"{counts['gain_table']}/"
                                f"{counts['gain_stream']}")
                if not (torch.equal(got_p, want_p)
                        and np.array_equal(got_c, want_c)
                        and counts["gain_table"] == counts["gain_stream"] == 0
                        and (weights == "integer" or r4 >= grid[1])):
                    bad.append(tag)
            print(f"[modelshard] {design} k={k} level {li} n={hga.n} "
                  f"p_pad={hga.p_pad} {weights} weights, alpha "
                  f"{POPSHARD_ALPHA}, shard=mesh model_shard=mesh over "
                  f"(pop, model): walls (s) {', '.join(walls)} | {smi}")
            print(f"[modelshard] {design} level {li} {weights}: launches "
                  f"{'; '.join(launches)}; every grid == off (parts, "
                  f"cuts), no #1/#2 on the model route: {not bad}")
            if bad:
                raise AssertionError(f"modelshard {design} level {li} "
                                     f"{weights}: grids differ from off or "
                                     f"launch the gain kernels: {bad}")

    # (b) the sharded contraction
    hg08 = ispd_like("ibm08_like", 1.0)
    want, w_off, _ = timed(lambda: build_hierarchy(
        hg08, 64, seed=0, path="device", device="cuda"), routed=False)
    got, w, counts = timed(lambda: build_hierarchy(
        hg08, 64, seed=0, path="device", model_shard="mesh",
        device="cuda"), (2, 2))
    ok = same_levels(got, want, False)
    print(f"[modelshard] device_coarsen ibm08_like k=64 over (2, 2): "
          f"{got.num_levels} levels {got.sizes()}, wall_s {w!r} "
          f"({w / w_off:.2f} x off {w_off!r}); every level == off: {ok}; "
          f"#3 {counts['rating_segment_sum']} | {smi}")
    if not ok:
        raise AssertionError("modelshard device_coarsen differs from off")
    hg01 = ispd_like("ibm01_like", 1.0)
    rng = np.random.default_rng(9)
    base = (np.arange(hg01.n) * 16 // hg01.n).astype(np.int32)
    cohort = np.stack([np.where(rng.random(hg01.n) < 0.02,
                                rng.integers(0, 16, hg01.n), base)
                       for _ in range(7)]).astype(np.int32)
    w_pop = np.stack([hg01.edge_weights * (1.0 + 0.1 * rng.integers(
        0, 4, hg01.m)) for _ in range(7)]).astype(np.float32)
    want, w_off, _ = timed(lambda: population_coarsen(
        hg01, cohort, w_pop, 16, seed=0, device="cuda"), routed=False)
    got, w, counts = timed(lambda: population_coarsen(
        hg01, cohort, w_pop, 16, seed=0, model_shard="mesh",
        device="cuda"), (2, 2))
    ok = same_levels(got, want, True)
    print(f"[modelshard] population_coarsen ibm01_like, 7 members, over "
          f"(2, 2): {got.num_levels} levels {got.sizes()}, wall_s {w!r} "
          f"({w / w_off:.2f} x off {w_off!r}); every level == off "
          f"(structure, parts, ew_pop): {ok}; #4 "
          f"{counts['rating_segment_sum_batch']} | {smi}")
    if not ok:
        raise AssertionError("modelshard population_coarsen differs")

    # (c) the giant instance: unsharded raises, sharded completes
    n, m, seed, k = MODELSHARD_GIANT
    t0 = time.perf_counter()
    giant = giant_netlist(n, m, seed=seed)
    hga = giant.arrays(device="cuda")
    t_build = time.perf_counter() - t0
    one = popshard.structure_bytes_per_device(hga, 1)
    two = popshard.structure_bytes_per_device(hga, 2)
    budget = (one + two) // 2
    warm = (np.arange(n, dtype=np.int64) * k // n).astype(np.int32)
    members = [warm.copy(), np.roll(warm, 1)]
    os.environ["REPRO_DEVICE_MEM_BUDGET"] = str(budget)
    try:
        def lp(model):
            return refine.lp_refine_population(
                hga, [p.copy() for p in members], k, 0.05, max_iters=1,
                shard="mesh", model_shard=model)
        try:
            timed(lambda: lp("off"), (2, 2), routed=False)
            raised = False
        except popshard.DeviceBudgetExceeded:
            raised = True
        (out, cuts), w, counts = timed(lambda: lp("mesh"), (2, 2))
    finally:
        del os.environ["REPRO_DEVICE_MEM_BUDGET"]
    part0 = out[0, :n].cpu().numpy()
    host_cut, balanced, _, _ = host_cut_and_balance(giant, part0, k, 0.05)
    cc = card_cut_check(giant, part0, k, host_cut, "modelshard giant")
    _add_counts(total, cc)
    start = float(metrics.cutsize(hga, refine.pad_part(warm, hga.n_pad,
                                                       "cuda"), k))
    ok = (raised and float(cuts[0]) == host_cut and balanced
          and float(cuts[0]) <= start)
    print(f"[modelshard] giant_netlist n={n} m={m} p_pad={hga.p_pad} k={k}, "
          f"2 members (built in {t_build!r} s): structure bytes/device "
          f"1-way {one}, 2-way {two}, REPRO_DEVICE_MEM_BUDGET {budget}; "
          f"unsharded raises DeviceBudgetExceeded: {raised}; sharded over "
          f"(2, 2) wall_s {w!r}, cut {float(cuts[0])!r} (warm start "
          f"{start!r}) == host {host_cut!r} == card #8 recount: {ok}; "
          f"launches { {n: c for n, c in counts.items() if c} } | {smi}")
    if not ok:
        raise AssertionError("modelshard giant instance failed its claim")
    del hga, giant

    # (d) the population step over (pop 4, model 2)
    hga = hg01.arrays(device="cuda")
    args = [hga.pin_vertex, hga.pin_edge, hga.vertex_weights,
            hga.edge_weights, hga.edge_sizes]
    rng = np.random.default_rng(4)
    start = np.zeros((4, hga.n_pad), np.int32)
    for i in range(4):
        start[i, : hg01.n] = refine.rebalance(
            hg01.vertex_weights,
            rng.integers(0, 16, hg01.n).astype(np.int32), 16, 0.03)

    def steps(grid):
        def go():
            step = make_population_step(popshard.pop_mesh("cuda"),
                                        n=hg01.n, m=hg01.m, k=16, eps=0.03,
                                        refine_rounds=3)
            parts, trail = torch.from_numpy(start).cuda(), []
            for _ in range(MODELSHARD_POP_STEPS):
                parts, cuts = step(*args, parts)
                trail.append((parts.clone(), cuts.clone()))
            return trail
        return timed(go, grid, routed=grid[1] > 1)
    want, w_off, _ = steps((4, 1))
    got, w, counts = steps((4, 2))
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(got, want))
    means = [float(c.mean()) for _, c in got]
    final = got[-1][0].cpu().numpy()
    checks = [host_cut_and_balance(hg01, final[i, : hg01.n], 16, 0.03)
              for i in range(4)]
    ok = (same and all(b <= a for a, b in zip(means, means[1:]))
          and all(c[1] for c in checks)
          and [c[0] for c in checks] == [float(x) for x in got[-1][1]])
    print(f"[modelshard] population step ibm01_like k=16, 4 members, "
          f"{MODELSHARD_POP_STEPS} steps over (4, 2): wall_s {w!r} "
          f"({w / w_off:.2f} x (4, 1) {w_off!r}); mean cuts {means}; == "
          f"(4, 1) every step {same}; balanced, cuts == host recount, "
          f"means non-increasing: {ok}; launches "
          f"{ {n: c for n, c in counts.items() if c} } | {smi}")
    if not ok:
        raise AssertionError("modelshard population step failed")
    missing = [n for n in must_launch if total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"modelshard path: kernels never launched: "
                             f"{missing}")
    return total


# MLPerf DLRM at its published widths with each table capped at this many
# rows (the MLPerf DLRM reference's own --max-ind-range knob): 54,063,992
# rows, 27.7 GB in f32; the full 187,767,399 rows (96.1 GB) exceed the card
SUBSTRATE_ROW_CAP = 10_000_000
# queries of the DLRM row placement (the rows they touch are its vertices)
# and the shards it places them on
SUBSTRATE_QUERIES = 8192
SUBSTRATE_SHARDS = 64
# Reddit's node count (the GNN_SHAPES minibatch_lg shape) and a tenth of
# its 114,615,892 edges: the host draws and sorts the edges inside the
# phase's time
REDDIT_NODES = 232_965
REDDIT_EDGES = 114_615_892 // 10
GNN_ZOO = ("gatedgcn", "gin-tu", "meshgraphnet", "graphsage-reddit")
# card against CPU: f32 products and segment sums add in other orders
# (cuBLAS against the CPU's BLAS, atomics in ``index_add_``)
SUBSTRATE_RTOL, SUBSTRATE_ATOL = 1e-4, 1e-5


def _phase_counts(total: dict, counts: dict, what: str, must) -> None:
    """Add a run's launch counts to ``total``; fail when a kernel of
    ``must`` (names, or tuples of names of which one must launch) did not
    launch."""
    _add_counts(total, counts)
    for need in must:
        names = (need,) if isinstance(need, str) else need
        if not any(counts.get(n, 0) for n in names):
            raise AssertionError(f"substrate {what}: none of {names} "
                                 f"launched ({counts})")


def _substrate_dlrm(dev, total):
    """(a) DLRM at the MLPerf width, tables capped: forward at serve_p99
    and serve_bulk, retrieval_scores at retrieval_cand, each timed with
    CUDA events after a warm-up; the p99 logits against the same module
    on the CPU over the rows the batch touches, the user bag (#9) against
    the bag-order sum on the card, bit for bit."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.data.recsys import click_batch
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.models.layers import batch_to
    full = dlrm_mlperf.CONFIG
    cfg = dataclasses.replace(full, table_sizes=tuple(
        min(t, SUBSTRATE_ROW_CAP) for t in full.table_sizes))
    shapes = {s.name: s.p() for s in DLRM_SHAPES}
    t0 = time.perf_counter()
    model = dlrm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    print(f"[substrate] dlrm {full.name}: D {cfg.embed_dim}, "
          f"{cfg.n_sparse} tables, bot {(cfg.n_dense,) + cfg.bot_mlp}, top "
          f"{(dlrm.interaction_dim(cfg),) + cfg.top_mlp}, {cfg.interaction}, "
          f"{cfg.dtype}; cut: each table capped at {SUBSTRATE_ROW_CAP} rows "
          f"(--max-ind-range): {cfg.total_rows} of {full.total_rows} rows, "
          f"{model.tables.nbytes / 1e9!r} GB; init {time.perf_counter() - t0!r}"
          f" s")
    rng = np.random.default_rng(0)
    p99 = click_batch(cfg, shapes["serve_p99"]["batch"], seed=1)
    bulk = click_batch(cfg, shapes["serve_bulk"]["batch"], seed=2)
    query = click_batch(cfg, shapes["retrieval_cand"]["batch"], seed=3)
    runs = {
        "serve_p99": (model, batch_to({k: p99[k] for k in ("dense",
                                                           "sparse_idx")},
                                      dev), 20),
        "serve_bulk": (model, batch_to({k: bulk[k] for k in (
            "dense", "sparse_idx")}, dev), 5),
        "retrieval_cand": (model.retrieval_scores, batch_to({
            "dense": query["dense"], "sparse_idx": query["sparse_idx"],
            "cand_idx": rng.integers(0, cfg.total_rows, shapes[
                "retrieval_cand"]["n_candidates"]).astype(np.int32)}, dev),
            20)}
    outs = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for name, (fn, batch, iters) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            outs[name] = fn(batch)
            ms = _time_ms(lambda: fn(batch), iters=iters, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 1e9
            b = batch["dense"].shape[0]
            print(f"[substrate] dlrm {name}: batch {b} -> "
                  f"{tuple(outs[name].shape)}, ms {ms!r} (CUDA events, mean "
                  f"of {iters} after 2 warm-up), peak device memory "
                  f"{peak!r} GB")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        _phase_counts(total, counts, "dlrm", ("embedding_bag",))
        print(f"[substrate] dlrm launches {counts}")
        for name, out in outs.items():
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"dlrm {name}: non-finite output")
        # p99 logits against the CPU over the rows the batch touches
        idx = runs["serve_p99"][1]["sparse_idx"]
        uniq, inv = torch.unique(idx, return_inverse=True)
        small = dataclasses.replace(cfg, table_sizes=(int(uniq.numel()),)
                                    + (0,) * (cfg.n_sparse - 1))
        cpu = dlrm.DLRM(small, device="cpu")
        cpu.tables = torch.nn.Parameter(model.tables[uniq].cpu())
        cpu.bot.load_state_dict(model.bot.state_dict())
        cpu.top.load_state_dict(model.top.state_dict())
        want = cpu({"dense": runs["serve_p99"][1]["dense"].cpu(),
                    "sparse_idx": inv.to(torch.int32).cpu()})
        got = outs["serve_p99"].cpu()
        torch.testing.assert_close(got, want, rtol=SUBSTRATE_RTOL,
                                   atol=SUBSTRATE_ATOL)
        print(f"[substrate] dlrm serve_p99 logits equal the CPU run over "
              f"the {int(uniq.numel())} rows touched (rtol {SUBSTRATE_RTOL}"
              f", atol {SUBSTRATE_ATOL}): max abs diff "
              f"{float((got - want).abs().max())!r}")
        # the user vector: #9 against the bag-order sum, bit for bit
        sparse = runs["retrieval_cand"][1]["sparse_idx"]
        bag = model.user_bag(sparse)
        plain = _bag_order_sum(model.tables.detach(), sparse, "sum")
        if not torch.equal(bag, plain):
            raise AssertionError("dlrm retrieval: the user bag (#9) differs "
                                 "from the bag-order sum")
        print("[substrate] dlrm retrieval_cand user bag through #9: "
              "bit-equal to the bag-order sum on the card")
    del model, runs, outs, cpu, fn, batch, bag, plain
    torch.cuda.empty_cache()


def _substrate_placement(dev, total) -> None:
    """(b) The three placements on the card, each checked on the host:
    cut (recount of the assignment), balance, reduction, kernels."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.apps import placement
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data.graphs import power_law_graph
    from repro_torch.data.recsys import click_batch
    from repro_torch.kernels import ops
    full = dlrm_mlperf.CONFIG
    cfg = dataclasses.replace(full, table_sizes=tuple(
        min(t, SUBSTRATE_ROW_CAP) for t in full.table_sizes))
    idx = click_batch(cfg, SUBSTRATE_QUERIES, seed=4)["sparse_idx"]
    uniq, inv = np.unique(idx, return_inverse=True)
    rows = inv.reshape(idx.shape)
    ei = power_law_graph(2500, 15000, seed=3)
    rng = np.random.default_rng(5)
    # top-2 routing of 65,536 tokens over 16 experts (Phi-3.5-MoE), with
    # a per-expert bias so that some experts are hot
    logits = rng.normal(size=(65536, 16)) + rng.normal(scale=0.5, size=16)
    trace = np.argsort(logits, axis=1)[:, -2:]
    gain = ("gain_table", "gain_stream", "gain_table_one", "gain_stream_one")
    rating = ("rating_segment_sum", "rating_segment_sum_batch")
    # (what, run, its hypergraph, k, eps, kernels it must launch); "fast"
    # (the experts) coarsens on the host as the reference's
    # multilevel_partition does, so only its refinement reaches the card
    runs = (
        ("dlrm rows", lambda: placement.partition_embedding_rows(
            rows, len(uniq), SUBSTRATE_SHARDS, quality="balanced",
            device=dev),
         lambda: placement.set_hypergraph(rows, len(uniq)), SUBSTRATE_SHARDS,
         0.10, (rating,)),
        ("gnn mesh", lambda: placement.partition_graph_for_mesh(
            ei, 2500, 16, quality="balanced", device=dev),
         lambda: placement.graph_hypergraph(ei, 2500), 16, 0.06, (rating,)),
        ("moe experts", lambda: placement.place_experts(trace, 4,
                                                        device=dev),
         lambda: placement.set_hypergraph(trace, 16), 4, 0.25, ()),
    )
    t_all = time.perf_counter()
    for what, run, build_hg, k, eps, must in runs:
        hg = build_hg()
        # LP gathers its gains through #1/#2/#5/#6 where a level carries
        # the dense incidence layout; hub vertices (a row that most queries
        # touch) make it exceed its size cap, and LP then assembles the
        # gains with plain segment sums, as the reference's routing does
        layout = hg.arrays(device=dev).incident is not None
        if layout:
            must = must + (gain,)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        cut, balanced, bw_max, cap = host_cut_and_balance(
            hg, res.assignment, k, eps)
        print(f"[substrate] placement {what}: n {hg.n} m {hg.m} pins "
              f"{hg.num_pins} max degree {hg.max_degree()} k {k} eps {eps}, "
              f"dense incidence layout {'yes' if layout else 'no'}: wall_s "
              f"{wall!r} cut "
              f"{res.cut!r} host cut {cut!r} random cut {res.random_cut!r} "
              f"reduction {res.reduction!r} max block {bw_max!r} cap "
              f"{cap!r}; launches "
              f"{ {n: c for n, c in counts.items() if c} }")
        if cut != res.cut or not balanced or not res.reduction > 0:
            raise AssertionError(f"placement {what}: host cut {cut} vs "
                                 f"{res.cut}, balanced={balanced}, "
                                 f"reduction {res.reduction}")
        _phase_counts(total, counts, f"placement {what}", must)
    print(f"[substrate] placement: Q {SUBSTRATE_QUERIES} queries touching "
          f"{len(uniq)} rows; the three runs {time.perf_counter() - t_all!r}"
          f" s")
    torch.cuda.empty_cache()


def _substrate_gnn(dev) -> None:
    """(c) The GNN zoo at its published widths: full_graph_sm (against
    the CPU run of the same module) and molecule for each arch, and
    graphsage-reddit's minibatch regime through ``NeighborSampler``."""
    import copy
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.graphs import full_graph_batch, molecule_batch
    from repro_torch.models import gnn
    from repro_torch.models.layers import batch_to
    shapes = {s.name: s.p() for s in GNN_SHAPES}
    sm, mol = shapes["full_graph_sm"], shapes["molecule"]
    gen = torch.Generator(dev).manual_seed(0)

    def timed(fn, batch):
        out = fn(batch)
        return out, _time_ms(lambda: fn(batch), iters=5, warmup=1)

    with torch.no_grad():
        for arch in GNN_ZOO:
            cfg = registry.get_arch(arch).config
            fe = gnn._edge_feat_dim(cfg)
            model = gnn.init_params(cfg, gen, sm["d_feat"], device=dev)
            host = full_graph_batch(sm["n_nodes"], sm["n_edges"],
                                    sm["d_feat"], cfg.n_classes, seed=0,
                                    need_edge_feat=fe)
            out, ms = timed(model.full_graph_logits, batch_to(host, dev))
            want = copy.deepcopy(model).cpu().full_graph_logits(
                batch_to(host, torch.device("cpu")))
            torch.testing.assert_close(out.cpu(), want, rtol=SUBSTRATE_RTOL,
                                       atol=SUBSTRATE_ATOL)
            mmodel = gnn.init_params(cfg, gen, cfg.d_feat, device=dev)
            mhost = molecule_batch(mol["batch"], mol["n_nodes"],
                                   mol["n_edges"], cfg.d_feat,
                                   cfg.n_classes, seed=1, need_edge_feat=fe)
            mout, mms = timed(mmodel.molecule_logits, batch_to(mhost, dev))
            if not (bool(torch.isfinite(out).all())
                    and bool(torch.isfinite(mout).all())):
                raise AssertionError(f"gnn {arch}: non-finite logits")
            print(f"[substrate] gnn {arch} ({cfg.n_layers} layers, d "
                  f"{cfg.d_hidden}): full_graph_sm {tuple(out.shape)} ms "
                  f"{ms!r}, equal to the CPU run (rtol {SUBSTRATE_RTOL}, "
                  f"atol {SUBSTRATE_ATOL}; max abs diff "
                  f"{float((out.cpu() - want).abs().max())!r}); molecule "
                  f"{tuple(mout.shape)} ms {mms!r}")
        cfg = registry.get_arch("graphsage-reddit").config
        mb = shapes["minibatch_lg"]
        smp, edges, build_s = _reddit_sampler(cfg, cfg.sample_sizes)
        t1 = time.perf_counter()
        host = smp.batch(mb["batch_nodes"])
        t2 = time.perf_counter()
        host.pop("labels")
        model = gnn.init_params(cfg, gen, cfg.d_feat, device=dev)
        out, ms = timed(model.minibatch_logits, batch_to(host, dev))
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("gnn graphsage-reddit minibatch: "
                                 "non-finite logits")
        print(f"[substrate] gnn graphsage-reddit minibatch: "
              f"{REDDIT_NODES} nodes, {edges} edges (cut: a tenth "
              f"of minibatch_lg's {mb['n_edges']}), fanout "
              f"{cfg.sample_sizes}, {mb['batch_nodes']} roots: graph and "
              f"sampler {build_s!r} s, batch {t2 - t1!r} s, logits "
              f"{tuple(out.shape)} ms {ms!r}")
    torch.cuda.empty_cache()


def run_substrate_path(must_launch):
    """Phase ``substrate``: the placement substrate's serving path
    (``repro_torch.models``, ``repro_torch.apps.placement``) at its
    published widths: (a) DLRM, (b) placement, (c) the GNN zoo.  Returns
    the launches of its main paths (the comparisons' own launches left
    out)."""
    import torch
    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is enabled; the port stays in f32")
    total = {}
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _substrate_dlrm(dev, total)
    t1 = time.perf_counter()
    _substrate_placement(dev, total)
    t2 = time.perf_counter()
    _substrate_gnn(dev)
    t3 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[substrate] wall_s dlrm {t1 - t0!r} placement {t2 - t1!r} gnn "
          f"{t3 - t2!r} total {t3 - t0!r}; launches "
          f"{ {n: c for n, c in total.items() if c} }; device memory "
          f"allocated before {before!r} B, after {torch.cuda.memory_allocated()!r}"
          f" B, reserved after {torch.cuda.memory_reserved()!r} B")
    missing = [n for n in must_launch if total.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"substrate path: kernels never launched: "
                             f"{missing}")
    return total


# the lm phase: LM serving (``ServeSession``) at the published widths in
# bf16.  Per architecture: (layers kept, None for all; generate batch,
# prompt length, new tokens, max_seq; score batch, score length).  The
# prompts are 192 and 64 tokens (448 and 192 took 17.4 and 10.9 s to the
# first token), to keep the script inside its limit with the train phase.
# Phi-3.5-MoE keeps 16 of its 32 layers: all 32 need 84 GB in bf16, more
# than the card holds; every layer is a MoE layer, so 16 hold every kind.
# Its score batch keeps B * S a multiple of the 256 MoE token groups.
LM_RUNS = {
    "codeqwen1.5-7b": (None, 16, 192, 64, 256, 4, 2048),
    "phi3.5-moe-42b-a6.6b": (16, 16, 64, 64, 128, 4, 1024),
}
# gates (i) and (ii): each architecture at full width with 2 layers in
# f32, on the card and on the CPU; a prefill of 2 x 256 tokens (phi's MoE
# then runs 256 groups of 2 tokens at capacity 1, so full experts drop
# tokens) and 4 decode steps; (ii) generates 16 tokens after a 16-token
# prompt.  f32 sums over up to 26,880 products add in another order on
# the two devices: about 1e-5 of a logit of about 1 at these widths, so
# rtol and atol 1e-4
LM_GATE_LAYERS, LM_GATE_BATCH, LM_GATE_SEQ, LM_GATE_STEPS = 2, 2, 256, 4
LM_GATE_PROMPT, LM_GATE_GEN = 16, 16
LM_GATE_RTOL, LM_GATE_ATOL = 1e-4, 1e-4
# decode steps of each bf16 model traced with torch.profiler
LM_TRACE_STEPS = 2
# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core rate at 700 W
BF16_OPS_PER_S = 989e12


def _lm_gates(aid: str, dev) -> None:
    """(i) ``aid`` at full width, ``LM_GATE_LAYERS`` layers, f32: prefill
    logits and ``LM_GATE_STEPS`` decode steps on the card equal the same
    module on the CPU; (ii) for a dense model, greedy ``generate`` on the
    card equals the argmax of ``prefill_logits`` over [prompt |
    generated] at every generated position."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.serve import ServeSession
    cfg = dataclasses.replace(registry.get_arch(aid).config,
                              n_layers=LM_GATE_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, torch.Generator(dev).manual_seed(1),
                                    device=dev)
    cpu = transformer.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LM_GATE_BATCH, LM_GATE_SEQ)).astype(np.int32))
    tol = dict(rtol=LM_GATE_RTOL, atol=LM_GATE_ATOL)
    got = transformer.prefill_logits(model, toks.to(dev)).cpu()
    want = transformer.prefill_logits(cpu, toks)
    torch.testing.assert_close(got, want, **tol)
    diffs = [float((got - want).abs().max())]
    cache = transformer.init_cache(cfg, LM_GATE_BATCH, LM_GATE_STEPS, dev)
    cache_cpu = transformer.init_cache(cfg, LM_GATE_BATCH, LM_GATE_STEPS,
                                       "cpu")
    for i in range(LM_GATE_STEPS):
        got, cache = transformer.decode_step(model, cache,
                                             toks[:, i:i + 1].to(dev), i)
        want, cache_cpu = transformer.decode_step(cpu, cache_cpu,
                                                  toks[:, i:i + 1], i)
        torch.testing.assert_close(got.cpu(), want, **tol)
        diffs.append(float((got.cpu() - want).abs().max()))
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), cache_cpu[name], **tol)
    print(f"[lm] gate (i) {aid} at full width, {cfg.n_layers} layers, f32 "
          f"(TF32 off): prefill {LM_GATE_BATCH}x{LM_GATE_SEQ} and "
          f"{LM_GATE_STEPS} decode steps equal the CPU run (rtol "
          f"{LM_GATE_RTOL}, atol {LM_GATE_ATOL}); max abs diff prefill "
          f"{diffs[0]!r}, decode {max(diffs[1:])!r}")
    if not cfg.moe_experts:
        sess = ServeSession(cfg=cfg, params=model, batch=LM_GATE_BATCH,
                            max_seq=LM_GATE_PROMPT + LM_GATE_GEN)
        prompt = toks[:, :LM_GATE_PROMPT].to(dev)
        gen, _ = sess.generate(prompt, LM_GATE_GEN)
        greedy = transformer.prefill_logits(
            model, torch.cat([prompt, gen], dim=1)).argmax(dim=-1)
        picks = greedy[:, LM_GATE_PROMPT - 1:-1].to(torch.int32)
        if not torch.equal(picks, gen):
            raise AssertionError(f"lm gate (ii) {aid}: greedy decode "
                                 f"differs from prefill's argmax at "
                                 f"{int((picks != gen).sum())} positions")
        print(f"[lm] gate (ii) {aid} f32 on the card: greedy generate of "
              f"{LM_GATE_GEN} tokens after {LM_GATE_PROMPT} equals "
              f"prefill's argmax at every generated position")
    del model, cpu, cache, cache_cpu
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm] gates {aid}: {time.perf_counter() - t0!r} s")


class _DecodeLog:
    """Wrap ``transformer.decode_step`` as ``ServeSession.generate`` calls
    it: after each step record a CUDA event, and fold into device flags
    (read once at the end, so no step waits) that its logits are finite,
    that it wrote row ``pos`` of both caches (every layer, batch row and
    KV head holds a non-zero) and that row ``pos + 1`` is still zero;
    after the first step, that every row past it is zero.  ``restore``
    undoes it."""

    def __init__(self, dev):
        import torch
        from repro_torch.models import transformer
        self.module, self.fn = transformer, transformer.decode_step
        self.events = []
        self.flags = {name: torch.ones((), dtype=torch.bool, device=dev)
                      for name in ("finite", "written", "later rows zero")}

        def wrapped(model, cache, tokens, pos):
            logits, cache = self.fn(model, cache, tokens, pos)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.flags["finite"] &= torch.isfinite(logits).all()
            for c in (cache["k"], cache["v"]):
                self.flags["written"] &= (c[:, :, pos] != 0).any(-1).all()
                later = c[:, :, pos + 1:] if pos == 0 else c[:, :, pos + 1:
                                                              pos + 2]
                self.flags["later rows zero"] &= ~later.any()
            return logits, cache
        transformer.decode_step = wrapped

    def restore(self) -> None:
        self.module.decode_step = self.fn

    def failed(self) -> list:
        return [name for name, ok in self.flags.items() if not bool(ok)]


def _lm_trace_decode(aid: str, model, cfg, tok, max_seq: int, dev) -> None:
    """``LM_TRACE_STEPS`` decode steps at ``generate``'s batch and
    ``max_seq`` (a fresh cache, after one untraced step) under
    ``torch.profiler``: the device's busy share of the traced wall, the
    kernels a step, and the kernels that take most of the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, tok.shape[0], max_seq, dev)
    transformer.decode_step(model, cache, tok, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pos in range(1, 1 + LM_TRACE_STEPS):
            transformer.decode_step(model, cache, tok, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    n = LM_TRACE_STEPS
    print(f"[lm] {aid} decode traced ({n} steps): wall {wall / n * 1e3!r} ms "
          f"a step, device busy {busy / n * 1e3!r} ms a step, busy share "
          f"{busy / wall!r}, {sum(r[2] for r in rows) / n!r} kernels a step")
    for dev_us, key, count in sorted(rows, reverse=True)[:6]:
        print(f"[lm] {aid} decode {dev_us / n / 1e3:.3f} ms a step  "
              f"{count // n} calls  {key[:90]}")
    del cache


def _lm_serve(aid: str, run, dev) -> None:
    """(iii) ``aid`` at its published widths in bf16 (``run`` from
    ``LM_RUNS``): ``ServeSession.generate`` on a ``TokenStream`` prompt
    with each decode step checked (``_DecodeLog``) and timed, the share
    of generated tokens that prefill's argmax picks, and ``score``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ArchSpec, ShapeSpec
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.launch.analytic import model_flops
    from repro_torch.models import transformer
    from repro_torch.serve import ServeSession
    layers, gb, s0, steps, max_seq, sb, ss = run
    full = registry.get_arch(aid).config
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                    device=dev)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.nbytes for p in model.parameters())
    cut = ("not cut" if layers is None else
           f"cut: {layers} of its {full.n_layers} layers")
    print(f"[lm] {aid}: d {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, experts "
          f"{cfg.moe_experts} (top-{cfg.moe_top_k if cfg.moe_experts else 0}"
          f"), {cfg.dtype}; {cfg.n_layers} layers ({cut}); {params} "
          f"parameters, {weight_bytes / 1e9!r} GB; init "
          f"{time.perf_counter() - t0!r} s")
    prompt = torch.from_numpy(TokenStream(cfg.vocab, gb, s0, seed=0)
                              .next_batch(0)["tokens"]).to(dev)
    sess = ServeSession(cfg=cfg, params=model, max_seq=max_seq, batch=gb)
    log = _DecodeLog(dev)
    start = torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        start.record()
        gen, last = sess.generate(prompt, steps)
        torch.cuda.synchronize()
    finally:
        log.restore()
    failed = log.failed()
    if (failed or len(log.events) != s0 + steps
            or tuple(gen.shape) != (gb, steps)
            or not bool(torch.isfinite(last).all())):
        raise AssertionError(f"lm {aid} generate: checks failed {failed}, "
                             f"{len(log.events)} steps, {tuple(gen.shape)}")
    ttft = start.elapsed_time(log.events[s0 - 1])
    step_ms = log.events[s0 - 1].elapsed_time(log.events[-1]) / steps
    cache_bytes = (2 * cfg.n_layers * gb * max_seq * cfg.n_kv_heads
                   * cfg.d_head * model.embed.element_size())
    # a step reads every weight but the embedding table, of which it
    # gathers gb rows, and the whole cache
    step_bytes = (weight_bytes - model.embed.nbytes
                  + gb * model.embed[0].nbytes + cache_bytes)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm] {aid} generate: batch {gb}, prompt {s0} (TokenStream seed "
          f"0), {steps} new, max_seq {max_seq}, cache {cache_bytes / 1e9!r} "
          f"GB: time to first token {ttft!r} ms (the prompt's {s0} decode "
          f"steps), decode {step_ms!r} ms a step over the {steps} generated "
          f"steps (CUDA events; each step's checks included), "
          f"{gb * 1e3 / step_ms!r} tokens/s; byte bound {bound_ms!r} ms a "
          f"step ({step_bytes / 1e9!r} GB at {HBM_BYTES_PER_S / 1e12} TB/s), "
          f"{bound_ms / step_ms!r} of it; every logit finite, each step "
          f"wrote the cache at pos and left later rows zero")
    _lm_trace_decode(aid, model, cfg, prompt[:, :1], max_seq, dev)
    full_seq = torch.cat([prompt, gen], dim=1)
    greedy = transformer.prefill_logits(model, full_seq).argmax(dim=-1)
    same = (greedy[:, s0 - 1:-1].to(torch.int32) == gen).float().mean()
    print(f"[lm] {aid} generated tokens that prefill's argmax over "
          f"[prompt | generated] also picks (bf16, no gate): {float(same)!r}")
    del greedy
    stoks = torch.from_numpy(TokenStream(cfg.vocab, sb, ss, seed=1)
                             .next_batch(0)["tokens"]).to(dev)
    scores = sess.score(stoks)
    if tuple(scores.shape) != (sb,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"lm {aid} score: {tuple(scores.shape)}, "
                             f"finite {bool(torch.isfinite(scores).all())}")
    ms = _time_ms(lambda: sess.score(stoks), iters=2, warmup=0)
    shape = ShapeSpec("score", "prefill", (("seq_len", ss),
                                           ("global_batch", sb)))
    flops = model_flops(ArchSpec(aid, cfg, (shape,), cfg), "score")
    rate = flops / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[lm] {aid} score: batch {sb} x {ss} tokens (TokenStream seed 1) "
          f"-> {tuple(scores.shape)} finite, {ms!r} ms (CUDA events, mean of "
          f"2 after one call), {flops / 1e12!r} TFLOP (model_flops, "
          f"prefill) = {rate / 1e12!r} TFLOP/s, {rate / BF16_OPS_PER_S!r} of "
          f"the {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 dense peak; peak "
          f"device memory {peak!r} GB")
    del model, sess, gen, last, prompt, stoks, scores, full_seq
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm] {aid}: {time.perf_counter() - t0!r} s")


def run_lm_path() -> None:
    """Phase ``lm``: LM serving (``repro_torch.models.transformer``,
    ``repro_torch.serve.ServeSession``) on the card.  Gates (i) and (ii)
    for both architectures, then (iii) each at its published widths in
    bf16, one model at a time.  No kernel of the port lies on this path;
    the launch counts are read to show it."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is enabled; the port stays in f32")
    before = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for aid in LM_RUNS:
        _lm_gates(aid, dev)
    t1 = time.perf_counter()
    for aid, run in LM_RUNS.items():
        _lm_serve(aid, run, dev)
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    print(f"[lm] wall_s gates {t1 - t0!r} serve {t2 - t1!r} total "
          f"{t2 - t0!r}; kernel launches "
          f"{ {n: c for n, c in counts.items() if c} }; device memory "
          f"allocated before {before!r} B, after "
          f"{torch.cuda.memory_allocated()!r} B")


# the train phase: training (``repro_torch.train.steps``, the AdamW
# update, the flash backward) on the card.  (i) gates, f32, card against
# CPU: each architecture at its published widths with
# ``TRAIN_GATE_LAYERS`` layer, ``TRAIN_GATE_BATCH`` sequences of
# ``TRAIN_GATE_SEQ`` tokens in 2 microbatches, one step from a state at
# step 200 with random moments (m ~ N(0, 1e-3^2), v ~ U(1e-7, 1e-6): an
# update smooth in the gradient); grok-1's SMOKE config with int8 moments
# (v ~ U(1e-4, 1e-3), so that no v quantises to a few steps of its
# block's scale, where m/sqrt(v) is ill-conditioned).
TRAIN_GATES = (("codeqwen1.5-7b", False), ("phi3.5-moe-42b-a6.6b", False),
               ("grok-1-314b", True))          # (arch, its SMOKE config)
# (128 tokens: at 256 the phase waited 16-35 s for the CPU on the H100 host)
TRAIN_GATE_LAYERS, TRAIN_GATE_BATCH, TRAIN_GATE_SEQ = 1, 2, 128
# f32 sums of up to 26,880 products in another order on the two devices
# (the lm phase's gates: 1e-4): loss, grad_norm, lr and the moments rtol
# 1e-4 (m atol 1e-6, v atol 1e-9: the gradient's last digits); the
# parameters rtol 1e-5, atol 1e-6 (an update is lr * delta, about 3e-4,
# and delta moves by about 1e-5 of itself with its gradient); int8
# moments within one quantiser step (a rounding boundary), scales rtol
# 1e-4
TRAIN_GATE_RTOL = 1e-4
TRAIN_GATE_TOL = {"['params']": (1e-5, 1e-6), "['m']": (1e-4, 1e-6),
                  "['v']": (1e-4, 1e-9)}
# (ii)-(iii) the LMs in bf16 at train_4k's sequence length, cut in depth
# and global batch (the config's 4 microbatches and remat kept): (layers,
# global batch).  All 32 layers of codeqwen need about 115 GB of state at
# 14 bytes a parameter (bf16 weights, f32 gradient accumulator, f32 m and
# v); 8 layers hold 2.615 B parameters.  Phi's 2 of 32 layers hold 2.863 B.
TRAIN_LM = {"codeqwen1.5-7b": (8, 8), "phi3.5-moe-42b-a6.6b": (2, 4)}
TRAIN_START_STEP = 200
TRAIN_WARMUP, TRAIN_TIMED = 1, 3
# (iv) the GNN zoo's training cells, 3 steps each
TRAIN_GNN = ("gatedgcn", "gin-tu", "meshgraphnet")
TRAIN_GNN_STEPS = 3
# (v) DLRM at the MLPerf widths, each table capped at DLRM_ROW_CAP rows
# (7,401,902 in all): the dense step holds p, the gradient, m and v of
# the [R, 128] f32 table (about 15 GB) and the update's temporaries.
# #4 at the sparse step's shape against its plain version (index_add_,
# whose atomics add in another order): runs of up to about 25,000
# per-sample gradients of mixed sign, whose two orders of addition
# differ by about sqrt(n) ulps of the partial sums (1.4e-9 seen against
# sums up to 3.4e-4): rtol 1e-4 and atol 1e-5 of the largest sum
TRAIN_DLRM_STEPS = 3
# (vi) the train CLI on the card in child processes: 6 steps unbroken,
# and 3 steps then a resume to 6, checkpoints every 3
TRAIN_CLI = ("--arch", "codeqwen1.5-7b", "--batch", "8", "--seq", "64",
             "--ckpt-every", "3", "--device", "cuda")
_REDDIT = {}


def _reddit_sampler(cfg, fanout):
    """graphsage-reddit's sampler with ``fanout`` over Reddit's node count
    and a tenth of its edges; the graph is drawn once a run (the
    substrate and train phases share it).  Returns (sampler, edges,
    seconds it took to draw the graph and build this sampler)."""
    import numpy as np
    from repro_torch.data.graphs import power_law_graph
    from repro_torch.data.sampler import NeighborSampler
    t0 = time.perf_counter()
    if not _REDDIT:
        rng = np.random.default_rng(0)
        _REDDIT["graph"] = (
            power_law_graph(REDDIT_NODES, REDDIT_EDGES, seed=0),
            rng.normal(size=(REDDIT_NODES, cfg.d_feat)).astype(np.float32),
            rng.integers(0, cfg.n_classes, REDDIT_NODES).astype(np.int32))
    ei, feats, labels = _REDDIT["graph"]
    smp = NeighborSampler(ei, REDDIT_NODES, feats, labels,
                          fanout=tuple(fanout), seed=0)
    return smp, int(ei.shape[1]), time.perf_counter() - t0


def _train_state(params, opt_cfg, dev, moments=None):
    """``{"params", "opt"}`` at ``TRAIN_START_STEP``: zero moments, or
    with ``moments=(seed, v_lo, v_hi)`` m ~ N(0, 1e-3^2) and v ~ U(v_lo,
    v_hi) drawn on ``dev`` (int8 when the config quantises them)."""
    import torch
    from repro_torch.optim import adamw
    opt = adamw.init(params, opt_cfg)
    opt["step"].fill_(TRAIN_START_STEP)
    if moments is not None:
        seed, lo, hi = moments
        gen = torch.Generator(dev).manual_seed(seed)

        def draw(p, kind):
            x = torch.empty(p.shape, dtype=torch.float32, device=dev)
            if kind == "m":
                x.normal_(generator=gen).mul_(1e-3)
            else:
                x.uniform_(lo, hi, generator=gen)
            if opt_cfg.quantize_moments:
                return adamw._quantize(x, opt_cfg.q_block, opt_cfg.q_row_mult)
            return x
        opt["m"] = adamw.tree_map(lambda p: draw(p, "m"), params)
        opt["v"] = adamw.tree_map(lambda p: draw(p, "v"), params)
    return {"params": params, "opt": opt}


def _state_to(state, dev):
    """A copy of a train state on ``dev``."""
    from repro_torch.optim import adamw

    def copy(x):
        if isinstance(x, adamw.QTensor):
            return adamw.QTensor(copy(x.q), copy(x.scale), x.shape)
        return x.detach().to(dev, copy=True)
    return adamw.tree_map(copy, state)


def _state_leaves(state):
    """(paths, detached leaves) of a train state, int8 moments as their
    ``q`` and ``scale``, in the reference's flatten order."""
    from repro_torch.checkpoint.manager import _flatten_with_paths
    paths, xs = _flatten_with_paths(state)
    return paths, [x.detach() for x in xs]


def _train_gate(aid: str, smoke: bool, dev):
    """(i), the card's part: one train step of ``aid`` (f32) on the card
    from a state whose copy stays on the host.  Returns the check to run
    on the CPU (``_train_gate_check``'s arguments): the host copy of the
    state before the step, the card's state after it (on the host), its
    metrics, the step's cell and batch."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import transformer
    from repro_torch.models.layers import batch_to
    from repro_torch.train import build_cell
    t0 = time.perf_counter()
    spec = registry.get_arch(aid)
    cfg = (registry.SMOKES[aid] if smoke else dataclasses.replace(
        spec.config, n_layers=TRAIN_GATE_LAYERS, dtype="float32"))
    cfg = dataclasses.replace(cfg, microbatches=2)
    opt_cfg = registry.get_opt(aid)
    shape = ShapeSpec("gate", "train", (("seq_len", TRAIN_GATE_SEQ),
                                        ("global_batch", TRAIN_GATE_BATCH)))
    cell = build_cell(dataclasses.replace(spec, config=cfg), shape,
                      opt_cfg=opt_cfg, n_devices=1)
    model = transformer.init_params(cfg, torch.Generator(dev).manual_seed(1),
                                    device=dev)
    n = sum(p.numel() for p in model.parameters())
    v_range = (1e-4, 1e-3) if opt_cfg.quantize_moments else (1e-7, 1e-6)
    state = _train_state(transformer.param_tree(model), opt_cfg, dev,
                         moments=(2,) + v_range)
    del model
    cpu = torch.device("cpu")
    before = _state_to(state, cpu)
    host = TokenStream(cfg.vocab, TRAIN_GATE_BATCH, TRAIN_GATE_SEQ,
                       seed=2).next_batch(0)
    state, got = cell.fn(state, batch_to(host, dev))
    got = {k: float(v) for k, v in got.items()}
    after = _state_to(state, cpu)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    what = (f"{aid} ({'SMOKE' if smoke else 'published widths'}, "
            f"{cfg.n_layers} layers, f32, TF32 off, {n} parameters, "
            f"{'int8' if opt_cfg.quantize_moments else 'f32'} moments)")
    return (what, cell, before, after, got, host,
            time.perf_counter() - t0)


def _close_in_pieces(a, b, rtol: float, atol: float, what: str) -> float:
    """``|a - b| <= atol + rtol * |b|`` everywhere (NaN fails), the test
    of ``torch.testing.assert_close``, in flat pieces of 2^24 elements so
    that a gate's billion-element leaves need no full-size temporaries on
    the host.  Returns the largest ``|a - b|``."""
    import torch
    fa, fb = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, fa.numel(), 1 << 24):
        pa, pb = fa[i:i + (1 << 24)], fb[i:i + (1 << 24)]
        d = (pa - pb).abs_()
        if not bool((d <= pb.abs().mul_(rtol).add_(atol)).all()):
            raise AssertionError(f"{what}: outside rtol {rtol}, atol {atol}"
                                 f" (max abs diff {float(d.max())!r})")
        worst = max(worst, float(d.max()))
    return worst


def _train_gate_check(what, cell, before, after, got, host, card_s) -> None:
    """(i), the CPU's part: the same step on the CPU from ``before``, held
    to the card's state ``after`` and metrics ``got``: loss, grad_norm,
    lr and every leaf."""
    import numpy as np
    import torch
    from repro_torch.models.layers import batch_to
    t0 = time.perf_counter()
    cpu_state, want = cell.fn(before, batch_to(host, torch.device("cpu")))
    cpu_s = time.perf_counter() - t0
    for key in ("loss", "grad_norm", "lr"):
        g, w = got[key], float(want[key])
        if not (np.isfinite(g) and abs(g - w) <= TRAIN_GATE_RTOL * abs(w)):
            raise AssertionError(f"train gate {what} {key}: card {g!r}, "
                                 f"cpu {w!r}")
    gp, gx = _state_leaves(after)
    wp, wx = _state_leaves(cpu_state)
    if gp != wp:
        raise AssertionError(f"train gate {what}: the states' paths differ")
    worst = {}
    for path, a, b in zip(gp, gx, wx):
        if a.dtype == torch.int8:
            d = int((a.int() - b.int()).abs().max())
            if d > 1:
                raise AssertionError(f"train gate {what} {path}: q differs "
                                     f"by {d}")
            worst["q steps"] = max(worst.get("q steps", 0), d)
            continue
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"train gate {what} {path} differs")
            continue
        key = next(k for k in TRAIN_GATE_TOL if k in path)
        rtol, atol = TRAIN_GATE_TOL[key]
        if path.endswith("[<flat index 1>]"):       # int8 moments' scales
            rtol, atol = TRAIN_GATE_RTOL, 0.0
        worst[key] = max(worst.get(key, 0.0),
                         _close_in_pieces(a, b, rtol, atol,
                                          f"train gate {what} {path}"))
    print(f"[train] gate (i) {what}: one step of {TRAIN_GATE_BATCH}x"
          f"{TRAIN_GATE_SEQ} tokens in 2 microbatches from step "
          f"{TRAIN_START_STEP} equals the CPU run: loss {got['loss']!r} (cpu "
          f"{float(want['loss'])!r}), grad_norm {got['grad_norm']!r} (cpu "
          f"{float(want['grad_norm'])!r}), lr {got['lr']!r}; every leaf "
          f"within {TRAIN_GATE_TOL}, max abs diffs {worst}; card {card_s!r} "
          f"s, cpu {cpu_s!r} s")


def _moved_probe(state) -> dict:
    """Each leaf's sum (f64, or int64 for an int8 moment; the moments'
    scales and the step left out), to tell later which leaves moved."""
    import torch
    paths, xs = _state_leaves(state)
    return {path: torch.sum(x.detach(), dtype=(
        torch.float64 if x.is_floating_point() else torch.int64))
        for path, x in zip(paths, xs)
        if not path.endswith("[<flat index 1>]") and "['step']" not in path}


def _beyond_reach(leaf, opt_cfg) -> bool:
    """Whether no AdamW step can move the bf16 ``leaf``: every element is
    nonzero and half its bf16 spacing, at least 2^(floor(log2|x|) - 9),
    exceeds ``lr`` times the largest ``|delta|``: ``|m^|/sqrt(v^)`` is at
    most (1 - b1) / sqrt(1 - b2) / (1 - b1 / sqrt(b2)) (5.83 at the default
    betas), plus ``wd * |p|``.  (A bf16 norm scale at 1.0 with lr 3e-4.)"""
    import torch
    if leaf.dtype != torch.bfloat16:
        return False
    x = leaf.detach().float().abs()
    if not bool((x > 0).all()):
        return False
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    ratio = (1 - b1) / (1 - b2) ** 0.5 / (1 - b1 / b2 ** 0.5)
    reach = opt_cfg.lr * (ratio + opt_cfg.weight_decay * float(x.max()))
    half = torch.exp2(torch.floor(torch.log2(x)) - 9)
    return bool((half > reach).all())


def _check_moved(probe: dict, state, opt_cfg, what: str) -> str:
    """Fail unless every leaf moved, but a bf16 parameter that
    ``_beyond_reach`` says no step can move; returns a note naming those."""
    paths, xs = _state_leaves(state)
    leaf = dict(zip(paths, xs))
    now = _moved_probe(state)
    unmoved = [p for p, was in probe.items() if bool(now[p] == was)]
    frozen = [p for p in unmoved
              if "['params']" in p and _beyond_reach(leaf[p], opt_cfg)]
    if len(frozen) != len(unmoved):
        raise AssertionError(f"train {what}: leaves that did not move: "
                             f"{sorted(set(unmoved) - set(frozen))}")
    if not frozen:
        return "every parameter leaf and both moments moved"
    return (f"every leaf moved but the bf16 parameters {frozen}, which no "
            f"step can move (half a bf16 ulp of each element exceeds lr "
            f"times the largest |delta|), and whose moments moved")


def _timed_steps(cell, state, batches, dev, what: str):
    """Run ``cell.fn`` over ``batches`` (host dicts), each step timed on
    the host clock around work that ends in a synchronize.  Returns (state,
    per-step ms, per-step metrics as floats)."""
    import numpy as np
    import torch
    from repro_torch.models.layers import batch_to
    ms, metrics = [], []
    for host in batches:
        batch = batch_to(host, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = cell.fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if not all(np.isfinite(v) for v in metrics[-1].values()):
            raise AssertionError(f"train {what}: non-finite {metrics[-1]}")
    return state, ms, metrics


def _trace_step(cell, state, host, dev, what: str):
    """One step under ``torch.profiler``: the device's busy share of the
    traced wall and the kernels that take most of its time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import batch_to
    batch = batch_to(host, dev)
    torch.cuda.synchronize()
    # device activity only: the busy share needs the kernels, and a
    # trace of every host op of a step takes longer to read than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = cell.fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[train] {what} traced step: wall {wall * 1e3!r} ms, device busy "
          f"{busy * 1e3!r} ms, busy share {busy / wall!r}, "
          f"{sum(r[2] for r in rows)} kernels")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        print(f"[train] {what} {dev_us / 1e3:.3f} ms ({dev_us / 1e6 / busy:.3f}"
              f" of busy)  {count} calls  {key[:90]}")
    return state


def _train_lm(aid: str, layers: int, gbatch: int, dev) -> None:
    """(ii)/(iii) ``aid`` at its published widths in bf16, ``layers``
    layers, train_4k's sequence length at global batch ``gbatch``:
    ``TRAIN_WARMUP`` + ``TRAIN_TIMED`` steps and one traced step from
    step 200 with zero moments."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ArchSpec, ShapeSpec
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.launch.analytic import model_flops
    from repro_torch.models import transformer
    from repro_torch.train import build_cell
    spec = registry.get_arch(aid)
    full = spec.config
    cfg = dataclasses.replace(full, n_layers=layers)
    seq = int(spec.shape("train_4k").p()["seq_len"])
    shape = ShapeSpec("train_4k", "train", (("seq_len", seq),
                                            ("global_batch", gbatch)))
    opt_cfg = registry.get_opt(aid)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                    device=dev)
    n = sum(p.numel() for p in model.parameters())
    state = _train_state(transformer.param_tree(model), opt_cfg, dev)
    del model
    cell = build_cell(dataclasses.replace(spec, config=cfg), shape,
                      opt_cfg=opt_cfg, n_devices=1)
    ts = TokenStream(cfg.vocab, gbatch, seq, seed=0)
    batches = [ts.next_batch(i) for i in range(TRAIN_WARMUP + TRAIN_TIMED
                                               + 1)]
    torch.cuda.synchronize()
    print(f"[train] {aid}: d {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, experts "
          f"{cfg.moe_experts}, {cfg.dtype}, grad accumulation "
          f"{cfg.grad_accum_dtype}, remat {cfg.remat}; {layers} of "
          f"{full.n_layers} layers (cut), global batch {gbatch} of "
          f"{spec.shape('train_4k').p()['global_batch']} (cut) in "
          f"{cfg.microbatches} microbatches of {gbatch // cfg.microbatches}"
          f" x {seq} tokens; {n} parameters; init {time.perf_counter() - t0!r}"
          f" s")
    probe = _moved_probe(state)
    state, wms, _ = _timed_steps(cell, state, batches[:TRAIN_WARMUP], dev,
                                 aid)
    state, ms, metrics = _timed_steps(cell, state, batches[TRAIN_WARMUP:-1],
                                      dev, aid)
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = model_flops(ArchSpec(aid, cfg, (shape,), cfg), "train_4k")
    tokens = gbatch * seq
    for i, (t, m) in enumerate(zip(ms, metrics)):
        rate = flops / (t / 1e3)
        print(f"[train] {aid} step {i + 1} of {TRAIN_TIMED}: {t!r} ms, "
              f"{tokens * 1e3 / t!r} tokens/s, {rate / 1e12!r} TFLOP/s "
              f"(model_flops {flops / 1e12!r} TFLOP a step), "
              f"{rate / BF16_OPS_PER_S!r} of the "
              f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; loss "
              f"{m['loss']!r} grad_norm {m['grad_norm']!r} lr {m['lr']!r}")
    state = _trace_step(cell, state, batches[-1], dev, aid)
    moved = _check_moved(probe, state, opt_cfg, aid)
    print(f"[train] {aid}: warm-up step {wms[0]!r} ms; timed mean "
          f"{sum(ms) / len(ms)!r} ms; {moved}; peak device memory {peak!r} GB; "
          f"{time.perf_counter() - t0!r} s")
    del state, probe
    gc.collect()
    torch.cuda.empty_cache()


def _train_gnn(dev) -> None:
    """(iv) the GNN zoo's train cells at their published widths:
    full_graph_sm and molecule for ``TRAIN_GNN``, graphsage-reddit's
    minibatch_lg over the Reddit-sized graph; ``TRAIN_GNN_STEPS`` steps
    each from step 200."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.graphs import full_graph_batch, molecule_batch
    from repro_torch.launch.analytic import model_flops
    from repro_torch.models import gnn
    from repro_torch.train import build_cell, steps
    gen = torch.Generator(dev).manual_seed(3)
    runs = []
    for arch in TRAIN_GNN:
        for name in ("full_graph_sm", "molecule"):
            runs.append((arch, name))
    runs.append(("graphsage-reddit", "minibatch_lg"))
    for arch, name in runs:
        spec = registry.get_arch(arch)
        cfg = spec.config
        shape = spec.shape(name)
        p = shape.p()
        fe = gnn._edge_feat_dim(cfg)
        d_feat = int(p.get("d_feat", cfg.d_feat))
        cell = build_cell(spec, shape, opt_cfg=registry.get_opt(arch))
        model = gnn.init_params(cfg, gen, d_feat, cfg.n_classes, device=dev)
        state = _train_state(gnn.param_tree(model), registry.get_opt(arch),
                             dev)
        extra = ""
        if name == "full_graph_sm":
            batches = [steps.pad_edges(full_graph_batch(
                p["n_nodes"], p["n_edges"], d_feat, cfg.n_classes, seed=i,
                need_edge_feat=fe)) for i in range(TRAIN_GNN_STEPS)]
            extra = (f"{p['n_nodes']} nodes, {p['n_edges']} edges padded "
                     f"to {batches[0]['edge_index'].shape[1]}")
        elif name == "molecule":
            batches = [molecule_batch(p["batch"], p["n_nodes"], p["n_edges"],
                                      cfg.d_feat, cfg.n_classes, seed=i,
                                      need_edge_feat=fe)
                       for i in range(TRAIN_GNN_STEPS)]
            extra = (f"{p['batch']} graphs of {p['n_nodes']} nodes, "
                     f"{p['n_edges']} edges")
        else:
            smp, edges, build_s = _reddit_sampler(cfg, p["fanout"])
            batches = [smp.batch(p["batch_nodes"])
                       for _ in range(TRAIN_GNN_STEPS)]
            extra = (f"{REDDIT_NODES} nodes, {edges} edges (a tenth of "
                     f"{p['n_edges']}; graph and sampler {build_s!r} s), "
                     f"{p['batch_nodes']} roots, fanout {p['fanout']}")
        probe = _moved_probe(state)
        torch.cuda.reset_peak_memory_stats()
        state, ms, metrics = _timed_steps(cell, state, batches, dev,
                                          f"{arch} {name}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        moved = _check_moved(probe, state, registry.get_opt(arch),
                             f"gnn {arch} {name}")
        unit, count = (("nodes", p["n_nodes"]) if name == "full_graph_sm"
                       else ("graphs", p["batch"]) if name == "molecule"
                       else ("roots", p["batch_nodes"]))
        flops = model_flops(spec, name)
        print(f"[train] gnn {arch} {name} ({cfg.n_layers} layers, d "
              f"{cfg.d_hidden}, f32; {extra}): ms a step {ms!r}; "
              f"{unit}/s {[count * 1e3 / t for t in ms]!r}; TFLOP/s "
              f"{[flops / t / 1e9 for t in ms]!r} (model_flops "
              f"{flops / 1e12!r} TFLOP a step; the f32 peak "
              f"{F32_OPS_PER_S / 1e12:.0f}); peak device memory {peak!r} "
              f"GB; loss {[m['loss'] for m in metrics]!r}; grad_norm "
              f"{metrics[-1]['grad_norm']!r}; {moved}")
        del model, state, probe
    gc.collect()
    torch.cuda.empty_cache()


def _train_dlrm(dev):
    """(v) DLRM at the MLPerf widths (tables capped at DLRM_ROW_CAP rows)
    at train_batch's 65,536 samples: ``TRAIN_DLRM_STEPS`` dense steps,
    then the sparse step ``TRAIN_DLRM_STEPS`` times from one state twice,
    which must give the same bits.  Returns the sparse steps' state and
    the last batch (for the kernel check)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.recsys import click_batch
    from repro_torch.launch.analytic import model_flops
    from repro_torch.models import dlrm
    from repro_torch.train import steps
    spec = registry.get_arch("dlrm-mlperf")
    cfg = dataclasses.replace(spec.config, table_sizes=tuple(
        min(s, DLRM_ROW_CAP) for s in spec.config.table_sizes))
    spec = dataclasses.replace(spec, config=cfg)
    shape = spec.shape("train_batch")
    b = int(shape.p()["batch"])
    opt_cfg = registry.get_opt("dlrm-mlperf")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dlrm.init_params(cfg, torch.Generator(dev).manual_seed(4),
                             device=dev)
    state = _train_state(dlrm.param_tree(model), opt_cfg, dev)
    del model
    batches = [click_batch(cfg, b, seed=i) for i in range(
        2 * TRAIN_DLRM_STEPS)]
    rows = state["params"]["tables"].shape[0]
    probe = _moved_probe(state)
    dense = steps.dlrm_train_cell(spec, shape, opt_cfg)
    state, ms, metrics = _timed_steps(dense, state,
                                      batches[:TRAIN_DLRM_STEPS], dev,
                                      "dlrm dense")
    moved = _check_moved(probe, state, opt_cfg, "dlrm dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = model_flops(spec, "train_batch")
    print(f"[train] dlrm dense ({rows} table rows of {cfg.embed_dim}, "
          f"capped at {DLRM_ROW_CAP} a table; batch {b}; f32): ms a step "
          f"{ms!r}, samples/s {[b * 1e3 / t for t in ms]!r}, TFLOP/s "
          f"{[flops / t / 1e9 for t in ms]!r} (model_flops "
          f"{flops / 1e12!r} TFLOP a step; the f32 peak "
          f"{F32_OPS_PER_S / 1e12:.0f}); loss "
          f"{[m['loss'] for m in metrics]!r}; {moved}; peak device memory "
          f"{peak!r} GB")
    sparse = steps.dlrm_train_cell(spec, shape, opt_cfg, sparse_update=True)
    twin = _state_to(state, dev)
    runs = []
    for st in (state, twin):
        probe = _moved_probe(st)
        st, ms, metrics = _timed_steps(sparse, st,
                                       batches[TRAIN_DLRM_STEPS:], dev,
                                       "dlrm sparse")
        moved = _check_moved(probe, st, opt_cfg, "dlrm sparse")
        runs.append((st, ms, metrics))
    (a, ms, metrics), (b_state, ms2, _) = runs
    pa, xa = _state_leaves(a)
    _, xb = _state_leaves(b_state)
    differ = [p for p, x, y in zip(pa, xa, xb) if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"train dlrm sparse: two runs from one state "
                             f"differ in {differ}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] dlrm sparse: ms a step {ms!r} (second run {ms2!r}), "
          f"samples/s {[b * 1e3 / t for t in ms]!r}, TFLOP/s "
          f"{[flops / t / 1e9 for t in ms]!r}; loss "
          f"{[m['loss'] for m in metrics]!r}; two runs of "
          f"{TRAIN_DLRM_STEPS} steps from one state give the same bits in "
          f"all {len(pa)} leaves; {moved}; peak device memory "
          f"{peak!r} GB; {time.perf_counter() - t0!r} s")
    del state, twin, runs, b_state
    return a, batches[-1], cfg


def _check_sparse_sum_kernel(state, host, cfg, dev) -> None:
    """#4 at the DLRM sparse step's shape (the transposed per-occurrence
    row gradients [D, T] over their sorted run ids) against its plain
    version on the card, timed beside it and beside ``index_add_``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    idx = torch.from_numpy(host["sparse_idx"]).to(dev).reshape(-1)
    t = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    si = idx[order].long()
    run_start = torch.ones(t, dtype=torch.int32, device=dev)
    run_start[1:] = (si[1:] != si[:-1]).to(torch.int32)
    run_id = (torch.cumsum(run_start, 0) - 1).to(torch.int32)
    gen = torch.Generator(dev).manual_seed(5)
    g = torch.randn((cfg.embed_dim, t), generator=gen, device=dev) / t
    got = ops.rating_segment_sum_batch(g, run_id, t)
    want = ref.rating_segment_sum_batch_ref(g, run_id, t)
    atol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)
    if not torch.equal(got, ops.rating_segment_sum_batch(g, run_id, t)):
        raise AssertionError("#4 at the sparse step's shape: two launches "
                             "differ")
    ms = _time_ms(lambda: ops.rating_segment_sum_batch(g, run_id, t),
                  iters=5, warmup=1)
    plain = _time_ms(lambda: ref.rating_segment_sum_batch_ref(g, run_id, t),
                     iters=2, warmup=1)
    flat = g.t().contiguous()
    lib = _time_ms(lambda: torch.zeros_like(flat).index_add_(
        0, run_id.long(), flat), iters=5, warmup=1)
    bound, by = _bound_ms(g.nbytes + run_id.nbytes + g.nbytes, g.numel())
    runs = int(run_id[-1]) + 1
    print(f"[train] #4 at the sparse step's shape ({cfg.embed_dim} rows x "
          f"{t} ids in {runs} runs, longest "
          f"{int(torch.bincount(run_id).max())}): equal to its plain version "
          f"(rtol 1e-4, atol {atol!r}; max abs diff "
          f"{float((got - want).abs().max())!r}), the same bits twice; "
          f"{ms!r} ms (eager, CUDA events), plain {plain!r} ms, index_add_ "
          f"{lib!r} ms, bound {bound!r} ms ({by})")


class _TrainCli:
    """(vi) ``python -m repro_torch.launch.train`` on the card in child
    processes: ``TRAIN_CLI`` for 6 steps unbroken and for 3 steps, both
    started at once (``__init__``); then ``--resume`` to 6 (``resume``);
    ``finish`` holds the two final checkpoints bit for bit.  The phase
    starts them beside its untimed parts, so that no child shares the
    card with a timed step; ``stop`` ends any child still running."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.tmp = tempfile.TemporaryDirectory()
        self.env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        self.procs = [self._start("a", 6), self._start("b", 3)]
        self.logs = None

    def _start(self, d, steps, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             "--steps", str(steps), "--ckpt-dir",
             os.path.join(self.tmp.name, d), *extra],
            cwd=ROOT, env=self.env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    def wait_first(self) -> None:
        if self.logs is None:
            outs = [p.communicate(timeout=300) for p in self.procs]
            if any(p.returncode for p in self.procs):
                raise AssertionError(f"train cli failed: "
                                     f"{[o[1][-3000:] for o in outs]}")
            self.logs = [o[0] for o in outs]

    def resume(self) -> None:
        self.wait_first()
        self.procs.append(self._start("b", 6, "--resume"))

    def finish(self) -> None:
        import numpy as np
        from repro_torch.checkpoint import CheckpointManager
        out, err = self.procs[-1].communicate(timeout=300)
        if self.procs[-1].returncode or \
                "[train] resumed from step 3" not in out:
            raise AssertionError(f"train cli resume: {out} {err[-3000:]}")
        ma, la = CheckpointManager(os.path.join(self.tmp.name, "a"))._load(
            None)
        mb, lb = CheckpointManager(os.path.join(self.tmp.name, "b"))._load(
            None)
        if not (ma["step"] == mb["step"] == 6 and ma["paths"] == mb["paths"]
                and all(np.array_equal(x, y) for x, y in zip(la, lb))):
            raise AssertionError("train cli: the resumed run's state differs "
                                 "from the unbroken run's")
        print(f"[train] cli {' '.join(TRAIN_CLI)}: 6 steps unbroken and 3 + "
              f"--resume to 6 give the same final state bit for bit "
              f"({len(la)} leaves, cursor {mb['extra']['data_cursor']}); "
              f"{self.logs[0].strip().splitlines()[-1]}; "
              f"{out.strip().splitlines()[-1]}; "
              f"{time.perf_counter() - self.t0!r} s from the first start")

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        self.tmp.cleanup()


def run_train_path(must_launch) -> dict:
    """Phase ``train``: training on the card.  (vi)'s first two CLI runs
    start beside the gates; (i) the gates: grok-1's SMOKE gate whole, then
    each published-width gate's card step, whose CPU step and comparison
    run in a background thread while the card goes on (phi's beside
    (ii) and (iv), codeqwen's beside (iii) and (v); one at a time, so
    that the host holds one gate's states); with the launch counts
    zeroed, (ii)-(v) the main path: the LMs, the GNN zoo, DLRM's dense
    and sparse steps; #4
    against its plain version at the sparse step's shape; the CLI's
    resume.  Returns the main path's launches."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is enabled; the port stays in f32")
    before = torch.cuda.memory_allocated()
    walls = {}
    t0 = time.perf_counter()
    cli = _TrainCli()
    cpu_side = ThreadPoolExecutor(max_workers=1)
    try:
        for aid in (a for a, smoke in TRAIN_GATES if smoke):
            _train_gate_check(*_train_gate(aid, True, dev))
        dense_lm, moe_lm = (a for a, smoke in TRAIN_GATES if not smoke)
        job = cpu_side.submit(_train_gate_check,
                              *_train_gate(moe_lm, False, dev))
        cli.wait_first()
        walls["gates' card steps"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        _train_lm(dense_lm, *TRAIN_LM[dense_lm], dev)
        walls[dense_lm] = time.perf_counter() - t1
        # the GNN zoo's cells also run while phi's CPU step does (the card
        # waited 30.7 s for it after codeqwen alone)
        t1 = time.perf_counter()
        _train_gnn(dev)
        walls["gnn"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        job.result()
        walls["wait for the gates' cpu steps"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        job = cpu_side.submit(_train_gate_check,
                              *_train_gate(dense_lm, False, dev))
        walls["gates' card steps"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        _train_lm(moe_lm, *TRAIN_LM[moe_lm], dev)
        walls[moe_lm] = time.perf_counter() - t1
        t1 = time.perf_counter()
        state, host, cfg = _train_dlrm(dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        walls["dlrm"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        _check_sparse_sum_kernel(state, host, cfg, dev)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        cli.resume()
        job.result()
        cli.finish()
        walls["#4, cli resume, wait"] = time.perf_counter() - t1
    finally:
        cpu_side.shutdown(wait=True)
        cli.stop()
    print(f"[train] wall_s {walls!r} total {time.perf_counter() - t0!r}; "
          f"main path launches { {n: c for n, c in counts.items() if c} }; "
          f"device memory allocated before {before!r} B, after "
          f"{torch.cuda.memory_allocated()!r} B")
    missing = [n for n in must_launch if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"train path: kernels never launched: "
                             f"{missing}")
    return counts

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


def run_solo_compare(parent_root: str) -> None:
    """The one-request paths with the memetic operators off and the CLI
    (phases ``off`` and ``cli``) on the tree at ``parent_root`` and on
    this one, each through its own ``chip_smoke.py`` in a child process,
    in the order parent, this, this, parent: their walls beside a tree
    before a change to the refinement or the drivers."""
    for label, root in (("parent", parent_root), ("this", ROOT),
                        ("this", ROOT), ("parent", parent_root)):
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "chip_smoke.py"),
             "--phases=off,cli"], capture_output=True, text=True, cwd=root,
            timeout=900)
        if proc.returncode != 3:
            raise AssertionError(f"solo-compare run on {root} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            if (line.startswith("[main]") and "wall_s" in line) or (
                    line.startswith("[cli]") and "child wall_s" in line):
                print(f"[solo-compare] {label}: {line[:240]}")


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
    #9) at the shapes the kernel phase times them, #4 at the FM step's
    shape (the level saved by ``save_fm_level``; the kernel alone and the
    whole ``_gain_segsum`` with member rows), and #1 at k 32 and at the
    coarse level saved there, all in a CUDA graph (``_graph_ms``); #7 and
    #8 both warm (the pins read from L2) and cold (``_graph_cold_ms``);
    #9 with its ids cold, f32 and bf16, and the probe's draws
    (``embedding_bag_times``).  Uses only calls that older trees of the
    port have too."""
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
    del inc, bi, wi
    out.update(embedding_bag_times(*_dlrm_inputs(dev)))
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
        table, idx = _dlrm_inputs(dev)
        for draw, ids in _dlrm_draws(idx, table.shape[0]).items():
            print(f"[compare] embedding_bag f32 sum {draw} bound_ms "
                  f"{_embedding_bag_bound(table, ids)[0]!r}")
        print(f"[compare] embedding_bag bf16 sum zipf bound_ms "
              f"{_embedding_bag_bound(table.to(torch.bfloat16), idx)[0]!r}")
        del table, idx
        torch.cuda.empty_cache()
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


def _kernel_rows(prof) -> list:
    """(device us, name, calls) of each kernel in a ``torch.profiler``
    profile: kernels only, since an operator's device time repeats its
    kernels'."""
    import torch
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    return rows


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
    rows = _kernel_rows(prof)
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
    t_phase = [time.perf_counter()]

    def mark(name):
        # each phase's seconds, for the script's time budget (PERF.md §5)
        if name in phases or (name == "off" and "memetic" in phases):
            now = time.perf_counter()
            print(f"[phase] {name} {now - t_phase[0]!r} s")
            t_phase[0] = now

    if "kernels" in phases:
        check_gain_kernels(report, dev)
        check_gain_one_kernels(report, dev)
        check_rating_kernel(report, dev)
        check_rating_batch_kernel(report, dev)
        check_connectivity_kernels(report, dev)
        check_embedding_bag_kernel(report, dev)
        check_fixed_order_sums(dev)
    mark("kernels")
    # the card tests run in a child process beside the phases parity to
    # ops, and are checked before sched
    cards = CardTests() if "cardtests" in phases else None
    if "parity" in phases:
        check_small_parity()
    launches = {name: 0 for name in KERNEL_META}

    def add(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)

    off_cut = None
    mark("parity")
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
    mark("off")
    if "memetic" in phases:
        add(run_memetic_path("ibm08_like", 64, off_cut,
                             ("rating_segment_sum", "gain_stream"),
                             ("rating_segment_sum_batch",),
                             beta=MEMETIC_BETA))
    mark("memetic")
    if "cli" in phases:
        add(run_cli((("ibm08_like", 64, ("gain_stream_one",)),
                     ("ibm01_like", 16, ("gain_table_one",)))))
    mark("cli")
    if "ops" in phases:
        add(run_ops_path(("connectivity", "cutsize", "embedding_bag")))
    mark("ops")
    if cards is not None:
        cards.finish()
    mark("cardtests")
    if "sched" in phases:
        # #8 comes from the phase's card-side cut checks, which fail
        # unless they launch it
        add(run_sched_path("ibm01_like", 16, ("gain_table",
                                              "rating_segment_sum"),
                           ("rating_segment_sum_batch",), beta=SCHED_BETA))
    mark("sched")
    if "instances" in phases:
        add(run_instances_path(("gain_table", "rating_segment_sum")))
    mark("instances")
    if "incremental" in phases:
        add(run_incremental_path(("gain_stream", "gain_table",
                                  "rating_segment_sum",
                                  "rating_segment_sum_batch")))
    mark("incremental")
    if "service" in phases:
        add(run_service_path(("gain_table", "gain_stream",
                              "rating_segment_sum",
                              "rating_segment_sum_batch")))
    mark("service")
    if "popshard" in phases:
        add(run_popshard_path(("gain_table", "gain_stream",
                               "rating_segment_sum",
                               "rating_segment_sum_batch"), smi))
    mark("popshard")
    if "modelshard" in phases:
        add(run_modelshard_path(("rating_segment_sum",
                                 "rating_segment_sum_batch", "connectivity",
                                 "cutsize"), smi))
    mark("modelshard")
    if "substrate" in phases:
        add(run_substrate_path(("embedding_bag",)))
    mark("substrate")
    if "lm" in phases:
        run_lm_path()
    mark("lm")
    if "train" in phases:
        add(run_train_path(("rating_segment_sum_batch",)))
    mark("train")
    if "--profile" in sys.argv[1:]:
        for design, k in (("ibm08_like", 64), ("ibm01_like", 16)):
            profile_main_path(design, k)
        trace_main_path("ibm08_like", 64)
    for arg in sys.argv[1:]:
        if arg.startswith("--repair-cost="):
            run_repair_cost(os.path.abspath(arg.split("=", 1)[1]))
        if arg.startswith("--kernel-compare="):
            run_kernel_compare(os.path.abspath(arg.split("=", 1)[1]))
        if arg.startswith("--solo-compare="):
            run_solo_compare(os.path.abspath(arg.split("=", 1)[1]))
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
