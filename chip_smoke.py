#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Run from the root of a checkout, with one CUDA device and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. print the device and its power limit;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at odd shapes: the gain kernels must
   be exactly equal, the rating kernel allclose (rtol 1e-6) and
   bit-identical across two launches; time kernel, plain version and the
   library yardstick, and compute the least time the card could take;
4. a small instance refined on the card and on the CPU under host
   coarsening must give the same partition and cut;
5. the main path: ``impart_partition`` on ``ispd_like("ibm08_like")`` at
   k=64 (stream gain kernel) and on ``ispd_like("ibm01_like")`` at k=16
   (table gain kernel), with the launch counters zeroed before each run
   and read after it, the cut and balance recomputed in numpy.

With ``--profile`` the script then splits each main-path run into its
phases (coarsening, initial partition, LP, FM; host clock around
synchronized work) and traces the ibm08 run with ``torch.profiler`` to
report the device's busy share and its top kernels.

The line before the last holds the kernels as JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): HBM3 rate and f32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_META = {
    "gain_table": ("src/repro_torch/kernels/csrc/gain.cu",
                   "src/repro/kernels/gain.py:124"),
    "gain_stream": ("src/repro_torch/kernels/csrc/gain.cu",
                    "src/repro/kernels/gain.py:257"),
    "rating_segment_sum": ("src/repro_torch/kernels/csrc/rating.cu",
                           "src/repro/kernels/rating.py:93"),
}


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


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gain_inputs(hg, k: int, alpha: int, seed: int, dev):
    """Gain tables of a random population on ``hg``'s padded arrays."""
    import numpy as np
    import torch
    from repro_torch.core import metrics
    hga = hg.arrays(device=dev)
    if hga.incident is None:
        raise AssertionError("the finest level has no dense incidence layout")
    rng = np.random.default_rng(seed)
    parts = torch.from_numpy(
        rng.integers(0, k, (alpha, hga.n_pad)).astype(np.int32)).to(dev)
    phi = metrics.pins_in_block_population(hga, parts, k)
    bi, wi = metrics._edge_gain_terms(hga, phi)
    return hga.incident, bi.contiguous(), wi.contiguous()


def _odd_gain_inputs(alpha, n, d, m, k, seed, dev):
    """Random incidence with pads, degree-0 rows and integer tables."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, m, (n, d)).astype(np.int32)
    inc[rng.random((n, d)) < 0.3] = -1
    inc[rng.random(n) < 0.1] = -1          # degree-0 vertices
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
    cases = {
        "gain_stream": (gain.gain_stream_batch, ref.gain_stream_batch_ref,
                        ("ibm08_like", 64)),
        "gain_table": (gain.gain_gather_batch, ref.gain_gather_batch_ref,
                       ("ibm01_like", 16)),
    }
    odd = [(1, 1000, 8, 700, 2), (3, 1000, 8, 700, 33), (3, 777, 16, 1500, 64),
           (1, 300, 24, 513, 1024)]
    for name, (kern, plain, (design, k)) in cases.items():
        errs = []
        for i, shape in enumerate(odd):
            inc, bi, wi = _odd_gain_inputs(*shape, seed=i, dev=dev)
            got, want = kern(inc, bi, wi), plain(inc, bi, wi)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {shape}")
            errs.append(float((got - want).abs().max()))
        inc, bi, wi = _gain_inputs(ispd_like(design, 1.0), k, 7, 0, dev)
        got, want = kern(inc, bi, wi), plain(inc, bi, wi)
        again = kern(inc, bi, wi)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{design} k={k}")
        errs.append(float((got - want).abs().max()))
        del got, want, again
        ms = _time_ms(lambda: kern(inc, bi, wi))
        plain_ms = _time_ms(lambda: plain(inc, bi, wi), iters=5)
        lib_ms = _time_ms(lambda: ref.gain_gather_embedding_bag(inc, bi))
        bound, by = _gain_bound(inc, bi)
        print(f"[kernel] {name} {design} incident={tuple(inc.shape)} "
              f"tables={tuple(bi.shape)}: exact at main-path and "
              f"{len(odd)} odd shapes")
        for label, val in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bound)):
            print(f"[kernel] {name} {label} {val!r}")
        report[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        torch.cuda.empty_cache()


def check_rating_kernel(report, dev):
    import numpy as np
    import torch
    from repro_torch.core import dcoarsen
    from repro_torch.data.hypergraphs import ispd_like
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
    hga = ispd_like("ibm08_like", 1.0).arrays(device=dev)
    _, _, r, seg = dcoarsen._sorted_candidates(
        hga, None, max_stride=dcoarsen.MAX_STRIDE,
        max_edge_size=dcoarsen.MAX_EDGE_SIZE)
    c = r.shape[0]
    got = rating.rating_segment_sum(r, seg, c)
    again = rating.rating_segment_sum(r, seg, c)
    want = ref.rating_segment_sum_ref(r, seg, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    if not torch.equal(got, again):
        raise AssertionError("rating kernel not bit-stable on ibm08_like")
    errs.append(float((got - want).abs().max()))
    lengths = torch.bincount(seg.long())
    ms = _time_ms(lambda: rating.rating_segment_sum(r, seg, c))
    plain_ms = _time_ms(lambda: ref.rating_segment_sum_ref(r, seg, c))
    lib_ms = _time_ms(lambda: torch.segment_reduce(r, "sum", lengths=lengths))
    bound, by = _bound_ms(c * 8 + c * 4, c)
    print(f"[kernel] rating_segment_sum ibm08_like C={c}: allclose rtol=1e-6 "
          "and bit-stable at main-path and 5 odd shapes")
    for label, val in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
        print(f"[kernel] rating_segment_sum {label} {val!r}")
    report["rating_segment_sum"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)


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


def host_cut_and_balance(hg, part, k: int, eps: float):
    """Cut and balance of ``part`` recomputed in numpy."""
    import numpy as np
    eids = hg.pin_edge_ids().astype(np.int64)
    pairs = np.unique(eids * k + part[hg.pins].astype(np.int64))
    lam = np.bincount(pairs // k, minlength=hg.m)
    cut = float(hg.edge_weights.astype(np.float64)[lam > 1].sum())
    bw = np.bincount(part, weights=hg.vertex_weights, minlength=k)
    cap = (1.0 + eps) * np.ceil(hg.vertex_weights.sum() / k)
    return cut, bool((bw <= cap + 1e-6).all() and part.max() < k
                     and part.min() >= 0), float(bw.max()), float(cap)


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
    return counts


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
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    report = {}
    check_gain_kernels(report, dev)
    check_rating_kernel(report, dev)
    check_small_parity()
    launches = {name: 0 for name in KERNEL_META}
    for design, k, must in (("ibm08_like", 64, ("gain_stream",
                                                 "rating_segment_sum")),
                            ("ibm01_like", 16, ("gain_table",
                                                "rating_segment_sum"))):
        counts = run_main_path(design, k, must)
        for name in launches:
            launches[name] += counts[name]
    if "--profile" in sys.argv[1:]:
        for design, k in (("ibm08_like", 64), ("ibm01_like", 16)):
            profile_main_path(design, k)
        trace_main_path("ibm08_like", 64)

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
