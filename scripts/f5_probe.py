#!/usr/bin/env python3
"""Find what gives a stacked real-valued instance other bits than its
solo run on the card (ROADMAP queue 3, F5).

Run from the root of a checkout on a machine with one CUDA device:

    python3 scripts/f5_probe.py [--src DIR] [--no-service]

``--src`` imports ``repro_torch`` from ``DIR`` (default: this
checkout's ``src``), so the same probe runs on an older tree.  It
prints, each on its own line:

* ``[rows]``: for real-valued f32 rows, whether row 0 of ``x[:R]``
  summed over its last axis (``Tensor.sum(-1)``, as the population cut
  sums), scanned along it (``torch.cumsum``, as ``accept_moves``' prefix
  sums) or summed by the batched rating kernel keeps the bits it has
  alone, for R from 1 to 28;
* ``[offset]``: whether the rating kernel's sum of one run of values
  keeps its bits when the run starts at another offset of the array
  (the union level of a stack lays instance i's pins from i * p_pad);
* ``[service]``: the grouping that showed F5: ibm01_like (k 16)
  beside ibm08_like (k 64) cold and its first drift step as an
  incremental refresh, admitted at once into one 4-slot service, each
  answer against ``solve_solo``: whether the parts are equal, how many
  vertices differ, and the served and solo cuts.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe_rows(torch, rating) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    for length in (4096, 65536):
        x = (torch.rand((28, length), generator=gen) * 100.0).to(dev)
        segs = torch.zeros(length, dtype=torch.int32, device=dev)
        alone = {"sum": x[:1].sum(-1)[0], "cumsum": x[:1].cumsum(-1)[0],
                 "rating": rating.rating_segment_sum_batch(
                     x[:1].contiguous(), segs, 1)[0]}
        for name, base in alone.items():
            differ = []
            for rows in (2, 3, 4, 7, 8, 14, 21, 28):
                sub = x[:rows].contiguous()
                got = {"sum": lambda: sub.sum(-1)[0],
                       "cumsum": lambda: sub.cumsum(-1)[0],
                       "rating": lambda: rating.rating_segment_sum_batch(
                           sub, segs, 1)[0]}[name]()
                if not torch.equal(got, base):
                    differ.append(rows)
            print(f"[rows] {name} over {length} real values: row 0 of R "
                  f"rows differs from R=1 at R in {differ}")


def probe_offsets(torch, rating) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(6)
    run = (torch.rand(700, generator=gen) * 100.0).to(dev)
    sums = {}
    for off in (0, 4, 128, 512, 1024, 4096):
        c = off + run.numel() + 300
        vals = torch.zeros(c, device=dev)
        vals[off:off + run.numel()] = run
        segs = torch.full((c,), 2, dtype=torch.int32, device=dev)
        segs[:off] = 0
        segs[off:off + run.numel()] = 1
        sums[off] = rating.rating_segment_sum(vals, segs, 3)[1]
    same = [o for o, s in sums.items() if torch.equal(s, sums[0])]
    print(f"[offset] rating kernel, a run of 700 real values: the sum at "
          f"offset 0 is {sums[0].item()!r}; offsets with its bits {same}, "
          f"others {[(o, s.item()) for o, s in sums.items() if o not in same]}")


def probe_service(torch, np) -> None:
    from repro_torch.data.hypergraphs import drift_stream, ispd_like
    from repro_torch.serve import PartitionRequest, PartitionService
    ibm08 = ispd_like("ibm08_like", 1.0)
    svc = PartitionService(slots=4, alpha=4, lp_iters=8, sched="static",
                           device="cuda")
    cold = PartitionRequest(name="ibm08_like", hg=ibm08, k=64, eps=0.08)
    t0 = time.perf_counter()
    inc, _ = svc.solve_solo(cold)
    print(f"[service] ibm08_like solo cold {time.perf_counter() - t0!r} s")
    step0 = drift_stream(ibm08, 1, magnitude=0.15, tag="chip-incr")[0]
    reqs = [PartitionRequest(name="ibm01_like",
                             hg=ispd_like("ibm01_like", 1.0), k=16,
                             eps=0.03),
            cold,
            PartitionRequest(name="ibm08_like refresh", hg=step0, k=64,
                             eps=0.08, incumbent=inc, migration_frac=0.15)]
    t0 = time.perf_counter()
    for r in reqs:
        svc.submit(r)
    svc.drain()
    print(f"[service] served {len(reqs)} requests in "
          f"{time.perf_counter() - t0!r} s, {svc.tick} ticks")
    for r in reqs:
        res = svc.results[r.name]
        part, cut = svc.solve_solo(r)
        diff = int((np.asarray(res.part) != np.asarray(part)).sum())
        w = np.asarray(r.hg.edge_weights, np.float64)
        print(f"[service] {r.name}: parts equal {diff == 0} ({diff} "
              f"vertices differ), served cut {res.cut!r}, solo cut "
              f"{cut!r}, cut bits equal {res.cut == cut}; weights "
              f"real-valued {bool(np.any(w != np.round(w)))}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--no-service", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("f5_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build, rating
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} | src {args.src}")
    probe_rows(torch, rating)
    probe_offsets(torch, rating)
    if not args.no_service:
        probe_service(torch, np)
    return 0


if __name__ == "__main__":
    sys.exit(main())
