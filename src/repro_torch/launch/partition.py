"""Partitioner launcher of the port (counterpart of
``repro.launch.partition``):

    python -m repro_torch.launch.partition --design ibm08_like --k 64 \
        --scale 1.0 [--method impart|multilevel|ext_memetic] [--out a.npy]

Runs IMPart (or a baseline) on a named benchmark netlist on ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels) and reports cut, balance and wall time.  Asking for ``cuda``
where there is none raises.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import metrics, refine
from repro_torch.core.baselines import external_memetic, multilevel_best_of
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.data.hypergraphs import (BENCH_ISPD, BENCH_TITAN, ispd_like,
                                          titan_like)
from repro_torch.env import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--design", default="sparcT1_core_like")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.08)
    ap.add_argument("--scale", type=float, default=0.08)
    ap.add_argument("--method", default="impart",
                    choices=["impart", "multilevel", "ext_memetic"])
    ap.add_argument("--alpha", type=int, default=7)
    ap.add_argument("--beta", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.design in BENCH_TITAN:
        hg = titan_like(args.design, scale=args.scale)
    elif args.design in BENCH_ISPD:
        hg = ispd_like(args.design, scale=args.scale)
    else:
        raise SystemExit(f"unknown design {args.design}; options: "
                         f"{sorted(BENCH_TITAN) + sorted(BENCH_ISPD)}")
    print(f"[partition] {args.design}: n={hg.n} m={hg.m} pins={hg.num_pins}")

    if args.method == "impart":
        res = impart_partition(hg, ImpartConfig(
            k=args.k, eps=args.eps, alpha=args.alpha, beta=args.beta,
            seed=args.seed), device=dev)
        part, cut, wall = res.part, res.cut, res.wall_s
        events = [t[2] for t in res.trace]
        print(f"[partition] events: "
              f"{sum(e.startswith('recombine') for e in events)} recomb, "
              f"{sum(e.startswith('mutate') for e in events)} mutations, "
              f"levels={res.levels}")
    elif args.method == "multilevel":
        r = multilevel_best_of(hg, args.k, args.eps, seed=args.seed,
                               repetitions=args.alpha, device=dev)
        part, cut, wall = r.part, r.cut, r.wall_s
    else:
        r = external_memetic(hg, args.k, args.eps, seed=args.seed,
                             population=args.alpha,
                             generations=args.beta, device=dev)
        part, cut, wall = r.part, r.cut, r.wall_s

    hga = hg.arrays(device=dev)
    padded = refine.pad_part(part, hga.n_pad, dev)
    bal = bool(metrics.is_balanced(hga, padded, args.k, args.eps))
    imb = float(metrics.imbalance(hga, padded, args.k))
    print(f"[partition] {args.method}: cut={cut:.0f} balanced={bal} "
          f"imbalance={imb:.3f} wall={wall:.1f}s")
    if args.out:
        np.save(args.out, part)
        print(f"[partition] assignment -> {args.out}")


if __name__ == "__main__":
    main()
