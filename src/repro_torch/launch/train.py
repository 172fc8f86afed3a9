"""Training launcher (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch <id> [--steps N] [--batch B]
        [--seq S] [--ckpt-dir DIR] [--ckpt-every K] [--resume] [--full]
        [--device cuda|cpu]

Trains the SMOKE config of the chosen arch (``--full``: the published
one) with the step of ``train.steps.build_cell`` on one device (the
card unless ``--device cpu``), from parameters drawn from a seeded
``torch.Generator``.  ``CheckpointManager`` saves the train state every
``--ckpt-every`` steps and at the end, with the data cursor; ``--resume``
restores the latest one and continues from its cursor, so a resumed run
sees the batches an unbroken run sees (the token stream is replayed up
to the cursor).  ``StragglerWatchdog`` reports slow steps.  The
reference's JAX mesh (``launch/mesh.py``) has no single-device role and
comes with the multi-device paths.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHS, SMOKES, get_opt
from repro_torch.env import resolve_device
from repro_torch.models.layers import batch_to
from repro_torch.optim import adamw
from repro_torch.runtime import Runner, StragglerWatchdog
from repro_torch.train.steps import build_cell


def make_batch_fn(arch_id: str, cfg, batch: int, seq: int,
                  device: torch.device):
    """``fn(step)`` -> the batch of ``step`` on ``device``."""
    fam = cfg.family
    if fam == "lm":
        from repro_torch.data.lm_data import TokenStream
        stream = {"ts": None, "next": 0}

        def fn(step):
            # the stream draws batch after batch: start it again and
            # replay it when a step comes out of order (a resume)
            if stream["ts"] is None or step < stream["next"]:
                stream["ts"] = TokenStream(cfg.vocab, batch, seq, seed=0)
                stream["next"] = 0
            while stream["next"] <= step:
                b = stream["ts"].next_batch(stream["next"])
                stream["next"] += 1
            return batch_to(b, device)
        return fn
    if fam == "gnn":
        from repro_torch.data.graphs import full_graph_batch
        from repro_torch.models import gnn

        def fn(step):
            return batch_to(full_graph_batch(
                256, 1024, cfg.d_feat, cfg.n_classes, seed=step,
                need_edge_feat=gnn._edge_feat_dim(cfg)), device)
        return fn
    from repro_torch.data.recsys import click_batch

    def fn(step):
        return batch_to(click_batch(cfg, batch, seed=step), device)
    return fn


def init_params(cfg, device: str | torch.device = "cuda", seed: int = 0):
    """The arch's parameter tree, drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "lm":
        from repro_torch.models import transformer
        return transformer.param_tree(
            transformer.init_params(cfg, gen, device=device))
    if cfg.family == "gnn":
        from repro_torch.models import gnn
        return gnn.param_tree(gnn.init_params(cfg, gen, cfg.d_feat,
                                              cfg.n_classes, device=device))
    from repro_torch.models import dlrm
    return dlrm.param_tree(dlrm.init_params(cfg, gen, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full (published) config, not the smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = ARCHS[args.arch]
    cfg = spec.config if args.full else SMOKES[args.arch]
    spec = dataclasses.replace(spec, config=cfg)
    fam = cfg.family
    if fam == "lm":
        shape = ShapeSpec("cli", "train", (("seq_len", args.seq),
                                           ("global_batch", args.batch)))
    elif fam == "gnn":
        shape = ShapeSpec("cli", "full_graph",
                          (("n_nodes", 256), ("n_edges", 1024),
                           ("d_feat", cfg.d_feat)))
    else:
        shape = ShapeSpec("cli", "train_batch", (("batch", args.batch),))

    opt_cfg = get_opt(args.arch)
    cell = build_cell(spec, shape, opt_cfg=opt_cfg, n_devices=1)
    params = init_params(cfg, dev)
    state = {"params": params, "opt": adamw.init(params, opt_cfg)}

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state, device=dev)
        start = extra.get("data_cursor", 0)
        print(f"[train] resumed from step {start}")

    wd = StragglerWatchdog()
    runner = Runner(step_fn=cell.fn, state=state,
                    next_batch=make_batch_fn(args.arch, cfg, args.batch,
                                             args.seq, dev),
                    ckpt=ckpt, step=start, ckpt_every=args.ckpt_every,
                    watchdog=wd, on_metrics=lambda m: print(f"[train] {m}"))
    t0 = time.perf_counter()
    result = runner.run_until(args.steps)
    m = result["metrics"]
    loss = float(m["loss"]) if m is not None else float("nan")
    print(f"[train] {args.arch}: step {result['final_step']} "
          f"loss={loss:.4f} wall={time.perf_counter() - t0:.1f}s "
          f"stragglers={len(wd.reports)} device={dev}")


if __name__ == "__main__":
    main()
