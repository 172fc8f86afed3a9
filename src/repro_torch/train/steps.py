"""The cells of training and serving (port of ``repro.train.steps``):
for every (architecture x input shape) cell, the step function and its
abstract arguments.

    build_cell(spec, shape, opt_cfg=None, n_devices=1) -> Cell
        Cell.fn      the step (signature per kind, below)
        Cell.args    abstract arguments: tensors on the ``meta`` device,
                     the counterpart of the reference's ShapeDtypeStructs
        Cell.static  the reference's ``trips``

Kinds and signatures:

- ``train`` (LM, the three GNN regimes, DLRM): ``fn(state, batch) ->
  (state, {"loss", "grad_norm", "lr"})``, where ``state`` is ``{"params":
  tree, "opt": {"m", "v", "step"}}`` and ``tree`` the reference's
  parameter tree (``models.*.param_tree``), leaf for leaf.  The step
  takes the gradient with autograd, then ``cosine_with_warmup`` of the
  step before its increment and ``adamw.update``, which writes the
  parameters and moments in place and returns the same tensors.
- ``prefill``/``decode`` (LM) and ``serve``/``retrieval`` (DLRM): the
  serving functions of ``models.transformer`` and ``models.dlrm``, whose
  first argument is the model module.

The LM step splits the batch into ``cfg.microbatches`` contiguous parts,
as ``reshape(mb, b // mb, ...)`` does, and adds each part's gradients
into accumulators of ``cfg.grad_accum_dtype`` (the first part's gradient
cast to that dtype is the reference's ``0 + g``), then divides by ``mb``.
The DLRM cell has the reference's two steps: the dense one, and with
``sparse_update`` the lazy touched-rows update of the tables
(``adamw.sparse_row_update``, whose duplicate-row sums run kernel #4 on
the card).

Single device only: the reference's ``in_specs``/``out_specs``,
``shardings()`` and ``lower()`` belong to the multi-device paths and the
dry-run analysis, and are not ported; nor is the gradient-sharding
constraint the reference's LM step puts on each microbatch's gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (ArchSpec, DLRMConfig, GNNConfig,
                                      LMConfig, ShapeSpec)
from repro_torch.models import dlrm, gnn, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: Tuple
    static: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _state_args(tree: Dict, opt_cfg: adamw.AdamWConfig) -> Dict:
    return {"params": tree, "opt": adamw.init(tree, opt_cfg)}


def _take_grads(leaves: List[torch.Tensor], acc: Optional[List],
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Move each leaf's ``.grad`` out (clearing it): the first time as
    the accumulator (cast to ``dtype``), after that added into ``acc``."""
    out = []
    for i, p in enumerate(leaves):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        if acc is None:
            out.append(g if dtype is None else g.to(dtype))
        else:
            acc[i].add_(g)
    return acc if acc is not None else out


def _with_grad(tree) -> List[torch.Tensor]:
    leaves = adamw.tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _apply(grads: List[torch.Tensor], state: Dict, opt_cfg, loss):
    lr_scale = cosine_with_warmup(state["opt"]["step"])
    params, opt, om = adamw.update(grads, state["opt"], state["params"],
                                   opt_cfg, lr_scale)
    return {"params": params, "opt": opt}, {"loss": loss, **om}


def _loss_step(loss_fn: Callable, cfg, opt_cfg) -> Callable:
    """The one-batch step of the GNN and DLRM cells."""
    def train_step(state, batch):
        leaves = _with_grad(state["params"])
        loss = loss_fn(state["params"], batch, cfg)
        loss.backward()
        return _apply(_take_grads(leaves, None), state, opt_cfg,
                      loss.detach())
    return train_step


# ==========================================================================
# LM family
# ==========================================================================
def lm_train_cell(spec: ArchSpec, shape: ShapeSpec,
                  opt_cfg: adamw.AdamWConfig, n_devices: int) -> Cell:
    cfg: LMConfig = spec.config
    p = shape.p()
    b, s = int(p["global_batch"]), int(p["seq_len"])
    mb = cfg.microbatches
    moe_groups = max(n_devices, 1)
    g_dtype = dtype_of(cfg.grad_accum_dtype)
    tree = transformer.param_tree(transformer.Transformer(cfg, META))
    batch_args = {"tokens": _meta((b, s), torch.int32),
                  "labels": _meta((b, s), torch.int32)}

    def train_step(state, batch):
        params = state["params"]
        leaves = _with_grad(params)
        bsz = batch["tokens"].shape[0]
        grads, loss = None, 0.0
        for i in range(mb):
            part = {k: v.reshape(mb, bsz // mb, *v.shape[1:])[i]
                    for k, v in batch.items()}
            l = transformer.loss_fn(params, part, moe_groups, cfg)
            l.backward()
            grads = _take_grads(leaves, grads, g_dtype)
            loss = loss + l.detach()
        if mb > 1:
            for g in grads:
                g.div_(mb)
        return _apply(grads, state, opt_cfg, loss / mb)

    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="train",
                fn=train_step, args=(_state_args(tree, opt_cfg), batch_args),
                static={"trips": [mb, cfg.n_layers, max(s // 1024, 1)]})


def lm_prefill_cell(spec: ArchSpec, shape: ShapeSpec, n_devices: int
                    ) -> Cell:
    cfg: LMConfig = spec.config
    p = shape.p()
    b, s = int(p["global_batch"]), int(p["seq_len"])

    def prefill(model, tokens):
        return transformer.prefill_logits(model, tokens,
                                          moe_groups=max(n_devices, 1))

    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="prefill",
                fn=prefill, args=(transformer.Transformer(cfg, META),
                                  _meta((b, s), torch.int32)),
                static={"trips": [cfg.n_layers, max(s // 1024, 1)]})


def lm_decode_cell(spec: ArchSpec, shape: ShapeSpec) -> Cell:
    """``fn(model, cache, tokens [B, 1], pos)``; ``pos`` is the current
    length, an int (its abstract argument a 0-d int32 tensor)."""
    cfg: LMConfig = spec.config
    p = shape.p()
    b, s = int(p["global_batch"]), int(p["seq_len"])

    def serve_step(model, cache, tokens, pos):
        return transformer.decode_step(model, cache, tokens, int(pos))

    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="decode",
                fn=serve_step,
                args=(transformer.Transformer(cfg, META),
                      transformer.init_cache(cfg, b, s, META),
                      _meta((b, 1), torch.int32), _meta((), torch.int32)),
                static={"trips": [cfg.n_layers]})


# ==========================================================================
# GNN family
# ==========================================================================
def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pad_edges(batch: Dict[str, np.ndarray], mult: int = 512
              ) -> Dict[str, np.ndarray]:
    """A full-graph host batch with its edges padded to a multiple of
    ``mult``, as the full-graph cell's abstract batch is: each padded
    edge joins node 0 to itself with ``edge_mask`` 0 and zero features
    (a batch's own ``edge_mask``, if any, is kept on its edges)."""
    e = batch["edge_index"].shape[1]
    pad = _round_up(e, mult) - e
    out = dict(batch)
    out["edge_index"] = np.pad(batch["edge_index"], ((0, 0), (0, pad)))
    out["edge_mask"] = np.pad(batch.get("edge_mask",
                                        np.ones(e, np.float32)), (0, pad))
    if "edge_feat" in batch:
        out["edge_feat"] = np.pad(batch["edge_feat"], ((0, pad), (0, 0)))
    return out


def _gnn_tree(cfg: GNNConfig, d_feat: int) -> Dict:
    return gnn.param_tree(gnn.GNN(cfg, d_feat, cfg.n_classes, META))


def gnn_full_graph_cell(spec: ArchSpec, shape: ShapeSpec,
                        opt_cfg: adamw.AdamWConfig) -> Cell:
    """Edges padded to a multiple of 512 (``edge_mask`` zero on the
    padding), as the reference's abstract batch is."""
    cfg: GNNConfig = spec.config
    p = shape.p()
    n, e = int(p["n_nodes"]), int(p["n_edges"])
    d_feat = int(p.get("d_feat", cfg.d_feat))
    e_pad = _round_up(e, 512)
    batch_args = {"node_feat": _meta((n, d_feat), torch.float32),
                  "edge_index": _meta((2, e_pad), torch.int32),
                  "edge_mask": _meta((e_pad,), torch.float32),
                  "labels": _meta((n,), torch.int32)}
    if gnn._needs_edge_feat(cfg):
        batch_args["edge_feat"] = _meta((e_pad, gnn._edge_feat_dim(cfg)),
                                        torch.float32)
    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="train",
                fn=_loss_step(gnn.full_graph_loss, cfg, opt_cfg),
                args=(_state_args(_gnn_tree(cfg, d_feat), opt_cfg),
                      batch_args),
                static={"trips": [cfg.n_layers]})


def gnn_minibatch_cell(spec: ArchSpec, shape: ShapeSpec,
                       opt_cfg: adamw.AdamWConfig) -> Cell:
    cfg: GNNConfig = spec.config
    p = shape.p()
    r = int(p["batch_nodes"])
    f1, f2 = p["fanout"]
    d = cfg.d_feat
    batch_args = {"x0": _meta((r, d), torch.float32),
                  "x1": _meta((r, f1, d), torch.float32),
                  "x2": _meta((r, f1, f2, d), torch.float32),
                  "mask1": _meta((r, f1), torch.float32),
                  "mask2": _meta((r, f1, f2), torch.float32),
                  "labels": _meta((r,), torch.int32)}
    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="train",
                fn=_loss_step(gnn.minibatch_loss, cfg, opt_cfg),
                args=(_state_args(_gnn_tree(cfg, d), opt_cfg), batch_args))


def gnn_molecule_cell(spec: ArchSpec, shape: ShapeSpec,
                      opt_cfg: adamw.AdamWConfig) -> Cell:
    cfg: GNNConfig = spec.config
    p = shape.p()
    b, nn_, ne = int(p["batch"]), int(p["n_nodes"]), int(p["n_edges"])
    d = cfg.d_feat
    batch_args = {"node_feat": _meta((b, nn_, d), torch.float32),
                  "edge_index": _meta((b, 2, ne), torch.int32),
                  "edge_mask": _meta((b, ne), torch.float32),
                  "node_mask": _meta((b, nn_), torch.float32),
                  "labels": _meta((b,), torch.int32)}
    if gnn._needs_edge_feat(cfg):
        batch_args["edge_feat"] = _meta((b, ne, gnn._edge_feat_dim(cfg)),
                                        torch.float32)
    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="train",
                fn=_loss_step(gnn.molecule_loss, cfg, opt_cfg),
                args=(_state_args(_gnn_tree(cfg, d), opt_cfg), batch_args),
                static={"trips": [cfg.n_layers]})


# ==========================================================================
# DLRM family
# ==========================================================================
def _dlrm_batch_args(cfg: DLRMConfig, b: int, labels: bool = True) -> Dict:
    out = {"dense": _meta((b, cfg.n_dense), torch.float32),
           "sparse_idx": _meta((b, cfg.n_sparse), torch.int32)}
    if labels:
        out["labels"] = _meta((b,), torch.int32)
    return out


def dlrm_train_cell(spec: ArchSpec, shape: ShapeSpec,
                    opt_cfg: adamw.AdamWConfig,
                    sparse_update: bool = False) -> Cell:
    """DLRM train step.  ``sparse_update``: lazy touched-rows-only AdamW
    for the tables (O(B x S x D) instead of the O(R x D) dense sweep);
    off by default, as in the reference."""
    cfg: DLRMConfig = spec.config
    b = int(shape.p()["batch"])
    tree = dlrm.param_tree(dlrm.DLRM(cfg, META))

    def train_step_sparse(state, batch):
        params, opt = state["params"], state["opt"]
        other = {"bot": params["bot"], "top": params["top"]}
        flat_idx = batch["sparse_idx"].reshape(-1)
        rows = params["tables"].detach()[flat_idx.long()].reshape(
            flat_idx.shape[0] // cfg.n_sparse, cfg.n_sparse, cfg.embed_dim)
        rows.requires_grad_(True)
        leaves = _with_grad(other)
        loss = dlrm.loss_from_rows(other, rows, batch, cfg)
        loss.backward()
        g_other = _take_grads(leaves, None)
        step = opt["step"]
        lr_scale = cosine_with_warmup(step)
        new_other, new_opt_o, om = adamw.update(
            g_other, {"m": {"bot": opt["m"]["bot"], "top": opt["m"]["top"]},
                      "v": {"bot": opt["v"]["bot"], "top": opt["v"]["top"]},
                      "step": step}, other, opt_cfg, lr_scale)
        p_t, m_t, v_t = adamw.sparse_row_update(
            params["tables"], opt["m"]["tables"], opt["v"]["tables"],
            flat_idx, rows.grad.reshape(-1, cfg.embed_dim), opt_cfg,
            lr_scale, step + 1)
        new_state = {"params": {"tables": p_t, **new_other},
                     "opt": {"m": {"tables": m_t, **new_opt_o["m"]},
                             "v": {"tables": v_t, **new_opt_o["v"]},
                             "step": new_opt_o["step"]}}
        return new_state, {"loss": loss.detach(), **om}

    fn = (train_step_sparse if sparse_update
          else _loss_step(dlrm.loss_fn, cfg, opt_cfg))
    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="train",
                fn=fn, args=(_state_args(tree, opt_cfg),
                             _dlrm_batch_args(cfg, b)))


def dlrm_serve_cell(spec: ArchSpec, shape: ShapeSpec) -> Cell:
    cfg: DLRMConfig = spec.config
    b = int(shape.p()["batch"])

    @torch.no_grad()
    def serve(model, batch):
        return model(batch)

    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="serve",
                fn=serve, args=(dlrm.DLRM(cfg, META),
                                _dlrm_batch_args(cfg, b, labels=False)))


def dlrm_retrieval_cell(spec: ArchSpec, shape: ShapeSpec) -> Cell:
    cfg: DLRMConfig = spec.config
    c = int(shape.p()["n_candidates"])
    batch_args = _dlrm_batch_args(cfg, 1, labels=False)
    batch_args["cand_idx"] = _meta((c,), torch.int32)

    @torch.no_grad()
    def serve(model, batch):
        return model.retrieval_scores(batch)

    return Cell(arch_id=spec.arch_id, shape_name=shape.name,
                kind="retrieval", fn=serve,
                args=(dlrm.DLRM(cfg, META), batch_args))


# ==========================================================================
# dispatch
# ==========================================================================
def build_cell(spec: ArchSpec, shape: ShapeSpec,
               opt_cfg: Optional[adamw.AdamWConfig] = None,
               n_devices: int = 1) -> Cell:
    """The cell of ``spec`` x ``shape``.  ``n_devices`` sets the LM's MoE
    token groups (``max(n_devices, 1)``), as in the reference; the port
    runs on one device."""
    opt_cfg = opt_cfg or getattr(spec, "opt_cfg", None) \
        or adamw.AdamWConfig()
    fam = spec.config.family
    if fam == "lm":
        if shape.kind == "train":
            return lm_train_cell(spec, shape, opt_cfg, n_devices)
        if shape.kind == "prefill":
            return lm_prefill_cell(spec, shape, n_devices)
        if shape.kind in ("decode", "long_decode"):
            return lm_decode_cell(spec, shape)
    if fam == "gnn":
        if shape.kind == "full_graph":
            return gnn_full_graph_cell(spec, shape, opt_cfg)
        if shape.kind == "minibatch":
            return gnn_minibatch_cell(spec, shape, opt_cfg)
        if shape.kind == "molecule":
            return gnn_molecule_cell(spec, shape, opt_cfg)
    if fam == "recsys":
        if shape.kind == "train_batch":
            return dlrm_train_cell(spec, shape, opt_cfg)
        if shape.kind == "serve_batch":
            return dlrm_serve_cell(spec, shape)
        if shape.kind == "retrieval":
            return dlrm_retrieval_cell(spec, shape)
    raise ValueError(f"no cell for {spec.arch_id} x {shape.name}")
