"""DLRM (MLPerf config): bottom MLP -> embedding lookups -> dot-product
feature interaction -> top MLP (port of ``repro.models.dlrm``'s serving
path).

All 26 tables are one ``[padded_total_rows, D]`` parameter, as in the
reference, with each table's ids offset into it (``table_offsets``).
``forward`` gathers the rows of a batch with plain indexing, as the
reference does with ``jnp.take`` outside any kernel.
``retrieval_scores`` sums the query's 26 user rows through
``kernels.ops.embedding_bag``: kernel #9 on the card, its plain version
on the CPU.

Training (the reference's losses): ``param_tree(model)`` lists the
parameters as the reference's tree (``{"tables", "bot", "top"}``);
``forward``, ``loss_fn`` and ``loss_from_rows`` take that tree.
``loss_from_rows`` takes the gathered rows [B, S, D] as an explicit
argument, so autograd gives a row gradient instead of a dense table
gradient: the enabler of the sparse (touched-rows-only) update.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import DLRMConfig
from repro_torch.env import resolve_device
from repro_torch.kernels import ops
from .layers import MLP, dtype_of, mlp_apply


def table_offsets(cfg: DLRMConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.table_sizes)]).astype(np.int64)


def padded_total_rows(cfg: DLRMConfig, mult: int = 512) -> int:
    t = cfg.total_rows
    return ((t + mult - 1) // mult) * mult


def interaction_dim(cfg: DLRMConfig) -> int:
    n_feat = cfg.n_sparse + 1
    if cfg.interaction == "dot":
        return (n_feat * (n_feat - 1)) // 2 + cfg.bot_mlp[-1]
    return n_feat * cfg.embed_dim


def _interact(dense_emb: torch.Tensor, sparse_emb: torch.Tensor,
              interaction: str) -> torch.Tensor:
    """dense_emb [B, D]; sparse_emb [B, S, D] -> interaction features
    (the strict upper triangle of the feature Gram matrix, row-major, as
    ``jnp.triu_indices(n, k=1)`` orders it)."""
    feats = torch.cat([dense_emb[:, None, :], sparse_emb], dim=1)
    if interaction == "dot":
        z = torch.bmm(feats, feats.transpose(1, 2))
        n = feats.shape[1]
        iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
        return torch.cat([dense_emb, z[:, iu, ju]], dim=-1)
    return feats.reshape(feats.shape[0], -1)


class DLRM(nn.Module):
    """The model's parameters on one device.  The constructor leaves them
    uninitialised: build one with ``init_params`` (random, from a
    ``torch.Generator``) or ``from_reference_params``."""

    def __init__(self, cfg: DLRMConfig, device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        self.cfg = cfg
        tables = torch.empty((padded_total_rows(cfg), cfg.embed_dim),
                             dtype=dt, device=dev)
        if generator is not None:
            # in place: the MLPerf tables fill most of the card
            tables.normal_(generator=generator).mul_(0.01)
        self.tables = nn.Parameter(tables)
        self.bot = MLP((cfg.n_dense,) + cfg.bot_mlp, dt, dev, prefix="bot",
                       final_act=True, generator=generator)
        self.top = MLP((interaction_dim(cfg),) + cfg.top_mlp, dt, dev,
                       prefix="top", generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(param_tree(self), batch, self.cfg)

    def retrieval_scores(self, batch: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """retrieval_cand: score ONE query against n_candidates items with
        a batched two-tower dot product.

        batch: dense [1, n_dense], sparse_idx [1, n_sparse] int32,
               cand_idx [n_cand] int32 rows into the item table.
        """
        dense_emb = self.bot(batch["dense"])                  # [1, D]
        user_vec = dense_emb + self.user_bag(batch["sparse_idx"])
        cand = self.tables[batch["cand_idx"].long()]          # [C, D]
        return (cand @ user_vec[0]).to(torch.float32)          # [C]

    def user_bag(self, sparse_idx: torch.Tensor) -> torch.Tensor:
        """The sum of each query's rows, [B, D]: kernel #9."""
        return ops.embedding_bag(self.tables.detach(),
                                 sparse_idx.to(torch.int32).contiguous(),
                                 combiner="sum")


def param_tree(model: DLRM) -> Dict:
    """The model's parameters in the reference's tree."""
    return {"tables": model.tables, "bot": model.bot.tree(),
            "top": model.top.tree()}


def _head(other: Dict, dense: torch.Tensor, rows: torch.Tensor,
          cfg: DLRMConfig) -> torch.Tensor:
    dense_emb = mlp_apply(other["bot"], dense, len(cfg.bot_mlp),
                          prefix="bot", final_act=True)
    feats = _interact(dense_emb, rows, cfg.interaction)
    return mlp_apply(other["top"], feats, len(cfg.top_mlp),
                     prefix="top")[..., 0]


def forward(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense [B, n_dense] f32, sparse_idx [B, n_sparse] int32
    (already offset into the concatenated table).  Returns logits [B]."""
    rows = params["tables"][batch["sparse_idx"].long()]       # [B, S, D]
    return _head(params, batch["dense"], rows, cfg)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    y = labels.to(torch.float32)
    z = logits.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: DLRMConfig) -> torch.Tensor:
    return _bce(forward(params, batch, cfg), batch["labels"])


def loss_from_rows(other_params: Dict, rows: torch.Tensor,
                   batch: Dict[str, torch.Tensor], cfg: DLRMConfig
                   ) -> torch.Tensor:
    """The loss with the gathered rows [B, S, D] as an explicit argument
    (``other_params``: ``{"bot", "top"}``)."""
    return _bce(_head(other_params, batch["dense"], rows, cfg),
                batch["labels"])


def init_params(cfg: DLRMConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> DLRM:
    """Random parameters drawn from ``generator`` (which lives on
    ``device``): tables N(0, 0.01^2), dense weights by the reference's
    scale rule, zero biases."""
    return DLRM(cfg, device, generator=generator)


def from_reference_params(cfg: DLRMConfig, params: Dict,
                          device: str | torch.device = "cuda") -> DLRM:
    """The port's module holding the reference's parameters (a dict of
    numpy arrays, ``jax.tree.map(np.asarray, init_params(...))``)."""
    model = DLRM(cfg, device)
    with torch.no_grad():
        model.tables.copy_(torch.from_numpy(np.array(params["tables"])))
    model.bot.load_reference(params["bot"])
    model.top.load_reference(params["top"])
    return model

