"""Gradient compression with error feedback (port of
``repro.optim.compression``'s ``topk_compress``).

``topk_compress`` keeps the largest-magnitude fraction of a gradient and
carries the rest over to the next step as a residual.  The reference's
other function, ``quantized_psum`` (an int8 all-reduce inside
``shard_map``), is a collective of the multi-device GNN regime and
comes with the multi-device paths.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk_compress(g: torch.Tensor, residual: torch.Tensor,
                  frac: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback top-k: returns (the sparse gradient to exchange, in
    ``g``'s dtype; the new f32 residual).  ``frac`` is the kept fraction;
    every entry whose magnitude ties the k-th largest is kept too."""
    acc = g.to(torch.float32) + residual
    flat = acc.reshape(-1)
    k = max(int(frac * flat.shape[0]), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    kept = torch.where(mask, flat, 0.0).reshape(acc.shape)
    return kept.to(g.dtype), acc - kept
