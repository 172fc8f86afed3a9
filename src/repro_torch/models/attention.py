"""Attention of the LM (port of ``repro.models.attention``): the blocked
flash attention forward (an online softmax over KV blocks, computed in
f32 from upcast q/k/v) and the one-token decode attention over a KV
cache.

The reference has no fused kernel here: both are plain array programs,
and so are these.  The flash backward (the reference's custom VJP,
``_flash_bwd``) belongs to training; ``flash_forward`` returns the
``(out, lse)`` pair it needs, so that a ``torch.autograd.Function`` can
wrap it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, dh] -> [B, S, KV * n_rep, dh] (GQA head sharing): query
    head ``h`` reads KV head ``h // n_rep``."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _blocked(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[B, S, H, dh] -> [nb, B, S/nb, H, dh]."""
    b, s, h, d = x.shape
    return x.reshape(b, nb, s // nb, h, d).transpose(0, 1)


def _scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded in f32 as the reference computes it (a
    Python float, so that no step copies a scalar to the device)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, block_kv: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_fwd``: q, k, v [B, S, H, dh] with as many KV
    heads as query heads.  Returns ``out`` [B, Sq, H, dh] in q's dtype and
    the log-sum-exp rows ``lse`` [B, H, Sq] in f32."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    nb = max(skv // block_kv, 1)
    bkv = skv // nb
    kb, vb = _blocked(k, nb), _blocked(v, nb)
    scale = _scale(dh)
    q32 = q.to(torch.float32)
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for bi in range(nb):
        s = torch.einsum("bqhd,bkhd->bhqk", q32,
                         kb[bi].to(torch.float32)) * scale
        if causal:
            k_pos = bi * bkv + torch.arange(bkv, device=q.device)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None],
                            s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb[bi].to(torch.float32))
        m = m_new
    lse = m + torch.log(l.clamp(min=1e-30))                   # [B, H, Sq]
    out = acc / l[..., None].clamp(min=1e-30)                 # [B, H, Sq, dh]
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_kv: int = 1024
                    ) -> torch.Tensor:
    """q: [B, Sq, H, dh]; k, v: [B, Skv, KV, dh], H % KV == 0."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    block_kv = min(block_kv, k.shape[1])
    return flash_forward(q, k, v, causal, block_kv)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token attention against a KV cache: a masked softmax over the
    whole cache, whose first ``cache_len`` rows count, in f32.

    q: [B, 1, H, dh];  caches: [B, S, KV, dh].  The query heads are
    grouped by the KV head they read (head ``h`` reads ``h // n_rep``),
    and each product upcasts the cache as it reads it: no f32 or
    repeated copy of the cache is made, and no step permutes it."""
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    n_rep = h // kv
    q32 = q.to(torch.float32).reshape(b, 1, kv, n_rep, dh)
    s = (q32 * k_cache[:, :, :, None, :]).sum(dim=-1) * _scale(dh)
    mask = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    s = torch.where(mask[None, :, None, None], s, NEG_INF)  # [B, S, KV, R]
    p = torch.softmax(s, dim=1)
    out = (p[..., None] * v_cache[:, :, :, None, :]).sum(dim=1)
    return out.reshape(b, 1, h, dh).to(q.dtype)
