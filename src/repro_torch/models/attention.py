"""Attention of the LM (port of ``repro.models.attention``): the blocked
flash attention (an online softmax over KV blocks, computed in f32 from
upcast q/k/v) with its O(S)-memory backward, and the one-token decode
attention over a KV cache.

The reference has no fused kernel here: all are plain array programs,
and so are these.  ``_Flash`` is the reference's custom VJP as a
``torch.autograd.Function``: the forward saves only ``(q, k, v, out,
lse)``, and ``flash_backward`` recomputes each KV block's scores, so no
``[S, S]`` residual is ever stored.
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


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool, block_kv: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_bwd``, in f32: per KV block the scores are
    recomputed, ``p = exp(s - lse)``, and ``dv``, ``dp``, ``ds = p * (dp
    - delta) * scale``, ``dk`` follow; ``dq`` accumulates over the
    blocks.  Returns (dq, dk, dv) in the dtypes of (q, k, v).

    Under ``causal`` the query rows before a block's first key see none
    of its keys (their ``p`` is exactly 0), so each block's products
    start at that row: the same terms as the reference's, without the
    masked half of the work."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    nb = max(skv // block_kv, 1)
    bkv = skv // nb
    kb, vb = _blocked(k, nb), _blocked(v, nb)
    scale = _scale(dh)
    q32 = q.to(torch.float32)
    do = dout.to(torch.float32).transpose(1, 2)              # [B, H, Sq, dh]
    delta = (do * out.to(torch.float32).transpose(1, 2)).sum(dim=-1)
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    dkb, dvb = [], []
    for bi in range(nb):
        q0 = min(bi * bkv, sq) if causal else 0
        kblk = kb[bi].to(torch.float32)
        vblk = vb[bi].to(torch.float32)
        qs, dos = q32[:, q0:], do[:, :, q0:]
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kblk) * scale
        if causal:
            k_pos = bi * bkv + torch.arange(bkv, device=q.device)
            s = torch.where((q_pos[q0:, None] >= k_pos[None, :])[None, None],
                            s, NEG_INF)
        p = torch.exp(s - lse[:, :, q0:, None])             # [B, H, Sq, bkv]
        dvb.append(torch.einsum("bhqk,bhqd->bkhd", p, dos))
        dp = torch.einsum("bhqd,bkhd->bhqk", dos, vblk)
        ds = p * (dp - delta[:, :, q0:, None]) * scale
        dq[:, q0:] += torch.einsum("bhqk,bkhd->bqhd", ds, kblk)
        dkb.append(torch.einsum("bhqk,bqhd->bkhd", ds, qs))
    dk = torch.cat(dkb, dim=1)
    dv = torch.cat(dvb, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: q, k, v [B, S, H,
    dh] with as many KV heads as query heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_kv: int):
        out, lse = flash_forward(q, k, v, causal, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_kv = causal, block_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                    ctx.block_kv)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_kv: int = 1024
                    ) -> torch.Tensor:
    """q: [B, Sq, H, dh]; k, v: [B, Skv, KV, dh], H % KV == 0.  The GQA
    repeat stays outside ``_Flash``, so autograd sums ``dk``/``dv`` over
    each query-head group, as the reference's broadcast does."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    block_kv = min(block_kv, k.shape[1])
    return _Flash.apply(q, k, v, causal, block_kv)


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
