"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing
with GShard-style capacity dispatch over token groups.

``moe_route`` builds the dispatch and combine masks of the reference's
``moe_ffn_grouped`` (``[G, T, E, C]``; ``route_masks`` builds them from
the router's probabilities); the FFN then runs the same one-hot
einsums.  What fixes which tokens a full expert drops:

- capacity ``C = int(max(top_k * T * capacity_factor / E, 1))`` slots an
  expert in each group;
- a token's slot in an expert is the count of earlier choices of that
  expert along the ``[T * top_k]`` axis, token-major and k-minor;
- ties in the top-k go to the lower expert index, as ``lax.top_k``
  breaks them: a stable descending sort, then the first k;
- the router computes in f32 (its weight is f32 in every model), and
  the combine weights are cast to the activation dtype.

The reference's ``xe_spec``/``group_spec`` are sharding hints with no
single-device meaning and are left out.  Aux losses: load-balancing
(Switch) and the router z-loss.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Route(NamedTuple):
    """The routing of one call: router ``logits``/``probs`` [G, T, E] in
    f32, the chosen experts as ``onehot`` [G, T, K, E] int32, and the
    ``dispatch``/``combine`` masks [G, T, E, C] in the activation dtype."""
    logits: torch.Tensor
    probs: torch.Tensor
    onehot: torch.Tensor
    dispatch: torch.Tensor
    combine: torch.Tensor


def capacity(top_k: int, t: int, capacity_factor: float, e: int) -> int:
    return int(max(top_k * t * capacity_factor / e, 1))


def route_masks(probs: torch.Tensor, top_k: int, cap: int,
                dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities [G, T, E] -> (``onehot`` [G, T, K, E] int32,
    ``dispatch`` and ``combine`` [G, T, E, C] in ``dtype``)."""
    g, t, e = probs.shape
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = ranked.values[..., :top_k]                   # [G, T, K]
    expert_idx = ranked.indices[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)

    onehot = F.one_hot(expert_idx, e).to(torch.int32)        # [G, T, K, E]
    flat = onehot.reshape(g, t * top_k, e)
    pos = (flat.cumsum(dim=1) - flat).reshape(g, t, top_k, e)
    keep = (pos < cap) & (onehot > 0)
    disp = (F.one_hot(torch.where(keep, pos, 0).long(), cap).to(dtype)
            * keep[..., None].to(dtype))                     # [G,T,K,E,C]
    dispatch = disp.sum(dim=2)                               # [G, T, E, C]
    combine = (disp * gate_vals[..., None, None].to(dtype)).sum(dim=2)
    return onehot, dispatch, combine


def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
              capacity_factor: float) -> Route:
    """x: [G, T, D]; router_w: [D, E]."""
    _, t, _ = x.shape
    e = router_w.shape[-1]
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32),
                          router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    onehot, dispatch, combine = route_masks(
        probs, top_k, capacity(top_k, t, capacity_factor, e), x.dtype)
    return Route(logits, probs, onehot, dispatch, combine)


def moe_ffn_grouped(x: torch.Tensor, router_w: torch.Tensor,
                    w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                    top_k: int, capacity_factor: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, T, D]; router_w: [D, E]; w1/w3: [E, D, F]; w2: [E, F, D].
    Returns (out [G, T, D], aux [])."""
    e = router_w.shape[-1]
    r = moe_route(x, router_w, top_k, capacity_factor)
    xe = torch.einsum("gtd,gtec->gecd", x, r.dispatch)       # [G, E, C, D]
    h = torch.einsum("gecd,edf->gecf", xe, w1.to(x.dtype))
    gate = torch.einsum("gecd,edf->gecf", xe, w3.to(x.dtype))
    h = F.silu(gate) * h
    ye = torch.einsum("gecf,efd->gecd", h, w2.to(x.dtype))
    out = torch.einsum("gecd,gtec->gtd", ye, r.combine)

    me = r.probs.mean(dim=1)                                 # [G, E]
    ce = (r.onehot.sum(dim=2) > 0).to(torch.float32).mean(dim=1)
    lb = e * (me * ce).sum(dim=-1).mean()
    z = torch.logsumexp(r.logits, dim=-1).square().mean()
    aux = 0.01 * lb + 1e-3 * z
    return out, aux


def moe_ffn(x: torch.Tensor, router_w, w1, w3, w2, top_k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ungrouped wrapper (the decode path): x [T, D] as one group."""
    out, aux = moe_ffn_grouped(x[None], router_w, w1, w3, w2, top_k,
                               capacity_factor)
    return out[0], aux
