"""Transformer LM: GQA + RoPE + SwiGLU (+ optional MoE), its serving
functions (port of ``repro.models.transformer``).

The parameters are the reference's stacked layout in one ``nn.Module``:
``embed`` [V, D], ``lm_head`` [D, V], ``final_norm`` [D] and, in
``layers``, one ``[L, ...]`` tensor per leaf (``ln1``, ``ln2``, the
fused ``wqkv``, ``wo``; ``w13``/``w2`` for a dense FFN, or the f32
``router`` and ``we1``/``we3``/``we2`` for MoE).  The KV cache is
``[L, B, S, KV, dh]`` too.  The layers run in a Python loop over ``L``
where the reference scans, and the rotary angles of a forward or a
decode step are computed once for all of them.

Functions (the reference's serving API; the model carries its config):
  init_params(cfg, generator, device)          -> Transformer
  from_reference_params(cfg, params, device)   -> Transformer
  prefill_logits(model, tokens)                -> logits [B, S, V]
  init_cache(cfg, batch, max_seq, device)      -> {"k", "v"}
  decode_step(model, cache, tokens, pos)       -> (logits, cache)

Training (the reference's ``loss_fn``):
  param_tree(model)                            -> the reference's tree
  loss_fn(model_or_tree, batch, moe_groups, cfg) -> CE + MoE aux loss

``loss_fn`` runs under autograd: each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint(layer)``), the attention through the flash backward,
and the gradient reaches the stacked ``[L, ...]`` leaves through one
``unbind`` each (the layers read views of it).

Prefill runs the MoE over ``min(moe_groups, B * S)`` token groups,
decode over one group of the ``B`` tokens of the step, so a MoE model's
decode and prefill logits differ by design (capacity per group).  The
sharding specs belong to the multi-device slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.env import resolve_device
from .attention import decode_attention, flash_attention
from .layers import (cross_entropy, dtype_of, init_dense, rms_norm,
                     rope_cos_sin, rotate, tensor_from_reference, unstack)
from .moe import moe_ffn, moe_ffn_grouped


def layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """Each stacked layer leaf: (shape, whether it stays f32)."""
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head
    shapes = {"ln1": ((l, d), False), "ln2": ((l, d), False),
              "wqkv": ((l, d, hq + 2 * hkv), False), "wo": ((l, hq, d), False)}
    if cfg.moe_experts:
        e = cfg.moe_experts
        shapes.update({"router": ((l, d, e), True),
                       "we1": ((l, e, d, f), False),
                       "we3": ((l, e, d, f), False),
                       "we2": ((l, e, f, d), False)})
    else:
        shapes.update({"w13": ((l, d, 2 * f), False),
                       "w2": ((l, f, d), False)})
    return shapes


class Transformer(nn.Module):
    """The LM's parameters on one device.  The constructor leaves them
    uninitialised: build one with ``init_params`` (random, from a
    ``torch.Generator``) or ``from_reference_params``."""

    def __init__(self, cfg: LMConfig, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype_of(cfg.dtype)
        self.cfg = cfg

        def empty(shape, f32=False):
            return nn.Parameter(torch.empty(
                shape, dtype=torch.float32 if f32 else dt, device=dev))

        self.embed = empty((cfg.vocab, cfg.d_model))
        self.lm_head = empty((cfg.d_model, cfg.vocab))
        self.final_norm = empty((cfg.d_model,))
        self.layers = nn.ParameterDict({
            name: empty(shape, f32)
            for name, (shape, f32) in layer_shapes(cfg).items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s slices of the stacked leaves."""
        return {name: w[i] for name, w in self.layers.items()}


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Transformer:
    """Random parameters drawn from ``generator`` (which lives on
    ``device``) by the reference's scale rule: norms one, dense weights
    ``N(0, 1/fan_in)``, the embedding ``N(0, 1)``.  Drawn one layer at a
    time, so that a bf16 model needs one layer of f32 scratch."""
    model = Transformer(cfg, device)
    dev = model.device
    for name, w in model.layers.items():
        if name.startswith("ln"):
            w.fill_(1.0)
            continue
        for i in range(cfg.n_layers):
            w[i].copy_(init_dense(w.shape[1:], w.dtype, generator, dev))
    model.embed.copy_(init_dense(model.embed.shape, model.embed.dtype,
                                 generator, dev, scale=1.0))
    model.lm_head.copy_(init_dense(model.lm_head.shape, model.lm_head.dtype,
                                   generator, dev))
    model.final_norm.fill_(1.0)
    return model


@torch.no_grad()
def from_reference_params(cfg: LMConfig, params: Dict,
                          device: str | torch.device = "cuda") -> Transformer:
    """The port's module holding the reference's parameters (its tree as
    numpy arrays, ``jax.tree.map(np.asarray, init_params(...))``)."""
    model = Transformer(cfg, device)
    for name in ("embed", "lm_head", "final_norm"):
        getattr(model, name).copy_(tensor_from_reference(params[name]))
    for name, w in model.layers.items():
        w.copy_(tensor_from_reference(params["layers"][name]))
    return model


def param_tree(model: Transformer) -> Dict:
    """The model's parameters in the reference's tree: ``{"embed",
    "lm_head", "final_norm", "layers": {leaf: [L, ...]}}``."""
    return {"embed": model.embed, "lm_head": model.lm_head,
            "final_norm": model.final_norm, "layers": dict(model.layers)}


# --------------------------------------------------------------------------
# one transformer block (operates on [B, S, D])
# --------------------------------------------------------------------------
def _qkv(h: torch.Tensor, lp: Dict, cfg: LMConfig):
    b, s, _ = h.shape
    hq_d = cfg.n_heads * cfg.d_head
    hkv_d = cfg.n_kv_heads * cfg.d_head
    qkv = h @ lp["wqkv"]
    q = qkv[..., :hq_d].reshape(b, s, cfg.n_heads, cfg.d_head)
    k = qkv[..., hq_d:hq_d + hkv_d].reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = qkv[..., hq_d + hkv_d:].reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _dense_ffn(h: torch.Tensor, lp: Dict) -> torch.Tensor:
    up, gate = (h @ lp["w13"]).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ lp["w2"]


def _block(x: torch.Tensor, lp: Dict, cfg: LMConfig, rope, moe_groups: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rope``: the (cos, sin) of the positions (``rope_cos_sin``)."""
    b, s, d = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    k = rotate(k, *rope)
    q = rotate(q, *rope)
    attn = flash_attention(q, k, v, causal=True)
    x = x + attn.reshape(b, s, cfg.n_heads * cfg.d_head) @ lp["wo"]

    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        t = b * s
        g = min(moe_groups, t)
        out, aux = moe_ffn_grouped(
            h.reshape(g, t // g, d), lp["router"], lp["we1"], lp["we3"],
            lp["we2"], cfg.moe_top_k, cfg.capacity_factor)
        mlp_out = out.reshape(b, s, d)
    else:
        mlp_out = _dense_ffn(h, lp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_out, aux


def _forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig,
             moe_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> logits [B, S, V] (+ the summed MoE aux loss);
    ``params`` is ``param_tree``'s layout."""
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    rope = rope_cos_sin(torch.arange(s, device=x.device).expand(b, s),
                        cfg.d_head, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack(params["layers"], cfg.n_layers):
        def layer(x, lp=lp):
            return _block(x, lp, cfg, rope, moe_groups)
        x, a = (checkpoint(layer, x, use_reentrant=False) if remat
                else layer(x))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], aux


def loss_fn(params, batch: Dict[str, torch.Tensor], moe_groups: int = 256,
            cfg: Optional[LMConfig] = None) -> torch.Tensor:
    """Cross-entropy of ``batch["labels"]`` (over ``batch["mask"]`` when
    given) plus the MoE aux loss.  ``params``: a ``Transformer``, or
    ``param_tree``'s layout with ``cfg``."""
    if isinstance(params, Transformer):
        params, cfg = param_tree(params), params.cfg
    logits, aux = _forward(params, batch["tokens"], cfg, moe_groups)
    return cross_entropy(logits, batch["labels"], batch.get("mask")) + aux


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@torch.no_grad()
def prefill_logits(model: Transformer, tokens: torch.Tensor,
                   moe_groups: int = 256) -> torch.Tensor:
    return _forward(param_tree(model), tokens, model.cfg, moe_groups)[0]


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda"
               ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: int,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One greedy decode step.  tokens [B, 1]; ``pos`` = the current
    length (uniform across the batch: static-batch serving).  Writes the
    step's keys and values into row ``pos`` of ``cache`` in place and
    returns (logits [B, 1, V], cache)."""
    cfg = model.cfg
    b = tokens.shape[0]
    x = F.embedding(tokens.long(), model.embed)              # [B, 1, D]
    rope = rope_cos_sin(torch.full((b, 1), pos, dtype=torch.int32,
                                   device=x.device),
                        cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = model.layer(i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = rotate(q, *rope)
        k = rotate(k, *rope)
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        attn = decode_attention(q, kc, vc, pos + 1)
        x = x + attn.reshape(b, 1, cfg.n_heads * cfg.d_head) @ lp["wo"]
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.moe_experts:
            out, _ = moe_ffn(h.reshape(b, -1), lp["router"], lp["we1"],
                             lp["we3"], lp["we2"], cfg.moe_top_k,
                             cfg.capacity_factor)
            mlp_out = out.reshape(b, 1, -1)
        else:
            mlp_out = _dense_ffn(h, lp)
        x = x + mlp_out
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.lm_head, cache
