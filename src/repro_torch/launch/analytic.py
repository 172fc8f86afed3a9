"""Analytic MODEL_FLOPS per cell: first-principles *useful* work per step
(6·N·D-style accounting), the numerator of an MFU figure (port of
``repro.launch.analytic``'s ``_lm_fwd_flops`` and ``model_flops``, copied:
pure Python).

Conventions: train = 3x forward (fwd + 2x bwd); embedding gathers are not
FLOPs; causal attention = half the full score matrix; MoE counts only the
top-k activated experts.  The reference's ``roofline_terms`` reads
dry-run HLO records and belongs to the dry-run slice; no hardware
constant is kept here.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, LMConfig, GNNConfig, DLRMConfig


def _lm_fwd_flops(cfg: LMConfig, tokens: int, seq: int) -> float:
    # matmul params actually multiplied per token (embed gather excluded,
    # lm_head included)
    n_eff = cfg.active_param_count() - cfg.vocab * cfg.d_model
    attn = 2.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * tokens * 0.5
    return 2.0 * n_eff * tokens + attn


def model_flops(spec: ArchSpec, shape_name: str) -> float:
    """Global useful FLOPs for one step of (arch x shape)."""
    shape = spec.shape(shape_name)
    p = shape.p()
    cfg = spec.config

    if isinstance(cfg, LMConfig):
        b, s = int(p["global_batch"]), int(p["seq_len"])
        if shape.kind == "train":
            return 3.0 * _lm_fwd_flops(cfg, b * s, s)
        if shape.kind == "prefill":
            return _lm_fwd_flops(cfg, b * s, s)
        # decode: one token against an s-token cache
        n_eff = cfg.active_param_count() - cfg.vocab * cfg.d_model
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * s * b
        return 2.0 * n_eff * b + attn

    if isinstance(cfg, GNNConfig):
        h = cfg.d_hidden
        if shape.kind == "molecule":
            n = int(p["batch"]) * int(p["n_nodes"])
            e = int(p["batch"]) * int(p["n_edges"])
        elif shape.kind == "minibatch":
            # fanout regime: encode MLP on every sampled node + pooling
            # (pooling adds are not matmul FLOPs); sage adds 2 matmul hops
            r = int(p["batch_nodes"])
            f1, f2 = p["fanout"]
            n_eff = r * (1 + f1 + f1 * f2)
            h = cfg.d_hidden
            fwd = 2.0 * n_eff * cfg.d_feat * h \
                + 2.0 * r * (h * h + h * cfg.n_classes)
            if cfg.name == "graphsage-reddit":
                fwd += 4.0 * (r + r * f1) * h * h
            return 3.0 * fwd
        else:
            n, e = int(p["n_nodes"]), int(p["n_edges"])
        d_feat = int(p.get("d_feat", cfg.d_feat))
        per_layer = {
            "gatedgcn": 2.0 * h * h * (4 * e + n),
            "gin-tu": 4.0 * n * h * h,
            "meshgraphnet": 8.0 * e * h * h + 6.0 * n * h * h,
            "graphsage-reddit": 4.0 * n * h * h,
        }[cfg.name]
        io = 2.0 * n * d_feat * h + 2.0 * n * (h * h + h * cfg.n_classes)
        layers = cfg.n_layers if shape.kind != "minibatch" else min(
            cfg.n_layers, 2)
        fwd = per_layer * layers + io
        return 3.0 * fwd  # all GNN shapes are training cells

    if isinstance(cfg, DLRMConfig):
        nf = cfg.n_sparse + 1
        bot = 2.0 * sum(a * b_ for a, b_ in zip(
            (cfg.n_dense,) + cfg.bot_mlp[:-1], cfg.bot_mlp))
        inter = 2.0 * nf * nf * cfg.embed_dim
        top_in = nf * (nf - 1) // 2 + cfg.bot_mlp[-1]
        top = 2.0 * sum(a * b_ for a, b_ in zip(
            (top_in,) + cfg.top_mlp[:-1], cfg.top_mlp))
        per_ex = bot + inter + top
        if shape.kind == "train_batch":
            return 3.0 * int(p["batch"]) * per_ex
        if shape.kind == "serve_batch":
            return float(int(p["batch"]) * per_ex)
        # retrieval: two-tower dot
        return bot + 2.0 * int(p["n_candidates"]) * cfg.embed_dim

    raise ValueError(type(cfg))
