"""Config schema for the architecture zoo (port of ``repro.configs.base``,
copied: pure data, no framework).

Every assigned architecture gets a ``configs/<id>.py`` that
instantiates one of these dataclasses with the exact published numbers,
plus a ``smoke()`` reduction for CPU tests and the arch's own shape set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture x input-shape) cell of the dry-run table."""
    name: str
    kind: str       # train | prefill | decode | long_decode |
    #                 full_graph | minibatch | molecule |
    #                 train_batch | serve_p99 | serve_bulk | retrieval
    params: Tuple[Tuple[str, object], ...] = ()

    def p(self) -> Dict[str, object]:
        return dict(self.params)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0          # 0 = dense
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # training knobs
    microbatches: int = 4
    remat: bool = True
    sequence_parallel: bool = True
    grad_accum_dtype: str = "float32"  # bf16 halves FSDP grad collectives

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def family(self) -> str:
        return "lm"

    def param_count(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * (self.n_heads * self.d_head) + 2 * d * (
            self.n_kv_heads * self.d_head) + (self.n_heads * self.d_head) * d
        if self.moe_experts:
            mlp = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            mlp = 3 * d * f
        return l * (attn + mlp + 2 * d) + 2 * v * d + d

    def active_param_count(self) -> int:
        if not self.moe_experts:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        attn = d * (self.n_heads * self.d_head) + 2 * d * (
            self.n_kv_heads * self.d_head) + (self.n_heads * self.d_head) * d
        mlp = self.moe_top_k * 3 * d * f + d * self.moe_experts
        return l * (attn + mlp + 2 * d) + 2 * self.vocab * d + d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str               # gated | sum | mean
    mlp_layers: int = 2
    eps_learnable: bool = False   # GIN
    sample_sizes: Tuple[int, ...] = ()  # GraphSAGE fanouts
    n_classes: int = 64
    d_feat: int = 128             # default input feature dim
    dtype: str = "float32"
    residual: bool = True

    @property
    def family(self) -> str:
        return "gnn"


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    table_sizes: Tuple[int, ...]
    interaction: str = "dot"
    dtype: str = "float32"

    @property
    def family(self) -> str:
        return "recsys"

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Registry record: config + its assigned shape set."""
    arch_id: str
    config: object                # LMConfig | GNNConfig | DLRMConfig
    shapes: Tuple[ShapeSpec, ...]
    smoke_config: object          # reduced same-family config
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


# ---- the LM shape set shared by all five LM archs ------------------------
LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train",
              (("seq_len", 4096), ("global_batch", 256))),
    ShapeSpec("prefill_32k", "prefill",
              (("seq_len", 32768), ("global_batch", 32))),
    ShapeSpec("decode_32k", "decode",
              (("seq_len", 32768), ("global_batch", 128))),
    ShapeSpec("long_500k", "long_decode",
              (("seq_len", 524288), ("global_batch", 1))),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "full_graph",
              (("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433))),
    ShapeSpec("minibatch_lg", "minibatch",
              (("n_nodes", 232965), ("n_edges", 114615892),
               ("batch_nodes", 1024), ("fanout", (15, 10)))),
    ShapeSpec("ogb_products", "full_graph",
              (("n_nodes", 2449029), ("n_edges", 61859140),
               ("d_feat", 100))),
    ShapeSpec("molecule", "molecule",
              (("n_nodes", 30), ("n_edges", 64), ("batch", 128))),
)

DLRM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train_batch", (("batch", 65536),)),
    ShapeSpec("serve_p99", "serve_batch", (("batch", 512),)),
    ShapeSpec("serve_bulk", "serve_batch", (("batch", 262144),)),
    ShapeSpec("retrieval_cand", "retrieval",
              (("batch", 1), ("n_candidates", 1_000_000))),
)
