"""phi3.5-moe-42b-a6.6b — 32L d4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, moe_experts=16, moe_top_k=2,
    microbatches=4,
)

SMOKE = LMConfig(
    name="phi3.5-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, moe_experts=4, moe_top_k=2,
    microbatches=1, sequence_parallel=False, dtype="float32",
)

OPT = AdamWConfig()

SPEC = ArchSpec(arch_id="phi3.5-moe-42b-a6.6b", config=CONFIG,
                shapes=LM_SHAPES, smoke_config=SMOKE,
                notes="MoE EP over model axis (16 experts / 16-way TP)")
