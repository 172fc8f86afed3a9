"""grok-1-314b — 64L d6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8
experts top-2.  [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, moe_experts=8, moe_top_k=2,
    microbatches=4,
)

SMOKE = LMConfig(
    name="grok1-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, moe_experts=2, moe_top_k=2,
    microbatches=1, sequence_parallel=False, dtype="float32",
)

# 314B params: int8 moments are what fits the optimizer on 256 chips
OPT = AdamWConfig(quantize_moments=True)

SPEC = ArchSpec(arch_id="grok-1-314b", config=CONFIG, shapes=LM_SHAPES,
                smoke_config=SMOKE,
                notes="8 experts !% 16 -> TP inside experts (d_ff/16); "
                      "int8-quantised AdamW moments")
