"""mistral-large-123b — 88L d12288 96H (GQA kv=8) d_ff=28672 vocab=32768
(dense).  [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = LMConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768, microbatches=4, grad_accum_dtype="bfloat16",
)

SMOKE = LMConfig(
    name="mistral-large-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, microbatches=1, sequence_parallel=False,
    dtype="float32",
)

OPT = AdamWConfig()

SPEC = ArchSpec(arch_id="mistral-large-123b", config=CONFIG,
                shapes=LM_SHAPES, smoke_config=SMOKE)
