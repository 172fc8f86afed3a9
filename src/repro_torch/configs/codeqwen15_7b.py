"""codeqwen1.5-7b — 32L d4096 32H (GQA kv=32 == MHA) d_ff=13440
vocab=92416 (dense, qwen1.5 arch).  [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = LMConfig(
    name="codeqwen1.5-7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, microbatches=4,
)

SMOKE = LMConfig(
    name="codeqwen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=256, microbatches=1, sequence_parallel=False,
    dtype="float32",
)

OPT = AdamWConfig()

SPEC = ArchSpec(arch_id="codeqwen1.5-7b", config=CONFIG, shapes=LM_SHAPES,
                smoke_config=SMOKE)
