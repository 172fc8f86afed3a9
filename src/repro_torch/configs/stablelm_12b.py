"""stablelm-12b — 40L d5120 32H (GQA kv=8) d_ff=13824 vocab=100352 (dense).
[hf:stabilityai/stablelm-2-12b]"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = LMConfig(
    name="stablelm-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, microbatches=4,
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, microbatches=1, sequence_parallel=False,
    dtype="float32",
)

OPT = AdamWConfig()

SPEC = ArchSpec(arch_id="stablelm-12b", config=CONFIG, shapes=LM_SHAPES,
                smoke_config=SMOKE)
