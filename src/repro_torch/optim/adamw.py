"""AdamW's hyper-parameters (counterpart of ``repro.optim.adamw``).

Only the config dataclass is ported so far: the arch modules name one
each (``OPT``).  The update rule and the quantised moments come with
training.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    q_block: int = 256
    # block-row count padded to this multiple so QTensors shard evenly
    # over any production mesh (512 covers 2x16x16 and 16x16)
    q_row_mult: int = 512
