"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step counter, computed in f32 on the step tensor's device."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step: torch.Tensor, *, warmup: int = 200,
                       total: int = 10_000, min_ratio: float = 0.1
                       ) -> torch.Tensor:
    """Linear warm-up to 1 over ``warmup`` steps, then a cosine decay to
    ``min_ratio`` at ``total``.  ``cosine_with_warmup(0)`` is 0: the
    train steps take it at the step *before* their increment, so the
    first step of a fresh state moves no parameter."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (min_ratio + (1 - min_ratio) * cos)


def constant(step: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(step, dtype=torch.float32)
