"""Shared budget checks: wall-clock and level-count exhaustion (port of
``repro.core.budget``).

A falsy budget never exhausts; a set wall-clock budget exhausts strictly
after it elapses.  The level-count budget is batch-invariant (DESIGN.md
§13): it depends only on how many uncoarsening level-steps a request
has refined, never on machine load.
"""
from __future__ import annotations

import time
from typing import Optional


def exhausted(t0: float, budget_s: Optional[float]) -> bool:
    """True once more than ``budget_s`` seconds elapsed since ``t0``
    (``None``/``0`` → never)."""
    return bool(budget_s) and (time.perf_counter() - t0) > budget_s


def level_exhausted(steps_done: int, level_budget: Optional[int]) -> bool:
    """True once ``steps_done`` full-strength level refinements have
    consumed the level budget (``None`` → never).  Deterministic and
    batch-invariant: the trigger is a pure function of the request's own
    ladder position."""
    return level_budget is not None and steps_done >= level_budget

