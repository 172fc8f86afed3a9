"""Elastic runtime: fault detection, device-pool shrink, straggler
mitigation (port of ``repro.runtime.elastic``).

Failures are *injected* (``FailureInjector``), and the tests exercise
the whole kill -> restore -> continue path.  Design points:

  * state is restorable onto a different device (``CheckpointManager``
    places leaves on load), so an elastic restart re-uses the same files;
  * the data cursor lives in the checkpoint manifest, so a resume is
    exactly-once with respect to the batch stream;
  * straggler mitigation: a per-step deadline watchdog reports steps
    that exceed a multiple of the trailing median;
  * a device loss shrinks the survivor pool (``core.popshard``) and, for
    a placement, repartitions at the surviving count as a forced
    k-change (``repartition_after_loss``).

``ElasticTrainer`` and ``Runner`` are generic over ``step_fn``: any
callable ``(state, batch) -> (state, metrics)``, a torch step included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class FailureInjector:
    """Deterministic failure schedule for tests/examples.

    The training-side ancestor of the serving fault harness:
    ``serve.faults.FaultPlan`` generalises this step -> kind dict into
    typed, scheduled events (device loss, mid-tick crash, state
    corruption, stragglers); ``as_fault_plan()`` lifts an existing
    schedule into that form."""

    def __init__(self, fail_at_steps: Dict[int, str] | None = None):
        self.fail_at_steps = fail_at_steps or {}

    def check(self, step: int):
        if step in self.fail_at_steps:
            kind = self.fail_at_steps.pop(step)
            raise NodeFailure(f"injected {kind} failure at step {step}")

    def as_fault_plan(self):
        """The equivalent ``serve.faults.FaultPlan`` (typed events,
        each firing once)."""
        from repro_torch.serve.faults import FaultPlan
        return FaultPlan.from_fail_at_steps(self.fail_at_steps)


# --------------------------------------------------------------------------
# Device-loss elasticity (serving side, DESIGN.md §13)
# --------------------------------------------------------------------------
def simulate_device_loss(survivors: int,
                         device: str | torch.device = "cuda") -> list:
    """Shrink the device pool (``popshard.local_devices``) to the first
    ``survivors`` devices: the simulation of losing a device mid-flight.
    Returns the surviving devices of ``device``'s type."""
    from repro_torch.core import popshard
    return popshard.set_device_limit(survivors, device)


def restore_device_pool(device: str | torch.device = "cuda") -> list:
    """Undo ``simulate_device_loss``: every device visible again (the
    rejoin/repair path).  Returns the full pool."""
    from repro_torch.core import popshard
    return popshard.set_device_limit(None, device)


def repartition_after_loss(hg, assignment, k_new: int, *,
                           eps: float = 0.08,
                           migration_frac: Optional[float] = 0.25,
                           alpha: int = 4, seed: int = 0,
                           lp_iters: int = 8, state=None,
                           device: str | torch.device = "cuda"):
    """Device-loss repartitioning as a forced k-change incremental solve
    on ``device`` (DESIGN.md §14): the survivors' assignment is remapped
    ``b -> b % k_new`` and the warm-start pipeline runs at the surviving
    device count, with additional movement bounded by ``migration_frac``
    of the total vertex weight.  Passing the ``IncrementalState`` that
    served the original placement reuses its resident hierarchy (weights
    are unchanged at loss time and k only shrinks).  Returns the
    ``IncrementalResult``."""
    from repro_torch.core import incremental as incr
    cfg = incr.IncrementalConfig(
        k=k_new, eps=eps, alpha=alpha, migration_frac=migration_frac,
        seed=seed, lp_iters=lp_iters)
    return incr.repartition_k_change(hg, np.asarray(assignment, np.int32),
                                     k_new, cfg, state=state, device=device)


class NodeFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    deadline: float


class StragglerWatchdog:
    """Flags steps that exceed ``factor`` x the trailing-median step
    time, so the caller can checkpoint and shrink its pool."""

    def __init__(self, factor: float = 3.0, window: int = 16,
                 grace_steps: int = 4):
        self.factor = factor
        self.window = window
        self.grace = grace_steps
        self.times: List[float] = []
        self.reports: List[StragglerReport] = []

    def observe(self, step: int, step_time: float) -> Optional[StragglerReport]:
        self.times.append(step_time)
        if len(self.times) <= self.grace:
            return None
        med = float(np.median(self.times[-self.window:]))
        if step_time > self.factor * med:
            rep = StragglerReport(step=step, step_time=step_time,
                                  deadline=self.factor * med)
            self.reports.append(rep)
            return rep
        return None


class ElasticTrainer:
    """Restart loop: run -> on failure, restore the latest checkpoint
    (possibly onto fewer devices) -> continue.  ``make_runner`` builds a
    fresh (step_fn, state, start_step) for a given attempt."""

    def __init__(self, make_runner: Callable[[int], "Runner"],
                 max_restarts: int = 3):
        self.make_runner = make_runner
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, total_steps: int) -> dict:
        attempt = 0
        history = []
        while True:
            runner = self.make_runner(attempt)
            try:
                result = runner.run_until(total_steps)
                result["restarts"] = self.restarts
                result["history"] = history
                return result
            except NodeFailure as e:
                self.restarts += 1
                history.append((runner.step, str(e)))
                if self.restarts > self.max_restarts:
                    raise
                attempt += 1


@dataclasses.dataclass
class Runner:
    """One attempt: owns step_fn + state + data cursor."""
    step_fn: Callable
    state: object
    next_batch: Callable[[int], dict]
    ckpt: object                       # CheckpointManager
    step: int = 0
    ckpt_every: int = 10
    injector: Optional[FailureInjector] = None
    watchdog: Optional[StragglerWatchdog] = None
    on_metrics: Optional[Callable] = None

    def run_until(self, total_steps: int) -> dict:
        metrics = None
        while self.step < total_steps:
            if self.injector:
                self.injector.check(self.step)
            t0 = time.perf_counter()
            batch = self.next_batch(self.step)
            self.state, metrics = self.step_fn(self.state, batch)
            dt = time.perf_counter() - t0
            if self.watchdog:
                rep = self.watchdog.observe(self.step, dt)
                if rep and self.on_metrics:
                    self.on_metrics({"straggler": dataclasses.asdict(rep)})
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state,
                               extra={"data_cursor": self.step})
        self.ckpt.save(self.step, self.state,
                       extra={"data_cursor": self.step})
        return {"state": self.state, "metrics": metrics,
                "final_step": self.step}
