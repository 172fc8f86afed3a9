"""Deterministic fault injection for the partition service (port of
``repro.serve.faults``; DESIGN.md §13).

Generalises ``runtime.elastic.FailureInjector`` (a step -> kind dict that
raises) into a ``FaultPlan``: a schedule of typed ``FaultEvent``s keyed
on service TICK numbers, each firing exactly once.  Four fault kinds
cover the serving failure model:

* ``device_loss`` — shrink the visible device pool to ``survivors``
  (``popshard.set_device_limit``); the service treats all in-flight
  device state as lost (it drops every tensor it holds for the requests
  in flight) and resumes every surviving request from its slot snapshot
  (or deterministically from scratch).
* ``crash``       — raise ``InjectedCrash`` inside the tick's grouped
  dispatch; slot state is consistent at that point, so the service
  records the event and retries the tick.
* ``corrupt``     — overwrite one slot's post-dispatch state
  (out-of-range block ids / NaN cuts / an all-in-one-block imbalance);
  the per-tick validator must quarantine exactly that slot.
* ``straggler``   — sleep ``delay_s`` inside the tick so the straggler
  watchdog fires; results are unchanged.

Everything is injected, nothing is random: a plan replays identically,
which is what lets the chaos test pin bit-identical answers for every
unfaulted request.  ``REPRO_FAULT_PLAN`` carries a plan through the
environment (a chaos lane)::

    REPRO_FAULT_PLAN="2:straggler:delay_ms=80;3:device_loss:survivors=2;4:corrupt:slot=0"
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.env import warn_env_once

FAULT_KINDS = ("device_loss", "crash", "corrupt", "straggler")

CORRUPT_MODES = ("block_range", "nan_cut", "imbalance")


class InjectedCrash(RuntimeError):
    """A scheduled mid-tick crash (the serving analogue of
    ``runtime.elastic.NodeFailure``)."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault.  ``tick`` is the service tick it fires on
    (first tick = 1).  Fields beyond (tick, kind) apply per kind:
    ``survivors`` (device_loss), ``delay_s`` (straggler), ``slot`` +
    ``mode`` (corrupt)."""
    tick: int
    kind: str
    slot: int = 0                     # corrupt: target slot index
    survivors: Optional[int] = None   # device_loss: pool size after loss
    delay_s: float = 0.0              # straggler: injected stall
    mode: str = "block_range"         # corrupt: what to poison

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"expected one of {CORRUPT_MODES}")
        if self.tick < 1:
            raise ValueError(f"fault tick must be >= 1 (got {self.tick})")


class FaultPlan:
    """A deterministic schedule of ``FaultEvent``s, each consumed once.

    The service polls ``events_for(tick)`` at every tick; events whose
    tick has passed (e.g. scheduled during an idle stretch) fire on the
    next polled tick, so a plan never silently drops an event.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(events,
                                               key=lambda e: e.tick)
        self._fired: set = set()

    def events_for(self, tick: int) -> List[FaultEvent]:
        out = []
        for i, ev in enumerate(self.events):
            if i not in self._fired and ev.tick <= tick:
                self._fired.add(i)
                out.append(ev)
        return out

    @property
    def pending(self) -> int:
        return len(self.events) - len(self._fired)

    def reset(self) -> "FaultPlan":
        self._fired.clear()
        return self

    @classmethod
    def from_fail_at_steps(cls, fail_at_steps: Dict[int, str]
                           ) -> "FaultPlan":
        """Lift a ``runtime.elastic.FailureInjector`` schedule
        (step -> freeform kind string) into typed events: kinds naming a
        device/node loss, straggler or corruption map to their typed
        fault; everything else (the injector's generic failure) becomes
        a mid-tick crash."""
        events = []
        for step, kind in sorted(fail_at_steps.items()):
            k = kind.strip().lower()
            if "straggler" in k or "slow" in k:
                events.append(FaultEvent(tick=step, kind="straggler",
                                         delay_s=0.05))
            elif "corrupt" in k or "nan" in k:
                events.append(FaultEvent(tick=step, kind="corrupt"))
            elif "device" in k or "node" in k or "pod" in k:
                events.append(FaultEvent(tick=step, kind="device_loss"))
            else:
                events.append(FaultEvent(tick=step, kind="crash"))
        return cls(events)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``REPRO_FAULT_PLAN`` wire format:
        ``tick:kind[:key=value[,key=value...]]`` joined by ``;``.
        Keys: ``survivors``, ``slot``, ``delay_ms``, ``mode``."""
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(f"fault spec {part!r}: need tick:kind")
            tick, kind = int(fields[0]), fields[1].strip().lower()
            kw: dict = {}
            if len(fields) > 2:
                for item in fields[2].split(","):
                    if not item.strip():
                        continue
                    key, _, val = item.partition("=")
                    key, val = key.strip(), val.strip()
                    if key == "survivors":
                        kw["survivors"] = int(val)
                    elif key == "slot":
                        kw["slot"] = int(val)
                    elif key == "delay_ms":
                        kw["delay_s"] = float(val) / 1000.0
                    elif key == "mode":
                        kw["mode"] = val
                    else:
                        raise ValueError(
                            f"fault spec {part!r}: unknown key {key!r}")
            events.append(FaultEvent(tick=tick, kind=kind, **kw))
        return cls(events)


def fault_plan_env() -> Optional[FaultPlan]:
    """``REPRO_FAULT_PLAN``: a fault schedule forced through the
    environment (a chaos lane).  Unset/empty -> None; unparsable
    values warn once and fall back to no plan."""
    raw = os.environ.get("REPRO_FAULT_PLAN", "").strip()
    if not raw:
        return None
    try:
        return FaultPlan.parse(raw)
    except (ValueError, TypeError):
        warn_env_once("REPRO_FAULT_PLAN", raw, "no fault plan")
        return None


# --------------------------------------------------------------------------
# corruption application (deterministic, per mode)
# --------------------------------------------------------------------------
def corrupt_state(parts: np.ndarray, cuts: np.ndarray, k: int,
                  mode: str = "block_range"):
    """Return a poisoned copy of one slot's ``(parts [A, n_pad],
    cuts [A])`` — the injected state the per-tick validator must catch.
    Deterministic per mode; never mutates the inputs.  Numpy in and
    numpy out: the service converts the targeted entry of its dispatch
    before calling it."""
    parts = np.array(parts, np.int32)
    cuts = np.array(cuts, np.float64)
    if mode == "block_range":
        parts[0, :] = k + 7          # block ids outside [0, k)
    elif mode == "nan_cut":
        cuts[0] = np.nan
    elif mode == "imbalance":
        parts[:, :] = 0              # every vertex in block 0
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    return parts, cuts
