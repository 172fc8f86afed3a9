"""Continuous-batching partition service (port of
``repro.serve.partition_service``; DESIGN.md §12, robustness §13).

A fixed number of SLOTS each hold one in-flight request (its hierarchy
and population); every tick advances each occupied slot by ONE
uncoarsening level, with all slots that share a shape bucket refined in
one stacked dispatch (``core.instances.refine_grouped``).  A request
that reaches the finest level emits its result and vacates the slot; a
queued request fills it on the next tick and joins mid-flight, as
continuous batching slots new sequences into a decode batch.

Each request runs the multilevel population pipeline of
``impart_partition`` with the memetic events off (no recombination, no
mutation, no final V-cycle).  ``solve_solo`` runs the same pipeline for
one request alone; the service's answer for a request is bit-identical
to it whatever shares the slots (the batching contract of the static
schedule).  Incremental requests (an ``incumbent`` and a
``migration_frac``) run the ``incremental_partition`` pipeline and
share the stacks with cold ones.

Robustness (DESIGN.md §13).  Every request ends in a STRUCTURED terminal
state, never an unhandled exception:

* ``ok``          — full-strength answer, bit-identical to solo.
* ``degraded``    — a deadline fired mid-flight: the remaining levels
  were fast-forwarded and the best so far returned (``degraded=True``).
* ``rejected``    — shed at submit (queue over ``REPRO_SERVE_MAX_QUEUE``,
  or an invalid incumbent).
* ``timed_out``   — shed from the queue (waited past ``max_queue_s`` or
  the deadline passed before admission).
* ``recovered``   — the slot was restored from a snapshot or restarted
  (seed-bumped) after corruption or device loss, then finished.
* ``quarantined`` — state validation failed and the one retry failed
  too; the slot is freed, co-bucketed slots never see the poison.

Slot state (population, level index, projection flag) snapshots through
``checkpoint.CheckpointManager`` every ``REPRO_SERVE_CKPT_EVERY`` ticks;
each snapshot reads a slot's population to the host once.  An injected
device loss (``serve/faults.py``) shrinks the device pool to the
survivors and treats every device tensor the service holds for its
requests in flight or queued as lost: each occupied slot's hierarchy
and population and each such request's cached level-0 arrays are
dropped, the CUDA caching allocator returns the freed blocks, the
service moves to the first survivor if its own device is not among
them, and every slot resumes from its snapshot, or is reinstalled with
its original seed.
Both rebuild the hierarchy from (hg, k, seed), so the answers stay
bit-identical to solo.

The service is single-threaded and launches on the default stream of
its device (the scratch of the cut kernel, ``kernels/connectivity.py``,
is correct on one stream only).

Env knobs (the reference's, same names):

* ``REPRO_SERVE_SLOTS``        — slot count (default 8).
* ``REPRO_SERVE_BUCKETS``      — comma list of vertex-padding bucket
  sizes (e.g. ``1024,4096``); requests round up to the smallest listed
  bucket so mixed sizes share stacks.  ``auto``/unset: natural pow2
  paddings are their own buckets.
* ``REPRO_SERVE_COALESCE_MS``  — arrival coalescing window (default 0).
* ``REPRO_SERVE_DEADLINE_S``   — default per-request deadline (0 = none).
* ``REPRO_SERVE_MAX_QUEUE``    — admission cap on queued requests
  (0 = unbounded).
* ``REPRO_SERVE_CKPT_EVERY``   — ticks between slot snapshots (0 = off).
* ``REPRO_SERVE_CKPT_DIR``     — snapshot directory (default: a fresh
  temp dir per service).
* ``REPRO_FAULT_PLAN``         — injected fault schedule (chaos lanes).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.core.dcoarsen import build_hierarchy
from repro_torch.core.initial_partition import initial_partition_population
from repro_torch.core import budget as budget_mod
from repro_torch.core import incremental as incremental_mod
from repro_torch.core import instances as instances_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import popshard
from repro_torch.core import refine as refine_mod
from repro_torch.core.scheduler import (OperatorScheduler, REFINE_ARMS,
                                        resolve_sched)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import (StragglerWatchdog,
                                         simulate_device_loss)
from repro_torch.serve import faults as faults_mod


def _host(x) -> np.ndarray:
    """One read of a population (or cut vector) to host numpy."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def serve_slots() -> int:
    """``REPRO_SERVE_SLOTS`` (default 8, floor 1)."""
    raw = os.environ.get("REPRO_SERVE_SLOTS", "8")
    try:
        s = int(raw)
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_SLOTS", raw, "8 slots")
        return 8
    return max(s, 1)


def serve_buckets() -> Optional[Tuple[int, ...]]:
    """``REPRO_SERVE_BUCKETS``: comma list of POSITIVE bucket sizes, or
    None for natural pow2 bucketing (``auto``/unset).  Unparsable or
    non-positive entries warn once and fall back to auto — a ``0,-4``
    grid would build degenerate paddings."""
    raw = os.environ.get("REPRO_SERVE_BUCKETS", "auto").strip().lower()
    if raw in ("", "auto"):
        return None
    try:
        grid = tuple(sorted(int(x) for x in raw.split(",") if x.strip()))
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_BUCKETS", raw,
                                 "auto bucketing")
        return None
    if not grid:
        return None
    if any(g <= 0 for g in grid):
        faults_mod.warn_env_once("REPRO_SERVE_BUCKETS", raw,
                                 "auto bucketing (buckets must be > 0)")
        return None
    return grid


def serve_coalesce_s() -> float:
    """``REPRO_SERVE_COALESCE_MS`` as seconds (default 0)."""
    raw = os.environ.get("REPRO_SERVE_COALESCE_MS", "0")
    try:
        ms = float(raw)
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_COALESCE_MS", raw, "0 ms")
        return 0.0
    return max(ms, 0.0) / 1000.0


def serve_deadline_s() -> Optional[float]:
    """``REPRO_SERVE_DEADLINE_S``: default per-request deadline in
    seconds (0/unset = none)."""
    raw = os.environ.get("REPRO_SERVE_DEADLINE_S", "0")
    try:
        s = float(raw)
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_DEADLINE_S", raw,
                                 "no deadline")
        return None
    if s < 0:
        faults_mod.warn_env_once("REPRO_SERVE_DEADLINE_S", raw,
                                 "no deadline (must be >= 0)")
        return None
    return s or None


def serve_max_queue() -> int:
    """``REPRO_SERVE_MAX_QUEUE``: admission cap on queued requests
    (0/unset = unbounded)."""
    raw = os.environ.get("REPRO_SERVE_MAX_QUEUE", "0")
    try:
        q = int(raw)
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_MAX_QUEUE", raw,
                                 "unbounded queue")
        return 0
    if q < 0:
        faults_mod.warn_env_once("REPRO_SERVE_MAX_QUEUE", raw,
                                 "unbounded queue (must be >= 0)")
        return 0
    return q


def serve_ckpt_every() -> int:
    """``REPRO_SERVE_CKPT_EVERY``: ticks between slot snapshots
    (0/unset = checkpointing off)."""
    raw = os.environ.get("REPRO_SERVE_CKPT_EVERY", "0")
    try:
        n = int(raw)
    except ValueError:
        faults_mod.warn_env_once("REPRO_SERVE_CKPT_EVERY", raw,
                                 "checkpointing off")
        return 0
    if n < 0:
        faults_mod.warn_env_once("REPRO_SERVE_CKPT_EVERY", raw,
                                 "checkpointing off (must be >= 0)")
        return 0
    return n


def serve_ckpt_dir() -> Optional[str]:
    """``REPRO_SERVE_CKPT_DIR`` (default: fresh temp dir per service)."""
    return os.environ.get("REPRO_SERVE_CKPT_DIR", "").strip() or None


# terminal request states (DESIGN.md §13 fault model)
STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_REJECTED = "rejected"
STATUS_TIMED_OUT = "timed_out"
STATUS_RECOVERED = "recovered"
STATUS_QUARANTINED = "quarantined"


@dataclasses.dataclass
class PartitionRequest:
    name: str
    hg: Hypergraph
    k: int
    eps: float = 0.08
    seed: int = 0
    # robustness contract: total latency budget from submit (None = the
    # REPRO_SERVE_DEADLINE_S default) and the longest acceptable queue
    # wait before the request is shed with ``timed_out``
    deadline_s: Optional[float] = None
    max_queue_s: Optional[float] = None
    submitted_s: float = 0.0  # stamped by submit()
    # incremental refresh (DESIGN.md §14): a previous assignment to warm
    # -start from, with moved-vertex weight bounded by
    # ``migration_frac`` of the total (None = unbounded).  Incremental
    # and cold requests co-batch through the same grouped dispatches.
    incumbent: Optional[np.ndarray] = None
    migration_frac: Optional[float] = None


@dataclasses.dataclass
class PartitionResult:
    name: str
    part: Optional[np.ndarray]
    cut: Optional[float]
    k: int
    submitted_s: float
    finished_s: float
    status: str = STATUS_OK
    degraded: bool = False
    error: Optional[str] = None
    # incremental requests: moved-vertex weight of the answer relative
    # to the request's incumbent (None for cold requests)
    migration_weight: Optional[float] = None

    @property
    def ok(self) -> bool:
        """True when the result carries a valid partition (full-strength,
        degraded, or recovered — shed/quarantined requests carry None)."""
        return self.part is not None

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s


@dataclasses.dataclass
class _Slot:
    """One in-flight request: its hierarchy, population, and ladder
    position.  ``li`` is the level the next tick refines;
    ``need_project`` marks that ``parts`` still lives at ``li + 1``."""
    request: Optional[PartitionRequest] = None
    cfg: Optional[ImpartConfig] = None
    hier: object = None
    parts: object = None
    li: int = 0
    need_project: bool = False
    retries: int = 0        # quarantine retries consumed
    hold_ticks: int = 0     # backoff: skip this many dispatch ticks
    recovered: bool = False  # state was restored/restarted at least once
    # incremental requests: per-level projected incumbents and
    # residual-adjusted budgets (core.incremental.project_incumbent);
    # None for cold requests
    incs: Optional[List[np.ndarray]] = None
    buds: Optional[List[float]] = None
    # bandit mode (DESIGN.md §16): the slot's per-request scheduler and
    # its running best cut (the reward baseline); both snapshot through
    # the checkpoint path and are vacated with the slot
    scheduler: Optional[OperatorScheduler] = None
    best_cut: Optional[float] = None

    @property
    def occupied(self) -> bool:
        return self.request is not None

    def vacate(self) -> None:
        # full reset: the next occupant starts from nothing (the no-leak
        # contract, tested by test_torch_service.py)
        self.request = None
        self.cfg = None
        self.hier = None
        self.parts = None
        self.li = 0
        self.need_project = False
        self.retries = 0
        self.hold_ticks = 0
        self.recovered = False
        self.incs = None
        self.buds = None
        self.scheduler = None
        self.best_cut = None


class PartitionService:
    """Static-slot continuous-batching front-end over the instance-axis
    engine.  Single-threaded: callers interleave ``submit`` and ``step``
    (or just ``drain``); every ``step`` advances all occupied slots one
    hierarchy level in bucketed group dispatches.

    The robustness layer (DESIGN.md §13) wraps the slot loop: queued
    requests shed on deadline/queue caps, near-deadline slots finish in
    degraded mode, every post-dispatch state is validated (blocks in
    range, finite cuts, balance cap) with per-slot quarantine + one
    seed-bumped retry, slot state snapshots every ``ckpt_every`` ticks,
    and an injected device loss drops the in-flight device state and
    resumes from the snapshots.  ``fault_plan`` injects deterministic
    faults (``serve/faults.py``; default: the ``REPRO_FAULT_PLAN`` env
    schedule, usually none).

    Every dispatch runs on ``device`` (default ``"cuda"``; asking for a
    card where none is present raises).  ``shard``/``model_shard`` other
    than ``None``/``"off"`` belong to later slices (the service's routes,
    item 13b; the model axis, 13c) and raise ``NotImplementedError``."""

    def __init__(self, slots: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 coalesce_ms: Optional[float] = None,
                 alpha: int = 4, lp_iters: int = 8,
                 fm_node_limit: int = 4096,
                 contraction_limit_factor: int = 64,
                 shard: Optional[str] = None,
                 model_shard: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 ckpt_every: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 fault_plan: Optional[faults_mod.FaultPlan] = None,
                 max_retries: int = 1,
                 sched: Optional[str] = None,
                 sched_policy: str = "ucb1",
                 device: str | torch.device = "cuda"):
        refine_mod._check_slice_options(shard, model_shard, "cpu")
        if shard is not None and shard.strip().lower() in ("mesh", "chunk"):
            refine_mod._later_slice(f"the service's shard={shard!r}",
                                    "the service's routes, item 13b")
        self.device = resolve_device(device)
        self.n_slots = slots if slots is not None else serve_slots()
        if buckets is not None:
            buckets = tuple(buckets)
            if any(b <= 0 for b in buckets):
                raise ValueError(f"bucket sizes must be > 0: {buckets}")
            self.grid: Optional[Tuple[int, ...]] = buckets
        else:
            self.grid = serve_buckets()
        self.coalesce_s = (coalesce_ms / 1000.0 if coalesce_ms is not None
                           else serve_coalesce_s())
        self.alpha = alpha
        self.lp_iters = lp_iters
        self.fm_node_limit = fm_node_limit
        self.contraction_limit_factor = contraction_limit_factor
        self.shard = shard
        self.model_shard = model_shard
        self.default_deadline_s = (deadline_s if deadline_s is not None
                                   else serve_deadline_s())
        self.max_queue = (max_queue if max_queue is not None
                          else serve_max_queue())
        self.ckpt_every = (ckpt_every if ckpt_every is not None
                           else serve_ckpt_every())
        self._ckpt_dir = ckpt_dir if ckpt_dir is not None else serve_ckpt_dir()
        self._ckpt: Optional[CheckpointManager] = None
        self.fault_plan = (fault_plan if fault_plan is not None
                           else faults_mod.fault_plan_env())
        self.max_retries = max_retries
        # per-slot operator scheduling (DESIGN.md §16): "bandit" picks
        # each slot's refinement tier ({lp, lp_fm}) per tick through a
        # per-request scheduler; "static" (the default; None defers to
        # REPRO_SCHED) dispatches every slot with the configured
        # fm_node_limit, byte-for-byte the pre-scheduler service.  The
        # bit-identical-to-solo batching contract is static-only: a live
        # bandit's rewards see shared dispatch walls.
        self.sched = resolve_sched(sched)
        self.sched_policy = sched_policy
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.queue: List[PartitionRequest] = []
        self.results: Dict[str, PartitionResult] = {}
        self.tick = 0
        # structured robustness telemetry (read by the chaos tests and
        # the service phase of chip_smoke.py)
        self.events: List[dict] = []
        self.watchdog = StragglerWatchdog(factor=4.0, window=16,
                                          grace_steps=3)
        self._tick_walls: deque = deque(maxlen=8)

    # -- request pipeline (shared with solve_solo) -------------------------
    def _cfg_for(self, req: PartitionRequest,
                 seed_bump: int = 0) -> ImpartConfig:
        return ImpartConfig(
            k=req.k, eps=req.eps, alpha=self.alpha,
            seed=req.seed + seed_bump,
            lp_iters=self.lp_iters, fm_node_limit=self.fm_node_limit,
            contraction_limit_factor=self.contraction_limit_factor,
            recombination_enabled=False, mutation_enabled=False,
            final_vcycles=0, pop_shard=self.shard,
            # the solo-reference pipeline is pinned static whatever
            # REPRO_SCHED says: the service's own bandit lives in the
            # slot loop, and the static parity baseline must not move
            sched="static", model_shard=self.model_shard)

    def _icfg_for(self, req: PartitionRequest, seed_bump: int = 0
                  ) -> incremental_mod.IncrementalConfig:
        return incremental_mod.IncrementalConfig(
            k=req.k, eps=req.eps, alpha=self.alpha,
            migration_frac=req.migration_frac,
            seed=req.seed + seed_bump, lp_iters=self.lp_iters,
            fm_node_limit=self.fm_node_limit,
            contraction_limit_factor=self.contraction_limit_factor,
            pop_shard=self.shard, model_shard=self.model_shard)

    def solve_solo(self, req: PartitionRequest
                   ) -> Tuple[np.ndarray, float]:
        """The reference: run ``req``'s exact pipeline alone (no slot
        sharing).  The service's answer for the same request is
        bit-identical — the batching contract (incremental requests run
        the standalone ``incremental_partition`` pipeline)."""
        if req.incumbent is not None:
            ires = incremental_mod.incremental_partition(
                req.hg, req.incumbent, self._icfg_for(req),
                device=self.device)
            return ires.part, ires.cut
        res = impart_partition(req.hg, self._cfg_for(req),
                               device=self.device)
        return res.part, res.cut

    # -- the slot loop ------------------------------------------------------
    def submit(self, req: PartitionRequest) -> Optional[PartitionResult]:
        """Queue ``req``.  Returns None when accepted; under admission
        control (``max_queue``) an over-capacity submit is shed
        immediately with a structured ``rejected`` result (also recorded
        in ``results``) instead of queuing forever."""
        req.submitted_s = time.perf_counter()
        if req.incumbent is not None:
            inc = np.asarray(req.incumbent, np.int32)
            if (inc.shape != (req.hg.n,) or inc.min(initial=0) < 0
                    or inc.max(initial=0) >= req.k):
                return self._emit_shed(
                    req, STATUS_REJECTED,
                    f"invalid incumbent: shape {inc.shape}, "
                    f"expected [{req.hg.n}] with blocks in [0, {req.k})")
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        if self.max_queue and len(self.queue) >= self.max_queue:
            res = self._emit_shed(req, STATUS_REJECTED,
                                  f"queue full ({self.max_queue})")
            return res
        self.queue.append(req)
        return None

    def _emit_shed(self, req: PartitionRequest, status: str,
                   error: str) -> PartitionResult:
        res = PartitionResult(
            name=req.name, part=None, cut=None, k=req.k,
            submitted_s=req.submitted_s, finished_s=time.perf_counter(),
            status=status, error=error)
        self.results[req.name] = res
        self.events.append({"tick": self.tick, "kind": status,
                            "request": req.name, "error": error})
        return res

    def _shed_queue(self) -> int:
        """Drop queued requests whose queue wait or deadline has already
        passed — load shedding with a structured ``timed_out`` result."""
        now = time.perf_counter()
        keep, shed = [], 0
        for req in self.queue:
            waited = now - req.submitted_s
            if req.max_queue_s is not None and waited > req.max_queue_s:
                self._emit_shed(req, STATUS_TIMED_OUT,
                                f"queued {waited:.3f}s > "
                                f"max_queue_s={req.max_queue_s}")
                shed += 1
            elif req.deadline_s and waited > req.deadline_s:
                self._emit_shed(req, STATUS_TIMED_OUT,
                                f"deadline {req.deadline_s}s passed "
                                "while queued")
                shed += 1
            else:
                keep.append(req)
        self.queue = keep
        return shed

    def _install(self, slot: _Slot, req: PartitionRequest,
                 seed_bump: int = 0) -> None:
        """(Re)build a slot's pipeline state from scratch: hierarchy +
        initial population at the coarsest level.  Deterministic in
        (req, seed_bump) — a scratch reinstall with bump 0 reproduces
        the original trajectory exactly.  Incremental requests build a
        partition-aware hierarchy around the incumbent and seed the
        UNREFINED incumbent population (the ladder's first tick refines
        the coarsest level, exactly like ``incremental_partition``)."""
        cfg = self._cfg_for(req, seed_bump=seed_bump)
        if req.incumbent is not None:
            icfg = self._icfg_for(req, seed_bump=seed_bump)
            inc0 = np.asarray(req.incumbent, np.int32)
            hier = build_hierarchy(
                req.hg, icfg.k, seed=icfg.seed, restrict_part=inc0,
                contraction_limit_factor=icfg.contraction_limit_factor,
                model_shard=icfg.model_shard, device=self.device)
            budget_w = (np.inf if icfg.migration_frac is None else
                        float(icfg.migration_frac)
                        * float(np.sum(req.hg.vertex_weights)))
            incs, buds = incremental_mod.project_incumbent(
                hier, inc0, icfg.k, budget_w)
            parts = incremental_mod.seed_incumbent_population(
                hier, incs[-1], buds[-1], icfg)
            slot.incs, slot.buds = incs, buds
            slot.best_cut = None  # baseline set by the first dispatch
        else:
            hier = build_hierarchy(
                req.hg, cfg.k, seed=cfg.seed,
                contraction_limit_factor=cfg.contraction_limit_factor,
                model_shard=cfg.model_shard, device=self.device)
            num = hier.num_levels
            parts, init_cuts = initial_partition_population(
                hier.level_host(num - 1), cfg.k, cfg.eps,
                seeds=[cfg.seed * 101 + i for i in range(cfg.alpha)],
                tries_per_strategy=1, hga=hier.level_arrays(num - 1))
            slot.incs, slot.buds = None, None
            slot.best_cut = float(np.min(np.asarray(init_cuts)))
        slot.request, slot.cfg, slot.hier = req, cfg, hier
        slot.parts, slot.li = parts, hier.num_levels - 1
        slot.need_project = False
        slot.scheduler = (OperatorScheduler(seed=cfg.seed,
                                            policy=self.sched_policy)
                          if self.sched == "bandit" else None)

    def _admit(self) -> None:
        for slot in self.slots:
            if not self.queue:
                break
            if slot.occupied:
                continue
            self._install(slot, self.queue.pop(0))

    # -- robustness machinery ----------------------------------------------
    def _ckpt_manager(self) -> CheckpointManager:
        if self._ckpt is None:
            if self._ckpt_dir is None:
                self._ckpt_dir = tempfile.mkdtemp(prefix="repro-serve-ckpt-")
            self._ckpt = CheckpointManager(self._ckpt_dir, keep=2)
        return self._ckpt

    def _snapshot_slots(self) -> None:
        """Snapshot every occupied slot's in-flight state (population,
        level index, projection flag) through the checkpoint manager —
        the state a device loss resumes from.  One host read of each
        slot's population."""
        state, meta = {}, {}
        for i, s in enumerate(self.slots):
            if not s.occupied:
                continue
            state[f"slot{i}.parts"] = _host(s.parts)
            meta[str(i)] = {"name": s.request.name, "li": s.li,
                            "need_project": bool(s.need_project),
                            "seed": s.cfg.seed, "retries": s.retries,
                            # mid-flight bandit state rides the same
                            # checkpoint (DESIGN.md §16)
                            "sched": (None if s.scheduler is None
                                      else s.scheduler.state_dict()),
                            "best_cut": s.best_cut}
        if state:
            self._ckpt_manager().save(self.tick, state,
                                      extra={"slots": meta,
                                             "tick": self.tick})

    def _latest_snapshot(self):
        if self._ckpt is None or self._ckpt.latest_step() is None:
            return None, None
        return self._ckpt.restore_items()

    def _restore_slot(self, s: _Slot, items, extra) -> bool:
        """Resume a slot from the latest snapshot (matched by request
        name).  The hierarchy is rebuilt — it is a pure function of
        (hg, k, seed), so the resumed trajectory is bit-identical to the
        uninterrupted one."""
        if items is None:
            return False
        for idx, m in extra.get("slots", {}).items():
            if m["name"] != s.request.name:
                continue
            key = f"slot{idx}.parts"
            if key not in items:
                return False
            if s.request.incumbent is not None:
                inc0 = np.asarray(s.request.incumbent, np.int32)
                s.hier = build_hierarchy(
                    s.request.hg, s.cfg.k, seed=m["seed"],
                    restrict_part=inc0,
                    contraction_limit_factor=s.cfg
                    .contraction_limit_factor,
                    model_shard=s.cfg.model_shard, device=self.device)
                budget_w = (np.inf if s.request.migration_frac is None
                            else float(s.request.migration_frac)
                            * float(np.sum(s.request.hg.vertex_weights)))
                s.incs, s.buds = incremental_mod.project_incumbent(
                    s.hier, inc0, s.cfg.k, budget_w)
            else:
                s.hier = build_hierarchy(
                    s.request.hg, s.cfg.k, seed=m["seed"],
                    contraction_limit_factor=s.cfg
                    .contraction_limit_factor,
                    model_shard=s.cfg.model_shard, device=self.device)
            s.parts = np.asarray(items[key], np.int32)
            s.li = int(m["li"])
            s.need_project = bool(m["need_project"])
            if m.get("sched") is not None:
                s.scheduler = OperatorScheduler.from_state(m["sched"])
                s.best_cut = m.get("best_cut")
            s.recovered = True
            return True
        return False

    def _handle_device_loss(self, ev: faults_mod.FaultEvent) -> None:
        """The elasticity path: shrink the device pool to the survivors,
        treat every device tensor held for the requests in flight or
        queued as lost, move the service onto the first survivor if its
        own device is not among them, and resume every occupied slot from
        its snapshot (requests without one restart from scratch with
        their original seed — equally deterministic, so unfaulted answers
        stay bit-identical to solo).  The event records the lost device's
        allocated bytes before and after the drop (None off the card) and
        splits ``recovery_s`` into ``drop_s`` (the drop, synchronize and
        the allocator's release of its cached blocks, which depends on
        what the process cached before) and ``rebuild_s`` (the service's
        own resume or reinstall)."""
        t_start = time.perf_counter()
        survivors = (ev.survivors if ev.survivors is not None
                     else max(1, len(popshard.local_devices(self.device))
                              - 1))
        pool = simulate_device_loss(survivors, self.device)
        lost = self.device
        mem_before = self._allocated(lost)
        self._drop_device_state()
        mem_after = self._allocated(lost)
        if self.device not in pool:
            self.device = pool[0]
        t_drop = time.perf_counter()
        items, extra = self._latest_snapshot()
        resumed = restarted = 0
        for s in self.slots:
            if not s.occupied:
                continue
            if self._restore_slot(s, items, extra):
                resumed += 1
            else:
                self._install(s, s.request)
                s.recovered = True
                restarted += 1
        t_end = time.perf_counter()
        self.events.append({
            "tick": self.tick, "kind": "device_loss",
            "survivors": len(pool), "resumed_from_ckpt": resumed,
            "restarted_from_scratch": restarted,
            "recovery_s": t_end - t_start, "drop_s": t_drop - t_start,
            "rebuild_s": t_end - t_drop,
            "allocated_before": mem_before, "allocated_after": mem_after})

    @staticmethod
    def _allocated(device: torch.device) -> Optional[int]:
        if device.type != "cuda":
            return None
        return int(torch.cuda.memory_allocated(device))

    def _drop_device_state(self) -> None:
        """Drop what a lost device held for the requests in flight or
        queued: each occupied slot's hierarchy and population, and each
        such request's cached arrays (``Hypergraph.arrays``); then let the
        caching allocator return the freed blocks."""
        for s in self.slots:
            if not s.occupied:
                continue
            s.hier, s.parts = None, None
            s.request.hg._arrays_cache.clear()
        for req in self.queue:
            req.hg._arrays_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _validate(self, s: _Slot, parts: np.ndarray,
                  cuts: np.ndarray) -> Optional[str]:
        """Cheap post-dispatch invariants: block ids in range, finite
        non-negative cuts, balance under the level's cap.  A violation
        quarantines only this slot — co-bucketed slots are independent
        lanes and never see the poison."""
        k = s.cfg.k
        n_li = s.hier.level_n(s.li)
        cuts = np.asarray(cuts, np.float64)
        if not np.isfinite(cuts).all() or (cuts < -1e-9).any():
            return f"non-finite or negative cut: {cuts.tolist()}"
        sl = _host(parts)[:, :n_li]
        lo, hi = int(sl.min()), int(sl.max())
        if lo < 0 or hi >= k:
            return f"block id out of range [0, {k}): saw [{lo}, {hi}]"
        hga = s.hier.level_arrays(s.li)
        vw = _host(hga.vertex_weights)[:n_li]
        cap = float(refine_mod._cap_for(hga, k, s.cfg.eps))
        for a in range(sl.shape[0]):
            load = float(np.bincount(sl[a], weights=vw,
                                     minlength=k).max())
            if load > cap * (1 + 1e-5) + 1e-6:
                return (f"balance cap exceeded: member {a} max load "
                        f"{load} > cap {cap}")
        return None

    def _quarantine(self, s: _Slot, msg: str) -> bool:
        """Structured quarantine: one retry (snapshot-resume, else a
        seed-bumped scratch restart) with a one-tick backoff; a second
        failure frees the slot with a terminal ``quarantined`` result.
        Returns True when the slot finished (terminally)."""
        s.retries += 1
        self.events.append({"tick": self.tick, "kind": "quarantine",
                            "request": s.request.name, "error": msg,
                            "retry": s.retries})
        if s.retries > self.max_retries:
            req = s.request
            self.results[req.name] = PartitionResult(
                name=req.name, part=None, cut=None, k=req.k,
                submitted_s=req.submitted_s,
                finished_s=time.perf_counter(),
                status=STATUS_QUARANTINED, error=msg)
            s.vacate()
            return True
        items, extra = self._latest_snapshot()
        if self._restore_slot(s, items, extra):
            pass  # snapshot predates the poison; replay is deterministic
        else:
            # no snapshot: scratch restart with a bumped seed, dodging a
            # deterministically-poisoned trajectory
            retries, req = s.retries, s.request
            self._install(s, req, seed_bump=9973 * retries)
            s.retries, s.recovered = retries, True
        s.hold_ticks = 1  # backoff: sit out the next dispatch
        return False

    def _finish(self, s: _Slot, parts: np.ndarray, cuts: np.ndarray,
                degraded: bool = False) -> None:
        req = s.request
        parts = _host(parts)
        if degraded:
            status = STATUS_DEGRADED
        elif s.recovered:
            status = STATUS_RECOVERED
        else:
            status = STATUS_OK
        migration = None
        if s.incs is not None:
            # budget-aware selection with incumbent fallback — the same
            # ``select_best`` the standalone solve runs, so service and
            # solo answers stay bit-identical
            inc0 = np.asarray(req.incumbent, np.int32)
            hga0 = s.hier.level_arrays(0)
            inc_cut = float(metrics_mod.cutsize(
                hga0, refine_mod.pad_part(inc0, hga0.n_pad, self.device),
                req.k))
            part, cut, migration = incremental_mod.select_best(
                parts[:, : req.hg.n], np.asarray(cuts), inc0, inc_cut,
                np.asarray(req.hg.vertex_weights, np.float64),
                s.buds[0])
        else:
            best = int(np.argmin(cuts))
            part = np.asarray(parts[best][: req.hg.n], np.int32)
            cut = float(cuts[best])
        self.results[req.name] = PartitionResult(
            name=req.name, part=np.asarray(part, np.int32),
            cut=float(cut), k=req.k,
            submitted_s=req.submitted_s,
            finished_s=time.perf_counter(),
            status=status, degraded=degraded,
            migration_weight=migration)
        s.vacate()

    def _fast_forward(self, s: _Slot) -> None:
        """Degraded-mode finish: project the population straight to the
        finest level, one cheap LP sweep, best-so-far out — the same
        fast-forward ``impart_partition`` runs on budget exhaustion."""
        if s.need_project:
            s.parts = s.hier.project_pop(s.parts, s.li + 1)
            s.need_project = False
        while s.li > 0:
            s.parts = s.hier.project_pop(s.parts, s.li)
            s.li -= 1
        hga0 = s.hier.level_arrays(0)
        parts, cuts = refine_mod.lp_refine_population(
            hga0, s.parts, s.cfg.k, s.cfg.eps, max_iters=4,
            shard=self.shard, model_shard=self.model_shard,
            incumbent=None if s.incs is None else s.incs[0],
            mig_budget=None if s.buds is None else s.buds[0])
        self.events.append({"tick": self.tick, "kind": "degraded",
                            "request": s.request.name})
        self._finish(s, parts, cuts, degraded=True)

    def _avg_tick_s(self) -> Optional[float]:
        if not self._tick_walls:
            return None
        return float(np.mean(self._tick_walls))

    def _degrade_pass(self) -> int:
        """Finish near-deadline slots in degraded mode NOW: when the
        remaining budget cannot cover the remaining ladder at the
        trailing tick pace (or is already spent), fast-forward instead
        of missing the deadline outright."""
        finished = 0
        for s in self.slots:
            if not s.occupied or not s.request.deadline_s:
                continue
            rem = budget_mod.deadline_remaining_s(s.request.submitted_s,
                                                  s.request.deadline_s)
            est = self._avg_tick_s()
            ticks_left = s.li + 1
            if rem <= 0 or (est is not None and rem < est * ticks_left):
                self._fast_forward(s)
                finished += 1
        return finished

    def step(self) -> int:
        """One tick: inject scheduled faults, shed late queue entries,
        admit queued requests into free slots (subject to the coalesce
        window), degrade near-deadline slots, refine every dispatchable
        slot's current level in bucketed group dispatches, validate and
        quarantine, advance/finish slots, snapshot.  Returns the number
        of requests that reached a terminal state this tick."""
        self.tick += 1
        t_tick = time.perf_counter()
        events = (self.fault_plan.events_for(self.tick)
                  if self.fault_plan else [])
        for ev in events:
            if ev.kind == "device_loss":
                self._handle_device_loss(ev)
        finished = self._shed_queue()
        busy = any(s.occupied for s in self.slots)
        if not busy and self.queue and self.coalesce_s > 0:
            waited = time.perf_counter() - self.queue[0].submitted_s
            if waited < self.coalesce_s:
                return finished  # hold: let near arrivals coalesce
        self._admit()
        finished += self._degrade_pass()
        dispatch = []
        for s in self.slots:
            if not s.occupied:
                continue
            if s.hold_ticks > 0:
                s.hold_ticks -= 1  # quarantine backoff: sit this one out
                continue
            dispatch.append(s)
        if not dispatch:
            return finished
        entries = []
        for s in dispatch:
            if s.need_project:
                s.parts = s.hier.project_pop(s.parts, s.li + 1)
                s.need_project = False
            if s.incs is not None:
                entries.append((s.hier.level_arrays(s.li), s.parts,
                                s.cfg.k, s.cfg.eps, s.incs[s.li],
                                s.buds[s.li]))
            else:
                entries.append((s.hier.level_arrays(s.li), s.parts,
                                s.cfg.k, s.cfg.eps))
        for ev in events:
            if ev.kind == "straggler":
                time.sleep(ev.delay_s)
                self.events.append({"tick": self.tick,
                                    "kind": "straggler_injected",
                                    "delay_s": ev.delay_s})
        try:
            for ev in events:
                if ev.kind == "crash":
                    raise faults_mod.InjectedCrash(
                        f"injected mid-tick crash at tick {self.tick}")
            outs, pulls = self._dispatch_entries(dispatch, entries)
        except faults_mod.InjectedCrash as e:
            # slot state is consistent (projection is deterministic and
            # already recorded); the next tick simply retries the dispatch
            self.events.append({"tick": self.tick, "kind": "crash",
                                "error": str(e)})
            self._observe_tick(t_tick)
            return finished
        for ev in events:
            if ev.kind == "corrupt" and dispatch:
                target = ev.slot % len(dispatch)
                s = dispatch[target]
                rp, rc = outs[target]
                outs[target] = faults_mod.corrupt_state(_host(rp), rc,
                                                        s.cfg.k,
                                                        mode=ev.mode)
                self.events.append({"tick": self.tick,
                                    "kind": "corrupt_injected",
                                    "request": s.request.name,
                                    "mode": ev.mode})
        for s, (rp, rc), pull in zip(dispatch, outs, pulls):
            msg = self._validate(s, rp, rc)
            if msg is not None:
                # a quarantined pull is never observed: poisoned cuts
                # must not train the bandit
                if self._quarantine(s, msg):
                    finished += 1
                continue
            if pull is not None:
                arm, wall = pull
                new_best = float(np.min(rc))
                before = (s.best_cut if s.best_cut is not None
                          else new_best)
                s.scheduler.observe(s.li, 0, arm, before - new_best,
                                    wall)
                s.best_cut = new_best
            s.parts = rp
            if s.li == 0:
                self._finish(s, rp, rc)
                finished += 1
            else:
                s.li -= 1
                s.need_project = True
        if self.ckpt_every and self.tick % self.ckpt_every == 0:
            self._snapshot_slots()
        self._observe_tick(t_tick)
        return finished

    def _dispatch_entries(self, dispatch: List[_Slot], entries: List
                          ) -> Tuple[List, List]:
        """Run the tick's grouped refinement.  Static mode: one dispatch
        with the configured ``fm_node_limit`` — byte-for-byte the
        pre-scheduler service.  Bandit mode (DESIGN.md §16): each slot's
        scheduler picks its refinement tier, and the tick runs (up to)
        two group dispatches — ``lp`` with ``fm_node_limit=0`` (exactly
        the LP-only lanes) and ``lp_fm`` with the configured limit.
        Returns ``(outs, pulls)`` in dispatch order; ``pulls[i]`` is
        ``(arm, group_wall_s)`` for reward observation after validation
        (None per slot in static mode)."""
        if self.sched != "bandit":
            outs = instances_mod.refine_grouped(
                entries, grid=self.grid,
                fm_node_limit=self.fm_node_limit,
                max_iters=self.lp_iters, shard=self.shard,
                model_shard=self.model_shard, device=self.device)
            return outs, [None] * len(dispatch)
        arms = [s.scheduler.choose(s.li, 0, REFINE_ARMS)
                for s in dispatch]
        outs: List = [None] * len(dispatch)
        pulls: List = [None] * len(dispatch)
        for arm in REFINE_ARMS:
            idxs = [i for i, a in enumerate(arms) if a == arm]
            if not idxs:
                continue
            tA = time.perf_counter()
            sub = instances_mod.refine_grouped(
                [entries[i] for i in idxs], grid=self.grid,
                fm_node_limit=0 if arm == "lp" else self.fm_node_limit,
                max_iters=self.lp_iters, shard=self.shard,
                model_shard=self.model_shard, device=self.device)
            wall = time.perf_counter() - tA
            for j, i in enumerate(idxs):
                outs[i] = sub[j]
                pulls[i] = (arm, wall)
        return outs, pulls

    def _observe_tick(self, t_tick: float) -> None:
        dt = time.perf_counter() - t_tick
        self._tick_walls.append(dt)
        rep = self.watchdog.observe(self.tick, dt)
        if rep is not None:
            self.events.append({"tick": self.tick, "kind": "straggler",
                                "step_time": rep.step_time,
                                "deadline": rep.deadline})

    @property
    def straggler_reports(self):
        return self.watchdog.reports

    def outcome_counts(self) -> Dict[str, int]:
        """Terminal-state histogram over all results so far (a soak's
        outcome row)."""
        counts: Dict[str, int] = {}
        for res in self.results.values():
            counts[res.status] = counts.get(res.status, 0) + 1
        return counts

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.occupied for s in self.slots)

    def drain(self) -> List[PartitionResult]:
        """Run ticks until queue and slots are empty; returns (and keeps)
        all results accumulated so far, in completion order."""
        while self.busy:
            if self.step() == 0 and not any(s.occupied
                                            for s in self.slots):
                # coalesce hold with an empty engine: sleep the window out
                time.sleep(min(self.coalesce_s or 1e-4, 0.05))
        return list(self.results.values())
