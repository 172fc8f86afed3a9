"""IMPart driver on one device (port of
``repro.core.impart.impart_partition``; paper Fig. 3).

One coarsening hierarchy; alpha solutions uncoarsen together, every
member refined at every level (LP, plus FM on coarse levels).  At the
beta geometric thresholds (Sec. 3.1.1) a ring-recombination round runs,
followed by mutation; the best member then goes through
``final_vcycles`` V-cycles.  Recombination and mutation materialise the
level on the host once (``level_host``) for their overlay work.

``sched="bandit"`` (or ``REPRO_SCHED=bandit``) replaces the fixed
schedule by the operator scheduler (``core.scheduler``, DESIGN.md §16):
the same dispatches, chosen per (level, phase) by a contextual bandit,
and replayable from the logged trace.  The multi-device paths keep
their config fields and raise ``NotImplementedError`` naming the slice
that brings them.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.env import resolve_device
from .budget import exhausted, level_exhausted
from .hypergraph import Hypergraph
from .coarsen import recombination_thresholds
from .dcoarsen import build_hierarchy
from .initial_partition import initial_partition_population
from . import refine as refine_mod
from .mutate import MUTATE_PATHS, mutate_population
from .recombine import ring_recombination
from .refine import _later_slice
from .scheduler import (OperatorScheduler, POLICIES, REFINE_ARMS,
                        SCHED_PATHS, SchedulerTrace, resolve_sched)
from .vcycle import vcycle
POP_SHARD_PATHS = ("mesh", "chunk", "off")
MODEL_SHARD_PATHS = ("mesh", "off")


@dataclasses.dataclass
class ImpartConfig:
    k: int
    eps: float = 0.08
    alpha: int = 7               # population size (paper: 7)
    beta: int = 7                # recombination rounds (paper: 7)
    similarity_threshold: float = 20.0  # t (paper: 20)
    mutation_mu: float = 0.1     # reweight scale (paper: 0.1)
    seed: int = 0
    fm_node_limit: int = 4096
    contraction_limit_factor: int = 64
    final_vcycles: int = 1
    lp_iters: int = 16
    time_budget_s: Optional[float] = None  # equal-time comparisons
    # uncoarsening level-steps refined at full strength before the
    # driver fast-forwards (DESIGN.md §13)
    level_budget: Optional[int] = None
    mutation_enabled: bool = True
    recombination_enabled: bool = True
    mutation_path: Optional[str] = None
    pop_shard: Optional[str] = None
    model_shard: Optional[str] = None
    sched: Optional[str] = None
    sched_policy: str = "ucb1"
    # replay a logged decision trace instead of choosing live
    sched_replay: Optional[SchedulerTrace] = None

    def __post_init__(self):
        for field, allowed in (("mutation_path", MUTATE_PATHS),
                               ("pop_shard", POP_SHARD_PATHS + ("auto",)),
                               ("model_shard", MODEL_SHARD_PATHS + ("auto",)),
                               ("sched", SCHED_PATHS + ("auto",))):
            val = getattr(self, field)
            if val is None:
                continue
            val = val.strip().lower()
            if val not in allowed:
                raise ValueError(f"unknown {field} {val!r}; expected one "
                                 f"of {allowed} (or None)")
            setattr(self, field, val)
        if self.level_budget is not None and self.level_budget < 1:
            raise ValueError(
                f"level_budget must be >= 1 (got {self.level_budget}); "
                "a request needs at least the coarsest-level refinement")
        self.sched_policy = self.sched_policy.strip().lower()
        if self.sched_policy not in POLICIES:
            raise ValueError(
                f"unknown sched_policy {self.sched_policy!r}; expected "
                f"one of {POLICIES}")


@dataclasses.dataclass
class ImpartResult:
    part: np.ndarray
    cut: float
    population_cuts: List[float]
    # trajectory: (n_at_level, [cut per member], event)
    trace: List[tuple]
    wall_s: float
    levels: List[int]
    # True when a budget fired and the run fast-forwarded (DESIGN.md §13)
    degraded: bool = False
    # the bandit's decision trace (None for the static schedule); fed
    # back through ``ImpartConfig.sched_replay`` it reproduces the run
    sched_trace: Optional[SchedulerTrace] = None
    # gain-assembly path of every refined level, coarsest first
    # ("table"/"stream" = kernel, "segsum"/"compact" = no layout)
    gain_paths: List[str] = dataclasses.field(default_factory=list)


def _check_slice(cfg: ImpartConfig) -> None:
    """Refuse every option this slice of the port does not run."""
    pop = cfg.pop_shard or os.environ.get("REPRO_POP_SHARD", "").strip().lower()
    if pop in ("mesh", "chunk"):
        _later_slice(f"pop_shard={pop!r}", "multi-device paths")
    model = (cfg.model_shard
             or os.environ.get("REPRO_MODEL_SHARD", "").strip().lower())
    if model == "mesh":
        _later_slice(f"model_shard={model!r}", "multi-device paths")


def impart_partition(hg: Hypergraph, cfg: ImpartConfig,
                     device: str | torch.device = "cuda") -> ImpartResult:
    """Partition ``hg`` into ``cfg.k`` blocks on ``device``, with the
    static schedule or, when ``resolve_sched(cfg.sched)`` says so, the
    bandit's."""
    _check_slice(cfg)
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    if resolve_sched(cfg.sched) == "bandit":
        return _impart_partition_bandit(hg, cfg, dev)
    t0 = time.perf_counter()
    k, eps = cfg.k, cfg.eps
    hier = build_hierarchy(hg, k, seed=cfg.seed,
                           contraction_limit_factor=cfg.contraction_limit_factor,
                           device=dev)
    num_levels = hier.num_levels
    n_c = hier.level_n(num_levels - 1)
    thresholds = recombination_thresholds(hg.n, n_c, cfg.beta)

    # alpha diverse initial solutions (distinct seeds), the whole
    # portfolio x population stack refined in one batch
    parts, cuts = initial_partition_population(
        hier.level_host(num_levels - 1), k, eps,
        seeds=[cfg.seed * 101 + i for i in range(cfg.alpha)],
        tries_per_strategy=1, hga=hier.level_arrays(num_levels - 1))

    trace: List[tuple] = [(n_c, list(cuts), "init")]
    gain_paths: List[str] = []
    next_thr = 0
    steps_done = 0
    degraded = False

    for li in range(num_levels - 1, -1, -1):
        if li < num_levels - 1:
            parts = hier.project_pop(parts, li + 1)
        n_li = hier.level_n(li)
        hga = hier.level_arrays(li)
        gain_paths.append(ops.gain_path(hga.m_pad, k, hga.incident))
        parts, cuts = refine_mod.refine_population(
            hga, parts, k, eps, fm_node_limit=cfg.fm_node_limit,
            max_iters=cfg.lp_iters, device=hga.device)
        trace.append((n_li, list(cuts), "refine"))

        # the geometric-threshold recombination rounds (host overlay
        # work on the level, materialised once through level_host)
        while (next_thr < cfg.beta and n_li >= thresholds[next_thr] - 1e-9
               and cfg.recombination_enabled):
            lv_host = hier.level_host(li)
            parts, cuts = ring_recombination(
                lv_host, torch.as_tensor(parts).cpu().numpy()[:, : n_li],
                cuts, k, eps, seed=cfg.seed * 31 + next_thr,
                shard=cfg.pop_shard, model_shard=cfg.model_shard,
                device=dev)
            trace.append((n_li, list(cuts), f"recombine@{next_thr}"))
            if cfg.mutation_enabled:
                parts, cuts = mutate_population(
                    lv_host, parts, cuts, k, eps,
                    threshold=cfg.similarity_threshold,
                    mu=cfg.mutation_mu, seed=cfg.seed * 17 + next_thr,
                    path=cfg.mutation_path, shard=cfg.pop_shard,
                    model_shard=cfg.model_shard, device=dev)
                trace.append((n_li, list(cuts), f"mutate@{next_thr}"))
            next_thr += 1
        steps_done += 1
        if (exhausted(t0, cfg.time_budget_s)
                or (li > 0 and level_exhausted(steps_done,
                                               cfg.level_budget))):
            parts, cuts = _fast_forward(hier, parts, li, cfg)
            trace.append((hg.n, list(cuts), "budget-exhausted"))
            degraded = True
            break

    parts = torch.as_tensor(parts).cpu().numpy()
    best = int(np.argmin(cuts))
    part, cut = parts[best][: hg.n], float(cuts[best])
    if not degraded:
        for v in range(cfg.final_vcycles):
            if exhausted(t0, cfg.time_budget_s):
                break
            part, cut = vcycle(hg, part, k, eps, seed=cfg.seed * 997 + v,
                               shard=cfg.pop_shard,
                               model_shard=cfg.model_shard, device=dev)
            trace.append((hg.n, [cut], f"final-vcycle@{v}"))
    return ImpartResult(
        part=np.asarray(part, np.int32), cut=float(cut),
        population_cuts=[float(c) for c in cuts], trace=trace,
        wall_s=time.perf_counter() - t0, levels=hier.sizes(),
        degraded=degraded, gain_paths=gain_paths)


def _sched_menu(cfg: ImpartConfig) -> tuple:
    """The optional-slot arm menu under ``cfg``: the full operator menu
    minus the operators the config disables, and minus the population
    operators when there is no population to cross (alpha < 2)."""
    menu = list(REFINE_ARMS)
    if cfg.mutation_enabled and cfg.alpha > 1:
        menu.append("mutate")
    if cfg.recombination_enabled and cfg.alpha > 1:
        menu.append("recombine")
    return tuple(menu)


def _sched_pull(sch: OperatorScheduler, arm: str, li: int, phase: int,
                hier, parts, cuts, cfg: ImpartConfig, dev: torch.device):
    """Run one bandit arm, which is exactly one of the static schedule's
    dispatches (the decision index takes the role the threshold counter
    plays in the static seeds), then observe reward = best-cut
    improvement per second from the cuts the dispatch reports.

    Every arm returns its member cuts as host numpy values, read back
    from the card, so the wall clock below ends in a host sync and
    measures the device work, not only its launches."""
    k, eps = cfg.k, cfg.eps
    n_li = hier.level_n(li)
    best_before = float(np.min(np.asarray(cuts)))
    didx = len(sch.trace.decisions)
    tA = time.perf_counter()
    if arm in REFINE_ARMS:
        hga = hier.level_arrays(li)
        if arm == "lp":
            parts, cuts = refine_mod.lp_refine_population(
                hga, parts, k, eps, max_iters=cfg.lp_iters,
                shard=cfg.pop_shard, model_shard=cfg.model_shard)
        else:
            parts, cuts = refine_mod.refine_population(
                hga, parts, k, eps, fm_node_limit=cfg.fm_node_limit,
                max_iters=cfg.lp_iters, shard=cfg.pop_shard,
                model_shard=cfg.model_shard, device=hga.device)
    elif arm in ("recombine", "mutate"):
        # the population operators' overlay work runs on the host level
        lv_host = hier.level_host(li)
        host_parts = torch.as_tensor(parts).cpu().numpy()[:, : n_li]
        if arm == "recombine":
            parts, cuts = ring_recombination(
                lv_host, host_parts, cuts, k, eps, seed=cfg.seed * 31 + didx,
                shard=cfg.pop_shard, model_shard=cfg.model_shard, device=dev)
        else:
            parts, cuts = mutate_population(
                lv_host, host_parts, cuts, k, eps,
                threshold=cfg.similarity_threshold, mu=cfg.mutation_mu,
                seed=cfg.seed * 17 + didx, path=cfg.mutation_path,
                shard=cfg.pop_shard, model_shard=cfg.model_shard,
                device=dev)
    else:
        raise ValueError(f"unknown arm {arm!r}")
    improvement = best_before - float(np.min(np.asarray(cuts)))
    sch.observe(li, phase, arm, improvement, time.perf_counter() - tA)
    return parts, cuts


# extra optional slots the wall-budget loop may add at the finest level
# before the driver stops consulting the clock (a runaway backstop, far
# above any real budget)
_SCHED_MAX_EXTRA = 256


def _fast_forward(hier, parts, li: int, cfg: ImpartConfig):
    """Project the population from level ``li`` straight to the finest
    level and refine it once more (the degraded mode of a budget)."""
    for lj in range(li, 0, -1):
        parts = hier.project_pop(parts, lj)
    return refine_mod.lp_refine_population(
        hier.level_arrays(0), parts, cfg.k, cfg.eps, max_iters=4,
        shard=cfg.pop_shard, model_shard=cfg.model_shard)


def _impart_partition_bandit(hg: Hypergraph, cfg: ImpartConfig,
                             dev: torch.device) -> ImpartResult:
    """The bandit-scheduled ladder (DESIGN.md §16): the static driver's
    hierarchy, initial population, budgets and fast-forward, with the
    dispatch at each (level, phase) slot chosen by the scheduler:

    * phase 0 of every level is a mandatory refinement from {lp, lp_fm};
    * each beta-threshold crossing grants two optional slots from the
      full menu (the static schedule's recombine + mutate budget);
    * at the finest level, a wall-clock budget keeps granting optional
      slots until it is spent.

    Replay (``cfg.sched_replay``): the trace decides the arms, how many
    optional slots ran, where a budget fast-forwarded (the trace ends at
    that ladder position) and how many final V-cycles ran; the clock is
    never consulted, so the replayed run is bit-identical to the live
    one.
    """
    t0 = time.perf_counter()
    k, eps = cfg.k, cfg.eps
    hier = build_hierarchy(hg, k, seed=cfg.seed,
                           contraction_limit_factor=cfg.contraction_limit_factor,
                           device=dev)
    num_levels = hier.num_levels
    n_c = hier.level_n(num_levels - 1)
    thresholds = recombination_thresholds(hg.n, n_c, cfg.beta)
    parts, cuts = initial_partition_population(
        hier.level_host(num_levels - 1), k, eps,
        seeds=[cfg.seed * 101 + i for i in range(cfg.alpha)],
        tries_per_strategy=1, hga=hier.level_arrays(num_levels - 1))

    trace: List[tuple] = [(n_c, list(cuts), "init")]
    sch = OperatorScheduler(seed=cfg.seed, policy=cfg.sched_policy,
                            replay=cfg.sched_replay)
    menu = _sched_menu(cfg)
    next_thr = 0
    steps_done = 0
    degraded = False

    def pull(li, phase, arms):
        nonlocal parts, cuts
        arm = sch.choose(li, phase, arms)
        parts, cuts = _sched_pull(sch, arm, li, phase, hier, parts, cuts,
                                  cfg, dev)
        trace.append((hier.level_n(li), list(cuts), f"sched:{arm}@{phase}"))

    for li in range(num_levels - 1, -1, -1):
        if sch.replaying and not sch.replay_has_level(li):
            # the live run's budget tripped at this boundary: replay the
            # same fast-forward
            parts, cuts = _fast_forward(hier, parts, li + 1, cfg)
            trace.append((hg.n, list(cuts), "budget-exhausted"))
            degraded = True
            break
        if li < num_levels - 1:
            parts = hier.project_pop(parts, li + 1)
        n_li = hier.level_n(li)
        pull(li, 0, REFINE_ARMS)    # phase 0: the mandatory refinement
        phase = 1
        if sch.replaying:
            while sch.replay_pending(li, phase):
                pull(li, phase, menu)
                phase += 1
            continue
        # optional slots: two per beta-threshold crossing...
        while next_thr < cfg.beta and n_li >= thresholds[next_thr] - 1e-9:
            for _ in range(2):
                pull(li, phase, menu)
                phase += 1
            next_thr += 1
        # ...plus, at the finest level, whatever the wall-clock budget
        # still affords (the natural end of a scheduled run)
        if li == 0 and cfg.time_budget_s is not None:
            while (not exhausted(t0, cfg.time_budget_s)
                   and phase < 1 + 2 * cfg.beta + _SCHED_MAX_EXTRA):
                pull(li, phase, menu)
                phase += 1
        steps_done += 1
        if li > 0 and (exhausted(t0, cfg.time_budget_s)
                       or level_exhausted(steps_done, cfg.level_budget)):
            parts, cuts = _fast_forward(hier, parts, li, cfg)
            trace.append((hg.n, list(cuts), "budget-exhausted"))
            degraded = True
            break

    parts = torch.as_tensor(parts).cpu().numpy()
    best = int(np.argmin(cuts))
    part, cut = parts[best][: hg.n], float(cuts[best])
    if not degraded:
        n_vc = 0
        n_want = (sch.replay_final_vcycles() if sch.replaying
                  else cfg.final_vcycles)
        for v in range(n_want):
            if not sch.replaying and exhausted(t0, cfg.time_budget_s):
                break
            part, cut = vcycle(hg, part, k, eps, seed=cfg.seed * 997 + v,
                               shard=cfg.pop_shard,
                               model_shard=cfg.model_shard, scheduler=sch,
                               device=dev)
            trace.append((hg.n, [cut], f"final-vcycle@{v}"))
            n_vc += 1
        sch.trace.final_vcycles = n_vc
    return ImpartResult(
        part=np.asarray(part, np.int32), cut=float(cut),
        population_cuts=[float(c) for c in cuts], trace=trace,
        wall_s=time.perf_counter() - t0, levels=hier.sizes(),
        degraded=degraded, sched_trace=sch.trace)
