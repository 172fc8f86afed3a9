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
and replayable from the logged trace.

One driver runs both: ``impart_partition_instances`` (DESIGN.md §12)
takes a batch of independent requests and groups their refinement
through ``instances.refine_grouped``; ``impart_partition`` is its batch
of one, whose one-entry stacks go straight to
``refine.refine_population``.  The multi-device paths keep their config
fields and raise ``NotImplementedError`` naming the slice that brings
them.
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
from . import instances as instances_mod
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
    """Refuse every option this slice of the port does not run: the
    model axis (``pop_shard`` routes through ``core.popshard``)."""
    model = (cfg.model_shard
             or os.environ.get("REPRO_MODEL_SHARD", "").strip().lower())
    if model == "mesh":
        _later_slice(f"model_shard={model!r}", "the model axis, item 13c")


def impart_partition(hg: Hypergraph, cfg: ImpartConfig,
                     device: str | torch.device = "cuda") -> ImpartResult:
    """Partition ``hg`` into ``cfg.k`` blocks on ``device``, with the
    static schedule or, when ``resolve_sched(cfg.sched)`` says so, the
    bandit's: a batch of one request through
    ``impart_partition_instances``, whose one-entry stacks refine through
    ``refine.refine_population``."""
    return impart_partition_instances([hg], [cfg], device=device)[0]


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


def _instances_setup(hgs: List[Hypergraph], cfgs: List[ImpartConfig],
                     dev: torch.device, bandit: bool) -> List[dict]:
    """Each request's hierarchy, initial population and thresholds (plus
    its own scheduler under the bandit)."""
    st = []
    for hg, cfg in zip(hgs, cfgs):
        hier = build_hierarchy(
            hg, cfg.k, seed=cfg.seed,
            contraction_limit_factor=cfg.contraction_limit_factor,
            device=dev)
        num = hier.num_levels
        parts, cuts = initial_partition_population(
            hier.level_host(num - 1), cfg.k, cfg.eps,
            seeds=[cfg.seed * 101 + i for i in range(cfg.alpha)],
            tries_per_strategy=1, hga=hier.level_arrays(num - 1))
        n_c = hier.level_n(num - 1)
        s = dict(hier=hier, parts=parts, cuts=cuts, next_thr=0,
                 thresholds=recombination_thresholds(hg.n, n_c, cfg.beta),
                 trace=[(n_c, list(cuts), "init")], steps=0,
                 degraded=False, gain_paths=[])
        if bandit:
            s["sch"] = OperatorScheduler(seed=cfg.seed,
                                         policy=cfg.sched_policy,
                                         replay=cfg.sched_replay)
        st.append(s)
    return st


def _level_entry(s: dict, li: int, cfg: ImpartConfig) -> tuple:
    """A request's level ``li`` as a ``refine_grouped`` entry, with the
    level's gain-assembly path logged in its result."""
    from repro_torch.kernels import ops
    hga = s["hier"].level_arrays(li)
    s["gain_paths"].append(ops.gain_path(hga.m_pad, cfg.k, hga.incident))
    return (hga, s["parts"], cfg.k, cfg.eps)


def _instances_results(hgs, cfgs, st, t0: float, dev: torch.device
                       ) -> List[ImpartResult]:
    """Each request's best member through its final V-cycles (the
    scheduler's replay decides their count)."""
    results = []
    for hg, cfg, s in zip(hgs, cfgs, st):
        sch = s.get("sch")
        parts = torch.as_tensor(s["parts"]).cpu().numpy()
        cuts = s["cuts"]
        best = int(np.argmin(cuts))
        part, cut = parts[best][: hg.n], float(cuts[best])
        if not s["degraded"]:
            replaying = sch is not None and sch.replaying
            n_want = (sch.replay_final_vcycles() if replaying
                      else cfg.final_vcycles)
            n_vc = 0
            for v in range(n_want):
                if not replaying and exhausted(t0, cfg.time_budget_s):
                    break
                part, cut = vcycle(hg, part, cfg.k, cfg.eps,
                                   seed=cfg.seed * 997 + v,
                                   shard=cfg.pop_shard,
                                   model_shard=cfg.model_shard,
                                   scheduler=sch, device=dev)
                s["trace"].append((hg.n, [cut], f"final-vcycle@{v}"))
                n_vc += 1
            if sch is not None:
                sch.trace.final_vcycles = n_vc
        results.append(ImpartResult(
            part=np.asarray(part, np.int32), cut=float(cut),
            population_cuts=[float(c) for c in cuts], trace=s["trace"],
            wall_s=time.perf_counter() - t0, levels=s["hier"].sizes(),
            degraded=s["degraded"], gain_paths=s["gain_paths"],
            sched_trace=None if sch is None else sch.trace))
    return results


def impart_partition_instances(hgs: List[Hypergraph],
                               cfgs: List[ImpartConfig],
                               grid: Optional[List[int]] = None,
                               device: str | torch.device = "cuda"
                               ) -> List[ImpartResult]:
    """``impart_partition`` for a batch of independent requests on
    ``device`` (DESIGN.md §12): every request keeps its own hierarchy,
    population, recombination thresholds and mutation events (with the
    seeds of a run alone), but the refinement runs grouped: the requests walk
    their uncoarsening ladders in lockstep, and at each step the current
    levels that share a shape bucket refine as one stack through
    ``instances.refine_grouped``.

    Each request's result is bit-equal to ``impart_partition(hg, cfg)``,
    its batch of one.  ``alpha``, ``lp_iters`` and ``fm_node_limit`` must agree
    across configs (they shape the shared dispatch), and the schedule
    mode too (``_impart_instances_bandit`` runs the bandit's).

    Budgets (DESIGN.md §13): ``level_budget`` counts the request's own
    level refinements, so a capped request is still bit-equal to its
    run alone.  ``time_budget_s`` is accepted: a spent budget
    fast-forwards that request to a degraded result by the same
    mechanism, but *when* the clock trips depends on the work batched
    beside it."""
    if len(hgs) != len(cfgs):
        raise ValueError("one config per hypergraph required")
    if len({(c.alpha, c.lp_iters, c.fm_node_limit) for c in cfgs}) > 1:
        raise ValueError("instance batching requires equal alpha / "
                         "lp_iters / fm_node_limit across configs")
    for cfg in cfgs:
        _check_slice(cfg)
    dev = resolve_device(device)
    modes = {resolve_sched(c.sched) for c in cfgs}
    if "bandit" in modes:
        if modes != {"bandit"}:
            raise ValueError("instance batching requires a uniform sched "
                             "mode across configs (got mixed "
                             "bandit/static)")
        return _impart_instances_bandit(hgs, cfgs, grid, dev)
    t0 = time.perf_counter()
    st = _instances_setup(hgs, cfgs, dev, bandit=False)
    fm_limit, lp_iters = cfgs[0].fm_node_limit, cfgs[0].lp_iters

    for t in range(max(s["hier"].num_levels for s in st)):
        step_idx, entries = [], []
        for i, s in enumerate(st):
            hier = s["hier"]
            if s["degraded"] or t >= hier.num_levels:
                continue
            li = hier.num_levels - 1 - t
            if li < hier.num_levels - 1:
                s["parts"] = hier.project_pop(s["parts"], li + 1)
            entries.append(_level_entry(s, li, cfgs[i]))
            step_idx.append(i)
        if not entries:
            break
        outs = instances_mod.refine_grouped(
            entries, grid=grid, fm_node_limit=fm_limit, max_iters=lp_iters,
            shard=cfgs[0].pop_shard, model_shard=cfgs[0].model_shard,
            device=dev)
        for (rp, rc), i in zip(outs, step_idx):
            s, cfg, hier = st[i], cfgs[i], st[i]["hier"]
            li = hier.num_levels - 1 - t
            n_li = hier.level_n(li)
            s["parts"], s["cuts"] = rp, rc
            s["trace"].append((n_li, list(rc), "refine"))
            # the memetic events stay per request, with its own seeds
            while (s["next_thr"] < cfg.beta
                   and n_li >= s["thresholds"][s["next_thr"]] - 1e-9
                   and cfg.recombination_enabled):
                lv_host = hier.level_host(li)
                s["parts"], s["cuts"] = ring_recombination(
                    lv_host,
                    torch.as_tensor(s["parts"]).cpu().numpy()[:, : n_li],
                    s["cuts"], cfg.k, cfg.eps,
                    seed=cfg.seed * 31 + s["next_thr"],
                    shard=cfg.pop_shard, model_shard=cfg.model_shard,
                    device=dev)
                s["trace"].append(
                    (n_li, list(s["cuts"]), f"recombine@{s['next_thr']}"))
                if cfg.mutation_enabled:
                    s["parts"], s["cuts"] = mutate_population(
                        lv_host, s["parts"], s["cuts"], cfg.k, cfg.eps,
                        threshold=cfg.similarity_threshold,
                        mu=cfg.mutation_mu,
                        seed=cfg.seed * 17 + s["next_thr"],
                        path=cfg.mutation_path, shard=cfg.pop_shard,
                        model_shard=cfg.model_shard, device=dev)
                    s["trace"].append(
                        (n_li, list(s["cuts"]), f"mutate@{s['next_thr']}"))
                s["next_thr"] += 1
            s["steps"] += 1
            if (exhausted(t0, cfg.time_budget_s)
                    or (li > 0 and level_exhausted(s["steps"],
                                                   cfg.level_budget))):
                # the fast-forward: the request leaves the walk and
                # finishes degraded
                s["parts"], s["cuts"] = _fast_forward(hier, s["parts"], li,
                                                      cfg)
                s["trace"].append(
                    (hgs[i].n, list(s["cuts"]), "budget-exhausted"))
                s["degraded"] = True
    return _instances_results(hgs, cfgs, st, t0, dev)


def _impart_instances_bandit(hgs: List[Hypergraph],
                             cfgs: List[ImpartConfig],
                             grid: Optional[List[int]],
                             dev: torch.device) -> List[ImpartResult]:
    """The bandit-scheduled ladder (DESIGN.md §16): the static driver's
    hierarchies, initial populations, budgets and fast-forward, with the
    dispatch at each (level, phase) slot of each request chosen by its
    own scheduler:

    * phase 0 of every level is a mandatory refinement from {lp, lp_fm};
      a lockstep step's grouped refinement is split by the arm each
      request chose, the ``lp`` group dispatched with
      ``fm_node_limit=0`` (``lp_refine_population`` per row), the
      ``lp_fm`` group with the configured limit;
    * each beta-threshold crossing grants two optional slots from the
      full menu (the static schedule's recombine + mutate budget), run
      per request;
    * at the finest level, a wall-clock budget keeps granting optional
      slots until it is spent.

    Replay (``cfg.sched_replay``): the trace decides the arms, how many
    optional slots ran, where a budget fast-forwarded (the trace ends at
    that ladder position) and how many final V-cycles ran; the clock is
    never consulted, so the replayed run is bit-identical to the live
    one.

    The dispatch wall is shared by its group and is every member's
    reward wall, so a live grouped bandit may pull other arms than the
    same request alone: a grouped bandit run is reproduced from its
    per-request traces, not from a live run of one."""
    t0 = time.perf_counter()
    st = _instances_setup(hgs, cfgs, dev, bandit=True)
    fm_limit, lp_iters = cfgs[0].fm_node_limit, cfgs[0].lp_iters

    for t in range(max(s["hier"].num_levels for s in st)):
        groups = {"lp": [], "lp_fm": []}
        for i, s in enumerate(st):
            hier, cfg, sch = s["hier"], cfgs[i], s["sch"]
            if s["degraded"] or t >= hier.num_levels:
                continue
            li = hier.num_levels - 1 - t
            if sch.replaying and not sch.replay_has_level(li):
                # the live run fast-forwarded at this boundary
                s["parts"], s["cuts"] = _fast_forward(hier, s["parts"],
                                                      li + 1, cfg)
                s["trace"].append(
                    (hgs[i].n, list(s["cuts"]), "budget-exhausted"))
                s["degraded"] = True
                continue
            if li < hier.num_levels - 1:
                s["parts"] = hier.project_pop(s["parts"], li + 1)
            s["before"] = float(np.min(np.asarray(s["cuts"])))
            groups[sch.choose(li, 0, REFINE_ARMS)].append(i)
        if not groups["lp"] and not groups["lp_fm"]:
            break
        for arm in REFINE_ARMS:
            idxs = groups[arm]
            if not idxs:
                continue
            entries = []
            for i in idxs:
                entries.append(_level_entry(
                    st[i], st[i]["hier"].num_levels - 1 - t, cfgs[i]))
            t_arm = time.perf_counter()
            outs = instances_mod.refine_grouped(
                entries, grid=grid,
                fm_node_limit=0 if arm == "lp" else fm_limit,
                max_iters=lp_iters, shard=cfgs[0].pop_shard,
                model_shard=cfgs[0].model_shard, device=dev)
            # the cuts are host values read back from the card, so the
            # group's wall ends in a host sync
            wall = time.perf_counter() - t_arm
            for (rp, rc), i in zip(outs, idxs):
                s, hier = st[i], st[i]["hier"]
                li = hier.num_levels - 1 - t
                s["parts"], s["cuts"] = rp, rc
                s["sch"].observe(li, 0, arm,
                                 s["before"] - float(np.min(rc)), wall)
                s["trace"].append((hier.level_n(li), list(rc),
                                   f"sched:{arm}@0"))
        # optional slots and budgets: host work per request
        for i, s in enumerate(st):
            hier, cfg, sch = s["hier"], cfgs[i], s["sch"]
            if s["degraded"] or t >= hier.num_levels:
                continue
            li = hier.num_levels - 1 - t
            n_li = hier.level_n(li)
            menu = _sched_menu(cfg)
            phase = 1

            def pull():
                arm = sch.choose(li, phase, menu)
                s["parts"], s["cuts"] = _sched_pull(
                    sch, arm, li, phase, hier, s["parts"], s["cuts"], cfg,
                    dev)
                s["trace"].append(
                    (n_li, list(s["cuts"]), f"sched:{arm}@{phase}"))

            if sch.replaying:
                while sch.replay_pending(li, phase):
                    pull()
                    phase += 1
                continue
            while (s["next_thr"] < cfg.beta
                   and n_li >= s["thresholds"][s["next_thr"]] - 1e-9):
                for _ in range(2):
                    pull()
                    phase += 1
                s["next_thr"] += 1
            if li == 0 and cfg.time_budget_s is not None:
                while (not exhausted(t0, cfg.time_budget_s)
                       and phase < 1 + 2 * cfg.beta + _SCHED_MAX_EXTRA):
                    pull()
                    phase += 1
            s["steps"] += 1
            if li > 0 and (exhausted(t0, cfg.time_budget_s)
                           or level_exhausted(s["steps"],
                                              cfg.level_budget)):
                s["parts"], s["cuts"] = _fast_forward(hier, s["parts"], li,
                                                      cfg)
                s["trace"].append(
                    (hgs[i].n, list(s["cuts"]), "budget-exhausted"))
                s["degraded"] = True
    return _instances_results(hgs, cfgs, st, t0, dev)
