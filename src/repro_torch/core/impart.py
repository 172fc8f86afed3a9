"""IMPart driver, static schedule on one device (port of
``repro.core.impart.impart_partition``).

One coarsening hierarchy; alpha solutions uncoarsen together, every
member refined at every level (LP, plus FM on coarse levels); best
member wins.  This slice of the port runs the driver with the memetic
operators off: ``recombination_enabled=False``,
``mutation_enabled=False`` and ``final_vcycles=0``.  Those options, the
bandit schedule and the multi-device paths keep their config fields and
raise ``NotImplementedError`` naming the slice that brings them.
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
from .dcoarsen import build_hierarchy
from .initial_partition import initial_partition_population
from . import refine as refine_mod
from .refine import _later_slice

MUTATE_PATHS = ("batch", "loop")
POP_SHARD_PATHS = ("mesh", "chunk", "off")
MODEL_SHARD_PATHS = ("mesh", "off")
SCHED_PATHS = ("bandit", "static")
POLICIES = ("ucb1", "egreedy")


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
    sched_replay: Optional[object] = None

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
    sched_trace: Optional[object] = None
    # gain-assembly path of every refined level, coarsest first
    # ("table"/"stream" = kernel, "segsum"/"compact" = no layout)
    gain_paths: List[str] = dataclasses.field(default_factory=list)


def _check_slice(cfg: ImpartConfig) -> None:
    """Refuse every option this slice of the port does not run."""
    if cfg.recombination_enabled:
        _later_slice("recombination_enabled=True",
                     "recombination and the V-cycle")
    if cfg.mutation_enabled:
        _later_slice("mutation_enabled=True", "mutation")
    if cfg.final_vcycles > 0:
        _later_slice("final_vcycles > 0", "recombination and the V-cycle")
    sched = cfg.sched or os.environ.get("REPRO_SCHED", "").strip().lower()
    if sched == "bandit" or cfg.sched_replay is not None:
        _later_slice("the bandit operator schedule", "operator scheduler")
    pop = cfg.pop_shard or os.environ.get("REPRO_POP_SHARD", "").strip().lower()
    if pop in ("mesh", "chunk"):
        _later_slice(f"pop_shard={pop!r}", "multi-device paths")
    model = (cfg.model_shard
             or os.environ.get("REPRO_MODEL_SHARD", "").strip().lower())
    if model == "mesh":
        _later_slice(f"model_shard={model!r}", "multi-device paths")


def impart_partition(hg: Hypergraph, cfg: ImpartConfig,
                     device: str | torch.device = "cuda") -> ImpartResult:
    """Partition ``hg`` into ``cfg.k`` blocks on ``device`` (static
    schedule, memetic operators off)."""
    _check_slice(cfg)
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    t0 = time.perf_counter()
    k, eps = cfg.k, cfg.eps
    hier = build_hierarchy(hg, k, seed=cfg.seed,
                           contraction_limit_factor=cfg.contraction_limit_factor,
                           device=dev)
    num_levels = hier.num_levels
    n_c = hier.level_n(num_levels - 1)

    # alpha diverse initial solutions (distinct seeds), the whole
    # portfolio x population stack refined in one batch
    parts, cuts = initial_partition_population(
        hier.level_host(num_levels - 1), k, eps,
        seeds=[cfg.seed * 101 + i for i in range(cfg.alpha)],
        tries_per_strategy=1, hga=hier.level_arrays(num_levels - 1))

    trace: List[tuple] = [(n_c, list(cuts), "init")]
    gain_paths: List[str] = []
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
        steps_done += 1
        if (exhausted(t0, cfg.time_budget_s)
                or (li > 0 and level_exhausted(steps_done,
                                               cfg.level_budget))):
            # fast-forward: project straight to the finest level and
            # refine once more (degraded mode)
            for lj in range(li - 1, -1, -1):
                parts = hier.project_pop(parts, lj + 1)
            parts, cuts = refine_mod.lp_refine_population(
                hier.level_arrays(0), parts, k, eps, max_iters=4)
            trace.append((hg.n, list(cuts), "budget-exhausted"))
            degraded = True
            break

    parts = torch.as_tensor(parts).cpu().numpy()
    best = int(np.argmin(cuts))
    part, cut = parts[best][: hg.n], float(cuts[best])
    return ImpartResult(
        part=np.asarray(part, np.int32), cut=float(cut),
        population_cuts=[float(c) for c in cuts], trace=trace,
        wall_s=time.perf_counter() - t0, levels=hier.sizes(),
        degraded=degraded, gain_paths=gain_paths)
