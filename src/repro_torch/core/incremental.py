"""Incremental repartitioning: warm-start V-cycles with bounded
migration for drifting workloads (port of ``repro.core.incremental``;
DESIGN.md §14).

A refresh takes (previous assignment, reweighted or edited hypergraph,
migration budget) and returns a new assignment without rebuilding the
world:

* **Hierarchy reuse.**  ``IncrementalState`` caches the multilevel
  hierarchy keyed on a structure token (crc32 over pins and edge
  offsets), the seed, the contraction limit and the device.  Identical
  weights reuse the resident hierarchy as it is ("resident").  When only
  weights drift, every stored contraction is replayed on the new
  weights with the stored cluster maps ("replayed"): the host engine
  re-runs ``contract`` per level, the device engine re-runs
  ``contract_arrays`` and swaps the weight leaves of the resident levels
  with ``dataclasses.replace`` (structure, incidence layout and the
  pins sorted by vertex stay).  Pin edits change the token and rebuild
  the hierarchy restricted by the incumbent (``restrict_part``), so the
  incumbent still projects cut-exactly ("patched"; "cold" without a
  cached entry).
* **Incumbent projection.**  The cached hierarchy may have been built
  around an older assignment, so the incumbent is projected by weighted
  majority per cluster, and each level's budget is reduced by the
  residual (the weight of vertices outside their cluster's majority
  block): true migration at the finest level is at most the coarse
  migration plus the residual.  At zero drift the projection is exact
  and the residual zero.
* **Bounded migration.**  Each level's (incumbent, budget) pair feeds
  ``refine.refine_population``, whose LP and FM tiers keep every
  member's moved weight within the budget.  The final selection keeps
  only members within budget and falls back to the incumbent when none
  beats it.
* **k-change.**  Elastic device loss remaps the incumbent
  ``b -> b % k_new`` and runs the same pipeline; a cached hierarchy is
  reusable whenever ``k_new <= k_built``.

The helpers that run on the host (``structure_token``,
``project_incumbent``, ``seed_incumbent_population``, ``select_best``)
are numpy copies of the reference's, with the same crc32 seeds, so they
give the same bits.  Drifted weights are real-valued; the levels carry
that as ``real_edge_weights``/``real_vertex_weights``, and their sums on
the card take fixed-order paths, so two runs of one refresh give the
same bits (``core.metrics``).
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device, warn_env_once
from . import dcoarsen, metrics
from . import refine as refine_mod
from .coarsen import Hierarchy, Level
from .hypergraph import (DeviceLevel, HierarchyArrays, Hypergraph, contract,
                         contract_arrays, is_real_valued)

__all__ = [
    "IncrementalConfig", "IncrementalResult", "IncrementalState",
    "incremental_partition", "repartition_k_change", "structure_token",
    "project_incumbent", "seed_incumbent_population", "select_best",
    "incr_reuse_enabled", "incr_perturb_frac",
]


# --------------------------------------------------------------------------
# REPRO_INCR_* knobs: a bad value warns once and names its fallback

def incr_reuse_enabled() -> bool:
    """``REPRO_INCR_REUSE``: hierarchy reuse across refreshes ("on" or
    "off", default on).  Off rebuilds the hierarchy every solve."""
    raw = os.environ.get("REPRO_INCR_REUSE", "on").strip().lower()
    if raw not in ("on", "off"):
        warn_env_once("REPRO_INCR_REUSE", raw, "on")
        return True
    return raw == "on"


def incr_perturb_frac() -> float:
    """``REPRO_INCR_PERTURB``: the fraction of the migration budget each
    perturbed clone spends on seed moves away from the incumbent (a
    float in [0, 1], default 0.5)."""
    raw = os.environ.get("REPRO_INCR_PERTURB", "").strip()
    if not raw:
        return 0.5
    try:
        v = float(raw)
        if not 0.0 <= v <= 1.0:
            raise ValueError
        return v
    except ValueError:
        warn_env_once("REPRO_INCR_PERTURB", raw, "0.5")
        return 0.5


# --------------------------------------------------------------------------
# config and result

@dataclasses.dataclass
class IncrementalConfig:
    k: int
    eps: float = 0.08
    alpha: int = 4               # population size (incumbent + clones)
    # migration budget as a fraction of the total vertex weight; None is
    # unbounded (a plain warm start).  A k-change's forced remap does not
    # count: the budget bounds movement beyond it
    migration_frac: Optional[float] = 0.1
    seed: int = 0
    lp_iters: int = 8
    fm_node_limit: int = 4096
    contraction_limit_factor: int = 64
    perturb_frac: Optional[float] = None   # None -> REPRO_INCR_PERTURB
    reuse: Optional[bool] = None           # None -> REPRO_INCR_REUSE
    pop_shard: Optional[str] = None        # None -> REPRO_POP_SHARD
    model_shard: Optional[str] = None      # None -> REPRO_MODEL_SHARD

    def __post_init__(self):
        if self.k < 2:
            raise ValueError(f"k must be >= 2, got {self.k}")
        if self.migration_frac is not None and self.migration_frac < 0:
            raise ValueError("migration_frac must be >= 0 or None")


@dataclasses.dataclass
class IncrementalResult:
    part: np.ndarray             # [n] int32
    cut: float
    migration_weight: float      # moved vertex weight against the incumbent
    budget_weight: float         # absolute budget (inf when unbounded)
    reused: str                  # "cold" | "resident" | "replayed" | "patched"
    wall_s: float
    levels: int
    cuts: np.ndarray             # finest-level cut of every member


# --------------------------------------------------------------------------
# structure token and hierarchy cache

def structure_token(hg: Hypergraph) -> Tuple[int, int, int, int]:
    """crc32 over the structure arrays: weights are left out, so weight
    drift keeps the token and pin edits change it."""
    t = zlib.crc32(np.ascontiguousarray(hg.pins, np.int32).tobytes())
    t = zlib.crc32(np.ascontiguousarray(hg.edge_offsets, np.int64)
                   .tobytes(), t)
    return (t, int(hg.n), int(hg.m), int(hg.num_pins))


def _replay_host(hier: Hierarchy, hg_new: Hypergraph) -> Hierarchy:
    """Re-run every stored contraction of a host hierarchy on the new
    weights.  The cluster maps are structure-only, so ``contract`` gives
    each level's pins again; each level shares its old host structure
    (``with_edge_weights``) and builds its device arrays anew on use."""
    old0 = hier.levels[0].hg
    hg0 = old0.with_edge_weights(hg_new.edge_weights, hg_new.vertex_weights)
    levels = [Level(hg0, hier.levels[0].cluster_id, hier.levels[0].part)]
    for li in range(1, len(hier.levels)):
        old = hier.levels[li]
        coarse, _ = contract(levels[li - 1].hg, old.cluster_id, old.hg.n)
        hg_li = old.hg.with_edge_weights(coarse.edge_weights,
                                         coarse.vertex_weights)
        levels.append(Level(hg_li, old.cluster_id, old.part))
    return Hierarchy(levels=levels, device=hier.device)


def _replay_device(hier: HierarchyArrays,
                   hg_new: Hypergraph) -> HierarchyArrays:
    """Device-engine replay: swap the finest level's weight leaves, then
    re-run ``contract_arrays`` with every stored cluster map.  Its output
    keeps the finer level's padding; slicing it to the old level's
    ``m_pad``/``n_pad`` is the rebucketing the original build did, so at
    zero drift every leaf is bit-equal to the build's.

    ``dataclasses.replace`` carries the structure-only fields over
    (pins, ``incident``, ``pin_sort``, ``pin_sort_edge``) and sets the
    weight-derived ``real_*_weights`` flags anew (level 0 from the host
    weights, coarser levels from their contraction).  Level 0 gets no
    ``host_hg``: the old one's ``arrays()`` cache holds the old weights,
    so ``level_host(0)`` rebuilds it from the new arrays if asked."""
    lv0 = hier.levels[0]
    dev = lv0.hga.device
    ew = np.zeros(lv0.hga.m_pad, np.float32)
    ew[: lv0.m] = hg_new.edge_weights
    vw = np.zeros(lv0.hga.n_pad, np.float32)
    vw[: lv0.n] = hg_new.vertex_weights
    hga0 = dataclasses.replace(
        lv0.hga, edge_weights=torch.from_numpy(ew).to(dev),
        vertex_weights=torch.from_numpy(vw).to(dev),
        real_edge_weights=is_real_valued(hg_new.edge_weights),
        real_vertex_weights=is_real_valued(hg_new.vertex_weights))
    levels = [DeviceLevel(hga0, lv0.cluster_id, lv0.n, lv0.m, lv0.p,
                          part=lv0.part, host_hg=None)]
    for li in range(1, len(hier.levels)):
        old = hier.levels[li]
        coarse, _ = contract_arrays(levels[li - 1].hga, old.cluster_id,
                                    old.n)
        hga_li = dataclasses.replace(
            old.hga,
            edge_weights=coarse.edge_weights[: old.hga.m_pad].contiguous(),
            vertex_weights=coarse.vertex_weights[: old.hga.n_pad]
            .contiguous(),
            real_edge_weights=coarse.real_edge_weights,
            real_vertex_weights=coarse.real_vertex_weights)
        levels.append(DeviceLevel(hga_li, old.cluster_id, old.n, old.m,
                                  old.p, part=old.part, host_hg=None))
    return HierarchyArrays(levels=levels)


def _replay_weights(hier, hg_new: Hypergraph):
    if isinstance(hier, HierarchyArrays):
        return _replay_device(hier, hg_new)
    return _replay_host(hier, hg_new)


class IncrementalState:
    """Resident state across refreshes: one cached hierarchy keyed on
    (structure token, seed, contraction limit, device).
    ``hierarchy_for`` classifies the refresh: identical weights reuse
    the resident hierarchy untouched, weight drift replays the
    contractions, and a structure change (pin edits), another device or
    a k larger than the cached build's rebuilds restricted by the
    incumbent."""

    def __init__(self):
        self._entry: Optional[dict] = None

    def hierarchy_for(self, hg: Hypergraph, incumbent: np.ndarray,
                      cfg: IncrementalConfig,
                      device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        token = structure_token(hg)
        e = self._entry
        if (e is not None and e["token"] == token
                and e["seed"] == cfg.seed
                and e["clf"] == cfg.contraction_limit_factor
                and e["dev"] == dev and cfg.k <= e["k_built"]):
            old_hg = e["hg"]
            if (np.array_equal(old_hg.edge_weights, hg.edge_weights)
                    and np.array_equal(old_hg.vertex_weights,
                                       hg.vertex_weights)):
                return e["hier"], "resident"
            hier = _replay_weights(e["hier"], hg)
            e["hier"], e["hg"] = hier, hg
            return hier, "replayed"
        how = "cold" if e is None else "patched"
        hier = _build(hg, incumbent, cfg, dev)
        self._entry = dict(token=token, k_built=cfg.k, seed=cfg.seed,
                           clf=cfg.contraction_limit_factor, dev=dev,
                           hier=hier, hg=hg)
        return hier, how


def _build(hg: Hypergraph, incumbent: np.ndarray, cfg: IncrementalConfig,
           dev: torch.device):
    """A hierarchy restricted by the incumbent (only same-block vertices
    merge), with the engine ``dcoarsen.coarsen_path`` picks for ``dev``."""
    return dcoarsen.build_hierarchy(
        hg, cfg.k, seed=cfg.seed, restrict_part=incumbent,
        contraction_limit_factor=cfg.contraction_limit_factor,
        model_shard=cfg.model_shard, device=dev)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# incumbent projection with residual-adjusted budgets

def project_incumbent(hier, incumbent: np.ndarray, k: int,
                      budget_w: float
                      ) -> Tuple[List[np.ndarray], List[float]]:
    """Per-level majority-projected incumbents and conservative budgets.

    Level ``li``'s incumbent gives each cluster its members' weighted
    majority block; the residual (the weight of the members outside it)
    comes off the budget.  True migration at the finest level is at most
    a level's migration plus its residual, so the reduced budget keeps
    every accepted member within the true one.  On a hierarchy built
    with ``restrict_part=incumbent`` every cluster is pure and the
    residual is zero.
    """
    inc0 = np.asarray(incumbent, np.int32)
    n0 = hier.level_n(0)
    vw0 = _np(hier.level_arrays(0).vertex_weights).astype(np.float64)[:n0]
    total = float(vw0.sum())
    incs: List[np.ndarray] = [inc0]
    buds: List[float] = [float(budget_w)]
    cur_map = np.arange(n0)
    for li in range(1, hier.num_levels):
        cid = _np(hier.levels[li].cluster_id)
        cur_map = cid[cur_map]
        n_li = hier.level_n(li)
        w = np.zeros((n_li, k), np.float64)
        np.add.at(w, (cur_map, inc0), vw0)
        incs.append(w.argmax(axis=1).astype(np.int32))
        residual = total - float(w.max(axis=1).sum())
        buds.append(float(budget_w) - residual)
    return incs, buds


# --------------------------------------------------------------------------
# incumbent-seeded population

def _cap_like_reference(total: float, k: int, eps: float) -> float:
    """``metrics.balance_cap`` of a host total as the reference evaluates
    it: the quotient in float64, its ceiling and the product in f32."""
    return float(metrics.balance_cap(
        torch.tensor(total / k, dtype=torch.float32), 1, eps))


def seed_incumbent_population(hier, inc_L: np.ndarray, budget_L: float,
                              cfg: IncrementalConfig) -> np.ndarray:
    """Unrefined coarsest-level seeds [alpha, n_L]: member 0 is the
    projected incumbent; each clone perturbs it with random moves that
    keep balance and spend at most ``perturb_frac`` of the level budget,
    drawn from ``default_rng(crc32("incr:<seed>:<i>"))``.  The ladder's
    first step refines this level."""
    li = hier.num_levels - 1
    n_l = hier.level_n(li)
    vw = _np(hier.level_arrays(li).vertex_weights).astype(np.float64)[:n_l]
    cap = _cap_like_reference(float(vw.sum()), cfg.k, cfg.eps)
    bw = np.zeros(cfg.k)
    np.add.at(bw, inc_L, vw)
    pfrac = (incr_perturb_frac() if cfg.perturb_frac is None
             else cfg.perturb_frac)
    per_budget = max(float(budget_L), 0.0) * pfrac
    members = [inc_L.astype(np.int32)]
    for i in range(1, cfg.alpha):
        rng = np.random.default_rng(
            zlib.crc32(f"incr:{cfg.seed}:{i}".encode()) & 0x7FFFFFFF)
        clone = inc_L.astype(np.int32).copy()
        bw_c = bw.copy()
        spent = 0.0
        for v in rng.permutation(n_l):
            if spent >= per_budget:
                break
            if vw[v] <= 0.0 or spent + vw[v] > per_budget:
                continue
            tgt = int(rng.integers(0, cfg.k))
            if tgt == clone[v] or bw_c[tgt] + vw[v] > cap + 1e-6:
                continue
            bw_c[clone[v]] -= vw[v]
            bw_c[tgt] += vw[v]
            clone[v] = tgt
            spent += vw[v]
        members.append(clone)
    return np.stack(members)


# --------------------------------------------------------------------------
# budget-aware selection

def select_best(parts0: np.ndarray, cuts: np.ndarray,
                incumbent: np.ndarray, inc_cut: float, vw: np.ndarray,
                budget_w: float) -> Tuple[np.ndarray, float, float]:
    """The best finest-level member with migration <= budget; the
    incumbent (zero migration) competes as a fallback and wins when its
    cut is strictly better, so the answer is never worse than keeping
    the old assignment.  Returns (part, cut, migration)."""
    parts0 = np.asarray(parts0)
    cuts = np.asarray(cuts, np.float64)
    migs = ((parts0 != incumbent[None, :]) * vw[None, :]).sum(axis=1)
    ok = migs <= budget_w + 1e-6
    best = None
    for i in np.argsort(cuts, kind="stable"):
        if ok[i]:
            best = int(i)
            break
    if best is None or float(inc_cut) < cuts[best] - 1e-9:
        return np.asarray(incumbent, np.int32), float(inc_cut), 0.0
    return (parts0[best].astype(np.int32), float(cuts[best]),
            float(migs[best]))


# --------------------------------------------------------------------------
# the solve

def incremental_partition(hg: Hypergraph, incumbent,
                          cfg: IncrementalConfig,
                          state: Optional[IncrementalState] = None,
                          device: str | torch.device = "cuda"
                          ) -> IncrementalResult:
    """Warm-start repartition of ``hg`` around ``incumbent`` on
    ``device``, the moved weight bounded by ``cfg.migration_frac`` of the
    total.  A ``state`` reuses its hierarchy across refreshes (unless
    ``cfg.reuse``/``REPRO_INCR_REUSE`` turn reuse off)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    inc0 = np.asarray(incumbent, np.int32)
    if inc0.shape[0] != hg.n:
        raise ValueError(f"incumbent has {inc0.shape[0]} entries for "
                         f"{hg.n} vertices")
    if inc0.min(initial=0) < 0 or inc0.max(initial=0) >= cfg.k:
        raise ValueError("incumbent block ids out of range")
    total_w = float(np.sum(hg.vertex_weights))
    budget_w = (np.inf if cfg.migration_frac is None
                else float(cfg.migration_frac) * total_w)
    reuse = incr_reuse_enabled() if cfg.reuse is None else cfg.reuse
    if state is not None and reuse:
        hier, how = state.hierarchy_for(hg, inc0, cfg, dev)
    else:
        hier, how = _build(hg, inc0, cfg, dev), "cold"
    incs, buds = project_incumbent(hier, inc0, cfg.k, budget_w)
    top = hier.num_levels - 1
    parts = seed_incumbent_population(hier, incs[top], buds[top], cfg)
    cuts = None
    for li in range(top, -1, -1):
        if li < top:
            parts = hier.project_pop(parts, li + 1)
        parts, cuts = refine_mod.refine_population(
            hier.level_arrays(li), parts, cfg.k, cfg.eps,
            max_iters=cfg.lp_iters, fm_node_limit=cfg.fm_node_limit,
            shard=cfg.pop_shard, model_shard=cfg.model_shard,
            incumbent=incs[li], mig_budget=buds[li], device=dev)
    hga0 = hier.level_arrays(0)
    inc_cut = float(metrics.cutsize(
        hga0, refine_mod.pad_part(inc0, hga0.n_pad, dev), cfg.k))
    parts0 = parts.cpu().numpy()[:, : hg.n]
    vw = np.asarray(hg.vertex_weights, np.float64)
    part, cut, mig = select_best(parts0, cuts, inc0, inc_cut, vw, budget_w)
    return IncrementalResult(
        part=part, cut=cut, migration_weight=mig, budget_weight=budget_w,
        reused=how, wall_s=time.perf_counter() - t0,
        levels=hier.num_levels, cuts=np.asarray(cuts, np.float64))


def repartition_k_change(hg: Hypergraph, incumbent, k_new: int,
                         cfg: IncrementalConfig,
                         state: Optional[IncrementalState] = None,
                         device: str | torch.device = "cuda"
                         ) -> IncrementalResult:
    """Forced k-change (elastic device loss): remap incumbent blocks
    ``b -> b % k_new`` and run the incremental pipeline at ``k_new``.
    The migration budget bounds movement beyond the forced remap; a
    cached hierarchy stays reusable, since device loss only shrinks k."""
    inc = np.asarray(incumbent, np.int32) % k_new
    cfg2 = dataclasses.replace(cfg, k=k_new)
    return incremental_partition(hg, inc, cfg2, state=state, device=device)
