"""V-cycle improvement (port of ``repro.core.vcycle``), used by
recombination on clustered instances above the paper's size threshold,
by mutation to re-partition the reweighted hypergraph, and as the
driver's final V-cycle.

Partition-aware coarsening: only same-block vertices merge, so the input
partition projects exactly (same cut) onto every level; refinement then
improves it on the way back up.

``vcycle`` builds its hierarchy with ``dcoarsen.build_hierarchy`` (the
numpy coarsener or the device engine, ``REPRO_COARSEN_PATH``) and walks
it through the shared hierarchy protocol.  ``vcycle_population``
(DESIGN.md §10) is the mutation cohort's V-cycle: the members share one
hierarchy built by ``dcoarsen.population_coarsen`` and differ only in
their edge-weight rows; ``path="loop"`` runs the same pipeline member by
member (populations of one) as the per-member reference.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import Hypergraph
from .dcoarsen import build_hierarchy, population_coarsen
from . import refine as refine_mod
from . import metrics
from .scheduler import REFINE_ARMS, SCHED_VCYCLE_PHASE


def vcycle(hg: Hypergraph, part: np.ndarray, k: int, eps: float,
           seed: int = 0, fm_node_limit: int = 4096,
           contraction_limit_factor: int = 64,
           eval_weights: np.ndarray | None = None,
           shard: Optional[str] = None,
           model_shard: Optional[str] = None,
           scheduler=None,
           device: str | torch.device = "cuda"
           ) -> Tuple[np.ndarray, float]:
    """One V-cycle on ``device``: partition-aware coarsening, then refine
    back up with a population of one.

    ``eval_weights``: if given, the returned cut is measured with these
    edge weights.  Never returns a worse partition than the input
    (elitism on that cut).

    ``scheduler``: the ``OperatorScheduler`` of a bandit-scheduled
    impart run.  Each level's refinement tier ({lp, lp_fm}) is then
    chosen and observed through it, under the context phase
    ``SCHED_VCYCLE_PHASE``, so replay covers the final V-cycles too.
    ``None`` is the static pipeline."""
    dev = resolve_device(device)
    part = np.asarray(part, np.int32)
    hier = build_hierarchy(hg, k, seed=seed, restrict_part=part,
                           contraction_limit_factor=contraction_limit_factor,
                           model_shard=model_shard, device=dev)
    num = hier.num_levels
    cur = torch.as_tensor(hier.level_part(num - 1),
                          device=dev).to(torch.int32)[None, :]
    prev_best = None
    for li in range(num - 1, -1, -1):
        if li < num - 1:
            cur = hier.project_pop(cur, li + 1)
        hga = hier.level_arrays(li)
        if scheduler is None:
            cur, _ = refine_mod.refine_population(
                hga, cur, k, eps, fm_node_limit=fm_node_limit, shard=shard,
                model_shard=model_shard, device=dev)
            continue
        if prev_best is None:
            # the exact projection keeps the cut, so only the coarsest
            # level needs a measurement before its refinement
            prev_best = float(metrics.cutsize(
                hga, refine_mod.pad_part(cur[0][: hga.n_pad], hga.n_pad),
                k))
        arm = scheduler.choose(li, SCHED_VCYCLE_PHASE, REFINE_ARMS)
        t_arm = time.perf_counter()
        if arm == "lp":
            cur, rc = refine_mod.lp_refine_population(
                hga, cur, k, eps, shard=shard, model_shard=model_shard)
        else:
            cur, rc = refine_mod.refine_population(
                hga, cur, k, eps, fm_node_limit=fm_node_limit, shard=shard,
                model_shard=model_shard, device=dev)
        # ``rc`` are host values read back from the card: the wall
        # below ends in a host sync
        new_best = float(np.min(np.asarray(rc)))
        scheduler.observe(li, SCHED_VCYCLE_PHASE, arm, prev_best - new_best,
                          time.perf_counter() - t_arm)
        prev_best = new_best

    out = cur[0].cpu().numpy()[: hg.n]
    # elitism on the true (or the given) objective
    true_hg = hg if eval_weights is None else hg.with_edge_weights(eval_weights)
    hga0 = true_hg.arrays(device=dev)
    cut_new, cut_old = (float(metrics.cutsize(
        hga0, torch.from_numpy(_pad_part(p, hga0.n_pad)).to(dev), k))
        for p in (out, part))
    if cut_new <= cut_old + 1e-9:
        return out, cut_new
    return part, cut_old


def _pad_part(part: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros(n_pad, np.int32)
    out[: len(part)] = part
    return out


def vcycle_population(hg: Hypergraph, parts, ew_pop, k: int, eps: float,
                      seed: int = 0, fm_node_limit: int = 4096,
                      contraction_limit_factor: int = 64,
                      path: Optional[str] = None,
                      shard: Optional[str] = None,
                      model_shard: Optional[str] = None,
                      device: str | torch.device = "cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One V-cycle for the whole mutation cohort on ``device``.

    ``parts`` [alpha, n] warm starts; ``ew_pop`` [alpha, m] per-member
    reweighted edge weights over ``hg``'s structure.  One shared
    partition-aware hierarchy is built for the cohort; every level
    refines all members, each on its own weight row.  Per-member elitism
    on the member's own (reweighted) objective.  Returns ``(parts
    [alpha, n], cuts [alpha])``, the cuts on each member's own weights.

    ``path``: "batch" (default, via ``mutate.mutate_path``) runs every
    per-member stage as one batched dispatch; "loop" runs the same
    pipeline member by member, and gives the same partitions and cuts.
    """
    from .mutate import MUTATE_PATHS, mutate_path
    if path is None:
        path = mutate_path()
    else:
        path = path.strip().lower()
        if path not in MUTATE_PATHS:
            raise ValueError(f"unknown mutation path {path!r}; "
                             f"expected one of {MUTATE_PATHS}")
    batch = path == "batch"
    dev = resolve_device(device)
    parts = np.asarray(parts, np.int32)
    alpha = parts.shape[0]
    hier = population_coarsen(
        hg, parts, ew_pop, k, seed=seed, batch=batch,
        contraction_limit_factor=contraction_limit_factor,
        model_shard=model_shard, device=dev)
    num = hier.num_levels

    cur = hier.level_parts(num - 1)
    for li in range(num - 1, -1, -1):
        if li < num - 1:
            cur = hier.project_pop(cur, li + 1)
        hga = hier.level_arrays(li)
        ew_li = hier.level_ew(li)
        if batch:
            cur, _ = refine_mod.refine_population(
                hga, cur, k, eps, fm_node_limit=fm_node_limit,
                edge_weights_pop=ew_li, shard=shard,
                model_shard=model_shard, device=dev)
        else:  # member by member: populations of one, same dispatches
            cur = torch.cat([refine_mod.refine_population(
                hga, cur[a:a + 1], k, eps, fm_node_limit=fm_node_limit,
                edge_weights_pop=ew_li[a:a + 1], shard=shard,
                model_shard=model_shard, device=dev)[0]
                for a in range(alpha)])

    # per-member elitism on each member's own (reweighted) objective
    hga0 = hier.level_arrays(0)
    ew0 = hier.level_ew(0)
    out = refine_mod.pad_parts(cur[:, : hg.n], hga0.n_pad, dev)
    warm = refine_mod.pad_parts(parts[:, : hg.n], hga0.n_pad, dev)
    if batch:
        cut_new = metrics.cutsize_population_weighted(hga0, out, ew0, k)
        cut_old = metrics.cutsize_population_weighted(hga0, warm, ew0, k)
    else:
        cut_new, cut_old = (torch.cat([
            metrics.cutsize_population_weighted(hga0, x[a:a + 1],
                                                ew0[a:a + 1], k)
            for a in range(alpha)]) for x in (out, warm))
    cut_new = cut_new.cpu().numpy().astype(np.float64)
    cut_old = cut_old.cpu().numpy().astype(np.float64)
    take = cut_new <= cut_old + 1e-9
    final = np.where(take[:, None], out.cpu().numpy(), warm.cpu().numpy())
    cuts = np.where(take, cut_new, cut_old)
    return final[:, : hg.n].astype(np.int32), cuts
