"""V-cycle improvement (port of ``repro.core.vcycle``), used by
recombination on clustered instances above the paper's size threshold,
by mutation to re-partition the reweighted hypergraph, and as the
driver's final V-cycle.

Partition-aware coarsening: only same-block vertices merge, so the input
partition projects exactly (same cut) onto every level; refinement then
improves it on the way back up.

``vcycle_instances`` (DESIGN.md §12) runs one V-cycle for a batch of
independent requests: each builds its hierarchy with
``dcoarsen.build_hierarchy`` (the numpy coarsener or the device engine,
``REPRO_COARSEN_PATH``), and their refinement steps are grouped through
``instances.refine_grouped``; ``vcycle`` is its batch of one.
``vcycle_population``
(DESIGN.md §10) is the mutation cohort's V-cycle: the members share one
hierarchy built by ``dcoarsen.population_coarsen`` and differ only in
their edge-weight rows; ``path="loop"`` runs the same pipeline member by
member (populations of one) as the per-member reference.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import Hypergraph
from .dcoarsen import build_hierarchy, population_coarsen
from . import instances as instances_mod
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
    back up with a population of one (``vcycle_instances`` on a batch of
    one request).

    ``eval_weights``: if given, the returned cut is measured with these
    edge weights.  Never returns a worse partition than the input
    (elitism on that cut).

    ``scheduler``: the ``OperatorScheduler`` of a bandit-scheduled
    impart run.  Each level's refinement tier ({lp, lp_fm}) is then
    chosen and observed through it, under the context phase
    ``SCHED_VCYCLE_PHASE``, so replay covers the final V-cycles too.
    ``None`` is the static pipeline."""
    return vcycle_instances(
        [hg], [part], [k], [eps], seeds=[seed], fm_node_limit=fm_node_limit,
        contraction_limit_factor=contraction_limit_factor,
        eval_weights=[eval_weights], shard=shard, model_shard=model_shard,
        schedulers=[scheduler], device=device)[0]


def _pad_part(part: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros(n_pad, np.int32)
    out[: len(part)] = part
    return out


def vcycle_instances(hgs: Sequence[Hypergraph], parts: Sequence,
                     ks: Sequence[int], epss: Sequence[float],
                     seeds: Optional[Sequence[int]] = None,
                     fm_node_limit: int = 4096,
                     contraction_limit_factor: int = 64,
                     grid: Optional[Sequence[int]] = None,
                     shard: Optional[str] = None,
                     model_shard: Optional[str] = None,
                     eval_weights: Optional[Sequence] = None,
                     schedulers: Optional[Sequence] = None,
                     device: str | torch.device = "cuda"
                     ) -> List[Tuple[np.ndarray, float]]:
    """One V-cycle for a batch of independent requests on ``device``
    (DESIGN.md §12): each request builds its own partition-aware
    hierarchy, then all requests walk their uncoarsening ladders in
    lockstep, and at every step their current levels are refined
    together through ``instances.refine_grouped``, one stacked dispatch
    per shape bucket.  Each result is bit-equal to ``vcycle`` on that
    request alone.  Returns ``[(part [n_i], cut), ...]``.

    ``eval_weights`` and ``schedulers`` hold ``vcycle``'s arguments of
    those names per request (``None`` entries allowed).  A step's
    scheduled requests are grouped by the tier their scheduler chose,
    the ``lp`` group dispatched with ``fm_node_limit=0``, and each
    observes its group's wall."""
    dev = resolve_device(device)
    num_req = len(hgs)
    seeds = list(seeds) if seeds is not None else [0] * num_req
    eval_weights = (list(eval_weights) if eval_weights is not None
                    else [None] * num_req)
    schedulers = (list(schedulers) if schedulers is not None
                  else [None] * num_req)
    parts = [np.asarray(p, np.int32) for p in parts]
    hiers, curs = [], []
    for hg, part, k, seed in zip(hgs, parts, ks, seeds):
        hier = build_hierarchy(
            hg, k, seed=seed, restrict_part=part,
            contraction_limit_factor=contraction_limit_factor,
            model_shard=model_shard, device=dev)
        hiers.append(hier)
        curs.append(torch.as_tensor(hier.level_part(hier.num_levels - 1),
                                    device=dev).to(torch.int32)[None, :])
    prev_best: List[Optional[float]] = [None] * num_req
    for t in range(max(h.num_levels for h in hiers)):
        groups = {arm: [] for arm in REFINE_ARMS}
        for i, hier in enumerate(hiers):
            if t >= hier.num_levels:
                continue
            li = hier.num_levels - 1 - t
            if li < hier.num_levels - 1:
                curs[i] = hier.project_pop(curs[i], li + 1)
            sch = schedulers[i]
            if sch is None:
                groups["lp_fm"].append(i)
                continue
            if prev_best[i] is None:
                # the exact projection keeps the cut, so only the
                # coarsest level needs a measurement before its refinement
                hga = hier.level_arrays(li)
                prev_best[i] = float(metrics.cutsize(
                    hga, refine_mod.pad_part(curs[i][0][: hga.n_pad],
                                             hga.n_pad), ks[i]))
            groups[sch.choose(li, SCHED_VCYCLE_PHASE, REFINE_ARMS)].append(i)
        for arm, idxs in groups.items():
            if not idxs:
                continue
            t_arm = time.perf_counter()
            outs = instances_mod.refine_grouped(
                [(hiers[i].level_arrays(hiers[i].num_levels - 1 - t),
                  curs[i], ks[i], epss[i]) for i in idxs], grid=grid,
                fm_node_limit=0 if arm == "lp" else fm_node_limit,
                shard=shard, model_shard=model_shard, device=dev)
            # the cuts are host values read back from the card: the wall
            # below ends in a host sync
            wall = time.perf_counter() - t_arm
            for (rp, rc), i in zip(outs, idxs):
                curs[i] = rp
                if schedulers[i] is None:
                    continue
                new_best = float(np.min(np.asarray(rc)))
                schedulers[i].observe(hiers[i].num_levels - 1 - t,
                                      SCHED_VCYCLE_PHASE, arm,
                                      prev_best[i] - new_best, wall)
                prev_best[i] = new_best

    results = []
    for i, (hg, part, k) in enumerate(zip(hgs, parts, ks)):
        out = curs[i][0].cpu().numpy()[: hg.n]
        # elitism on the true (or the given) objective
        true_hg = (hg if eval_weights[i] is None
                   else hg.with_edge_weights(eval_weights[i]))
        hga0 = true_hg.arrays(device=dev)
        cut_new, cut_old = (float(metrics.cutsize(
            hga0, torch.from_numpy(_pad_part(p, hga0.n_pad)).to(dev), k))
            for p in (out, part))
        results.append((out, cut_new) if cut_new <= cut_old + 1e-9
                       else (part, cut_old))
    return results


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
