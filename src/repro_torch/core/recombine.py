"""Recombination operator (port of ``repro.core.recombine``; paper
Sec. 3.1.2).

Two parents S_a, S_b at the current level -> overlay clustering
(vertices on which both parents agree collapse) -> clustered hypergraph
-> solve:

* ``n' * k < ILP_EXACT`` and ``n' <= EXACT_N_LIMIT``: exact branch and
  bound (``ilp.solve_exact``), warm-started from the better parent;
* ``n' * k < ILP_APPROX``: iterated local search (warm-started FM with
  perturbed restarts), 6 restarts;
* ``n' <= 40 k``: the same with 2 restarts;
* otherwise: a V-cycle of the current level, warm-started from the
  better parent.

The offspring is never worse than the better parent (warm starts and FM
passes are monotone; elitism guards the rest).  The overlay and the
clustered hypergraph are host (numpy) work; the clustered instance and
the V-cycle refine on ``device``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import Hypergraph, contract
from . import popshard
from . import refine as refine_mod
from . import metrics
from . import ilp as ilp_mod
from .vcycle import vcycle

ILP_EXACT = 600     # paper threshold: provably-optimal region
ILP_APPROX = 1000   # paper threshold: 1%-gap region
EXACT_N_LIMIT = 26  # B&B practical vertex limit within budget


def overlay_clustering(part_a: np.ndarray, part_b: np.ndarray, k: int
                       ) -> Tuple[np.ndarray, int]:
    """cluster id per vertex = dense id of the (S_a(v), S_b(v)) pair."""
    combo = np.asarray(part_a, np.int64) * k + np.asarray(part_b, np.int64)
    _, dense = np.unique(combo, return_inverse=True)
    return dense.astype(np.int32), int(dense.max()) + 1


def _ils_clustered(chg: Hypergraph, k: int, eps: float, warm: np.ndarray,
                   seed: int, restarts: int = 6, kick: float = 0.15,
                   waves: int = 2, device: str | torch.device = "cuda"
                   ) -> Tuple[np.ndarray, float]:
    """Iterated local search on the clustered hypergraph: FM from the
    warm start, then ``waves`` waves that each perturb the incumbent
    ``restarts / waves`` times (``kick`` of the vertices re-drawn) and
    refine every candidate in one batched FM dispatch; elitism across
    waves.  The random draws (``choice`` then ``integers`` per
    candidate, from ``default_rng(seed)``) are the reference's."""
    rng = np.random.default_rng(seed)
    hga = chg.arrays(device=device)
    part, cut = refine_mod.fm_refine(hga, warm, k, eps)
    best, best_cut = np.asarray(part).copy(), cut
    waves = max(1, min(waves, restarts))
    per_wave = [restarts // waves + (1 if w < restarts % waves else 0)
                for w in range(waves)]
    for n_cands in per_wave:
        if n_cands <= 0:
            continue
        cands = []
        for _ in range(n_cands):
            cand = best[: chg.n].copy()
            nk = max(1, int(kick * chg.n))
            idx = rng.choice(chg.n, size=nk, replace=False)
            cand[idx] = rng.integers(0, k, size=nk).astype(np.int32)
            cands.append(refine_mod.rebalance(
                chg.vertex_weights, cand, k, eps, rng))
        pp, cc = refine_mod.fm_refine_population(hga, cands, k, eps)
        i = int(np.argmin(cc))
        if cc[i] < best_cut - 1e-9:
            best, best_cut = pp[i].cpu().numpy(), float(cc[i])
    return best, best_cut


def recombine(hg: Hypergraph, part_a: np.ndarray, part_b: np.ndarray,
              cut_a: float, cut_b: float, k: int, eps: float, seed: int = 0,
              shard: Optional[str] = None, model_shard: Optional[str] = None,
              device: str | torch.device = "cuda"
              ) -> Tuple[np.ndarray, float]:
    """Produce one offspring from two parents at the current level."""
    dev = resolve_device(device)
    part_a = np.asarray(part_a, np.int32)[: hg.n]
    part_b = np.asarray(part_b, np.int32)[: hg.n]
    better, better_cut = (part_a, cut_a) if cut_a <= cut_b else (part_b, cut_b)

    cid, n_prime = overlay_clustering(part_a, part_b, k)
    if n_prime <= k:  # parents identical up to relabeling: nothing to merge
        return better.copy(), better_cut

    chg, _ = contract(hg, cid, n_prime)
    # warm start: block of each cluster under the better parent
    first_member = np.zeros(n_prime, np.int64)
    first_member[cid[::-1]] = np.arange(hg.n - 1, -1, -1)
    warm = better[first_member].astype(np.int32)

    metric = n_prime * k
    if metric < ILP_EXACT and n_prime <= EXACT_N_LIMIT:
        cpart, _ = ilp_mod.solve_exact(chg, k, eps, warm_start=warm,
                                       node_budget=400_000)
    elif metric < ILP_APPROX:
        cpart, _ = _ils_clustered(chg, k, eps, warm, seed, restarts=6,
                                  device=dev)
    elif n_prime <= 40 * k:  # still small: cheap ILS with fewer restarts
        cpart, _ = _ils_clustered(chg, k, eps, warm, seed, restarts=2,
                                  device=dev)
    else:
        # too large to treat as a clustered instance: V-cycle the level
        return vcycle(hg, better, k, eps, seed=seed, shard=shard,
                      model_shard=model_shard, device=dev)

    offspring = np.asarray(cpart)[cid]
    hga = hg.arrays(device=dev)
    off_cut = float(metrics.cutsize(
        hga, refine_mod.pad_part(offspring, hga.n_pad, dev), k))
    if off_cut <= better_cut + 1e-9:
        return offspring, off_cut
    return better.copy(), better_cut  # elitism


def ring_recombination(hg: Hypergraph, parts, cuts, k: int,
                       eps: float, seed: int = 0,
                       shard: Optional[str] = None,
                       model_shard: Optional[str] = None,
                       device: str | torch.device = "cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Paper's circular pairing: (1,2), (2,3), ..., (alpha, 1).

    Takes the population as a stacked [alpha, >= n] array (or a list of
    vectors) and returns the offspring stacked [alpha, n] with their
    cuts.  Partners come from ``popshard.ring_partners`` (the host
    roll, or the exchange over the pool's shards on the ``mesh``
    route)."""
    alpha = len(parts)
    stacked = np.stack([np.asarray(p, np.int32)[: hg.n] for p in parts])
    partners = popshard.ring_partners(stacked, shard=shard, device=device)
    partner_cuts = np.roll(np.asarray(cuts, np.float64), -1)
    new_parts, new_cuts = [], []
    for i in range(alpha):
        off, c = recombine(hg, stacked[i], partners[i],
                           float(cuts[i]), float(partner_cuts[i]),
                           k, eps, seed=seed * 1009 + i, shard=shard,
                           model_shard=model_shard, device=device)
        new_parts.append(np.asarray(off, np.int32)[: hg.n])
        new_cuts.append(c)
    return np.stack(new_parts), np.asarray(new_cuts, np.float64)
