"""Mutation / diversity enhancement (port of ``repro.core.mutate``; paper
Sec. 3.2, DESIGN.md §10).

After a recombination round the offspring are sorted by cut (best
first); for each offspring S_j, M(S_j) = { better offspring S_i :
d_e(S_i, S_j) < t }.  A non-empty M(S_j) re-partitions S_j on a
reweighted hypergraph

    w'_e = w_e * (1 + mu * C_{M(S_j)}(e)),   mu = 0.1, t = 20  (paper)

where C counts how many members of M(S_j) cut e.  All flagged members
share one structure and differ only in their edge weights, so the cohort
runs one population V-cycle (``vcycle.vcycle_population``).

``REPRO_MUTATE_PATH=batch|loop`` routes the cohort: ``batch`` (auto)
dispatches each per-member stage once for the whole cohort (the rating
sums through the batched rating kernel); ``loop`` runs the same pipeline
member by member and gives the same partitions and cuts.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device, warn_env_once
from .hypergraph import Hypergraph
from . import metrics
from . import refine as refine_mod
from .vcycle import vcycle_population

MUTATE_PATHS = ("batch", "loop")


def mutate_path() -> str:
    """Cohort dispatch: ``REPRO_MUTATE_PATH=batch|loop`` forces one;
    auto (unset) is ``batch``."""
    env = os.environ.get("REPRO_MUTATE_PATH", "auto").strip().lower()
    if env in MUTATE_PATHS:
        return env
    if env not in ("", "auto"):
        warn_env_once("REPRO_MUTATE_PATH", env, "batch (auto)")
    return "batch"


def similarity_sets(hga, parts, cuts, k: int,
                    threshold: float) -> List[List[int]]:
    """M(S_j) for each offspring, with the label-invariant edge distance
    d_e (paper Eq. 2); all alpha^2 distances come from one batched
    connectivity computation (``metrics.edge_distance_matrix``)."""
    alpha = len(parts)
    order = np.argsort(np.asarray(cuts), kind="stable")  # best first
    padded = refine_mod.pad_parts(parts, hga.n_pad, hga.device)
    dmat = metrics.edge_distance_matrix(hga, padded, k).cpu().numpy()
    msets: List[List[int]] = [[] for _ in range(alpha)]
    for pos_j in range(alpha):
        j = int(order[pos_j])
        for pos_i in range(pos_j):
            i = int(order[pos_i])
            if dmat[i, j] < threshold:
                msets[j].append(i)
    return msets


def mutate_population(hg: Hypergraph, parts, cuts, k: int, eps: float,
                      threshold: float = 20.0, mu: float = 0.1,
                      seed: int = 0, path: Optional[str] = None,
                      shard: Optional[str] = None,
                      model_shard: Optional[str] = None,
                      device: str | torch.device = "cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the mutation operator on ``device`` to every offspring with
    a non-empty similarity set.  Returns the updated population
    (stacked [alpha, n]) and its true (unweighted) cuts."""
    dev = resolve_device(device)
    hga = hg.arrays(device=dev)
    msets = similarity_sets(hga, parts, cuts, k, threshold)
    new_parts = np.stack([np.asarray(p, np.int32)[: hg.n] for p in parts])
    new_cuts = np.asarray(cuts, np.float64).copy()

    # [alpha, m] cut indicators of every member, one batched computation
    lam_all = metrics.connectivity_population(
        hga, refine_mod.pad_parts(new_parts, hga.n_pad, dev),
        k).cpu().numpy()[:, : hg.m]
    cut_ind = (lam_all > 1).astype(np.float64)

    mutated_js = [j for j, mset in enumerate(msets) if mset]
    if not mutated_js:
        return new_parts, new_cuts

    # per-member reweights over the shared structure: [alpha_f, m]
    w_pop = np.stack([
        hg.edge_weights * (1.0 + mu * cut_ind[np.asarray(msets[j],
                                                         np.int64)]
                           .sum(axis=0))
        for j in mutated_js]).astype(np.float32)
    mutated, _ = vcycle_population(hg, new_parts[mutated_js], w_pop, k,
                                   eps, seed=seed * 7919, path=path,
                                   shard=shard, model_shard=model_shard,
                                   device=dev)
    new_parts[mutated_js] = mutated

    # report true (unweighted) cuts
    new_cuts[mutated_js] = metrics.cutsize_population(
        hga, refine_mod.pad_parts(new_parts[mutated_js], hga.n_pad, dev),
        k).cpu().numpy().astype(np.float64)
    return new_parts, new_cuts
