"""Initial partitioning portfolio on the coarsest hypergraph (port of
``repro.core.initial_partition``: the numpy constructions are copied,
the refinement is the port's batched ``refine_population``).

Mirrors KaHyPar's pool approach: several cheap constructions, each
FM-refined, best kept.  Each population member draws a different seed, so
the paper's "alpha diverse solutions" requirement (Sec. 3.1.1) is met.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .hypergraph import Hypergraph
from . import refine as refine_mod


def random_balanced(hg: Hypergraph, k: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """Shuffled greedy fill into the currently lightest block."""
    order = rng.permutation(hg.n)
    part = np.zeros(hg.n, np.int32)
    bw = np.zeros(k)
    # sort heavy vertices first within the shuffle for tighter balance
    heavy = np.argsort(-hg.vertex_weights[order], kind="stable")
    for v in order[heavy]:
        b = int(np.argmin(bw))
        part[v] = b
        bw[b] += hg.vertex_weights[v]
    return part


def linear_blocks(hg: Hypergraph, k: int, rng: np.random.Generator
                  ) -> np.ndarray:
    """Contiguous ranges of a random rotation of vertex ids (captures any
    locality present in the input ordering)."""
    shift = int(rng.integers(hg.n)) if hg.n else 0
    ids = (np.arange(hg.n) + shift) % hg.n
    target = hg.total_weight / k
    csum = np.cumsum(hg.vertex_weights[np.argsort(ids)])
    part = np.minimum((csum / max(target, 1e-9)).astype(np.int32), k - 1)
    out = np.zeros(hg.n, np.int32)
    out[np.argsort(ids)] = part
    return out


def bfs_growth(hg: Hypergraph, k: int, rng: np.random.Generator
               ) -> np.ndarray:
    """Multi-source capacity-bounded BFS region growth over the incidence
    structure (greedy hypergraph variant of GGGP)."""
    incident, voff = hg.dual()
    part = np.full(hg.n, -1, np.int32)
    target = hg.total_weight / k
    seeds = rng.choice(hg.n, size=min(k, hg.n), replace=False)
    frontiers = [[int(s)] for s in seeds]
    bw = np.zeros(k)
    eoff = hg.edge_offsets
    pins = hg.pins
    for b, s in enumerate(seeds):
        part[s] = b
        bw[b] += hg.vertex_weights[s]
    active = True
    while active:
        active = False
        for b in range(min(k, hg.n)):
            if bw[b] >= target or not frontiers[b]:
                continue
            nxt = []
            for v in frontiers[b]:
                for e in incident[voff[v]:voff[v + 1]]:
                    for u in pins[eoff[e]:eoff[e + 1]]:
                        if part[u] < 0 and bw[b] < target * 1.05:
                            part[u] = b
                            bw[b] += hg.vertex_weights[u]
                            nxt.append(int(u))
            frontiers[b] = nxt
            active = active or bool(nxt)
    # leftovers -> lightest block
    for v in np.nonzero(part < 0)[0]:
        b = int(np.argmin(bw))
        part[v] = b
        bw[b] += hg.vertex_weights[v]
    return part


STRATEGIES = (random_balanced, linear_blocks, bfs_growth)


def initial_partition_population(hg: Hypergraph, k: int, eps: float,
                                 seeds, tries_per_strategy: int = 2,
                                 hga=None,
                                 device: str | torch.device = "cuda"):
    """Portfolio x population initial partitioning in ONE batched
    refinement dispatch.

    The cheap host constructions (``STRATEGIES``) run per (member, try)
    with each member's own rng — identical draws to the sequential
    ``initial_partition`` loop — and the whole
    ``len(seeds) * len(STRATEGIES) * tries_per_strategy`` candidate stack
    then refines through ``refine_population`` (LP + coarse FM) in one
    batch instead of one dispatch chain per candidate.  Per-candidate
    trajectories are bit-identical to the scalar path, so the best-of
    selection returns exactly what the sequential loop returned.

    ``hga``: pass the (possibly device-born) arrays of ``hg`` to avoid a
    host->device re-ship when the caller already holds them; otherwise
    ``hg``'s arrays are built on ``device``.

    Returns ``(parts [len(seeds), n], cuts [len(seeds)])``.
    """
    hga = hga if hga is not None else hg.arrays(device=device)
    cands, owner = [], []
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        for strat in STRATEGIES:
            for _ in range(tries_per_strategy):
                part = strat(hg, k, rng)
                part = refine_mod.rebalance(hg.vertex_weights, part, k,
                                            eps, rng)
                cands.append(np.asarray(part, np.int32)[: hg.n])
                owner.append(i)
    parts, cuts = refine_mod.refine_population(hga, np.stack(cands), k, eps,
                                               device=hga.device)
    parts = parts.cpu().numpy()
    owner = np.asarray(owner)
    out_p = np.zeros((len(seeds), hg.n), np.int32)
    out_c = np.zeros(len(seeds), np.float64)
    for i in range(len(seeds)):
        idx = np.nonzero(owner == i)[0]
        best = idx[int(np.argmin(cuts[idx]))]
        out_p[i] = parts[best][: hg.n]
        out_c[i] = cuts[best]
    return out_p, out_c


def initial_partition(hg: Hypergraph, k: int, eps: float, seed: int,
                      tries_per_strategy: int = 2,
                      device: str | torch.device = "cuda"
                      ) -> Tuple[np.ndarray, float]:
    """Best-of-portfolio initial partition, FM-refined.  The portfolio
    refines as one batch (population of one member)."""
    parts, cuts = initial_partition_population(
        hg, k, eps, [seed], tries_per_strategy=tries_per_strategy,
        device=device)
    return parts[0].copy(), float(cuts[0])
