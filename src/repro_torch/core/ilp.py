"""Exact solver for tiny clustered instances (port of ``repro.core.ilp``,
numpy only and copied, so both packages return the same part and cut).

The paper hands instances with ``n' * k < 600`` to Gurobi ILP (with
symmetry breaking and warm start).  No external MILP solver is part of
the deployment, so this is a branch-and-bound over cluster assignments
with the same two accelerations the paper uses:

* **symmetry breaking** — vertex v may only open block ``i <= v`` (first
  occurrence order), exactly the paper's rule;
* **warm start** — the incumbent is initialised with the better parent.

It is exact given enough node budget; with a budget it degrades into an
anytime solver that still returns the best incumbent.  Tests use it to
verify that the annealed/FM clustered solver reaches optimal cuts on
paper-threshold-sized instances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .hypergraph import Hypergraph


def solve_exact(hg: Hypergraph, k: int, eps: float,
                warm_start: Optional[np.ndarray] = None,
                node_budget: int = 2_000_000) -> Tuple[np.ndarray, float]:
    """Branch & bound k-way min-cut under the paper's balance constraint.

    Vertices are branched in decreasing-weight order (tighter balance
    pruning).  Bound: cut of fully-decided edges (exact, admissible).
    """
    n, m = hg.n, hg.m
    total = hg.total_weight
    cap = (1.0 + eps) * np.ceil(total / k)
    order = np.argsort(-hg.vertex_weights, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)

    # edge pin lists in branching order
    sizes = hg.edge_sizes()
    incident, voff = hg.dual()

    best_cut = np.inf
    best_part = None
    if warm_start is not None:
        ws = np.asarray(warm_start, np.int64)
        bw = np.zeros(k)
        np.add.at(bw, ws, hg.vertex_weights)
        if (bw <= cap + 1e-6).all():
            best_cut = _cut(hg, ws, k)
            best_part = ws.astype(np.int32)

    # iterative DFS
    part = np.full(n, -1, np.int64)
    bw = np.zeros(k)
    # per-edge state: first seen block (-2 none), is_cut flag, #assigned pins
    first_blk = np.full(m, -2, np.int64)
    edge_cut = np.zeros(m, bool)
    cur_cut = 0.0
    rem_weight = np.cumsum(hg.vertex_weights[order][::-1])[::-1]  # suffix sums

    nodes = 0
    depth = 0
    choice = np.zeros(n + 1, np.int64)  # next block to try at each depth
    opened = np.zeros(n + 1, np.int64)  # blocks opened so far (symmetry)
    opened[0] = 0
    # undo stacks per depth
    undo_edges: list = [None] * (n + 1)

    while depth >= 0:
        v = order[depth] if depth < n else -1
        if depth == n:
            if cur_cut < best_cut - 1e-9:
                best_cut = cur_cut
                best_part = part.astype(np.int32).copy()
            depth -= 1
            continue
        b = choice[depth]
        # undo previous assignment at this depth, if any
        if part[v] >= 0:
            pb = part[v]
            bw[pb] -= hg.vertex_weights[v]
            es, fb, ec, dc = undo_edges[depth]
            first_blk[es] = fb
            edge_cut[es] = ec
            cur_cut -= dc
            part[v] = -1
        max_b = min(opened[depth] + 1, k)  # symmetry breaking
        if b >= max_b or nodes >= node_budget:
            choice[depth] = 0
            depth -= 1
            if depth >= 0:
                choice[depth] += 1
            continue
        nodes += 1
        # feasibility: balance
        if bw[b] + hg.vertex_weights[v] > cap + 1e-6:
            choice[depth] += 1
            continue
        # remaining weight must still fit somewhere (weak but cheap)
        free_cap = (cap - bw).sum() - hg.vertex_weights[v]
        if depth + 1 < n and rem_weight[depth + 1] > free_cap + 1e-6:
            choice[depth] += 1
            continue
        # assign, update edge state + bound
        es = incident[voff[v]:voff[v + 1]]
        fb_save = first_blk[es].copy()
        ec_save = edge_cut[es].copy()
        dcut = 0.0
        for e in es:
            if edge_cut[e]:
                continue
            if first_blk[e] == -2:
                first_blk[e] = b
            elif first_blk[e] != b:
                edge_cut[e] = True
                dcut += float(hg.edge_weights[e])
        if cur_cut + dcut >= best_cut - 1e-9:  # bound
            first_blk[es] = fb_save
            edge_cut[es] = ec_save
            choice[depth] += 1
            continue
        part[v] = b
        bw[b] += hg.vertex_weights[v]
        cur_cut += dcut
        undo_edges[depth] = (es, fb_save, ec_save, dcut)
        opened[depth + 1] = max(opened[depth], b + 1)
        depth += 1
        choice[depth] = 0

    if best_part is None:
        raise RuntimeError("no feasible partition found (eps too tight?)")
    return best_part, float(best_cut)


def _cut(hg: Hypergraph, part: np.ndarray, k: int) -> float:
    cut = 0.0
    for e in range(hg.m):
        p = part[hg.pins[hg.edge_offsets[e]:hg.edge_offsets[e + 1]]]
        if len(np.unique(p)) > 1:
            cut += float(hg.edge_weights[e])
    return cut
