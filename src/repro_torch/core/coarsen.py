"""Coarsening: level-parallel heavy-edge matching (host numpy; port of
``repro.core.coarsen``, copied so the host engine builds identical
hierarchies).

Adaptation note (see DESIGN.md §3): KaHyPar's n-level scheme removes a
single vertex pair per level — inherently sequential.  We use the standard
scalable alternative (Mt-KaHyPar-style): per round, every vertex picks its
best-rated partner, mutual pairs whose combined weight fits the cluster cap
are contracted, and the round repeats until the contraction limit.  The
paper's beta recombination thresholds are applied over this level schedule
with the exact geometric formula from Sec. 3.1.1.

Rating (heavy-edge, weight-normalised, as in hMETIS/KaHyPar):
    r(u, v) = sum_{e ⊇ {u,v}} w_e / (|e| - 1)  /  (c(u) * c(v))
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .hypergraph import Hypergraph, HypergraphArrays, contract


# --------------------------------------------------------------------------
# round schedule — the single source of truth for "when does coarsening
# stop", shared by this host coarsener and the device one (core/dcoarsen)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """Stopping/capping policy of the round-based coarsener.

    Both coarsening paths (host numpy and the device engine) derive their
    control flow from one instance, so "same round schedule" is a
    structural property, not a convention the parity tests merely hope
    for."""
    target: int        # stop once n <= target (contraction limit)
    c_max: float       # cluster weight cap (KaHyPar-style)
    max_rounds: int
    min_shrink: float  # a round shrinking less than this fraction stalls

    def done(self, n_cur: int) -> bool:
        return n_cur <= self.target

    def stalled(self, n_cur: int, n_new: int) -> bool:
        return n_new >= n_cur * (1.0 - self.min_shrink)


def round_schedule(hg: Hypergraph, k: int, *,
                   contraction_limit_factor: int = 64, max_rounds: int = 64,
                   min_shrink: float = 0.02,
                   max_cluster_frac: float = 1.0) -> RoundSchedule:
    """Coarsen down to ~``contraction_limit_factor * k`` vertices, capping
    cluster weight so the coarsest vertices stay refinable."""
    target = max(contraction_limit_factor * k, 8)
    total_w = hg.total_weight
    c_max = max_cluster_frac * max(
        total_w / target * 4.0,
        float(hg.vertex_weights.max()) if hg.n else 1.0,
    )
    return RoundSchedule(target=target, c_max=c_max, max_rounds=max_rounds,
                         min_shrink=min_shrink)


@dataclasses.dataclass
class Level:
    """One coarsening level: the coarse hypergraph plus the mapping from
    the finer level's vertices onto it."""
    hg: Hypergraph
    cluster_id: np.ndarray  # [n_finer] -> [0, hg.n)
    # partition-aware hierarchies carry the input partition projected to
    # this level (exact: only same-block vertices merge)
    part: Optional[np.ndarray] = None


@dataclasses.dataclass
class Hierarchy:
    """levels[0] is the original hypergraph (cluster_id = identity).

    The driver-facing accessors below (``num_levels`` .. ``project_pop``)
    form the hierarchy protocol shared with the device-resident
    ``dcoarsen.HierarchyArrays`` — ``impart_partition`` and ``vcycle``
    are written against the protocol and never ask which engine built
    the hierarchy."""
    levels: List[Level]
    # device of ``level_arrays`` / ``project_pop`` (set by build_hierarchy)
    device: torch.device = torch.device("cpu")

    @property
    def coarsest(self) -> Hypergraph:
        return self.levels[-1].hg

    @property
    def original(self) -> Hypergraph:
        return self.levels[0].hg

    def sizes(self) -> List[int]:
        return [lv.hg.n for lv in self.levels]

    def project_to_level(self, part_coarse: np.ndarray, from_level: int,
                         to_level: int) -> np.ndarray:
        """Project a partition at ``from_level`` down to finer ``to_level``
        (to_level < from_level)."""
        part = np.asarray(part_coarse)
        for li in range(from_level, to_level, -1):
            part = part[self.levels[li].cluster_id]
        return part

    # -------------------------------------------------- hierarchy protocol
    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_n(self, li: int) -> int:
        return self.levels[li].hg.n

    def level_arrays(self, li: int) -> HypergraphArrays:
        """Device arrays for refinement at level ``li`` (cached on the
        host hypergraph — built once per level)."""
        return self.levels[li].hg.arrays(device=self.device)

    def level_host(self, li: int) -> Hypergraph:
        """Host CSR hypergraph at level ``li`` (for the irregular host
        operators: recombination overlays, mutation reweighting)."""
        return self.levels[li].hg

    def level_part(self, li: int) -> Optional[np.ndarray]:
        return self.levels[li].part

    def project_pop(self, parts, li: int) -> torch.Tensor:
        """Project a (possibly padded) population [alpha, >= n_li] at
        level ``li`` onto the finer level ``li - 1`` (a tensor on
        ``device``)."""
        parts = torch.as_tensor(parts, device=self.device)
        cid = torch.as_tensor(self.levels[li].cluster_id, device=self.device)
        return parts[:, cid.long()]


# --------------------------------------------------------------------------
# pair generation + rating
# --------------------------------------------------------------------------
def _candidate_pairs(hg: Hypergraph, max_edge_size: int = 512,
                     max_stride: int = 4,
                     restrict_part: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised pair candidates with heavy-edge ratings.

    For each edge we emit pin pairs at strides 1..min(|e|-1, max_stride):
    full coverage for small edges, a structured sample for large ones.
    Edges above ``max_edge_size`` are skipped for rating (standard
    practice — huge nets carry almost no locality signal).
    """
    sizes = hg.edge_sizes()
    eids = hg.pin_edge_ids()
    pins = hg.pins
    ok_edge = sizes <= max_edge_size
    rating_unit = np.where(
        sizes > 1, hg.edge_weights / np.maximum(sizes - 1, 1), 0.0
    ).astype(np.float64)

    us, vs, rs = [], [], []
    p = len(pins)
    if p == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    offs = np.repeat(hg.edge_offsets[:-1], sizes)  # start offset per pin
    idx = np.arange(p, dtype=np.int64)
    local = idx - offs
    for d in range(1, max_stride + 1):
        sel = (local + d < sizes[eids]) & ok_edge[eids]
        if not sel.any():
            continue
        u = pins[idx[sel]]
        v = pins[idx[sel] + d]
        r = rating_unit[eids[sel]]
        us.append(u)
        vs.append(v)
        rs.append(r)
    if not us:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    u = np.concatenate(us).astype(np.int64)
    v = np.concatenate(vs).astype(np.int64)
    r = np.concatenate(rs)
    if restrict_part is not None:  # partition-aware (V-cycle) coarsening
        same = restrict_part[u] == restrict_part[v]
        u, v, r = u[same], v[same], r[same]
    # aggregate duplicate pairs
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi
    lo, hi, r = lo[keep], hi[keep], r[keep]
    if len(lo) == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    key = lo * hg.n + hi
    order = np.argsort(key, kind="stable")
    key_s, lo_s, hi_s, r_s = key[order], lo[order], hi[order], r[order]
    new_grp = np.ones(len(key_s), bool)
    new_grp[1:] = key_s[1:] != key_s[:-1]
    grp = np.cumsum(new_grp) - 1
    n_grp = grp[-1] + 1
    agg = np.zeros(n_grp, np.float64)
    np.add.at(agg, grp, r_s)
    first = np.nonzero(new_grp)[0]
    lo_u, hi_u = lo_s[first], hi_s[first]
    # normalise by cluster weights (prefer merging light vertices)
    cw = hg.vertex_weights.astype(np.float64)
    agg = agg / np.maximum(cw[lo_u] * cw[hi_u], 1e-12)
    return lo_u, hi_u, agg


def _mutual_match(n: int, u: np.ndarray, v: np.ndarray, r: np.ndarray,
                  weights: np.ndarray, max_cluster_weight: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Best-partner mutual matching.  Returns cluster_id [n] (renumbered)."""
    partner = np.full(n, -1, np.int64)
    if len(u):
        # both directions; random jitter breaks rating ties reproducibly
        uu = np.concatenate([u, v])
        vv = np.concatenate([v, u])
        rr = np.concatenate([r, r]) * (1.0 + 1e-9 * rng.random(2 * len(u)))
        # weight-cap filter
        okw = weights[uu] + weights[vv] <= max_cluster_weight
        uu, vv, rr = uu[okw], vv[okw], rr[okw]
        if len(uu):
            order = np.lexsort((-rr, uu))
            uu_s, vv_s = uu[order], vv[order]
            first = np.ones(len(uu_s), bool)
            first[1:] = uu_s[1:] != uu_s[:-1]
            partner[uu_s[first]] = vv_s[first]
    matched_to = np.full(n, -1, np.int64)
    has = partner >= 0
    cand = np.nonzero(has)[0]
    mutual = cand[(partner[partner[cand]] == cand) & (partner[cand] != cand)]
    # each mutual pair appears twice; keep u < partner[u]
    pairs = mutual[mutual < partner[mutual]]
    matched_to[pairs] = partner[pairs]
    cluster = np.arange(n, dtype=np.int64)
    cluster[matched_to[pairs]] = pairs  # partner joins the smaller id
    # second chance: unmatched vertex whose best partner stayed single
    single = (cluster == np.arange(n)) & ~np.isin(np.arange(n), pairs)
    cand2 = np.nonzero(single & has)[0]
    tgt = partner[cand2]
    tgt_single = (cluster[tgt] == tgt) & ~np.isin(tgt, pairs)
    okw2 = weights[cand2] + weights[tgt] <= max_cluster_weight
    take = tgt_single & okw2 & (tgt != cand2)
    # conflicts (two vertices picking the same single target): keep first
    cand2, tgt = cand2[take], tgt[take]
    if len(cand2):
        order = np.argsort(tgt, kind="stable")
        cand2, tgt = cand2[order], tgt[order]
        first = np.ones(len(tgt), bool)
        first[1:] = tgt[1:] != tgt[:-1]
        # target must not itself be a source
        src_set = np.zeros(n, bool)
        src_set[cand2[first]] = True
        sel = first & ~src_set[tgt]
        cluster[cand2[sel]] = tgt[sel]
    # renumber densely
    _, dense = np.unique(cluster, return_inverse=True)
    return dense.astype(np.int32)


# --------------------------------------------------------------------------
# the coarsener
# --------------------------------------------------------------------------
def coarsen(hg: Hypergraph, k: int, *, contraction_limit_factor: int = 64,
            max_rounds: int = 64, min_shrink: float = 0.02,
            seed: int = 0, restrict_part: Optional[np.ndarray] = None,
            max_cluster_frac: float = 1.0) -> Hierarchy:
    """Build the multilevel hierarchy down to ~contraction_limit_factor * k
    vertices.  ``restrict_part`` enables partition-aware (V-cycle)
    coarsening: only same-block vertices may merge."""
    rng = np.random.default_rng(seed)
    sched = round_schedule(
        hg, k, contraction_limit_factor=contraction_limit_factor,
        max_rounds=max_rounds, min_shrink=min_shrink,
        max_cluster_frac=max_cluster_frac)
    cur_part = (None if restrict_part is None
                else np.asarray(restrict_part, np.int32))
    levels = [Level(hg=hg, cluster_id=np.arange(hg.n, dtype=np.int32),
                    part=cur_part)]
    cur = hg
    for _ in range(sched.max_rounds):
        if sched.done(cur.n):
            break
        u, v, r = _candidate_pairs(cur, restrict_part=cur_part)
        cluster = _mutual_match(cur.n, u, v, r, cur.vertex_weights,
                                sched.c_max, rng)
        n_new = int(cluster.max()) + 1 if len(cluster) else 0
        if sched.stalled(cur.n, n_new):
            break
        # do not overshoot far below the target
        coarse, cmap = contract(cur, cluster, n_new)
        if cur_part is not None:
            # block id of each cluster = block of any member (same by constr.)
            newp = np.zeros(n_new, cur_part.dtype)
            newp[cmap] = cur_part
            cur_part = newp
        levels.append(Level(hg=coarse, cluster_id=cmap, part=cur_part))
        cur = coarse
    return Hierarchy(levels=levels)


def recombination_thresholds(n: int, n_c: int, beta: int) -> np.ndarray:
    """Paper Sec. 3.1.1: geometric schedule over the uncoarsening
    trajectory: { n_c^(1-i/beta) * n^(i/beta) : i = 1..beta }."""
    i = np.arange(1, beta + 1, dtype=np.float64)
    return np.power(float(max(n_c, 1)), 1.0 - i / beta) * np.power(
        float(max(n, 1)), i / beta
    )
