"""Device-resident coarsening engine (port of ``repro.core.dcoarsen``,
single-device path; DESIGN.md §3).

Each round runs on the device, on fixed padded shapes, so every level's
``HypergraphArrays`` is born there:

1. **pair rating** — heavy-edge candidates from stride-shifted views of
   the edge-contiguous pin array; duplicate pairs made adjacent by one
   stable sort on the int64 key ``lo * n_pad + hi`` and their ratings
   ``r(u, v) = sum_e w_e / (|e| - 1)`` aggregated by the rating kernel
   (``kernels.ops.rating_segment_sum``), then normalised by
   ``c(u) * c(v)``;
2. **best-partner mutual matching** — argmax by scatter-max with a
   tie-jitter vector drawn from a ``torch.Generator`` seeded by ``seed``
   (the reference draws it from ``jax.random``; the bits differ, so the
   two engines agree on cut quality, not on matchings), weight cap,
   mutual pairs, the single-vertex second chance, dense renumbering;
3. **contraction** — ``hypergraph.contract_arrays``.

Both engines take their control flow from ``coarsen.round_schedule``.
``REPRO_COARSEN_PATH=device|host`` forces an engine; auto picks the
device engine on a CUDA device and the numpy engine on the CPU.

The mutation cohort takes a third road (DESIGN.md §10):
``population_coarsen`` builds one shared-structure hierarchy for all
flagged members at once, always with the device engine (on CPU tensors
too, as the reference does): candidate pairs restricted to vertices
that share a block in every member, per-member ratings aggregated by
the batched rating kernel (``ops.rating_segment_sum_batch``), one
consensus matching from the members' ratings summed in member order,
and one contraction that carries every member's edge-weight row.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.env import resolve_device, warn_env_once
from .hypergraph import (Hypergraph, HypergraphArrays, HierarchyArrays,
                         DeviceLevel, contract_arrays, _pad_cols,
                         _round_pow2, _INCIDENCE_LANE_PAD,
                         _INCIDENCE_MAX_EXPANSION)
from .coarsen import Hierarchy, coarsen, round_schedule

#: Pair-candidate sampling, mirroring the host ``_candidate_pairs``
#: defaults: strides 1..MAX_STRIDE within each edge; edges larger than
#: MAX_EDGE_SIZE carry almost no locality signal and are skipped.
MAX_STRIDE = 4
MAX_EDGE_SIZE = 512

COARSEN_PATHS = ("device", "host")


def coarsen_path(device: str | torch.device = "cuda") -> str:
    """Engine selection: ``REPRO_COARSEN_PATH=device|host`` forces one;
    auto takes the device engine on a CUDA device and the numpy engine
    on the CPU."""
    env = os.environ.get("REPRO_COARSEN_PATH", "auto").strip().lower()
    if env in COARSEN_PATHS:
        return env
    if env not in ("", "auto"):
        warn_env_once("REPRO_COARSEN_PATH", env, "auto routing")
    return "device" if torch.device(device).type == "cuda" else "host"


def build_hierarchy(hg: Hypergraph, k: int, *, seed: int = 0,
                    restrict_part=None, contraction_limit_factor: int = 64,
                    max_rounds: int = 64, min_shrink: float = 0.02,
                    max_cluster_frac: float = 1.0,
                    path: Optional[str] = None,
                    model_shard: Optional[str] = None,
                    device: str | torch.device = "cuda"
                    ) -> Union[Hierarchy, HierarchyArrays]:
    """Build the multilevel hierarchy with the engine picked by
    ``coarsen_path()`` (or forced via ``path``).  Both return types
    implement the hierarchy protocol the driver consumes; their level
    arrays live on ``device``."""
    if model_shard not in (None, "off", "auto"):
        raise NotImplementedError(
            f"model_shard={model_shard!r} belongs to a later slice of the "
            "port (multi-device paths)")
    dev = resolve_device(device)
    path = path or coarsen_path(dev)
    if path == "host":
        hier = coarsen(hg, k, contraction_limit_factor=contraction_limit_factor,
                       max_rounds=max_rounds, min_shrink=min_shrink,
                       seed=seed, restrict_part=restrict_part,
                       max_cluster_frac=max_cluster_frac)
        hier.device = dev
        return hier
    return device_coarsen(hg, k,
                          contraction_limit_factor=contraction_limit_factor,
                          max_rounds=max_rounds, min_shrink=min_shrink,
                          seed=seed, restrict_part=restrict_part,
                          max_cluster_frac=max_cluster_frac, device=dev)


# --------------------------------------------------------------------------
# one round: rate -> match -> contract
# --------------------------------------------------------------------------
def _stride_candidates(hga: HypergraphArrays, *, max_stride: int,
                       max_edge_size: int):
    """Stride-shifted candidate pairs over the edge-contiguous pin array.

    Returns ``(u, v, valid, pe_cat)``, each [C = max_stride * p_pad]
    int64/bool: the raw endpoints, the structure-only validity mask
    (same edge, rateable edge size, distinct endpoints), and the edge id
    of every candidate slot.
    """
    m_pad = hga.m_pad
    ghost_v = hga.n_pad - 1
    pv, pe = hga.pin_vertex.long(), hga.pin_edge.long()
    sizes = hga.edge_sizes
    ok_edge = (sizes > 1) & (sizes <= max_edge_size)
    us, vs, valids = [], [], []
    for d in range(1, max_stride + 1):
        v = torch.cat([pv[d:], torch.full((d,), ghost_v, dtype=pv.dtype,
                                          device=pv.device)])
        e2 = torch.cat([pe[d:], torch.full((d,), m_pad - 1, dtype=pe.dtype,
                                           device=pe.device)])
        us.append(pv)
        vs.append(v)
        valids.append((pe == e2) & ok_edge[pe] & (pv != v))
    return (torch.cat(us), torch.cat(vs), torch.cat(valids),
            pe.repeat(max_stride))


def _sort_pairs(hga: HypergraphArrays, u: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor):
    """Sort candidate pairs so duplicates are adjacent, ghosts last.

    Returns ``(lo, hi, order, seg)``: the sorted endpoints (int64), the
    stable sort permutation of the candidate slots, and the sorted
    segment id of every slot (int32, one id per distinct pair)."""
    n_pad = hga.n_pad
    ghost_v = n_pad - 1
    lo = torch.where(valid, torch.minimum(u, v), ghost_v)
    hi = torch.where(valid, torch.maximum(u, v), ghost_v)
    order = torch.argsort(lo * n_pad + hi, stable=True)
    lo, hi = lo[order], hi[order]
    c = lo.shape[0]
    newg = torch.ones(c, dtype=torch.bool, device=lo.device)
    newg[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    seg = (torch.cumsum(newg.to(torch.int32), 0) - 1).to(torch.int32)
    return lo, hi, order, seg


def _sorted_candidates(hga: HypergraphArrays, part, *, max_stride: int,
                       max_edge_size: int):
    """Candidate pairs sorted so duplicates are adjacent, ghosts last.

    Returns ``(lo, hi, r, seg)``, each [C]: the sorted endpoints (int64),
    their unnormalised ratings ``w_e / (|e| - 1)`` (f32, 0 for ghosts)
    and the sorted segment id of every slot (int32, one id per distinct
    pair).  ``part`` (optional) restricts candidates to same-block pairs.
    The sort is stable on the exact int64 key ``lo * n_pad + hi``, so
    the keys are those of the reference and ``r`` keeps candidate order
    inside every run.
    """
    sizes = hga.edge_sizes
    unit = torch.where(sizes > 1,
                       hga.edge_weights / torch.clamp(sizes - 1, min=1), 0.0)
    u, v, valid, pe_cat = _stride_candidates(
        hga, max_stride=max_stride, max_edge_size=max_edge_size)
    if part is not None:
        valid = valid & (part[u] == part[v])
    r = torch.where(valid, unit[pe_cat], 0.0)
    lo, hi, order, seg = _sort_pairs(hga, u, v, valid)
    return lo, hi, r[order], seg


def _pair_ratings(hga: HypergraphArrays, part, *, max_stride: int,
                  max_edge_size: int):
    """Aggregated, weight-normalised heavy-edge pair ratings.

    Returns ``(lo, hi, rating)``, each [C = max_stride * p_pad]: one
    slot per distinct candidate pair (indexed by its segment id), ghost
    slots carrying ``lo == hi == n_pad - 1`` and rating 0.
    """
    from repro_torch.kernels import ops
    lo, hi, r, seg = _sorted_candidates(hga, part, max_stride=max_stride,
                                        max_edge_size=max_edge_size)
    agg = ops.rating_segment_sum(r, seg, lo.shape[0])
    lo_g, hi_g, norm = _representatives(hga, lo, hi, seg)
    return lo_g, hi_g, agg / norm


def _representatives(hga: HypergraphArrays, lo: torch.Tensor,
                     hi: torch.Tensor, seg: torch.Tensor):
    """Representative (lo, hi) per segment slot (ghost for unused slots)
    and the weight normalisation ``c(lo) * c(hi)`` (floored at 1e-12)."""
    ghost_v = hga.n_pad - 1
    c = lo.shape[0]
    seg64 = seg.long()
    lo_g = torch.full((c,), ghost_v, dtype=torch.int64,
                      device=lo.device).scatter_reduce(0, seg64, lo, "amin")
    hi_g = torch.full((c,), ghost_v, dtype=torch.int64,
                      device=lo.device).scatter_reduce(0, seg64, hi, "amin")
    cw = hga.vertex_weights
    return lo_g, hi_g, torch.clamp(cw[lo_g] * cw[hi_g], min=1e-12)


def draw_jitter(gen: torch.Generator, c: int,
                device: torch.device) -> torch.Tensor:
    """The matching's tie-jitter for ``c`` candidate slots: ``2 * c``
    uniforms in [0, 1), drawn on the CPU generator and moved to
    ``device`` (the same draws on every device)."""
    return torch.rand(2 * c, generator=gen, dtype=torch.float32).to(device)


def _mutual_match_dev(hga: HypergraphArrays, lo: torch.Tensor,
                      hi: torch.Tensor, rating: torch.Tensor,
                      jitter: torch.Tensor, c_max: float):
    """Best-partner mutual matching on the device.

    ``jitter`` [2 * C] holds uniforms in [0, 1) (the reference draws
    them with ``jax.random.uniform``; tests inject those to compare).
    Every scatter is an order-independent min/max, so the matching is a
    function of (ratings, jitter) alone.  Returns ``(cid, n_new)``:
    dense cluster ids [n_pad] int64 (ghost/pad slots -> ``n_pad - 1``)
    and the coarse vertex count (a 0-d tensor).
    """
    n_pad = hga.n_pad
    dev = lo.device
    arange = torch.arange(n_pad, device=dev)
    cw = hga.vertex_weights
    c_max = torch.tensor(c_max, dtype=torch.float32, device=dev)
    lo, hi = lo.long(), hi.long()

    uu = torch.cat([lo, hi])
    vv = torch.cat([hi, lo])
    # tie-jitter must be visible at f32 resolution: 1e-6 relative stays
    # far below any real rating difference while making ties seed-driven
    jit_r = 1.0 + 1e-6 * jitter
    rr = torch.cat([rating, rating]) * jit_r
    ok = ((torch.cat([lo, lo]) != torch.cat([hi, hi]))
          & (cw[uu] + cw[vv] <= c_max) & (rr > 0))

    score = torch.where(ok, rr, -1.0)
    best = torch.full((n_pad,), -1.0, device=dev).scatter_reduce(
        0, uu, score, "amax")
    hit = ok & (score == best[uu])
    partner = torch.full((n_pad,), n_pad, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, uu, torch.where(hit, vv, n_pad), "amin")
    has = partner < n_pad
    p_of = torch.where(has, partner, 0)
    mutual = has & (partner[p_of] == arange) & (partner != arange)
    cluster = torch.where(mutual & (arange > partner), p_of, arange)

    # second chance: unmatched vertex whose best partner stayed single
    single = (cluster == arange) & ~mutual
    cand = single & has
    tgt = torch.where(cand, p_of, n_pad - 1)
    tgt_ok = single[tgt] & (cw[arange] + cw[tgt] <= c_max) & (tgt != arange)
    want = cand & tgt_ok
    winner = torch.full((n_pad,), n_pad, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, tgt, torch.where(want, arange, n_pad), "amin")
    win = want & (winner[tgt] == arange)
    # a chosen target must not itself be a source
    sel = win & ~win[tgt]
    cluster = torch.where(sel, tgt, cluster)

    # dense renumbering (roots keep ascending order, like np.unique)
    is_root = (cluster == arange) & (arange < hga.n)
    new_id = torch.cumsum(is_root.to(torch.int64), 0) - 1
    n_new = is_root.sum()
    cid = torch.where(arange < hga.n, new_id[cluster], n_pad - 1)
    return cid, n_new


def _coarsen_round(hga: HypergraphArrays, part, jitter_gen, c_max: float,
                   max_stride: int, max_edge_size: int):
    lo, hi, rating = _pair_ratings(hga, part, max_stride=max_stride,
                                   max_edge_size=max_edge_size)
    jitter = draw_jitter(jitter_gen, lo.shape[0], lo.device)
    cid, n_new = _mutual_match_dev(hga, lo, hi, rating, jitter, c_max)
    coarse, p_new = contract_arrays(hga, cid, n_new)
    new_part = None
    if part is not None:
        # block of each cluster = block of any member (same by constr.)
        new_part = torch.zeros(hga.n_pad, dtype=torch.int32,
                               device=part.device).scatter_reduce(
            0, cid, part, "amax")
    return coarse, cid, new_part, p_new


# --------------------------------------------------------------------------
# host-side schedule loop
# --------------------------------------------------------------------------
def _rebucket(hga: HypergraphArrays, cid: torch.Tensor, part,
              n_pad2: int, m_pad2: int, p_pad2: int):
    """Slice a freshly contracted level down to its own pow2 padding
    bucket (ghost ids remapped)."""
    ghost_v = n_pad2 - 1
    ghost_e = m_pad2 - 1
    pv = hga.pin_vertex[:p_pad2]
    pe = hga.pin_edge[:p_pad2]
    pv = torch.where(pv >= hga.n, ghost_v, pv)
    pe = torch.where(pe >= hga.m, ghost_e, pe)
    out = HypergraphArrays(
        pin_vertex=pv.contiguous(), pin_edge=pe.contiguous(),
        vertex_weights=hga.vertex_weights[:n_pad2].contiguous(),
        edge_weights=hga.edge_weights[:m_pad2].contiguous(),
        edge_sizes=hga.edge_sizes[:m_pad2].contiguous(),
        n=hga.n, m=hga.m, incident=None,
        real_edge_weights=hga.real_edge_weights,
        real_vertex_weights=hga.real_vertex_weights,
    )
    cid = torch.where(cid >= hga.n, ghost_v, cid)
    part = None if part is None else part[:n_pad2].contiguous()
    return out, cid, part


def _incidence_dev(hga: HypergraphArrays, d_pad: int) -> torch.Tensor:
    """Dense [n_pad, d_pad] int32 incident-edge layout (pad = -1) built
    on the device — the analogue of ``Hypergraph.incidence_matrix``
    (edges ascending within each row)."""
    p_pad = hga.p_pad
    ghost_e = hga.m_pad - 1
    dev = hga.device
    pv, pe = hga.pin_vertex.long(), hga.pin_edge.long()
    order = torch.argsort(pv * hga.m_pad + pe, stable=True)
    pv, pe = pv[order], pe[order]
    arange_p = torch.arange(p_pad, device=dev)
    first = torch.full((hga.n_pad,), p_pad, dtype=torch.int64,
                       device=dev).scatter_reduce(0, pv, arange_p, "amin")
    col = arange_p - first[pv]
    live = (pe != ghost_e) & (col < d_pad)
    out = torch.full((hga.n_pad, d_pad), -1, dtype=torch.int32, device=dev)
    out[pv[live], col[live]] = pe[live].to(torch.int32)
    return out


def _attach_incident(hga: HypergraphArrays, m: int,
                     p: int) -> HypergraphArrays:
    """Attach the kernel gain layout when a kernel path is reachable,
    with ``HypergraphArrays.from_host``'s policy (lane padding and the
    hub-vertex expansion guard)."""
    from repro_torch.kernels import ops
    if not m or not ops.gain_layout_enabled(hga.device):
        return hga
    live = (hga.pin_edge != hga.m_pad - 1).to(torch.int32)
    deg = torch.zeros(hga.n_pad, dtype=torch.int32,
                      device=hga.device).index_add_(
        0, hga.pin_vertex.long(), live)
    deg[hga.n_pad - 1] = 0
    d_max = int(deg.max())  # one scalar readback, once per level
    d_pad = max(_round_pow2(max(d_max, 1), _INCIDENCE_LANE_PAD),
                _INCIDENCE_LANE_PAD)
    if hga.n_pad * d_pad > _INCIDENCE_MAX_EXPANSION * max(p, 1):
        return hga
    return dataclasses.replace(hga, incident=_incidence_dev(hga, d_pad))


def device_coarsen(hg: Hypergraph, k: int, *,
                   contraction_limit_factor: int = 64, max_rounds: int = 64,
                   min_shrink: float = 0.02, seed: int = 0,
                   restrict_part=None,
                   max_cluster_frac: float = 1.0,
                   device: str | torch.device = "cuda") -> HierarchyArrays:
    """Build the multilevel hierarchy on the device.

    The host keeps only the round schedule (shared with the numpy
    coarsener via ``coarsen.round_schedule``): each round it reads back
    three scalars (n, m, live-pin count), decides done/stalled, and
    re-buckets the new level into its own pow2 padding.  The tie-jitter
    comes from one ``torch.Generator`` seeded with ``seed``.
    """
    dev = resolve_device(device)
    sched = round_schedule(hg, k,
                           contraction_limit_factor=contraction_limit_factor,
                           max_rounds=max_rounds, min_shrink=min_shrink,
                           max_cluster_frac=max_cluster_frac)
    hga = hg.arrays(device=dev)
    part = None
    if restrict_part is not None:
        pp = np.zeros(hga.n_pad, np.int32)
        pp[: hg.n] = np.asarray(restrict_part, np.int32)[: hg.n]
        part = torch.from_numpy(pp).to(dev)
    levels = [DeviceLevel(hga=hga, cluster_id=None, n=hg.n, m=hg.m,
                          p=hg.num_pins, part=part, host_hg=hg)]
    gen = torch.Generator().manual_seed(seed)
    c_max = float(np.float32(sched.c_max))
    cur, cur_part, n_cur = hga, part, hg.n
    for _ in range(sched.max_rounds):
        if sched.done(n_cur):
            break
        coarse, cid, new_part, p_new = _coarsen_round(
            cur, cur_part, gen, c_max, max_stride=MAX_STRIDE,
            max_edge_size=MAX_EDGE_SIZE)
        n_new = coarse.n
        if sched.stalled(n_cur, n_new):
            break
        m_new = coarse.m
        n_pad2 = _round_pow2(n_new + 1)
        m_pad2 = _round_pow2(m_new + 1)
        p_pad2 = _round_pow2(p_new + 1)
        if (n_pad2, m_pad2, p_pad2) != (coarse.n_pad, coarse.m_pad,
                                        coarse.p_pad):
            coarse, cid, new_part = _rebucket(coarse, cid, new_part,
                                              n_pad2, m_pad2, p_pad2)
        coarse = _attach_incident(coarse, m_new, p_new)
        levels.append(DeviceLevel(hga=coarse, cluster_id=cid.to(torch.int32),
                                  n=n_new, m=m_new, p=p_new, part=new_part))
        cur, cur_part, n_cur = coarse, new_part, n_new
    return HierarchyArrays(levels=levels)


# --------------------------------------------------------------------------
# population coarsening for the mutation cohort (DESIGN.md §10): one
# shared structure, alpha edge-weight rows, alpha partitions
# --------------------------------------------------------------------------
def _sorted_candidates_population(hga: HypergraphArrays,
                                  parts: torch.Tensor, ew_pop: torch.Tensor,
                                  *, max_stride: int, max_edge_size: int):
    """The population form of ``_sorted_candidates``: one shared sort of
    the pairs that share a block in every member of ``parts`` [alpha,
    n_pad], and the per-member unnormalised ratings ``r_pop`` [alpha, C]
    (contiguous) from the edge-weight rows ``ew_pop`` [alpha, m_pad]."""
    sizes = hga.edge_sizes
    unit_pop = torch.where(sizes[None] > 1,
                           ew_pop / torch.clamp(sizes - 1, min=1)[None], 0.0)
    u, v, valid, pe_cat = _stride_candidates(
        hga, max_stride=max_stride, max_edge_size=max_edge_size)
    valid = valid & (parts[:, u] == parts[:, v]).all(dim=0)
    lo, hi, order, seg = _sort_pairs(hga, u, v, valid)
    r_pop = torch.where(valid[None], unit_pop[:, pe_cat], 0.0)[:, order]
    return lo, hi, r_pop.contiguous(), seg


def _pair_ratings_population(hga: HypergraphArrays, parts: torch.Tensor,
                             ew_pop: torch.Tensor, *, max_stride: int,
                             max_edge_size: int, batch: bool):
    """Per-member aggregated, weight-normalised heavy-edge ratings over
    one shared candidate structure.

    ``parts`` [alpha, n_pad] restricts candidates to pairs that share a
    block in every member, so every member's partition projects exactly
    through the shared hierarchy; ``ew_pop`` [alpha, m_pad] are the
    per-member edge weights.  Returns ``(lo, hi, rating_pop)`` with
    ``rating_pop`` [alpha, C].  ``batch`` sums the members' ratings with
    one batched kernel launch; otherwise with one scalar launch per
    member (the ``REPRO_MUTATE_PATH=loop`` reference).  Both give the
    same bits: the stable sort permutation is shared and every row is
    reduced in the same order.
    """
    from repro_torch.kernels import ops
    lo, hi, r_pop, seg = _sorted_candidates_population(
        hga, parts, ew_pop, max_stride=max_stride,
        max_edge_size=max_edge_size)
    c = lo.shape[0]
    if batch:
        agg_pop = ops.rating_segment_sum_batch(r_pop, seg, c)
    else:
        agg_pop = torch.stack([ops.rating_segment_sum(row.contiguous(),
                                                      seg, c)
                               for row in r_pop])
    lo_g, hi_g, norm = _representatives(hga, lo, hi, seg)
    return lo_g, hi_g, agg_pop / norm[None]


def _member_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of ``rows`` [alpha, C], added in member order
    a = 0..alpha-1 on every device."""
    acc = rows[0].clone()
    for row in rows[1:]:
        acc += row
    return acc


def _coarsen_round_population(hga: HypergraphArrays, parts: torch.Tensor,
                              ew_pop: torch.Tensor, jitter_gen, c_max: float,
                              max_stride: int, max_edge_size: int,
                              batch: bool):
    """One cohort round: batched ratings, consensus matching on the
    members' summed ratings (the member's own rating for a cohort of
    one), and one contraction carrying every weight row."""
    lo, hi, rating_pop = _pair_ratings_population(
        hga, parts, ew_pop, max_stride=max_stride,
        max_edge_size=max_edge_size, batch=batch)
    jitter = draw_jitter(jitter_gen, lo.shape[0], lo.device)
    cid, n_new = _mutual_match_dev(hga, lo, hi, _member_sum(rating_pop),
                                   jitter, c_max)
    coarse, p_new, ew_new = contract_arrays(hga, cid, n_new, ew_pop=ew_pop)
    # block of each cluster = block of any member (the restriction made
    # every merged pair agree in every member)
    new_parts = torch.zeros_like(parts).scatter_reduce(
        1, cid[None].expand(parts.shape[0], -1), parts, "amax")
    return coarse, cid, new_parts, ew_new, p_new


@dataclasses.dataclass
class PopulationLevel:
    """One shared-structure cohort level: the shared structure (``hga``,
    ``cluster_id``) plus the per-member leaves (``ew_pop`` edge weights,
    ``parts`` projected partitions)."""
    hga: HypergraphArrays
    cluster_id: Optional[torch.Tensor]
    ew_pop: torch.Tensor            # [alpha, m_pad]
    parts: torch.Tensor             # [alpha, n_pad]
    n: int
    m: int
    p: int


@dataclasses.dataclass
class PopulationHierarchy:
    """Shared-structure multilevel hierarchy of the mutation cohort: one
    structure per level, per-member edge weights and partitions stacked
    on a leading alpha axis."""
    levels: List[PopulationLevel]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def sizes(self) -> List[int]:
        return [lv.n for lv in self.levels]

    def level_n(self, li: int) -> int:
        return self.levels[li].n

    def level_arrays(self, li: int) -> HypergraphArrays:
        return self.levels[li].hga

    def level_ew(self, li: int) -> torch.Tensor:
        return self.levels[li].ew_pop

    def level_parts(self, li: int) -> torch.Tensor:
        return self.levels[li].parts

    def project_pop(self, parts, li: int) -> torch.Tensor:
        """Project the cohort at level ``li`` onto level ``li - 1``."""
        lv = self.levels[li]
        parts = torch.as_tensor(parts, device=lv.hga.device).to(torch.int32)
        return _pad_cols(parts, lv.hga.n_pad)[:, lv.cluster_id.long()]


def population_coarsen(hg: Hypergraph, parts, ew_pop, k: int, *,
                       contraction_limit_factor: int = 64,
                       max_rounds: int = 64, min_shrink: float = 0.02,
                       seed: int = 0, max_cluster_frac: float = 1.0,
                       batch: bool = True,
                       model_shard: Optional[str] = None,
                       device: str | torch.device = "cuda"
                       ) -> PopulationHierarchy:
    """Build one partition-aware hierarchy for the whole mutation cohort
    on ``device``.

    ``parts`` [alpha, n] warm starts and ``ew_pop`` [alpha, m] per-member
    reweighted edge weights, both over ``hg``'s structure.  The schedule
    is the shared ``coarsen.round_schedule`` (it reads only vertex
    weights and structure, which the members share); the tie-jitter
    comes from one ``torch.Generator`` seeded with ``seed``, as in
    ``device_coarsen``.  ``batch=False`` aggregates the ratings member by
    member; the hierarchy is the same either way.
    """
    if model_shard not in (None, "off", "auto"):
        raise NotImplementedError(
            f"model_shard={model_shard!r} belongs to a later slice of the "
            "port (multi-device paths)")
    dev = resolve_device(device)
    sched = round_schedule(hg, k,
                           contraction_limit_factor=contraction_limit_factor,
                           max_rounds=max_rounds, min_shrink=min_shrink,
                           max_cluster_frac=max_cluster_frac)
    hga = hg.arrays(device=dev)
    alpha = len(parts)
    pp = np.zeros((alpha, hga.n_pad), np.int32)
    pp[:, : hg.n] = np.asarray(parts, np.int32)[:, : hg.n]
    ww = np.zeros((alpha, hga.m_pad), np.float32)
    ww[:, : hg.m] = np.asarray(ew_pop, np.float32)[:, : hg.m]
    parts_t = torch.from_numpy(pp).to(dev)
    ew_t = torch.from_numpy(ww).to(dev)
    levels = [PopulationLevel(hga=hga, cluster_id=None, ew_pop=ew_t,
                              parts=parts_t, n=hg.n, m=hg.m,
                              p=hg.num_pins)]
    gen = torch.Generator().manual_seed(seed)
    c_max = float(np.float32(sched.c_max))
    cur, cur_parts, cur_ew, n_cur = hga, parts_t, ew_t, hg.n
    for _ in range(sched.max_rounds):
        if sched.done(n_cur):
            break
        coarse, cid, new_parts, new_ew, p_new = _coarsen_round_population(
            cur, cur_parts, cur_ew, gen, c_max, max_stride=MAX_STRIDE,
            max_edge_size=MAX_EDGE_SIZE, batch=batch)
        n_new = coarse.n
        if sched.stalled(n_cur, n_new):
            break
        m_new = coarse.m
        n_pad2 = _round_pow2(n_new + 1)
        m_pad2 = _round_pow2(m_new + 1)
        p_pad2 = _round_pow2(p_new + 1)
        if (n_pad2, m_pad2, p_pad2) != (coarse.n_pad, coarse.m_pad,
                                        coarse.p_pad):
            coarse, cid, _ = _rebucket(coarse, cid, None, n_pad2, m_pad2,
                                       p_pad2)
            new_parts = new_parts[:, :n_pad2].contiguous()
            new_ew = new_ew[:, :m_pad2].contiguous()
        coarse = _attach_incident(coarse, m_new, p_new)
        levels.append(PopulationLevel(hga=coarse,
                                      cluster_id=cid.to(torch.int32),
                                      ew_pop=new_ew, parts=new_parts,
                                      n=n_new, m=m_new, p=p_new))
        cur, cur_parts, cur_ew, n_cur = coarse, new_parts, new_ew, n_new
    return PopulationHierarchy(levels=levels)
