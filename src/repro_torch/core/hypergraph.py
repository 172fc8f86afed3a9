"""Hypergraph data structures (port of ``repro.core.hypergraph``).

Two representations, as in the reference:

* :class:`Hypergraph` — host-side numpy CSR (pins per edge + dual
  incidence), used for the irregular structure work: host coarsening,
  contraction, the initial-partition constructions.
* :class:`HypergraphArrays` — a plain dataclass of fixed-shape padded
  tensors on one device, used by every numeric routine (metrics, gains,
  refinement, device coarsening).  The padding contract is the
  reference's: padded pins point at the ghost vertex ``n_pad - 1`` and
  the ghost edge ``m_pad - 1`` (both zero weight), so segment reductions
  stay exact without masks; ``n``/``m`` are the true counts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device


# --------------------------------------------------------------------------
# Host-side hypergraph
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Hypergraph:
    """CSR hypergraph.  ``pins[edge_offsets[e]:edge_offsets[e+1]]`` are the
    vertices of hyperedge ``e``."""

    n: int
    m: int
    pins: np.ndarray            # [P] int32 vertex ids
    edge_offsets: np.ndarray    # [m+1] int64
    vertex_weights: np.ndarray  # [n] float32
    edge_weights: np.ndarray    # [m] float32

    # dual incidence, built lazily: edges incident to each vertex
    _incident: Optional[np.ndarray] = None       # [P] int32 edge ids
    _vertex_offsets: Optional[np.ndarray] = None  # [n+1] int64

    # dense incidence layouts keyed by their padding (built once per level)
    _layout_cache: dict = dataclasses.field(default_factory=dict,
                                            repr=False, compare=False)
    # ``arrays()`` results keyed by (padding, layout mode, device)
    _arrays_cache: dict = dataclasses.field(default_factory=dict,
                                            repr=False, compare=False)

    # ---------------------------------------------------------------- util
    @property
    def num_pins(self) -> int:
        return int(self.pins.shape[0])

    @property
    def total_weight(self) -> float:
        return float(self.vertex_weights.sum())

    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.edge_offsets).astype(np.int32)

    def pin_edge_ids(self) -> np.ndarray:
        """Edge id of every pin (repeat-interleaved)."""
        return np.repeat(
            np.arange(self.m, dtype=np.int32), self.edge_sizes()
        )

    def dual(self) -> Tuple[np.ndarray, np.ndarray]:
        """(incident, vertex_offsets): edges incident to each vertex."""
        if self._incident is None:
            order = np.argsort(self.pins, kind="stable")
            self._incident = self.pin_edge_ids()[order].astype(np.int32)
            counts = np.bincount(self.pins, minlength=self.n)
            self._vertex_offsets = np.concatenate(
                [[0], np.cumsum(counts)]
            ).astype(np.int64)
        return self._incident, self._vertex_offsets

    def incidence_matrix(self, n_rows: int, lane_pad: int = 8) -> np.ndarray:
        """Padded [n_rows, D_pad] incident-edge matrix (pad = -1), the
        layout the gain kernels gather from.  Cached per
        ``(n_rows, lane_pad)``."""
        key = (int(n_rows), int(lane_pad))
        hit = self._layout_cache.get(key)
        if hit is not None:
            return hit
        incident, voff = self.dual()
        deg = np.diff(voff)
        d_pad = max(int(_round_pow2(int(deg.max()) if self.n else 1,
                                    lane_pad)), lane_pad)
        assert n_rows >= self.n
        out = np.full((n_rows, d_pad), -1, np.int32)
        rows = np.repeat(np.arange(self.n), deg)
        cols = (np.arange(len(incident), dtype=np.int64)
                - np.repeat(voff[:-1], deg))
        out[rows, cols] = incident
        self._layout_cache[key] = out
        return out

    def max_degree(self) -> int:
        if self.n == 0:
            return 0
        _, voff = self.dual()
        return int(np.diff(voff).max())

    def validate(self) -> None:
        assert self.edge_offsets.shape == (self.m + 1,)
        assert self.edge_offsets[0] == 0 and self.edge_offsets[-1] == len(self.pins)
        assert self.vertex_weights.shape == (self.n,)
        assert self.edge_weights.shape == (self.m,)
        if len(self.pins):
            assert self.pins.min() >= 0 and self.pins.max() < self.n
        assert (np.diff(self.edge_offsets) >= 1).all()

    # ------------------------------------------------------------ factory
    @staticmethod
    def from_edge_lists(edges, n=None, vertex_weights=None, edge_weights=None):
        """Build from a list of pin lists."""
        edges = [np.asarray(e, dtype=np.int32) for e in edges]
        m = len(edges)
        pins = (
            np.concatenate(edges) if m else np.zeros((0,), dtype=np.int32)
        ).astype(np.int32)
        sizes = np.array([len(e) for e in edges], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if n is None:
            n = int(pins.max()) + 1 if len(pins) else 0
        vw = (
            np.ones(n, np.float32)
            if vertex_weights is None
            else np.asarray(vertex_weights, np.float32)
        )
        ew = (
            np.ones(m, np.float32)
            if edge_weights is None
            else np.asarray(edge_weights, np.float32)
        )
        hg = Hypergraph(n=n, m=m, pins=pins, edge_offsets=offsets,
                        vertex_weights=vw, edge_weights=ew)
        hg.validate()
        return hg

    @staticmethod
    def from_numpy(n: int, m: int, pins, edge_offsets, vertex_weights,
                   edge_weights) -> "Hypergraph":
        """Build from the CSR fields of another package's hypergraph
        (copies every array, so the two objects share nothing)."""
        hg = Hypergraph(
            n=int(n), m=int(m),
            pins=np.array(pins, np.int32),
            edge_offsets=np.array(edge_offsets, np.int64),
            vertex_weights=np.array(vertex_weights, np.float32),
            edge_weights=np.array(edge_weights, np.float32))
        hg.validate()
        return hg

    def to_numpy(self) -> dict:
        """The CSR fields as numpy arrays (the ``from_numpy`` inverse)."""
        return dict(n=self.n, m=self.m, pins=self.pins,
                    edge_offsets=self.edge_offsets,
                    vertex_weights=self.vertex_weights,
                    edge_weights=self.edge_weights)

    def structural_copy(self) -> "Hypergraph":
        """Copy sharing the structural numpy arrays but none of the caches,
        so every timed or compared run pays its own conversions."""
        return Hypergraph(
            n=self.n, m=self.m, pins=self.pins,
            edge_offsets=self.edge_offsets,
            vertex_weights=self.vertex_weights,
            edge_weights=self.edge_weights,
        )

    def with_edge_weights(self, new_weights: np.ndarray,
                          new_vertex_weights: np.ndarray | None = None
                          ) -> "Hypergraph":
        """Reweighted copy sharing all host structure: pins, offsets, the
        dual incidence and the dense-layout cache."""
        hg = Hypergraph(
            n=self.n, m=self.m, pins=self.pins,
            edge_offsets=self.edge_offsets,
            vertex_weights=(self.vertex_weights
                            if new_vertex_weights is None
                            else np.asarray(new_vertex_weights,
                                            np.float32)),
            edge_weights=np.asarray(new_weights, np.float32),
        )
        hg._incident, hg._vertex_offsets = self._incident, self._vertex_offsets
        hg._layout_cache = self._layout_cache
        return hg

    def arrays(self, pad_pins: Optional[int] = None,
               pad_edges: Optional[int] = None,
               pad_vertices: Optional[int] = None,
               device: str | torch.device = "cuda") -> "HypergraphArrays":
        """Padded tensors on ``device``.  Cached per padding request,
        incidence-layout mode and device, so the per-level host->device
        conversion runs once however many rounds revisit the level."""
        from repro_torch.kernels.ops import gain_layout_enabled
        dev = resolve_device(device)
        key = (pad_pins, pad_edges, pad_vertices, gain_layout_enabled(dev),
               str(dev))
        hit = self._arrays_cache.get(key)
        if hit is None:
            hit = HypergraphArrays.from_host(self, pad_pins, pad_edges,
                                             pad_vertices, device=dev)
            self._arrays_cache[key] = hit
        return hit


# --------------------------------------------------------------------------
# Device-side padded arrays
# --------------------------------------------------------------------------
def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def _round_pow2(x: int, floor: int = 256) -> int:
    """Next power of two (>= floor): buckets level shapes so that every
    level and design share a few padded sizes."""
    x = max(x, floor)
    return 1 << (x - 1).bit_length()


# Dense-incidence attachment policy (see HypergraphArrays.from_host):
# lane padding of the incidence matrix, and the largest tolerated blowup
# of the dense [n_pad, D_pad] layout over the raw pin count.
_INCIDENCE_LANE_PAD = 8
_INCIDENCE_MAX_EXPANSION = 16

_FIELDS = ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
           "edge_sizes")


@dataclasses.dataclass
class HypergraphArrays:
    """Fixed-shape padded hypergraph on one device.

    ``pin_vertex``/``pin_edge`` are [P_pad] int32; padded pins point to
    the ghost vertex ``n_pad - 1`` (zero weight) and ghost edge
    ``m_pad - 1`` (zero weight).  ``n``/``m`` are the true counts (host
    ints).  ``incident`` is the optional dense [n_pad, D_pad] int32
    incident-edge layout (pad = -1) the gain kernels read; None when no
    kernel path is reachable.  ``pin_sort`` caches the pins sorted by
    vertex (``metrics.pins_by_vertex``) and ``pin_sort_edge`` their edge
    ids in that order, built once per level for the fixed-order sums of
    real-valued weights.

    ``real_edge_weights``/``real_vertex_weights`` say whether a weight
    leaf holds a value that is not an integer (drifted weights,
    DESIGN.md §14).  Integer-valued weights add exactly in any order;
    real ones would reach float atomics on the card (``index_add_``,
    ``scatter_add_``), whose order changes between runs, so the sums
    over them take the rating kernel's fixed-order segment sum instead.
    The flags are decided on the host when a level is made
    (``from_numpy``: one pass over the weights; ``contract_arrays``: a
    coarse level inherits its fine level's) or its weights are swapped
    (``is_real_valued`` of the new weights), never inside a CUDA graph's
    capture.
    """

    pin_vertex: torch.Tensor      # [P_pad] int32, padded -> n_pad - 1
    pin_edge: torch.Tensor        # [P_pad] int32, padded -> m_pad - 1
    vertex_weights: torch.Tensor  # [n_pad] f32, ghost = 0
    edge_weights: torch.Tensor    # [m_pad] f32, ghost/pad = 0
    edge_sizes: torch.Tensor      # [m_pad] int32 true pin counts, pad = 0
    n: int
    m: int
    incident: Optional[torch.Tensor] = None
    pin_sort: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    pin_sort_edge: Optional[torch.Tensor] = \
        dataclasses.field(default=None, repr=False, compare=False)
    real_edge_weights: bool = dataclasses.field(default=False,
                                                compare=False)
    real_vertex_weights: bool = dataclasses.field(default=False,
                                                  compare=False)

    # -- derived sizes -------------------------------------------------------
    @property
    def n_pad(self) -> int:
        return int(self.vertex_weights.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.edge_weights.shape[0])

    @property
    def p_pad(self) -> int:
        return int(self.pin_vertex.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vertex_weights.device

    @property
    def total_weight(self) -> torch.Tensor:
        return self.vertex_weights.sum()

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_host(hg: Hypergraph, pad_pins=None, pad_edges=None,
                  pad_vertices=None,
                  device: str | torch.device = "cuda") -> "HypergraphArrays":
        from repro_torch.kernels.ops import gain_layout_enabled
        dev = resolve_device(device)
        p = hg.num_pins
        p_pad = pad_pins if pad_pins is not None else _round_pow2(p + 1)
        m_pad = (pad_edges if pad_edges is not None
                 else _round_pow2(hg.m + 1))
        n_pad = (pad_vertices if pad_vertices is not None
                 else _round_pow2(hg.n + 1))
        assert p_pad >= p and m_pad >= hg.m + 1 and n_pad >= hg.n + 1

        pin_vertex = np.full(p_pad, n_pad - 1, np.int32)
        pin_vertex[:p] = hg.pins
        pin_edge = np.full(p_pad, m_pad - 1, np.int32)
        pin_edge[:p] = hg.pin_edge_ids()
        vw = np.zeros(n_pad, np.float32)
        vw[: hg.n] = hg.vertex_weights
        ew = np.zeros(m_pad, np.float32)
        ew[: hg.m] = hg.edge_weights
        es = np.zeros(m_pad, np.int32)
        es[: hg.m] = hg.edge_sizes()

        incident = None
        if hg.m and gain_layout_enabled(dev):
            d_pad = max(_round_pow2(max(hg.max_degree(), 1),
                                    _INCIDENCE_LANE_PAD),
                        _INCIDENCE_LANE_PAD)
            # guard against hub vertices: a dense [n_pad, D] layout much
            # larger than the CSR itself would cost more bytes than the
            # kernels save — skip it; the dispatcher then takes segsum
            if n_pad * d_pad <= _INCIDENCE_MAX_EXPANSION * max(p, 1):
                incident = torch.from_numpy(hg.incidence_matrix(
                    n_pad, lane_pad=_INCIDENCE_LANE_PAD)).to(dev)
        return HypergraphArrays.from_numpy(
            dict(pin_vertex=pin_vertex, pin_edge=pin_edge,
                 vertex_weights=vw, edge_weights=ew, edge_sizes=es,
                 n=hg.n, m=hg.m, incident=incident), device=dev)

    @staticmethod
    def from_numpy(fields: dict,
                   device: str | torch.device = "cuda") -> "HypergraphArrays":
        """Build from the reference's padded fields (numpy arrays or
        tensors under the reference's names; ``incident`` may be None)."""
        dev = resolve_device(device)
        dtypes = dict(pin_vertex=torch.int32, pin_edge=torch.int32,
                      vertex_weights=torch.float32,
                      edge_weights=torch.float32, edge_sizes=torch.int32)
        def tensor(x, dtype):
            # np.array copies: the source may be a read-only view
            x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
            return x.to(dev, dtype)
        kw = {f: tensor(fields[f], dtypes[f]) for f in _FIELDS}
        inc = fields.get("incident")
        if inc is not None:
            inc = tensor(inc, torch.int32)
        return HypergraphArrays(
            n=int(fields["n"]), m=int(fields["m"]), incident=inc,
            real_edge_weights=is_real_valued(fields["edge_weights"]),
            real_vertex_weights=is_real_valued(fields["vertex_weights"]),
            **kw)

    def to_numpy(self) -> dict:
        """Every field as numpy (``incident`` None when absent)."""
        out = {f: getattr(self, f).cpu().numpy() for f in _FIELDS}
        out.update(n=self.n, m=self.m,
                   incident=(None if self.incident is None
                             else self.incident.cpu().numpy()))
        return out


def is_real_valued(w) -> bool:
    """Does the weight array ``w`` (numpy or a tensor) hold a value that
    is not an integer?  A numpy array is checked on the host; a tensor
    costs one reduction and one read back from its device."""
    if torch.is_tensor(w):
        return bool((w != torch.round(w)).any())
    w = np.asarray(w)
    return bool(np.any(w != np.rint(w)))


# --------------------------------------------------------------------------
# Contraction (host): the workhorse of host coarsening
# --------------------------------------------------------------------------
def contract(hg: Hypergraph, cluster_id: np.ndarray, n_new: int,
             merge_parallel: bool = True) -> Tuple[Hypergraph, np.ndarray]:
    """Contract vertices by ``cluster_id`` (maps old vertex -> [0, n_new)).

    Returns (coarse hypergraph, cluster_id).  Within-edge duplicate pins
    are removed; single-pin edges are dropped; parallel edges merged
    (weights summed) when ``merge_parallel``.
    """
    cluster_id = np.asarray(cluster_id, np.int32)
    assert cluster_id.shape == (hg.n,)
    new_vw = np.zeros(n_new, np.float32)
    np.add.at(new_vw, cluster_id, hg.vertex_weights)

    pins = cluster_id[hg.pins].astype(np.int64)
    eids = hg.pin_edge_ids().astype(np.int64)
    # sort pins within each edge: lexicographic (edge, pin)
    key = eids * n_new + pins
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pins_s = pins[order]
    eids_s = eids[order]
    # drop duplicate (edge, pin) pairs
    keep = np.ones(len(key_s), bool)
    keep[1:] = key_s[1:] != key_s[:-1]
    pins_d = pins_s[keep]
    eids_d = eids_s[keep]
    # new sizes per original edge
    sizes = np.bincount(eids_d, minlength=hg.m)
    multi = sizes >= 2  # single-pin edges vanish
    keep_pin = multi[eids_d]
    pins_d = pins_d[keep_pin]
    eids_d = eids_d[keep_pin]
    kept_edges = np.nonzero(multi)[0]
    ew = hg.edge_weights[kept_edges]
    sizes_k = sizes[kept_edges]
    # re-index edges densely
    offsets = np.concatenate([[0], np.cumsum(sizes_k)]).astype(np.int64)

    if merge_parallel and len(kept_edges):
        # two independent polynomial hashes over each edge's sorted pins
        h1 = np.zeros(len(kept_edges), np.uint64)
        h2 = np.zeros(len(kept_edges), np.uint64)
        seg = np.repeat(np.arange(len(kept_edges)), sizes_k)
        p64 = pins_d.astype(np.uint64)
        pos = (np.arange(len(pins_d), dtype=np.uint64)
               - np.repeat(offsets[:-1], sizes_k).astype(np.uint64))
        a1 = (p64 + np.uint64(0x9E3779B97F4A7C15)) * (pos * np.uint64(2) + np.uint64(1))
        a2 = (p64 ^ np.uint64(0xC2B2AE3D27D4EB4F)) * (pos + np.uint64(0x165667B19E3779F9))
        np.add.at(h1, seg, a1 * (a1 >> np.uint64(31)))
        np.add.at(h2, seg, a2 ^ (a2 << np.uint64(7)))
        combo = h1 ^ (h2 << np.uint64(1)) ^ np.asarray(sizes_k, np.uint64)
        uniq, inv = np.unique(combo, return_inverse=True)
        if len(uniq) < len(kept_edges):
            # merge groups; representative = first occurrence, kept in
            # original edge order so pins stay aligned
            new_ew = np.zeros(len(uniq), np.float32)
            np.add.at(new_ew, inv, ew)
            first_idx = np.full(len(uniq), len(kept_edges), np.int64)
            np.minimum.at(first_idx, inv, np.arange(len(kept_edges)))
            rep_mask = np.zeros(len(kept_edges), bool)
            rep_mask[first_idx] = True
            pins_d = pins_d[rep_mask[seg]]
            rep_order = np.nonzero(rep_mask)[0]
            sizes_k = sizes_k[rep_order]
            ew = new_ew[inv[rep_order]]
            offsets = np.concatenate([[0], np.cumsum(sizes_k)]).astype(np.int64)

    coarse = Hypergraph(
        n=n_new, m=len(sizes_k) if len(kept_edges) else 0,
        pins=pins_d.astype(np.int32),
        edge_offsets=offsets,
        vertex_weights=new_vw,
        edge_weights=np.asarray(ew, np.float32),
    )
    coarse.validate()
    return coarse, cluster_id


def project_partition(part_coarse: np.ndarray, cluster_id: np.ndarray) -> np.ndarray:
    """Project a coarse partition vector through a contraction mapping."""
    return np.asarray(part_coarse)[np.asarray(cluster_id)]


# --------------------------------------------------------------------------
# Contraction (device): fixed-shape analogue of ``contract``
# --------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """uint32 multiply (mod 2**32) of non-negative int64 values below
    2**32, split in 16-bit halves so no int64 product overflows."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _compact_ghosts(live: torch.Tensor, arrays, fills):
    """Scatter live entries to the front, ghosts to the tail, preserving
    relative order (a cumsum partition, no comparison sort)."""
    csum = torch.cumsum(live.to(torch.int64), 0)
    n_live = csum[-1]
    csum_g = torch.cumsum((~live).to(torch.int64), 0)
    dest = torch.where(live, csum - 1, n_live + csum_g - 1)
    return [torch.full_like(a, fill).scatter_(0, dest, a)
            for a, fill in zip(arrays, fills)]


def contract_arrays(hga: HypergraphArrays, cid: torch.Tensor, n_new,
                    ew_pop: Optional[torch.Tensor] = None):
    """Contract a padded device hypergraph by cluster assignment ``cid``.

    ``cid`` maps every fine vertex slot [n_pad] onto dense coarse ids
    [0, n_new) with padded/ghost slots pointing at the coarse ghost
    ``n_pad - 1``.  The coarse hypergraph keeps the fine padding (the
    caller re-buckets).  Semantics match the host ``contract`` exactly:
    within-edge duplicate pins removed, single-pin edges dropped,
    parallel edges merged with weights summed onto the lowest original
    edge id, edges renumbered densely in original order, pins sorted by
    (edge, vertex) with ghosts compacted to the tail.

    Returns ``(coarse_arrays, p_new)``; ``coarse.n``/``coarse.m`` and
    ``p_new`` are host ints, read back together in one transfer.  The
    coarse level inherits the ``real_*_weights`` flags: on a level with
    real-valued edge (vertex) weights the merged parallel-edge weights
    (the cluster weights) are fixed-order sums, so two runs on the card
    give the same bits; integer-valued weights keep ``index_add_``.

    ``ew_pop`` ([alpha, m_pad], optional) stacks per-member edge weights
    over the shared structure (the mutation cohort, DESIGN.md §10).  The
    merge/drop/renumber decisions are structural, so every row goes
    through the same edge map as the structural weights, and a third
    value ``ew_pop_new`` [alpha, m_pad] is returned.  The rows are
    reweighted (non-integer) weights, so their merged sums hold to the
    reference within rounding, not bit for bit.  On the card the merged
    sums go through the rating kernel's fixed-order segment sum (the
    parallel-edge groups are sorted), so two runs give the same bits.
    """
    from repro_torch.kernels import ops
    n_pad, m_pad, p_pad = hga.n_pad, hga.m_pad, hga.p_pad
    dev = hga.device
    ghost_v = n_pad - 1
    ghost_e = m_pad - 1
    arange_m = torch.arange(m_pad, device=dev)
    cid = cid.long()

    if hga.real_vertex_weights:
        # real-valued weights: a stable sort by cluster makes the sum a
        # sorted-segment sum in fixed order (each cluster's members in
        # vertex order, as ``index_add_`` adds them on the CPU)
        vorder = torch.argsort(cid, stable=True)
        new_vw = ops.rating_segment_sum(
            hga.vertex_weights[vorder].contiguous(),
            cid[vorder].to(torch.int32), n_pad)
    else:
        new_vw = torch.zeros(n_pad, dtype=torch.float32,
                             device=dev).index_add_(0, cid,
                                                    hga.vertex_weights)

    # sort pins by (edge, vertex): an int64 composite key is exact here
    # (the reference needs a two-key sort because it has no int64)
    pv = cid[hga.pin_vertex.long()]
    pe = hga.pin_edge.long()
    order = torch.argsort(pe * n_pad + pv, stable=True)
    pe, pv = pe[order], pv[order]
    dup = torch.zeros(p_pad, dtype=torch.bool, device=dev)
    dup[1:] = (pe[1:] == pe[:-1]) & (pv[1:] == pv[:-1]) & (pe[1:] != ghost_e)
    pv = torch.where(dup, ghost_v, pv)
    pe = torch.where(dup, ghost_e, pe)

    # post-dedup sizes; single-pin (and empty) edges vanish
    live_pin = pe != ghost_e
    sizes = torch.zeros(m_pad, dtype=torch.int64, device=dev).index_add_(
        0, pe, live_pin.to(torch.int64))
    edge_alive = (arange_m < hga.m) & (sizes >= 2)
    keep_pin = live_pin & edge_alive[pe]
    pv = torch.where(keep_pin, pv, ghost_v)
    pe = torch.where(keep_pin, pe, ghost_e)

    # parallel-edge detection: the reference's two uint32 polynomial
    # hashes over each edge's live-pin ranks, emulated in int64 (same
    # values, so the same merge groups, collisions included)
    live_rank = torch.cumsum(keep_pin.to(torch.int64), 0) - 1
    first_rank = torch.full((m_pad,), p_pad, dtype=torch.int64,
                            device=dev).scatter_reduce(
        0, pe, torch.where(keep_pin, live_rank, p_pad), "amin")
    pos = (live_rank - first_rank[pe]) & _M32
    pu = pv
    a1 = _mul32((pu + 0x9E3779B9) & _M32, (pos * 2 + 1) & _M32)
    a2 = _mul32(pu ^ 0x85EBCA6B, (pos + 0xC2B2AE35) & _M32)
    m1 = _mul32(a1, a1 >> 15)
    m2 = a2 ^ ((a2 << 7) & _M32)
    live_u = keep_pin.to(torch.int64)
    h1 = torch.zeros(m_pad, dtype=torch.int64, device=dev).index_add_(
        0, pe, m1 * live_u) & _M32
    h2 = torch.zeros(m_pad, dtype=torch.int64, device=dev).index_add_(
        0, pe, m2 * live_u) & _M32
    h1 = h1 ^ _mul32(sizes, 0x27D4EB2F)
    h2 = h2 ^ sizes
    # dead edges must not group with anything (nor with each other)
    h1 = torch.where(edge_alive, h1, _M32)
    h2 = torch.where(edge_alive, h2, arange_m)

    eo = torch.argsort((h1 - 2 ** 31) * 2 ** 32 + h2, stable=True)
    h1s, h2s = h1[eo], h2[eo]
    newg = torch.ones(m_pad, dtype=torch.bool, device=dev)
    newg[1:] = (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1])
    grp = torch.cumsum(newg.to(torch.int64), 0) - 1
    alive_s = edge_alive[eo]
    w_s = torch.where(alive_s, hga.edge_weights[eo], 0.0)
    if hga.real_edge_weights:
        # ``grp`` ascends: the fixed-order sum of the sorted groups
        gw = ops.rating_segment_sum(w_s, grp.to(torch.int32), m_pad)
    else:
        gw = torch.zeros(m_pad, dtype=torch.float32,
                         device=dev).index_add_(0, grp, w_s)
    rep = torch.full((m_pad,), m_pad, dtype=torch.int64,
                     device=dev).scatter_reduce(
        0, grp, torch.where(alive_s, eo, m_pad), "amin")
    grp_of = torch.empty_like(grp).scatter_(0, eo, grp)
    keep_edge = edge_alive & (arange_m == rep[grp_of])
    merged_w = torch.where(keep_edge, gw[grp_of], 0.0)

    # drop pins of merged-away edges, renumber kept edges densely
    pin_ok = keep_edge[pe] & (pe != ghost_e)
    pv = torch.where(pin_ok, pv, ghost_v)
    pe = torch.where(pin_ok, pe, ghost_e)
    new_eid = torch.cumsum(keep_edge.to(torch.int64), 0) - 1
    m_new = keep_edge.sum()
    pe = torch.where(pe != ghost_e, new_eid[pe], ghost_e)
    tgt = torch.where(keep_edge, new_eid, ghost_e)
    new_ew = torch.zeros(m_pad, dtype=torch.float32, device=dev).index_add_(
        0, tgt, merged_w)
    new_es = torch.zeros(m_pad, dtype=torch.int64, device=dev).index_add_(
        0, tgt, torch.where(keep_edge, sizes, 0))

    # compact ghosts to the tail (live pins stay (edge, vertex) sorted,
    # so the next round's stride pairing sees contiguous edges)
    live_now = pe != ghost_e
    pv, pe = _compact_ghosts(live_now, [pv, pe], [ghost_v, ghost_e])
    n_new_t = torch.as_tensor(n_new, device=dev).to(torch.int64).reshape(())
    n_h, m_h, p_h = torch.stack([n_new_t, m_new, live_now.sum()]).tolist()

    coarse = HypergraphArrays(
        pin_vertex=pv.to(torch.int32), pin_edge=pe.to(torch.int32),
        vertex_weights=new_vw, edge_weights=new_ew,
        edge_sizes=new_es.to(torch.int32),
        n=n_h, m=m_h, incident=None,
        real_edge_weights=hga.real_edge_weights,
        real_vertex_weights=hga.real_vertex_weights,
    )
    if ew_pop is None:
        return coarse, p_h
    # per-member rows ride the structural edge map: same parallel-edge
    # groups, survivors and dense renumbering
    alpha = ew_pop.shape[0]
    rows = torch.where(alive_s[None], ew_pop[:, eo], 0.0)
    # ``grp`` ascends, so the group sums are a sorted-segment sum: the
    # rating kernel adds each group in a fixed order, where ``index_add_``
    # would add the real-valued rows with atomics on the card (its plain
    # version on the CPU adds in ``index_add_``'s order)
    gw_r = ops.rating_segment_sum_batch(rows.contiguous(),
                                        grp.to(torch.int32), m_pad)
    merged_r = torch.where(keep_edge[None], gw_r[:, grp_of], 0.0)
    # every kept edge receives one value and the ghost only zeros: exact
    # in any order
    ew_new = torch.zeros((alpha, m_pad), dtype=torch.float32,
                         device=dev).index_add_(1, tgt, merged_r)
    return coarse, p_h, ew_new


# --------------------------------------------------------------------------
# Device-resident hierarchy (built by core/dcoarsen)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceLevel:
    """One device-resident coarsening level.

    ``cluster_id`` maps the FINER level's padded vertex slots onto this
    level's padded ids (ghost -> ghost); ``part`` carries the projected
    input partition for partition-aware hierarchies.
    """
    hga: HypergraphArrays
    cluster_id: Optional[torch.Tensor]
    n: int
    m: int
    p: int
    part: Optional[torch.Tensor] = None
    host_hg: Optional[Hypergraph] = None  # lazy, cached


def _arrays_to_host(hga: HypergraphArrays, n: int, m: int) -> Hypergraph:
    """Materialise a host CSR hypergraph from device arrays (where an
    operator is genuinely host-side: the initial-partition portfolio)."""
    pv = hga.pin_vertex.cpu().numpy()
    pe = hga.pin_edge.cpu().numpy()
    keep = pe < m
    pv, pe = pv[keep], pe[keep]
    order = np.argsort(pe, kind="stable")
    pv, pe = pv[order], pe[order]
    sizes = np.bincount(pe, minlength=m)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    hg = Hypergraph(
        n=n, m=m, pins=pv.astype(np.int32), edge_offsets=offsets,
        vertex_weights=hga.vertex_weights[:n].cpu().numpy().astype(np.float32),
        edge_weights=hga.edge_weights[:m].cpu().numpy().astype(np.float32),
    )
    hg.validate()
    return hg


def _pad_cols(parts: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad a population [alpha, n] with zero columns up to ``n_pad``."""
    if parts.shape[1] >= n_pad:
        return parts
    pad = torch.zeros((parts.shape[0], n_pad - parts.shape[1]),
                      dtype=parts.dtype, device=parts.device)
    return torch.cat([parts, pad], dim=1)


@dataclasses.dataclass
class HierarchyArrays:
    """Device-resident multilevel hierarchy.  Implements the same
    hierarchy protocol as ``coarsen.Hierarchy`` (num_levels, level_n,
    level_arrays, level_host, level_part, project_pop, sizes)."""
    levels: List[DeviceLevel]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def sizes(self) -> List[int]:
        return [lv.n for lv in self.levels]

    def level_n(self, li: int) -> int:
        return self.levels[li].n

    def level_arrays(self, li: int) -> HypergraphArrays:
        return self.levels[li].hga

    def level_host(self, li: int) -> Hypergraph:
        lv = self.levels[li]
        if lv.host_hg is None:
            lv.host_hg = _arrays_to_host(lv.hga, lv.n, lv.m)
            # the level's arrays already live on the device: seed the
            # host copy's cache so ``arrays()`` returns them
            from repro_torch.kernels.ops import gain_layout_enabled
            dev = lv.hga.device
            lv.host_hg._arrays_cache[
                (None, None, None, gain_layout_enabled(dev), str(dev))] = lv.hga
        return lv.host_hg

    def level_part(self, li: int) -> Optional[torch.Tensor]:
        return self.levels[li].part

    def project_pop(self, parts, li: int) -> torch.Tensor:
        """Project a population at level ``li`` onto level ``li - 1``
        on the device (``cluster_id`` gather, ghost -> ghost)."""
        lv = self.levels[li]
        parts = torch.as_tensor(parts, device=lv.hga.device).to(torch.int32)
        parts = _pad_cols(parts, lv.hga.n_pad)
        return parts[:, lv.cluster_id.long()]
