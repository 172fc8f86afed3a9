"""Partition quality metrics and FM move gains (port of
``repro.core.metrics``).

Everything is computed from the flat pin arrays with segment
reductions.  Partition vectors are int32 ``[n_pad]`` (or a population
``[alpha, n_pad]``); the ghost vertex ``n_pad - 1`` carries any valid
block id and zero weight, ghost pins point at the zero-weight ghost
edge.  Flat indices are int64: the reference's int32 ``edge * k + part``
overflows once ``m_pad * k`` or ``n_pad * k`` passes 2**31.

Edge and vertex weights are integer-valued f32 on the instances the
engines ingest from the generators, so Phi, lambda, cuts, block weights
and gains are exact sums in any order: the population functions here
are bit-equal to the reference's vmapped ones, whatever path assembles
the gains.  Two kinds of weights are not integers: mutation's
per-member reweighting (``ew_pop``, DESIGN.md §10), ``w_e * (1 + mu *
C(e))``, and the drifted weights of incremental repartitioning
(DESIGN.md §14), which a level flags as ``real_edge_weights`` /
``real_vertex_weights``.  On the card ``index_add_`` and
``scatter_add_`` would add those with atomics, in an order that changes
between runs; so they are summed in a fixed order instead, the rating
kernel's sorted-segment sum (the gains over the pins sorted by vertex,
``pins_by_vertex``; block weights over the vertices sorted by block),
and two runs give the same bits.  On the CPU that sum's plain version
adds each segment in the original order, as ``index_add_`` did there,
so the CPU's bits are those of ``index_add_``.  Integer-valued levels
keep ``index_add_``.

The order of such a sum must not depend on how many rows share the
launch either: a member refined alone, in a compacted batch, in a stack
of instances (DESIGN.md §12) or on a shard of the pool (§11) must get
the same bits.  On the card ATen's reductions and scans pick their
split of a row from the number of rows, so the per-row sums of
real-valued weights (the cut, the moved weight, the block weights, the
acceptance prefix sums) take orders fixed by each row alone
(``row_sums``, ``block_weight_sums``, ``prefix_sums``).  The rating
kernel's order depends on where a run starts modulo its tile
(``RATING_TILE``), so the fixed-order sums lay every row, instance and
member block out from a multiple of it, and count only a row's true
entries, so a level re-padded into a stack sums as it does alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import RATING_TILE
from .hypergraph import HypergraphArrays


def _tile_multiple(n: int) -> int:
    return -(-n // RATING_TILE) * RATING_TILE


def row_sums(x: torch.Tensor, fixed_order: bool = False,
             lens=None) -> torch.Tensor:
    """[R] sums of ``x`` [R, L] over its last axis.

    ``fixed_order`` (real-valued weights) on the card: each row's first
    ``lens`` entries in the rating kernel's fixed order, whatever the
    rows beside it.  ``lens`` is an int for every row, or an [I] tensor
    for the rows of a stack of I instances (row ``a * I + i`` counts
    ``lens[i]`` entries); None counts the whole row.  The entries past
    ``lens`` must be zero.  Elsewhere ``Tensor.sum``, whose per-row bits
    on the CPU do not depend on the rows beside it."""
    if not (fixed_order and x.is_cuda):
        return x.sum(-1)
    from repro_torch.kernels import ops
    rows, length = x.shape
    dev = x.device
    lens = torch.as_tensor(length if lens is None else lens,
                           device=dev).reshape(-1)
    num = lens.shape[0]
    width = _tile_multiple(length)
    if width != length:
        x = torch.nn.functional.pad(x, (0, width - length))
    # instance i's entries from i * width, a multiple of the tile; ids 2i
    # for its true entries, 2i + 1 for the rest
    pos = torch.arange(width, device=dev)
    segs = (2 * torch.arange(num, device=dev)[:, None]
            + (pos[None] >= lens[:, None])).reshape(-1).to(torch.int32)
    sums = ops.rating_segment_sum_batch(
        x.reshape(rows // num, num * width).contiguous(), segs, 2 * num)
    return sums[:, 0::2].reshape(rows)


def prefix_sums(x: torch.Tensor, fixed_order: bool = False) -> torch.Tensor:
    """Inclusive prefix sums of ``x`` along its last axis.

    ``fixed_order`` (real-valued weights) on the card: a Hillis-Steele
    scan of elementwise adds, whose order at position p is fixed by p
    alone (``torch.cumsum`` on the card splits a row by the number of
    rows).  Elsewhere ``torch.cumsum``."""
    if not (fixed_order and x.is_cuda):
        return torch.cumsum(x, dim=-1)
    x = x.clone()
    d = 1
    while d < x.shape[-1]:
        x[..., d:] = x[..., d:] + x[..., :-d]
        d *= 2
    return x


def member_arrays(hga: HypergraphArrays,
                  ew_row: torch.Tensor) -> HypergraphArrays:
    """One mutation-cohort member's view of a shared-structure
    hypergraph: the structure shared, the edge-weight leaf swapped for
    the member's row."""
    return dataclasses.replace(hga, edge_weights=ew_row)


def block_weights(hga: HypergraphArrays, part: torch.Tensor,
                  k: int) -> torch.Tensor:
    """[k] total vertex weight per block."""
    return block_weights_population(hga, part[None], k)[0]


def block_weights_population(hga: HypergraphArrays, parts: torch.Tensor,
                             k: int) -> torch.Tensor:
    """[alpha, k] total vertex weight per block of every member."""
    return block_weight_sums(parts, hga.vertex_weights, k,
                             hga.real_vertex_weights, hga.n)


def block_weight_sums(parts: torch.Tensor, vertex_weights: torch.Tensor,
                      k: int, fixed_order: bool = False,
                      n=None) -> torch.Tensor:
    """[R, k] sums of ``vertex_weights`` ([n_pad], or one row per row of
    ``parts`` [R, n_pad]) per block.  ``fixed_order`` (real-valued
    weights) sorts each row's vertices by block, stably, and sums them
    with the rating kernel, in vertex order per block, instead of
    ``scatter_add_``: each row from a multiple of the kernel's tile, its
    vertices from ``n`` on (an int, or one per row: padding, of zero
    weight) in a last segment of their own, so a row's bits depend on
    that row alone."""
    rows, n_pad = parts.shape
    dev = parts.device
    vw = vertex_weights.expand(rows, -1)
    if not fixed_order:
        return torch.zeros((rows, k), dtype=torch.float32,
                           device=dev).scatter_add_(1, parts.long(), vw)
    from repro_torch.kernels import ops
    n = torch.as_tensor(n_pad if n is None else n, device=dev)
    local = torch.where(torch.arange(n_pad, device=dev)
                        < n.reshape(-1, 1), parts.long(), k)
    local, order = torch.sort(local, dim=1, stable=True)
    width = _tile_multiple(n_pad)
    vals = torch.nn.functional.pad(torch.gather(vw, 1, order),
                                   (0, width - n_pad))
    key = torch.nn.functional.pad(local, (0, width - n_pad), value=k)
    key = key + torch.arange(rows, device=dev)[:, None] * (k + 1)
    return ops.rating_segment_sum(
        vals.reshape(-1).contiguous(), key.reshape(-1).to(torch.int32),
        rows * (k + 1)).reshape(rows, k + 1)[:, :k]


def pins_in_block_population(hga: HypergraphArrays, parts: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Phi [alpha, m_pad, k] int32: for each member and edge, how many of
    the edge's pins lie in block j."""
    alpha = parts.shape[0]
    pin_parts = parts[:, hga.pin_vertex.long()].long()            # [a, P]
    base = torch.arange(alpha, device=parts.device)[:, None] * (hga.m_pad * k)
    flat = base + hga.pin_edge.long()[None, :] * k + pin_parts
    ones = torch.ones(flat.numel(), dtype=torch.int32, device=parts.device)
    counts = torch.zeros(alpha * hga.m_pad * k, dtype=torch.int32,
                         device=parts.device).index_add_(0, flat.reshape(-1),
                                                         ones)
    return counts.reshape(alpha, hga.m_pad, k)


def pins_in_block(hga: HypergraphArrays, part: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Phi [m_pad, k] int32 of one partition."""
    return pins_in_block_population(hga, part[None], k)[0]


def connectivity(hga: HypergraphArrays, part: torch.Tensor,
                 k: int) -> torch.Tensor:
    """lambda(e) [m_pad] int32: number of distinct blocks spanned."""
    return (pins_in_block(hga, part, k) > 0).sum(-1).to(torch.int32)


def connectivity_population(hga: HypergraphArrays, parts: torch.Tensor,
                            k: int) -> torch.Tensor:
    """lambda [alpha, m_pad] int32 of every member."""
    return (pins_in_block_population(hga, parts, k) > 0).sum(-1).to(
        torch.int32)


def cutsize(hga: HypergraphArrays, part: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of weights of edges spanning >= 2 blocks (the paper's
    objective), f32 scalar."""
    return cutsize_population(hga, part[None], k)[0]


def cutsize_population(hga: HypergraphArrays, parts: torch.Tensor,
                       k: int) -> torch.Tensor:
    """[alpha] f32 cut of every member (in a fixed order on real-valued
    edge weights, ``row_sums``)."""
    lam = (pins_in_block_population(hga, parts, k) > 0).sum(-1)
    return row_sums(torch.where(lam > 1, hga.edge_weights[None], 0.0),
                    hga.real_edge_weights, hga.m)


def cutsize_population_weighted(hga: HypergraphArrays, parts: torch.Tensor,
                                ew_pop: torch.Tensor, k: int) -> torch.Tensor:
    """[alpha] f32 cuts, each member measured with its own edge-weight
    row ``ew_pop[alpha, m_pad]`` over the shared structure (the mutation
    cohort's objective)."""
    lam = connectivity_population(hga, parts, k)
    return row_sums(torch.where(lam > 1, ew_pop, 0.0), True, hga.m)


def km1(hga: HypergraphArrays, part: torch.Tensor, k: int) -> torch.Tensor:
    """(lambda - 1) connectivity objective (KaHyPar's other metric)."""
    lam = connectivity(hga, part, k)
    return (torch.clamp(lam - 1, min=0).to(torch.float32)
            * hga.edge_weights).sum()


def edge_distance_matrix(hga: HypergraphArrays, parts: torch.Tensor,
                         k: int) -> torch.Tensor:
    """All-pairs label-invariant distance d_e (paper Eq. 2) between
    population members: the L1 distance of their connectivity vectors
    over the real edges.  Returns [alpha, alpha] int32."""
    lam = connectivity_population(hga, parts, k)[:, : hga.m].to(torch.int64)
    return (lam[:, None, :] - lam[None, :, :]).abs().sum(-1).to(torch.int32)


def node_distance(part_a: torch.Tensor, part_b: torch.Tensor,
                  valid_n: int | None = None) -> torch.Tensor:
    """Hamming distance d_v of two partitions (int64 scalar), over the
    first ``valid_n`` vertices when given; not label-invariant."""
    neq = part_a != part_b
    if valid_n is not None:
        neq = neq & (torch.arange(part_a.shape[0],
                                  device=part_a.device) < valid_n)
    return neq.sum()


def edge_distance(hga: HypergraphArrays, part_a: torch.Tensor,
                  part_b: torch.Tensor, k: int) -> torch.Tensor:
    """Label-invariant d_e (paper Eq. 2): the L1 distance of the two
    connectivity vectors over the real edges (int64 scalar)."""
    lam = connectivity_population(hga, torch.stack([part_a, part_b]), k)
    return (lam[0, : hga.m].long() - lam[1, : hga.m].long()).abs().sum()


def cut_edge_indicator(hga: HypergraphArrays, part: torch.Tensor,
                       k: int) -> torch.Tensor:
    """[m_pad] f32: 1.0 where the edge is cut."""
    return (connectivity(hga, part, k) > 1).to(torch.float32)


def balance_cap(total_weight: torch.Tensor, k: int,
                eps: float) -> torch.Tensor:
    """The paper's constraint: W_i <= (1+eps) * ceil(W/k) (f32)."""
    return (1.0 + eps) * torch.ceil(total_weight / k)


def is_balanced(hga: HypergraphArrays, part: torch.Tensor, k: int,
                eps: float) -> torch.Tensor:
    """True (0-d bool) when every block meets the balance cap."""
    bw = block_weights(hga, part, k)
    return (bw <= balance_cap(hga.total_weight, k, eps) + 1e-4).all()


def imbalance(hga: HypergraphArrays, part: torch.Tensor,
              k: int) -> torch.Tensor:
    """Heaviest block over the average block weight, minus one (f32)."""
    bw = block_weights(hga, part, k)
    avg = hga.total_weight / k
    return bw.max() / torch.clamp(avg, min=1e-9) - 1.0


# --------------------------------------------------------------------------
# FM move gains
# --------------------------------------------------------------------------
def _edge_gain_terms(hga: HypergraphArrays, phi: torch.Tensor,
                     ew_pop: torch.Tensor | None = None):
    """Per-edge FM terms (stage 1 of the gain pipeline) from Phi
    [..., m_pad, k]: becomes_internal [..., m_pad, k] and was_internal
    [..., m_pad] (f32).  ``ew_pop`` [alpha, m_pad] replaces the shared
    edge weights by each member's own row."""
    from repro_torch.kernels import ops
    return ops.edge_terms(phi, hga.edge_sizes,
                          hga.edge_weights if ew_pop is None else ew_pop)


def pins_by_vertex(hga: HypergraphArrays):
    """``(order, vertex)``: the pin permutation that sorts ``pin_vertex``
    ascending (stable) and the int32 vertex ids in that order, cached on
    ``hga`` (the structure is fixed per level) with the pins' edge ids in
    that order (``sorted_pin_edges``).  A CUDA graph must not build them
    during capture: callers that capture build them first."""
    if hga.pin_sort is None:
        order = torch.argsort(hga.pin_vertex, stable=True)
        hga.pin_sort = (order, hga.pin_vertex[order].contiguous())
        hga.pin_sort_edge = hga.pin_edge.long()[order]
    return hga.pin_sort


def sorted_pin_edges(hga: HypergraphArrays) -> torch.Tensor:
    """int64 edge id of every pin, pins in ``pins_by_vertex`` order: a
    gather through it builds per-pin rows already sorted by vertex."""
    pins_by_vertex(hga)
    return hga.pin_sort_edge


def _vertex_sums(hga: HypergraphArrays,
                 sorted_rows: torch.Tensor) -> torch.Tensor:
    """[R, n_pad] sums of per-pin rows ``sorted_rows[R, P]`` (pins in
    ``pins_by_vertex`` order, e.g. gathered through ``sorted_pin_edges``)
    over each vertex's pins, in a fixed order: the batched rating kernel,
    launched on the current stream with no host sync (capturable in a
    CUDA graph)."""
    from repro_torch.kernels import ops
    _, vertex = pins_by_vertex(hga)
    return ops.rating_segment_sum_batch(sorted_rows, vertex, hga.n_pad)


def _gain_segsum(hga: HypergraphArrays, phi: torch.Tensor,
                 ew_pop: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pin gather + segment-sum assembly from Phi [alpha, m_pad, k]:
    materialises an [alpha, P, k] intermediate."""
    becomes_internal, was_internal = _edge_gain_terms(hga, phi, ew_pop)
    pe, pv = hga.pin_edge.long(), hga.pin_vertex.long()
    alpha, _, k = phi.shape
    if ew_pop is not None or hga.real_edge_weights:
        # real-valued weights (member rows or a drifted level): the
        # (member, column) rows of becomes_internal, then the members'
        # was_internal rows, gathered with the pins sorted by vertex into
        # one buffer and summed per vertex in one fixed-order launch
        pe_v = sorted_pin_edges(hga)
        rows = torch.empty((alpha * (k + 1), pe_v.numel()),
                           dtype=torch.float32, device=phi.device)
        torch.index_select(becomes_internal.transpose(1, 2), 2, pe_v,
                           out=rows[: alpha * k].view(alpha, k, -1))
        torch.index_select(was_internal, 1, pe_v, out=rows[alpha * k:])
        sums = _vertex_sums(hga, rows)
        g = sums[: alpha * k].reshape(alpha, k, hga.n_pad).transpose(1, 2)
        return g - sums[alpha * k:, :, None]
    g = torch.zeros((alpha, hga.n_pad, k), dtype=torch.float32,
                    device=phi.device).index_add_(1, pv,
                                                  becomes_internal[:, pe])
    l = torch.zeros((alpha, hga.n_pad), dtype=torch.float32,
                    device=phi.device).index_add_(1, pv, was_internal[:, pe])
    return g - l[..., None]


def _gain_compact(hga: HypergraphArrays, phi: torch.Tensor, k: int,
                  ew_pop: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse assembly for large k, O(P) instead of O(P * k).

    ``becomes_internal`` has at most TWO nonzero columns per edge (an
    edge of size s >= 3 can have Phi = s-1 in at most one block, a
    size-2 edge in at most two; size <= 1 edges contribute no net gain
    and are dropped), so the two (column, weight) pairs per edge scatter
    through the pins straight into the gain table.  Column k stands for
    "none" and is sliced off.
    """
    alpha = phi.shape[0]
    dev = phi.device
    w = (hga.edge_weights[None].expand(alpha, -1) if ew_pop is None
         else ew_pop)                                       # [a, m_pad]
    s = hga.edge_sizes[:, None]
    multi = hga.edge_sizes >= 2
    mask = (phi == s - 1) & multi[:, None]                  # <= 2 per row
    cols = torch.arange(k, device=dev)
    c1 = torch.where(mask, cols, k).amin(-1)                # [a, m_pad]
    c2 = torch.where(mask & (cols != c1[..., None]), cols, k).amin(-1)
    was_internal = torch.where((phi == s) & multi[:, None], w[..., None],
                               0.0).sum(-1)
    pe, pv = hga.pin_edge.long(), hga.pin_vertex.long()
    rows = (torch.arange(alpha, device=dev)[:, None] * hga.n_pad
            + pv[None, :]) * (k + 1)                         # [a, P]
    wp = w[:, pe].reshape(-1)
    size = alpha * hga.n_pad * (k + 1)
    s1, s2 = (rows + c1[:, pe]).reshape(-1), (rows + c2[:, pe]).reshape(-1)
    if ew_pop is not None or hga.real_edge_weights:
        # real-valued weights: a stable sort of the (member, vertex,
        # column) slots makes the scatter a sorted-segment sum in a fixed
        # order
        from repro_torch.kernels import ops
        if size >= 2 ** 31:
            raise ValueError("compact gain slots exceed the rating "
                             "kernel's int32 segment ids")
        srt, perm = torch.sort(torch.cat([s1, s2]), stable=True)
        vals = torch.cat([wp, wp])[perm]
        # each member owns 2P consecutive slots of the sorted order: laid
        # out from multiples of the kernel's tile, the padding in the
        # member's last slot (its ghost's "none" column, sliced off)
        width = _tile_multiple(2 * hga.p_pad)
        if width != 2 * hga.p_pad:
            last = ((torch.arange(alpha, device=dev) + 1) * hga.n_pad
                    * (k + 1) - 1)[:, None]
            pad = (0, width - 2 * hga.p_pad)
            vals = torch.nn.functional.pad(vals.reshape(alpha, -1), pad)
            srt = torch.cat([srt.reshape(alpha, -1),
                             last.expand(alpha, pad[1])], dim=1)
        g = ops.rating_segment_sum(vals.reshape(-1).contiguous(),
                                   srt.reshape(-1).to(torch.int32), size)
        l = _vertex_sums(hga, was_internal[:, sorted_pin_edges(hga)])
    else:
        g = torch.zeros(size, dtype=torch.float32, device=dev)
        g.index_add_(0, s1, wp)
        g.index_add_(0, s2, wp)
        l = torch.zeros((alpha, hga.n_pad), dtype=torch.float32,
                        device=dev).index_add_(1, pv, was_internal[:, pe])
    g = g.reshape(alpha, hga.n_pad, k + 1)[..., :k]
    return g - l[..., None]


def _resolve_gain_path(hga: HypergraphArrays, k: int, assemble: str) -> str:
    """"auto" consults the ops dispatcher; a concrete path name forces it
    (the FM move loop pins "segsum")."""
    from repro_torch.kernels import ops
    if assemble == "auto":
        return ops.gain_path(hga.m_pad, k, hga.incident)
    return assemble


def _gain_matrix_population_impl(hga: HypergraphArrays, parts: torch.Tensor,
                                 k: int, assemble: str = "auto",
                                 phi: torch.Tensor | None = None,
                                 ew_pop: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Population gain matrices [alpha, n_pad, k]:

    gain[a, v, j] = reduction in cut if v moves from parts[a, v] to j
                  = sum_{e in I(v)} w_e * ([Phi(e,j) == |e|-1]
                                           - [Phi(e,part[v]) == |e|])

    with gain[a, v, parts[a, v]] == 0.  The kernel paths ("table",
    "stream") hand the per-edge tables of all members to one kernel
    launch; without a dense incidence layout they fall back to segsum.
    ``phi`` may be passed when the caller maintains it (FM).
    ``ew_pop`` [alpha, m_pad] gives every member its own edge-weight row
    over the shared structure (the mutation cohort): the weights enter
    only the per-edge tables, so the kernels get per-member tables and
    the one shared incidence layout.
    """
    if phi is None:
        phi = pins_in_block_population(hga, parts, k)
    path = _resolve_gain_path(hga, k, assemble)
    if path == "compact":
        g = _gain_compact(hga, phi, k, ew_pop)
    elif path == "segsum" or hga.incident is None:
        g = _gain_segsum(hga, phi, ew_pop)
    else:
        from repro_torch.kernels import ops
        bi, wi = _edge_gain_terms(hga, phi, ew_pop)
        g = ops.gain_assemble_batch(hga.incident, bi, wi, path)
    # moving to your own block is never a move
    return g.scatter_(2, parts.long()[..., None], 0.0)


def gain_matrix(hga: HypergraphArrays, part: torch.Tensor, k: int,
                phi: torch.Tensor | None = None,
                assemble: str = "auto") -> torch.Tensor:
    """Full [n_pad, k] cut-size gain matrix of one partition (see
    ``_gain_matrix_population_impl``).  On the kernel paths the one
    member's tables go to the one-member kernels (``ops.gain_assemble``);
    the other paths are the population ones with one member."""
    path = _resolve_gain_path(hga, k, assemble)
    if path in ("table", "stream") and hga.incident is not None:
        from repro_torch.kernels import ops
        if phi is None:
            phi = pins_in_block(hga, part, k)
        bi, wi = _edge_gain_terms(hga, phi)
        g = ops.gain_assemble(hga.incident, bi, wi, path)
        return g.scatter_(1, part.long()[:, None], 0.0)
    return _gain_matrix_population_impl(
        hga, part[None], k, assemble=path,
        phi=None if phi is None else phi[None])[0]
