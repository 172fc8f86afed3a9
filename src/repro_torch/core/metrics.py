"""Partition quality metrics and FM move gains (port of
``repro.core.metrics``).

Everything is computed from the flat pin arrays with segment
reductions.  Partition vectors are int32 ``[n_pad]`` (or a population
``[alpha, n_pad]``); the ghost vertex ``n_pad - 1`` carries any valid
block id and zero weight, ghost pins point at the zero-weight ghost
edge.  Flat indices are int64: the reference's int32 ``edge * k + part``
overflows once ``m_pad * k`` or ``n_pad * k`` passes 2**31.

Edge and vertex weights are integer-valued f32 on every instance the
engines ingest, so Phi, lambda, cuts, block weights and gains are exact
sums in any order: the population functions here are bit-equal to the
reference's vmapped ones, whatever path assembles the gains.
"""
from __future__ import annotations

import torch

from .hypergraph import HypergraphArrays


def block_weights(hga: HypergraphArrays, part: torch.Tensor,
                  k: int) -> torch.Tensor:
    """[k] total vertex weight per block."""
    return block_weights_population(hga, part[None], k)[0]


def block_weights_population(hga: HypergraphArrays, parts: torch.Tensor,
                             k: int) -> torch.Tensor:
    """[alpha, k] total vertex weight per block of every member."""
    vw = hga.vertex_weights.expand(parts.shape[0], -1)
    return torch.zeros((parts.shape[0], k), dtype=torch.float32,
                       device=parts.device).scatter_add_(1, parts.long(), vw)


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


def cutsize(hga: HypergraphArrays, part: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of weights of edges spanning >= 2 blocks (the paper's
    objective), f32 scalar."""
    return cutsize_population(hga, part[None], k)[0]


def cutsize_population(hga: HypergraphArrays, parts: torch.Tensor,
                       k: int) -> torch.Tensor:
    """[alpha] f32 cut of every member."""
    lam = (pins_in_block_population(hga, parts, k) > 0).sum(-1)
    return torch.where(lam > 1, hga.edge_weights[None], 0.0).sum(-1)


def balance_cap(total_weight: torch.Tensor, k: int,
                eps: float) -> torch.Tensor:
    """The paper's constraint: W_i <= (1+eps) * ceil(W/k) (f32)."""
    return (1.0 + eps) * torch.ceil(total_weight / k)


# --------------------------------------------------------------------------
# FM move gains
# --------------------------------------------------------------------------
def _edge_gain_terms(hga: HypergraphArrays, phi: torch.Tensor):
    """Per-edge FM terms (stage 1 of the gain pipeline) from Phi
    [..., m_pad, k]: becomes_internal [..., m_pad, k] and was_internal
    [..., m_pad] (f32)."""
    sizes = hga.edge_sizes[:, None]
    w = hga.edge_weights[:, None]
    becomes_internal = torch.where(phi == sizes - 1, w, 0.0)
    was_internal = torch.where((phi == sizes) & (sizes > 0), w,
                               0.0).sum(-1)
    return becomes_internal, was_internal


def _gain_segsum(hga: HypergraphArrays, phi: torch.Tensor) -> torch.Tensor:
    """Per-pin gather + segment-sum assembly from Phi [alpha, m_pad, k]:
    materialises an [alpha, P, k] intermediate."""
    becomes_internal, was_internal = _edge_gain_terms(hga, phi)
    pe, pv = hga.pin_edge.long(), hga.pin_vertex.long()
    alpha, _, k = phi.shape
    g = torch.zeros((alpha, hga.n_pad, k), dtype=torch.float32,
                    device=phi.device).index_add_(1, pv,
                                                  becomes_internal[:, pe])
    l = torch.zeros((alpha, hga.n_pad), dtype=torch.float32,
                    device=phi.device).index_add_(1, pv, was_internal[:, pe])
    return g - l[..., None]


def _gain_compact(hga: HypergraphArrays, phi: torch.Tensor,
                  k: int) -> torch.Tensor:
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
    w = hga.edge_weights
    s = hga.edge_sizes[:, None]
    multi = hga.edge_sizes >= 2
    mask = (phi == s - 1) & multi[:, None]                  # <= 2 per row
    cols = torch.arange(k, device=dev)
    c1 = torch.where(mask, cols, k).amin(-1)                # [a, m_pad]
    c2 = torch.where(mask & (cols != c1[..., None]), cols, k).amin(-1)
    was_internal = torch.where((phi == s) & multi[:, None], w[:, None],
                               0.0).sum(-1)
    pe, pv = hga.pin_edge.long(), hga.pin_vertex.long()
    rows = (torch.arange(alpha, device=dev)[:, None] * hga.n_pad
            + pv[None, :]) * (k + 1)                         # [a, P]
    wp = w[pe].expand(alpha, -1).reshape(-1)
    g = torch.zeros(alpha * hga.n_pad * (k + 1), dtype=torch.float32,
                    device=dev)
    g.index_add_(0, (rows + c1[:, pe]).reshape(-1), wp)
    g.index_add_(0, (rows + c2[:, pe]).reshape(-1), wp)
    g = g.reshape(alpha, hga.n_pad, k + 1)[..., :k]
    l = torch.zeros((alpha, hga.n_pad), dtype=torch.float32,
                    device=dev).index_add_(1, pv, was_internal[:, pe])
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
                                 phi: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Population gain matrices [alpha, n_pad, k]:

    gain[a, v, j] = reduction in cut if v moves from parts[a, v] to j
                  = sum_{e in I(v)} w_e * ([Phi(e,j) == |e|-1]
                                           - [Phi(e,part[v]) == |e|])

    with gain[a, v, parts[a, v]] == 0.  The kernel paths ("table",
    "stream") hand the per-edge tables of all members to one kernel
    launch; without a dense incidence layout they fall back to segsum.
    ``phi`` may be passed when the caller maintains it (FM).
    """
    if phi is None:
        phi = pins_in_block_population(hga, parts, k)
    path = _resolve_gain_path(hga, k, assemble)
    if path == "compact":
        g = _gain_compact(hga, phi, k)
    elif path == "segsum" or hga.incident is None:
        g = _gain_segsum(hga, phi)
    else:
        from repro_torch.kernels import ops
        bi, wi = _edge_gain_terms(hga, phi)
        g = ops.gain_assemble_batch(hga.incident, bi, wi, path)
    # moving to your own block is never a move
    return g.scatter_(2, parts.long()[..., None], 0.0)


def gain_matrix(hga: HypergraphArrays, part: torch.Tensor, k: int,
                phi: torch.Tensor | None = None,
                assemble: str = "auto") -> torch.Tensor:
    """Full [n_pad, k] cut-size gain matrix of one partition (see
    ``_gain_matrix_population_impl``)."""
    return _gain_matrix_population_impl(
        hga, part[None], k, assemble=assemble,
        phi=None if phi is None else phi[None])[0]
