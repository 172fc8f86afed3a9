"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``), plus the library call ``chip_smoke.py`` times as
the gain kernels' yardstick.

Every CPU run uses these, and on the card each kernel is held against
its plain version on the same inputs.  Layouts match the kernels:
``incident[N, D]`` int32 edge ids (pad = -1) shared by all members,
per-member edge tables ``bi[alpha, M, k]`` / ``wi[alpha, M]``, sorted
segment ids for the rating sum, the padded pin matrix ``pins[M, S]``
(pad = -1) for connectivity and cut, and bag ids ``idx[B, L]`` (pad =
-1) for the embedding bag.
"""
from __future__ import annotations

import torch


def gain_gather_batch_ref(incident: torch.Tensor,
                          becomes_internal: torch.Tensor,
                          was_internal: torch.Tensor) -> torch.Tensor:
    """Population gain assembly:
    ``gains[a, v, :] = sum_d bi[a, inc[v, d], :] - sum_d wi[a, inc[v, d]]``
    with pad entries (-1) skipped.  Returns [alpha, N, k] f32."""
    m = becomes_internal.shape[1]
    valid = incident >= 0                                    # [N, D]
    idx = incident.clamp(0, m - 1).long()
    rows = becomes_internal[:, idx] * valid[None, :, :, None]   # [a, N, D, k]
    loss = was_internal[:, idx] * valid[None]                    # [a, N, D]
    return rows.sum(dim=2) - loss.sum(dim=2, keepdim=True)


def gain_stream_batch_ref(incident: torch.Tensor,
                          becomes_internal: torch.Tensor,
                          was_internal: torch.Tensor,
                          block_m: int = 2048) -> torch.Tensor:
    """Edge-tile-order version of ``gain_gather_batch_ref`` (the
    accumulation order of ``repro.kernels.ref.gain_stream_ref``): the
    edge tables are swept in ``block_m``-row tiles and each tile's
    partial gains (sum over D of its masked rows, minus its losses) are
    added to the running result.  Every tile gathers a full
    [alpha, N, D, k] block, so the tile is wide to keep the sweep short
    at fine levels."""
    alpha, m, k = becomes_internal.shape
    out = torch.zeros((alpha, incident.shape[0], k), dtype=torch.float32,
                      device=incident.device)
    for lo in range(0, m, block_m):
        bi = becomes_internal[:, lo:lo + block_m]
        wi = was_internal[:, lo:lo + block_m]
        local = incident - lo
        valid = (incident >= 0) & (local >= 0) & (local < bi.shape[1])
        safe = torch.where(valid, local, 0).long()
        rows = bi[:, safe] * valid[None, :, :, None]
        loss = wi[:, safe] * valid[None]
        out = out + (rows.sum(dim=2) - loss.sum(dim=2, keepdim=True))
    return out


def gain_gather_ref(incident: torch.Tensor, becomes_internal: torch.Tensor,
                    was_internal: torch.Tensor) -> torch.Tensor:
    """One-member gain assembly: tables bi [M, k], wi [M] -> [N, k]."""
    return gain_gather_batch_ref(incident, becomes_internal[None],
                                 was_internal[None])[0]


def gain_stream_ref(incident: torch.Tensor, becomes_internal: torch.Tensor,
                    was_internal: torch.Tensor,
                    block_m: int = 2048) -> torch.Tensor:
    """One-member edge-tile-order gain assembly (``gain_stream_batch_ref``
    with one member)."""
    return gain_stream_batch_ref(incident, becomes_internal[None],
                                 was_internal[None], block_m)[0]


def rating_segment_sum_ref(vals: torch.Tensor, segs: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Segment-sum of candidate ratings: ``out[s] = sum vals[c]`` over
    ``segs[c] == s``; ids outside [0, num_segments) are dropped."""
    ok = (segs >= 0) & (segs < num_segments)
    return torch.zeros(num_segments, dtype=torch.float32,
                       device=vals.device).index_add_(
        0, torch.where(ok, segs, num_segments - 1).long(),
        torch.where(ok, vals, 0.0))


def rating_segment_sum_batch_ref(vals: torch.Tensor, segs: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Per-member rating sums: vals [alpha, C] over one shared segs [C]
    -> [alpha, num_segments]; row a is ``rating_segment_sum_ref(vals[a])``
    (the rows are summed one at a time, so they are bit-equal to it)."""
    return torch.stack([rating_segment_sum_ref(row, segs, num_segments)
                        for row in vals]) if vals.shape[0] else \
        torch.zeros((0, num_segments), dtype=torch.float32,
                    device=vals.device)


def connectivity_ref(pins: torch.Tensor, part: torch.Tensor,
                     k: int) -> torch.Tensor:
    """lambda(e) [M] int32: the number of distinct blocks among each
    edge's valid pins (one-hot form; a pin id >= N reads part[N - 1], a
    block id outside [0, k) counts for no block)."""
    valid = pins >= 0
    p = part[pins.clamp(0, part.shape[0] - 1).long()]             # [M, S]
    onehot = ((p[..., None] == torch.arange(k, device=pins.device))
              & valid[..., None])                                 # [M, S, k]
    return onehot.any(dim=1).sum(dim=-1).to(torch.int32)


def cutsize_ref(pins: torch.Tensor, part: torch.Tensor,
                edge_weights: torch.Tensor, k: int) -> torch.Tensor:
    """f32 scalar: the weight of the edges with lambda(e) > 1."""
    lam = connectivity_ref(pins, part, k)
    return torch.where(lam > 1, edge_weights, 0.0).sum()


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ``out[b] = sum_l table[idx[b, l]]`` over the ids
    >= 0 (an id >= R reads row R - 1), summed in f32; ``mean`` then
    divides by L (pads counted).  Returns [B, D] in the table's dtype."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    valid = (indices >= 0)[..., None]                             # [B, L, 1]
    rows = table[indices.clamp(0, table.shape[0] - 1).long()].float()
    out = (rows * valid).sum(dim=1)
    if combiner == "mean":
        out = out / indices.shape[1]
    return out.to(table.dtype)


def gain_gather_embedding_bag(incident: torch.Tensor,
                              becomes_internal: torch.Tensor) -> torch.Tensor:
    """The gather-sum half of the gain assembly as one
    ``torch.nn.functional.embedding_bag`` call per member: the library
    yardstick (``library_ms``) of the gain kernels in ``chip_smoke.py``.
    Pads are sent to the last table row and excluded with
    ``padding_idx``, so a genuine reference to that row is dropped too
    (on the port's levels it is the all-zero ghost edge).  The port
    never calls this."""
    m = becomes_internal.shape[1]
    idx = torch.where(incident >= 0, incident, m - 1).long()
    return torch.stack([
        torch.nn.functional.embedding_bag(idx, table, mode="sum",
                                          padding_idx=m - 1)
        for table in becomes_internal])
