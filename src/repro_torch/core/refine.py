"""Refinement: the two-tier scheme for a whole population (port of
``repro.core.refine``, single-device path).

* LP — balanced label-propagation rounds.  Every vertex scores all k
  destination blocks at once (the population gain tensor, one kernel
  launch for all members), proposals are accepted in global gain order
  subject to per-block capacity with sorted prefix sums.
* FM — one move at a time with negative-gain hill-climbing and
  best-prefix rollback; used on coarse levels (``n <= fm_node_limit``).

The reference runs both tiers inside device ``while_loop``s; here they
are host loops around batched tensor code, with the same per-member
trajectories: the tie-breaks are the reference's (stable argsort in
``accept_moves``, first-maximum argmax, ``NEG`` and the 1e-6 / 1e-9
slacks), and the integer-valued weights make every sum exact.

Both tiers guarantee: the returned partition never violates the balance
cap and never has a larger cut than the input.  Options of later slices
(per-member edge weights, mesh sharding, bounded migration) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import HypergraphArrays
from . import metrics

NEG = -1e30

#: FM move steps between two host reads of the "any move left" flag.
#: Once a member has no feasible move its state is frozen (the next step
#: finds the same empty move set), so running a few extra steps before
#: noticing changes nothing.
FM_FLAG_EVERY = 32


def _later_slice(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} belongs to a later slice of the port ({slice_name})")


def _check_slice_options(edge_weight_override=None, edge_weights_pop=None,
                         shard=None, incumbent=None, mig_budget=None,
                         model_shard=None) -> None:
    if edge_weight_override is not None or edge_weights_pop is not None:
        _later_slice("per-member edge weights (edge_weights_pop / "
                     "edge_weight_override)", "mutation")
    if shard not in (None, "off", "auto"):
        _later_slice(f"shard={shard!r}", "multi-device paths")
    if model_shard not in (None, "off", "auto"):
        _later_slice(f"model_shard={model_shard!r}", "multi-device paths")
    if incumbent is not None or mig_budget is not None:
        _later_slice("incumbent / mig_budget", "incremental repartitioning")


def pad_part(part, n_pad: int, device=None) -> torch.Tensor:
    """Pad a length-n partition vector to n_pad (pad block = 0; padded
    vertices have zero weight and no pins, so the value is inert)."""
    part = torch.as_tensor(part, device=device).to(torch.int32)
    if part.shape[0] == n_pad:
        return part
    return torch.cat([part, torch.zeros(n_pad - part.shape[0],
                                        dtype=torch.int32,
                                        device=part.device)])


def pad_parts(parts, n_pad: int, device=None) -> torch.Tensor:
    """Stack a population (list of [n] vectors or an [alpha, n] array)
    into a padded [alpha, n_pad] int32 tensor (a new tensor: callers may
    write into it)."""
    if isinstance(parts, (list, tuple)):
        return torch.stack([pad_part(p, n_pad, device) for p in parts])
    parts = torch.as_tensor(parts, device=device).to(torch.int32)
    if parts.dim() != 2:
        raise ValueError(f"expected [alpha, n] population, got "
                         f"{tuple(parts.shape)}")
    pad = torch.zeros((parts.shape[0], n_pad - parts.shape[1]),
                      dtype=torch.int32, device=parts.device)
    return torch.cat([parts, pad], dim=1)


# --------------------------------------------------------------------------
# label propagation round
# --------------------------------------------------------------------------
def accept_moves(part: torch.Tensor, target: torch.Tensor,
                 gain: torch.Tensor, propose: torch.Tensor,
                 vertex_weights: torch.Tensor, bw: torch.Tensor,
                 cap: torch.Tensor, frac: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """Balanced parallel-move acceptance for every member at once
    (``part``/``target``/``gain``/``propose`` [alpha, n_pad], ``bw``
    [alpha, k], ``frac`` [alpha]).

    Proposals (vertex -> target block, expected gain) are ranked by gain
    with a stable sort; the top ``frac`` are kept; per-target-block
    capacity is enforced with a prefix sum over the sorted proposal
    weights.
    """
    alpha, n_pad = part.shape
    order = torch.argsort(torch.where(propose, -gain, -NEG), dim=1,
                          stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(n_pad, device=part.device).expand(alpha, -1))
    keep_n = torch.ceil(frac * propose.sum(1)).to(torch.int64)
    propose = propose & (ranks < keep_n[:, None])

    w_sorted = torch.gather(
        torch.where(propose, vertex_weights[None], 0.0), 1, order)
    tgt_sorted = torch.gather(torch.where(propose, target, k), 1,
                              order).long()          # k = "no move"
    # per-block prefix sums of the sorted proposal weights, laid out
    # [a, k+1, n] so the scan runs over the innermost axis (a scan over
    # a middle axis took 4.6 ms per call at ibm08 shapes on the H100);
    # the one-hot is a comparison because F.one_hot syncs the device
    tgt_oh = (torch.arange(k + 1, device=part.device)[None, :, None]
              == tgt_sorted[:, None, :])
    pref = torch.cumsum(tgt_oh * w_sorted[:, None, :], dim=2)  # [a, k+1, n]
    fits_sorted = pref[:, :k] <= (cap - bw)[..., None] + 1e-6
    fit_own = torch.gather(fits_sorted, 1,
                           tgt_sorted.clamp(max=k - 1)[:, None, :])[:, 0]
    accept_sorted = fit_own & (tgt_sorted < k)
    accept = torch.zeros_like(propose).scatter_(1, order, accept_sorted)
    return torch.where(accept, target, part)


def _lp_round_from_gains(h: HypergraphArrays, parts: torch.Tensor, k: int,
                         cap: torch.Tensor, fracs: torch.Tensor,
                         gains: torch.Tensor) -> torch.Tensor:
    """Proposal + balanced acceptance given the population gain tensor
    [alpha, n_pad, k]: every vertex proposes its best block (first
    maximum), positive gains only."""
    n_pad = h.n_pad
    own = parts.long()[..., None] == torch.arange(k, device=parts.device)
    gains = torch.where(own, NEG, gains)
    best_j = torch.argmax(gains, dim=-1)
    best_g = torch.gather(gains, 2, best_j[..., None])[..., 0]
    valid = ((torch.arange(n_pad, device=parts.device) < h.n)
             & (h.vertex_weights > 0))
    propose = valid[None] & (best_g > 1e-9)
    bw = metrics.block_weights_population(h, parts, k)
    return accept_moves(parts, best_j.to(torch.int32), best_g, propose,
                        h.vertex_weights, bw, cap, fracs, k)


def _lp_round_population_impl(hga: HypergraphArrays, parts: torch.Tensor,
                              k: int, cap: torch.Tensor, fracs: torch.Tensor
                              ) -> torch.Tensor:
    """One LP round for all members: the gains of the whole population
    come from one dispatch (one kernel launch on the kernel paths)."""
    gains = metrics._gain_matrix_population_impl(hga, parts, k)
    return _lp_round_from_gains(hga, parts, k, cap, fracs, gains)


def _lp_attempt_population_impl(hga: HypergraphArrays, parts: torch.Tensor,
                                cuts: torch.Tensor, fracs: torch.Tensor,
                                attempts: int, k: int, cap: torch.Tensor):
    """The LP attempt loop: per member, propose a round at the current
    acceptance fraction, measure the cut, accept on improvement,
    otherwise quarter the fraction and retry.  Returns as soon as any
    member improved (the caller resumes the others), reading back one
    flag per attempt.  Returns ``(parts, cuts, improved, fracs, used)``.
    """
    improved = torch.zeros(parts.shape[0], dtype=torch.bool,
                           device=parts.device)
    used = 0
    while used < attempts:
        cands = _lp_round_population_impl(hga, parts, k, cap, fracs)
        cs = metrics.cutsize_population(hga, cands, k)
        take = cs < cuts - 1e-6
        parts = torch.where(take[:, None], cands, parts)
        cuts = torch.where(take, cs, cuts)
        fracs = torch.where(take, fracs, fracs * 0.25)
        improved = improved | take
        used += 1
        if bool(improved.any()):
            break
    return parts, cuts, improved, fracs, used


def _cap_for(hga: HypergraphArrays, k: int, eps: float) -> torch.Tensor:
    """The balance cap of (hga, k, eps), an f32 scalar on hga's device."""
    return metrics.balance_cap(hga.total_weight, k, eps)


def lp_refine_population(hga: HypergraphArrays, parts, k: int, eps: float,
                         max_iters: int = 24, patience: int = 3,
                         edge_weight_override=None, edge_weights_pop=None,
                         shard: str | None = None,
                         incumbent=None, mig_budget: float | None = None,
                         model_shard: str | None = None
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """Batched LP refinement: the host tracks stall counters per member;
    members that stopped improving drop out of the batch, so each member
    follows exactly the trajectory the reference gives it.
    Returns (parts [alpha, n_pad] int32 on hga's device, cuts [alpha]
    float64)."""
    _check_slice_options(edge_weight_override, edge_weights_pop, shard,
                         incumbent, mig_budget, model_shard)
    dev = hga.device
    cap = _cap_for(hga, k, eps)
    parts = pad_parts(parts, hga.n_pad, dev)
    alpha = parts.shape[0]
    cuts = metrics.cutsize_population(hga, parts, k).cpu().numpy().astype(
        np.float64)

    stall = np.zeros(alpha, np.int32)
    done = np.zeros(alpha, bool)
    for _ in range(max_iters):
        active = np.nonzero(~done)[0]
        if len(active) == 0:
            break
        improved_round = np.zeros(alpha, bool)
        idx = active
        fracs = np.ones(alpha, np.float32)
        remaining = 5
        while remaining > 0 and len(idx):
            idx_t = torch.as_tensor(idx, device=dev)
            sub = parts[idx_t] if len(idx) < alpha else parts
            new_sub, new_cuts, improved, new_fracs, used = \
                _lp_attempt_population_impl(
                    hga, sub,
                    torch.as_tensor(cuts[idx], dtype=torch.float32,
                                    device=dev),
                    torch.as_tensor(fracs[idx], device=dev),
                    remaining, k, cap)
            improved = improved.cpu().numpy()
            if len(idx) < alpha:
                parts[idx_t] = new_sub
            else:
                parts = new_sub
            # unimproved lanes pass their f32 cuts through unchanged
            cuts[idx] = new_cuts.cpu().numpy().astype(np.float64)
            fracs[idx] = new_fracs.cpu().numpy()
            improved_round[idx[improved]] = True
            remaining -= used
            idx = idx[~improved]
        stall[active] = np.where(improved_round[active], 0,
                                 stall[active] + 1)
        done |= stall >= patience
    return parts, cuts


# --------------------------------------------------------------------------
# sequential FM for coarse levels
# --------------------------------------------------------------------------
def _fm_pass_population_impl(hga: HypergraphArrays, parts: torch.Tensor,
                             k: int, cap: torch.Tensor, steps: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FM pass for every member: up to ``steps`` single moves
    (negative gains allowed), returning each member's best prefix
    (partition + its cut).

    A member stops once no feasible move exists (every vertex locked or
    infeasible); from then on its state is frozen, so the loop runs
    until every member stopped or ``steps`` is reached, and reads the
    flag only every ``FM_FLAG_EVERY`` steps — the result is the same as
    checking it after every move.
    """
    alpha, n_pad = parts.shape
    dev = parts.device
    rows = torch.arange(alpha, device=dev)
    vw = hga.vertex_weights
    pv, pe = hga.pin_vertex.long(), hga.pin_edge.long()
    valid = (torch.arange(n_pad, device=dev) < hga.n) & (vw > 0)
    part = parts.clone()
    phi = metrics.pins_in_block_population(hga, part, k)
    bw = metrics.block_weights_population(hga, part, k)
    cur_cut = metrics.cutsize_population(hga, part, k)
    best_cut = cur_cut.clone()
    best_part = part.clone()
    locked = torch.zeros((alpha, n_pad), dtype=torch.bool, device=dev)
    blocks = torch.arange(k, device=dev)
    # FM pins the segsum path: it only runs on coarse levels, whose small
    # pin counts make the [alpha, P, k] segment-sum cheaper per move
    # step than the compact path's fixed extract/scatter overhead
    feasible_slack = cap + 1e-6
    t = 0
    while t < steps:
        gains = metrics._gain_matrix_population_impl(hga, part, k,
                                                     assemble="segsum",
                                                     phi=phi)
        own = part.long()[..., None] == blocks
        feasible = (bw[:, None, :] + vw[None, :, None]) <= feasible_slack
        score = torch.where(own | ~feasible, NEG, gains)
        score = torch.where((locked | ~valid[None])[..., None], NEG, score)
        flat = torch.argmax(score.reshape(alpha, -1), dim=1)
        v = flat // k
        j = flat % k
        g = score.reshape(alpha, -1)[rows, flat]
        do = g > NEG / 2  # any feasible move at all?

        b = part[rows, v].long()
        d = (pv[None, :] == v[:, None]).to(torch.int32)         # [a, P]
        d = torch.zeros((alpha, hga.m_pad), dtype=torch.int32,
                        device=dev).index_add_(1, pe, d)         # [a, m_pad]
        delta = ((blocks == j[:, None]).to(torch.int32)
                 - (blocks == b[:, None]).to(torch.int32))      # [a, k]
        dm = do[:, None]
        phi = torch.where(dm[..., None], phi + d[..., None] * delta[:, None],
                          phi)
        bw = torch.where(dm, bw + vw[v][:, None] * delta, bw)
        part = torch.where(
            dm & (torch.arange(n_pad, device=dev)[None] == v[:, None]),
            j.to(torch.int32)[:, None], part)
        locked[rows, v] = locked[rows, v] | do
        cur_cut = torch.where(do, cur_cut - g, cur_cut)
        better = do & (cur_cut < best_cut - 1e-9)
        best_cut = torch.where(better, cur_cut, best_cut)
        best_part = torch.where(better[:, None], part, best_part)
        t += 1
        if t % FM_FLAG_EVERY == 0 and not bool(do.any()):
            break
    return best_part, best_cut


def _fm_pass_impl(hga: HypergraphArrays, part: torch.Tensor, k: int,
                  cap: torch.Tensor, steps: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FM pass of a single partition [n_pad]: the population pass
    with one member.  Returns (best prefix partition, its cut)."""
    best_part, best_cut = _fm_pass_population_impl(hga, part[None], k, cap,
                                                   steps)
    return best_part[0], best_cut[0]


def fm_refine_population(hga: HypergraphArrays, parts, k: int, eps: float,
                         max_passes: int = 8,
                         step_budget: int | None = None,
                         edge_weights_pop=None, shard: str | None = None,
                         incumbent=None, mig_budget: float | None = None,
                         model_shard: str | None = None
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """Batched FM with per-member pass acceptance: a member stops
    improving exactly when the scalar loop would have broken.
    Returns (parts [alpha, n_pad], cuts [alpha] float64)."""
    _check_slice_options(None, edge_weights_pop, shard, incumbent,
                         mig_budget, model_shard)
    dev = hga.device
    cap = _cap_for(hga, k, eps)
    parts = pad_parts(parts, hga.n_pad, dev)
    alpha = parts.shape[0]
    cuts = metrics.cutsize_population(hga, parts, k).cpu().numpy().astype(
        np.float64)
    steps = step_budget or int(min(hga.n_pad, 1024))
    done = np.zeros(alpha, bool)
    for _ in range(max_passes):
        idx = np.nonzero(~done)[0]  # compact: finished members drop out
        if len(idx) == 0:
            break
        idx_t = torch.as_tensor(idx, device=dev)
        cands, cs = _fm_pass_population_impl(hga, parts[idx_t], k, cap,
                                             steps)
        cs = cs.cpu().numpy().astype(np.float64)
        take = cs < cuts[idx] - 1e-6
        if take.any():
            tidx = idx[take]
            parts[torch.as_tensor(tidx, device=dev)] = \
                cands[torch.as_tensor(np.nonzero(take)[0], device=dev)]
            cuts[tidx] = cs[take]
        done[idx[~take]] = True
    return parts, cuts


# --------------------------------------------------------------------------
# combined per-level refinement + balance safety net
# --------------------------------------------------------------------------
def refine_population(hga: HypergraphArrays, parts, k: int, eps: float,
                      fm_node_limit: int = 4096, edge_weights_pop=None,
                      shard: str | None = None, incumbent=None,
                      mig_budget: float | None = None,
                      model_shard: str | None = None,
                      device: str | torch.device = "cuda", **kw
                      ) -> Tuple[torch.Tensor, np.ndarray]:
    """Two-tier refinement of the whole population (LP, then FM on
    levels with at most ``fm_node_limit`` vertices) on ``device``, where
    ``hga`` must live.  Returns (parts [alpha, n_pad] int32 on the
    device, cuts [alpha] float64)."""
    if hga.device.type != resolve_device(device).type:
        raise ValueError(f"hga lives on {hga.device}, device={device!r} was "
                         "requested")
    parts, cuts = lp_refine_population(hga, parts, k, eps,
                                       edge_weights_pop=edge_weights_pop,
                                       shard=shard, incumbent=incumbent,
                                       mig_budget=mig_budget,
                                       model_shard=model_shard, **kw)
    if int(hga.n) <= fm_node_limit:
        parts, cuts = fm_refine_population(hga, parts, k, eps, shard=shard,
                                           model_shard=model_shard)
    return parts, cuts


def rebalance(hg_vertex_weights: np.ndarray, part: np.ndarray, k: int,
              eps: float, rng: np.random.Generator | None = None
              ) -> np.ndarray:
    """Host safety net: spill the lightest vertices out of overfull blocks
    and re-place them (heaviest first) into blocks that actually have
    headroom, iterating to a fixpoint.  Only when a vertex fits nowhere
    does it fall back to the least-loaded block."""
    del rng  # kept for signature compatibility; the procedure is greedy
    part = np.asarray(part).copy()
    w = np.asarray(hg_vertex_weights, np.float64)
    n = len(part)
    total = w.sum()
    cap = (1.0 + eps) * np.ceil(total / k)
    bw = np.zeros(k)
    np.add.at(bw, part[:n], w)

    for _ in range(k + 1):  # forced placements may need another pass
        spill: list = []
        for b in range(k):
            if bw[b] <= cap + 1e-6:
                continue
            members = np.nonzero(part == b)[0]
            order = members[np.argsort(w[members], kind="stable")]
            for v in order:  # evict lightest first
                if bw[b] <= cap + 1e-6:
                    break
                spill.append(v)
                bw[b] -= w[v]
        if not spill:
            break
        # place heaviest first (best-fit decreasing)
        spill.sort(key=lambda v: -w[v])
        for v in spill:
            fits = np.nonzero(bw + w[v] <= cap + 1e-6)[0]
            tgt = (fits[np.argmin(bw[fits])] if len(fits)
                   else int(np.argmin(bw)))
            part[v] = tgt
            bw[tgt] += w[v]
    return part
