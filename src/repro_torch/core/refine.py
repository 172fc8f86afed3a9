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
cap and never has a larger cut than the input.  ``edge_weights_pop``
gives every member its own edge-weight row over the shared structure
(the mutation cohort, DESIGN.md §10).  Both tiers also refine a stack of
independent instances as rows of one population (``core.instances``,
DESIGN.md §12), with each row's missing blocks, frozen state and FM step
budget given as masks.  ``incumbent`` + ``mig_budget`` bound every
member's moved vertex weight relative to an incumbent assignment through
both tiers (incremental repartitioning, DESIGN.md §14); an infinite
budget (``mig_budget=None``) gives the bits of a call without them.

``shard`` (None = ``REPRO_POP_SHARD``, DESIGN.md §11) routes both tiers
over the pool of ``core.popshard``: on ``mesh`` the member rows are
padded to the "pop" size and split into contiguous blocks, the level's
structure and cap are placed once per (level, device), and every shard
runs the single-device code on its rows; the LP attempt loop ORs the
shards' "any lane improved" flags after every attempt (the reference's
``psum`` over "pop"), so every shard runs the single-device trip count;
FM needs no collective, each shard's move loop ends when its own lanes
are done.  ``chunk`` splits the FM batch over the pool's devices and
keeps LP on one device.  Every per-row sum of real-valued weights has a
fixed order whatever the rows that share the launch
(``metrics.row_sums``, ``block_weight_sums``, ``prefix_sums``), so each
member gets the same bits on every route.  The model axis
(``model_shard``) belongs to a later slice and raises
``NotImplementedError``.

The scalar entry points (``lp_round``, ``lp_refine``, ``fm_refine``,
``refine``) refine one partition; the baselines and recombination's
clustered solver use them.  Their LP gains come from the one-member
gain kernels (``metrics.gain_matrix``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import HypergraphArrays, is_real_valued
from . import metrics, popshard

NEG = -1e30

#: FM move steps between two host reads of the "any move left" flag,
#: and the steps one CUDA graph replays on the card.  Once a member has
#: no feasible move its state is frozen (the next step finds the same
#: empty move set), so running a few extra steps before noticing changes
#: nothing.
FM_FLAG_EVERY = 32


def _later_slice(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} belongs to a later slice of the port ({slice_name})")


def _check_slice_options(shard=None, model_shard=None,
                         device: str | torch.device = "cuda") -> str:
    """The population route ``shard`` resolves to over the pool of
    ``device``'s type (``popshard.resolve``); a ``model_shard`` other
    than off raises."""
    if model_shard not in (None, "off", "auto"):
        _later_slice(f"model_shard={model_shard!r}",
                     "the model axis, item 13c")
    return popshard.resolve(shard, device)


def _migration_args(incumbent, mig_budget, n_pad: int, device):
    """The incumbent [n_pad] int32 and the budget (an f32 scalar, inf
    for None) on ``device``, or ``(None, None)`` without an incumbent.
    The budget is rounded to f32 as the reference's traced scalar is."""
    if incumbent is None:
        return None, None
    inc = pad_part(incumbent, n_pad, device)
    mb = torch.tensor(np.inf if mig_budget is None else float(mig_budget),
                      dtype=torch.float32, device=device)
    return inc, mb


def _moved_weight(lv, parts: torch.Tensor,
                  incumbent: torch.Tensor) -> torch.Tensor:
    """[R] f32 weight of the vertices of each row that sit outside their
    incumbent block (in a fixed order on real-valued vertex weights)."""
    return metrics.row_sums(
        torch.where(parts != incumbent, lv.vertex_weights, 0.0),
        lv.real_vertex_weights, lv.n_lens)


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
                 cap: torch.Tensor, frac: torch.Tensor, k: int,
                 incumbent: torch.Tensor | None = None,
                 mig_remaining: torch.Tensor | None = None,
                 fixed_order: bool = False) -> torch.Tensor:
    """Balanced parallel-move acceptance for every member at once
    (``part``/``target``/``gain``/``propose`` [alpha, n_pad], ``bw``
    [alpha, k], ``frac`` [alpha]).

    Proposals (vertex -> target block, expected gain) are ranked by gain
    with a stable sort; the top ``frac`` are kept; per-target-block
    capacity is enforced with a prefix sum over the sorted proposal
    weights.  ``vertex_weights`` is [n_pad] or one row per member, and
    ``cap`` a scalar or [alpha, 1] (a stack of instances, DESIGN.md §12).

    ``incumbent`` ([n_pad], or one row per member) and ``mig_remaining``
    [alpha] add bounded migration (DESIGN.md §14): a second prefix sum
    over the sorted order adds up the positive migration deltas of the
    kept proposals, and a proposal that raises migration is accepted
    only while that sum stays within the row's remaining budget;
    proposals that lower it always pass.  An infinite budget passes
    every proposal, so the trajectory is the one without the branch.

    ``fixed_order`` (real-valued vertex weights) takes both prefix sums
    in an order that does not depend on the number of rows
    (``metrics.prefix_sums``).
    """
    alpha, n_pad = part.shape
    order = torch.argsort(torch.where(propose, -gain, -NEG), dim=1,
                          stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(n_pad, device=part.device).expand(alpha, -1))
    keep_n = torch.ceil(frac * propose.sum(1)).to(torch.int64)
    propose = propose & (ranks < keep_n[:, None])

    w_sorted = torch.gather(
        torch.where(propose, vertex_weights.expand_as(propose), 0.0), 1,
        order)
    tgt_sorted = torch.gather(torch.where(propose, target, k), 1,
                              order).long()          # k = "no move"
    # per-block prefix sums of the sorted proposal weights, laid out
    # [a, k+1, n] so the scan runs over the innermost axis (a scan over
    # a middle axis took 4.6 ms per call at ibm08 shapes on the H100);
    # the one-hot is a comparison because F.one_hot syncs the device
    tgt_oh = (torch.arange(k + 1, device=part.device)[None, :, None]
              == tgt_sorted[:, None, :])
    pref = metrics.prefix_sums(tgt_oh * w_sorted[:, None, :],
                               fixed_order)                    # [a, k+1, n]
    fits_sorted = pref[:, :k] <= (cap - bw)[..., None] + 1e-6
    fit_own = torch.gather(fits_sorted, 1,
                           tgt_sorted.clamp(max=k - 1)[:, None, :])[:, 0]
    accept_sorted = fit_own & (tgt_sorted < k)
    if incumbent is not None:
        moved_now = (part != incumbent).to(torch.float32)
        moved_tgt = (target != incumbent).to(torch.float32)
        delta = vertex_weights * (moved_tgt - moved_now)
        delta_sorted = torch.gather(torch.where(propose, delta, 0.0), 1,
                                    order)
        pos_pref = metrics.prefix_sums(torch.clamp(delta_sorted, min=0.0),
                                       fixed_order)
        mig_ok = ((delta_sorted <= 0.0)
                  | (pos_pref <= mig_remaining[:, None] + 1e-6))
        accept_sorted = accept_sorted & mig_ok
    accept = torch.zeros_like(propose).scatter_(1, order, accept_sorted)
    return torch.where(accept, target, part)


class _Level:
    """One level as the population tiers see it: ``hga`` refined as
    rows [R, n_pad], one row a member, each on its own edge-weight row
    of ``ew_pop`` [R, m_pad] when given; ``gain_weights`` [m_pad] biases
    the LP gains only (``edge_weight_override``).

    ``core.instances.InstanceBatch.rows`` answers the same questions for
    a stack of instances, one row a (member, instance) pair, so both
    tiers below run a stack through the same code."""

    def __init__(self, hga: HypergraphArrays, ew_pop=None,
                 gain_weights=None):
        self.hga, self.ew_pop = hga, ew_pop
        self.gain_hga = _with_weights(hga, gain_weights)
        self.n_pad, self.m_pad = hga.n_pad, hga.m_pad
        self.vertex_weights = hga.vertex_weights
        self.real_vertex_weights = hga.real_vertex_weights
        self.n_lens = hga.n  # each row's true vertex count
        self._pins = None

    @property
    def valid(self) -> torch.Tensor:
        """[n_pad] bool: a real vertex that carries weight."""
        h = self.hga
        return ((torch.arange(h.n_pad, device=h.device) < h.n)
                & (h.vertex_weights > 0))

    def phi(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        return metrics.pins_in_block_population(self.hga, parts, k)

    def block_weights(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        return metrics.block_weights_population(self.hga, parts, k)

    def cuts(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        return _member_cuts(self.hga, parts, self.ew_pop, k)

    def gains(self, parts: torch.Tensor, k: int, assemble: str = "auto",
              phi: torch.Tensor | None = None) -> torch.Tensor:
        return metrics._gain_matrix_population_impl(
            self.gain_hga, parts, k, assemble=assemble, phi=phi,
            ew_pop=self.ew_pop)

    def prepare_fm(self) -> None:
        """Build what the FM step reads, before a CUDA graph captures
        it."""
        h = self.hga
        self._pins = (h.pin_vertex.long(), h.pin_edge.long())
        if self.ew_pop is not None or h.real_edge_weights:
            # the fixed-order gain sums of real-valued weights read the
            # level's pins sorted by vertex
            metrics.pins_by_vertex(h)

    def pin_delta(self, v: torch.Tensor) -> torch.Tensor:
        """[R, m_pad] int32: the pins of vertex ``v[r]`` on each edge."""
        pv, pe = self._pins
        d = (pv[None, :] == v[:, None]).to(torch.int32)          # [R, P]
        return torch.zeros((v.shape[0], self.m_pad), dtype=torch.int32,
                           device=v.device).index_add_(1, pe, d)


def _rows_of(hga, ew_pop=None):
    """``hga`` itself when it already is a row geometry (a stack of
    instances), else the level wrapped as one."""
    if isinstance(hga, HypergraphArrays):
        return _Level(hga, ew_pop)
    return hga


def _mask_blocks(x: torch.Tensor, k_live: torch.Tensor | None
                 ) -> torch.Tensor:
    """``x`` [R, n, k] with the columns ``j >= k_live[r]`` set to NEG: a
    k_live-way instance refined in a k-padded bucket (DESIGN.md §12).
    The columns below are untouched and both libraries' argmax takes the
    first maximum in row-major order, so the choice is the solo one."""
    if k_live is None:
        return x
    cols = torch.arange(x.shape[-1], device=x.device)
    return torch.where(cols >= k_live[:, None, None], NEG, x)


def _lp_round_from_gains(lv, parts: torch.Tensor, k: int,
                         cap: torch.Tensor, fracs: torch.Tensor,
                         gains: torch.Tensor,
                         k_live: torch.Tensor | None = None,
                         incumbent: torch.Tensor | None = None,
                         mig_budget: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Proposal + balanced acceptance given the population gain tensor
    [R, n_pad, k] of the rows of ``lv``: every vertex proposes its best
    block (first maximum), positive gains only.  ``k_live`` [R] masks the
    blocks a row's instance does not have.  With ``incumbent`` a row's
    remaining migration budget is ``mig_budget`` (a scalar or [R]) less
    the weight it has already moved."""
    own = parts.long()[..., None] == torch.arange(k, device=parts.device)
    gains = _mask_blocks(torch.where(own, NEG, gains), k_live)
    best_j = torch.argmax(gains, dim=-1)
    best_g = torch.gather(gains, 2, best_j[..., None])[..., 0]
    propose = lv.valid & (best_g > 1e-9)
    bw = lv.block_weights(parts, k)
    mig_remaining = None
    if incumbent is not None:
        mig_remaining = mig_budget - _moved_weight(lv, parts, incumbent)
    return accept_moves(parts, best_j.to(torch.int32), best_g, propose,
                        lv.vertex_weights, bw, cap, fracs, k,
                        incumbent=incumbent, mig_remaining=mig_remaining,
                        fixed_order=lv.real_vertex_weights)


def _with_weights(hga: HypergraphArrays,
                  edge_weight_override: torch.Tensor | None
                  ) -> HypergraphArrays:
    if edge_weight_override is None:
        return hga
    return dataclasses.replace(
        hga, edge_weights=edge_weight_override,
        real_edge_weights=is_real_valued(edge_weight_override))


def _lp_round_population_impl(lv, parts: torch.Tensor, k: int,
                              cap: torch.Tensor, fracs: torch.Tensor,
                              k_live: torch.Tensor | None = None,
                              incumbent: torch.Tensor | None = None,
                              mig_budget: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """One LP round for all rows of ``lv``: the gains of the whole
    population come from one dispatch (one kernel launch on the kernel
    paths)."""
    return _lp_round_from_gains(lv, parts, k, cap, fracs,
                                lv.gains(parts, k), k_live, incumbent,
                                mig_budget)


def lp_round_population(hga: HypergraphArrays, parts, k: int,
                        cap: torch.Tensor, fracs,
                        edge_weight_override=None) -> torch.Tensor:
    """One parallel move round for every member [alpha, n_pad] in one
    dispatch, each at its own acceptance fraction ``fracs`` [alpha]."""
    dev = hga.device
    parts = torch.as_tensor(parts, device=dev).to(torch.int32)
    fracs = torch.as_tensor(fracs, dtype=torch.float32, device=dev)
    ewo = (None if edge_weight_override is None else torch.as_tensor(
        edge_weight_override, dtype=torch.float32, device=dev))
    return _lp_round_population_impl(_Level(hga, gain_weights=ewo), parts,
                                     k, cap, fracs)


def _lp_attempt_population_impl(lv, parts: torch.Tensor,
                                cuts: torch.Tensor, fracs: torch.Tensor,
                                attempts: int, k: int, cap: torch.Tensor,
                                live: torch.Tensor | None = None,
                                k_live: torch.Tensor | None = None,
                                incumbent: torch.Tensor | None = None,
                                mig_budget: torch.Tensor | None = None):
    """The LP attempt loop: per row, propose a round at the current
    acceptance fraction, measure the cut (on the true weights, or on the
    member's own row of ``ew_pop``), accept on improvement, otherwise
    quarter the fraction and retry.  Returns as soon as any row improved
    (the caller resumes the others), reading back one flag per attempt.
    A row with ``live`` False never accepts and never raises that flag;
    ``incumbent``/``mig_budget`` bound each row's migration
    (``_lp_round_from_gains``).  Returns ``(parts, cuts, improved, fracs,
    used)``: the loop of ``_lp_attempt_shards`` over one shard.
    """
    shard = dict(lv=lv, parts=parts, cuts=cuts, fracs=fracs, cap=cap,
                 live=live, k_live=k_live, incumbent=incumbent,
                 mig_budget=mig_budget)
    used = _lp_attempt_shards([shard], attempts, k)
    return (shard["parts"], shard["cuts"], shard["improved"],
            shard["fracs"], used)


def _lp_attempt_shards(shards, attempts: int, k: int) -> int:
    """The LP attempt loop over the shards of a population, each a dict
    of its rows' ``lv``, ``parts``, ``cuts``, ``fracs`` and ``cap`` (and
    optionally ``live``, ``k_live``, ``incumbent``, ``mig_budget``), on
    its own device; the state is updated in the dicts, each of which
    gains its rows' ``improved`` flags.  After every attempt the shards'
    "any row improved" flags are ORed in one host read (the reference
    ``psum``s them over "pop"), so every shard runs the trip count of
    the single-device loop.  Returns the attempts used."""
    for sh in shards:
        sh["improved"] = torch.zeros(sh["parts"].shape[0], dtype=torch.bool,
                                     device=sh["parts"].device)
    used = 0
    while used < attempts:
        flags = []
        for sh in shards:
            with popshard.on_device(sh["parts"].device):
                cands = _lp_round_population_impl(
                    sh["lv"], sh["parts"], k, sh["cap"], sh["fracs"],
                    sh.get("k_live"), sh.get("incumbent"),
                    sh.get("mig_budget"))
                cs = sh["lv"].cuts(cands, k)
                take = cs < sh["cuts"] - 1e-6
                if sh.get("live") is not None:
                    take = take & sh["live"]
                sh["parts"] = torch.where(take[:, None], cands, sh["parts"])
                sh["cuts"] = torch.where(take, cs, sh["cuts"])
                sh["fracs"] = torch.where(take, sh["fracs"],
                                          sh["fracs"] * 0.25)
                sh["improved"] = sh["improved"] | take
                flags.append(sh["improved"].any())
        used += 1
        home = flags[0].device
        if bool(flags[0] if len(flags) == 1
                else torch.stack([f.to(home) for f in flags]).any()):
            break
    return used


# Balance caps, keyed on (popshard.placement_token(hga), k, eps): the cap
# is a function of the level's total weight, so it is computed once per
# level, and its placements on the shards' devices go through the
# placement cache beside the level's.  The token, not a raw id(), keeps
# the key safe from CPython's id reuse after a level is freed.
_CAP_CACHE: dict = {}


def _cap_for(hga: HypergraphArrays, k: int, eps: float, target=None):
    """The balance cap of (hga, k, eps), an f32 scalar on hga's device,
    or placed on ``target`` (a device or ``popshard.Replicated``); both
    the scalar and its placements are cached."""
    key = (popshard.placement_token(hga), int(k), float(eps))
    cap = _CAP_CACHE.get(key)
    if cap is None:
        cap = metrics.balance_cap(hga.total_weight, k, eps)
        _CAP_CACHE[key] = cap
        weakref.finalize(hga, _CAP_CACHE.pop, key, None)
    if target is None:
        return cap
    return popshard.device_put_cached(cap, target)


def _mesh_dispatch(hga: HypergraphArrays, k: int, eps: float):
    """Shared setup of a mesh-route dispatch (both tiers): the mesh of
    the pool of hga's device type, its "pop" size and row placement, and
    the level's structure and cap on every shard, placed once per
    (level, device) through the placement cache.  The structure is
    replicated, so the budget checks a model shard count of 1."""
    mesh = popshard.pop_mesh(hga.device)
    rep = popshard.replicated(mesh)
    popshard.enforce_structure_budget(hga, 1)
    return (mesh, mesh.shape["pop"], popshard.pop_sharding(mesh),
            popshard.device_put_cached(hga, rep), _cap_for(hga, k, eps, rep))


def _put_rows(x: torch.Tensor, npop: int, pop_sh) -> list:
    """Pad a batch of member rows to the "pop" size (pad rows mirror row
    0) and split it over the shards."""
    return pop_sh.put(popshard.pad_rows(x, npop))


def _population_shard_devices(device) -> list | None:
    """The pool's devices for the ``chunk`` route, or None when the pool
    holds one device.  Draws from the survivor pool
    (``popshard.local_devices``), so a device loss re-routes it too."""
    devs = popshard.local_devices(device)
    return devs if len(devs) > 1 else None


def _member_cuts(hga: HypergraphArrays, parts: torch.Tensor,
                 ew_pop: torch.Tensor | None, k: int) -> torch.Tensor:
    """[alpha] f32 cuts, on each member's own row when ``ew_pop`` is
    given."""
    if ew_pop is None:
        return metrics.cutsize_population(hga, parts, k)
    return metrics.cutsize_population_weighted(hga, parts, ew_pop, k)


def lp_round(hga: HypergraphArrays, part: torch.Tensor, k: int,
             cap: torch.Tensor, frac: float,
             edge_weight_override=None) -> torch.Tensor:
    """One parallel move round of one partition [n_pad]: its gains come
    from the one-member gain dispatch (``metrics.gain_matrix``), the
    proposal and acceptance are the population ones with one member.
    ``edge_weight_override`` biases the gains only."""
    h = _with_weights(hga, edge_weight_override)
    gains = metrics.gain_matrix(h, part, k)
    fracs = torch.full((1,), frac, dtype=torch.float32, device=part.device)
    return _lp_round_from_gains(_Level(h), part[None], k, cap, fracs,
                                gains[None])[0]


def lp_refine(hga: HypergraphArrays, part, k: int, eps: float,
              max_iters: int = 24, patience: int = 3,
              edge_weight_override=None) -> Tuple[np.ndarray, float]:
    """Host loop around ``lp_round`` with regression-safe acceptance:
    up to 5 attempts a round, the acceptance fraction quartered after
    each that does not lower the (true) cut.  Returns (part [n_pad]
    numpy, cut)."""
    dev = hga.device
    cap = _cap_for(hga, k, eps)
    part = pad_part(part, hga.n_pad, dev)
    ewo = (None if edge_weight_override is None else torch.as_tensor(
        edge_weight_override, dtype=torch.float32, device=dev))
    cut = float(metrics.cutsize(hga, part, k))
    stall = 0
    for _ in range(max_iters):
        frac = 1.0
        improved = False
        for _attempt in range(5):
            cand = lp_round(hga, part, k, cap, frac, ewo)
            c = float(metrics.cutsize(hga, cand, k))
            if c < cut - 1e-6:
                part, cut, improved = cand, c, True
                break
            frac *= 0.25
        if not improved:
            stall += 1
            if stall >= patience:
                break
        else:
            stall = 0
    return part.cpu().numpy(), cut


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
    ``edge_weights_pop`` [alpha, m_pad]: each member's gains and
    acceptance cuts use its own row, as if it refined its own reweighted
    hypergraph.  ``incumbent`` [n] + ``mig_budget``: every member's moved
    weight relative to the incumbent stays within the budget (None is
    an infinite budget).  ``shard`` ``mesh`` runs every attempt loop over
    the pool's shards (the rows padded to the "pop" size, the flags ORed
    after every attempt); ``chunk`` and ``off`` stay on hga's device.
    Returns (parts [alpha, n_pad] int32 on hga's device, cuts [alpha]
    float64)."""
    dev = hga.device
    path = _check_slice_options(shard, model_shard, dev)
    cap = _cap_for(hga, k, eps)
    parts = pad_parts(parts, hga.n_pad, dev)
    inc, mb = _migration_args(incumbent, mig_budget, hga.n_pad, dev)
    alpha = parts.shape[0]
    ewo = (None if edge_weight_override is None else torch.as_tensor(
        edge_weight_override, dtype=torch.float32, device=dev))
    ew_pop = (None if edge_weights_pop is None else torch.as_tensor(
        edge_weights_pop, dtype=torch.float32, device=dev))
    mesh = None
    if path == "mesh" and alpha > 1:
        mesh, npop, pop_sh, hga_m, cap_m = _mesh_dispatch(hga, k, eps)
        devs = mesh.pop_devices
        ewo_m = [None if ewo is None else ewo.to(d) for d in devs]
        inc_m = [None if inc is None else inc.to(d) for d in devs]
        mb_m = [None if mb is None else mb.to(d) for d in devs]
    else:
        # the replicated structure on the one device this path touches
        popshard.enforce_structure_budget(hga, 1)
    cuts = _member_cuts(hga, parts, ew_pop, k).cpu().numpy().astype(
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
            sub_ew = None
            if ew_pop is not None:
                sub_ew = ew_pop[idx_t] if len(idx) < alpha else ew_pop
            sub_cuts = torch.as_tensor(cuts[idx], dtype=torch.float32,
                                       device=dev)
            sub_fracs = torch.as_tensor(fracs[idx], device=dev)
            if mesh is not None:
                # the bucket padded to the "pop" size (pad rows mirror row
                # 0, so the results and the ORed flag are unchanged) and
                # split over the shards; the active rows come back here
                na = len(idx)
                ew_s = ([None] * npop if sub_ew is None
                        else _put_rows(sub_ew, npop, pop_sh))
                shards = [dict(lv=_Level(hga_m[s], ew_s[s], ewo_m[s]),
                               parts=p, cuts=c, fracs=f, cap=cap_m[s],
                               incumbent=inc_m[s], mig_budget=mb_m[s])
                          for s, (p, c, f) in enumerate(zip(
                              _put_rows(sub, npop, pop_sh),
                              _put_rows(sub_cuts, npop, pop_sh),
                              _put_rows(sub_fracs, npop, pop_sh)))]
                used = _lp_attempt_shards(shards, remaining, k)
                new_sub, new_cuts, improved, new_fracs = (
                    pop_sh.gather([sh[f] for sh in shards], dev)[:na]
                    for f in ("parts", "cuts", "improved", "fracs"))
            else:
                new_sub, new_cuts, improved, new_fracs, used = \
                    _lp_attempt_population_impl(
                        _Level(hga, sub_ew, ewo), sub, sub_cuts, sub_fracs,
                        remaining, k, cap, incumbent=inc, mig_budget=mb)
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
def _fm_pass_population_impl(hga, parts: torch.Tensor, k: int,
                             cap: torch.Tensor, steps,
                             edge_weights_pop: torch.Tensor | None = None,
                             k_live: torch.Tensor | None = None,
                             live: torch.Tensor | None = None,
                             incumbent: torch.Tensor | None = None,
                             mig_budget: torch.Tensor | None = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FM pass for every row: up to ``steps`` single moves
    (negative gains allowed), returning each row's best prefix
    (partition + its cut).  ``hga`` is a level (each row a member; with
    ``edge_weights_pop`` every member's gains and cuts use its own
    edge-weight row) or the rows of a stack of instances
    (``InstanceBatch.rows``), with ``cap`` [R, 1].

    The instance masks (DESIGN.md §12), each None for a plain level:
    ``k_live`` [R] masks a row's missing blocks before the flat argmax;
    a row with ``live`` False never moves; ``steps`` given as an [R]
    tensor is each row's own budget, counted by a step index on the
    device, so the pass runs the largest and a row freezes at its own.

    ``incumbent`` ([n_pad], or [R, n_pad]) + ``mig_budget`` (a scalar or
    [R] f32 tensor): the weight a row has moved away from the incumbent
    is one more entry of the step state, and a move whose migration
    delta would take it past the budget is masked to NEG like a balance
    violation, so every prefix, and the best one, stays within budget.

    A row stops once no feasible move exists (every vertex locked or
    infeasible); from then on its state is frozen, so the loop runs
    until every row stopped or ``steps`` is reached, and reads the flag
    only every ``FM_FLAG_EVERY`` steps — the result is the same as
    checking it after every move.  On the card those steps are replayed
    as one CUDA graph (``_run_fm_steps``), which reads every mask from a
    tensor, so one capture serves the pass whatever the masks hold.
    """
    lv = _rows_of(hga, edge_weights_pop)
    alpha, n_pad = parts.shape
    dev = parts.device
    rows = torch.arange(alpha, device=dev)
    arange_n = torch.arange(n_pad, device=dev)
    vw = lv.vertex_weights.expand(alpha, n_pad)
    valid = lv.valid
    part = parts.clone()
    phi = lv.phi(part, k)
    bw = lv.block_weights(part, k)
    cur_cut = lv.cuts(part, k)
    locked = torch.zeros((alpha, n_pad), dtype=torch.bool, device=dev)
    blocks = torch.arange(k, device=dev)
    feasible_slack = cap + 1e-6
    if feasible_slack.dim():
        feasible_slack = feasible_slack.reshape(-1, 1, 1)
    budget = steps if torch.is_tensor(steps) else None
    if incumbent is not None:
        inc = incumbent.long().expand(alpha, n_pad)
        # a move to block j migrates v iff j differs from its incumbent
        # block; the budget's slack is added once, outside the graph
        mig_tgt = (blocks != inc[..., None]).to(torch.float32)  # [R, n, k]
        mig_slack = mig_budget + 1e-6
        if mig_slack.dim():
            mig_slack = mig_slack.reshape(-1, 1, 1)
    lv.prepare_fm()  # never inside the graph's capture

    def step(state):
        part, phi, bw, locked, cur_cut, best_cut, best_part = state[:7]
        extra = 7
        if budget is not None:
            t = state[extra]
            extra += 1
        # FM pins the segsum path: it only runs on coarse levels, whose
        # small pin counts make the [alpha, P, k] segment-sum cheaper per
        # move step than the compact path's fixed extract/scatter overhead
        gains = lv.gains(part, k, assemble="segsum", phi=phi)
        own = part.long()[..., None] == blocks
        feasible = (bw[:, None, :] + vw[..., None]) <= feasible_slack
        score = _mask_blocks(torch.where(own | ~feasible, NEG, gains),
                             k_live)
        if incumbent is not None:
            mig_w = state[extra]
            moved_cur = (part != inc).to(torch.float32)
            delta_mig = vw[..., None] * (mig_tgt - moved_cur[..., None])
            score = torch.where(mig_w[:, None, None] + delta_mig
                                > mig_slack, NEG, score)
        score = torch.where((locked | ~valid)[..., None], NEG, score)
        flat = torch.argmax(score.reshape(alpha, -1), dim=1)
        v = flat // k
        j = flat % k
        g = score.reshape(alpha, -1)[rows, flat]
        do = g > NEG / 2  # any feasible move at all?
        if live is not None:
            do = do & live
        carried = ()
        if budget is not None:
            do = do & (t < budget)
            carried = (t + 1,)
        if incumbent is not None:
            carried += (torch.where(do, mig_w + delta_mig[rows, v, j],
                                    mig_w),)

        b = part[rows, v].long()
        d = lv.pin_delta(v)                                      # [a, m_pad]
        delta = ((blocks == j[:, None]).to(torch.int32)
                 - (blocks == b[:, None]).to(torch.int32))      # [a, k]
        dm = do[:, None]
        moved = dm & (arange_n[None] == v[:, None])              # [a, n]
        phi = torch.where(dm[..., None], phi + d[..., None] * delta[:, None],
                          phi)
        bw = torch.where(dm, bw + vw[rows, v][:, None] * delta, bw)
        part = torch.where(moved, j.to(torch.int32)[:, None], part)
        locked = locked | moved
        cur_cut = torch.where(do, cur_cut - g, cur_cut)
        better = do & (cur_cut < best_cut - 1e-9)
        best_cut = torch.where(better, cur_cut, best_cut)
        best_part = torch.where(better[:, None], part, best_part)
        return ((part, phi, bw, locked, cur_cut, best_cut, best_part)
                + carried + (do,))

    state = (part, phi, bw, locked, cur_cut, cur_cut.clone(), part.clone())
    if budget is not None:
        state += (torch.zeros((), dtype=torch.int32, device=dev),)
    if incumbent is not None:
        state += (_moved_weight(lv, part, incumbent),)
    # the "moved" flag stays last: ``_run_fm_steps`` reads ``state[-1]``
    state += (torch.ones(alpha, dtype=torch.bool, device=dev),)
    n_steps = int(budget.max()) if budget is not None else steps
    state = _run_fm_steps(step, state, n_steps)
    return state[6], state[5]


def _run_fm_steps(step, state: tuple, steps: int) -> tuple:
    """Run ``steps`` FM move steps from ``state`` (its last entry is the
    per-member "moved" flag), stopping at the first multiple of
    ``FM_FLAG_EVERY`` steps after which no member moved.

    On CPU tensors every step is dispatched eagerly.  On the card a move
    step is some 70 small kernels, and dispatching them one by one from
    the host took about 1.4 ms a step; so ``FM_FLAG_EVERY`` steps are
    captured once per pass as one CUDA graph over the state tensors,
    which the graph updates in place, and replayed.  The graph runs the
    same kernels in the same order, so the result is the eager one.  A
    kernel wrapper counts its launch when the capture records it, where
    nothing runs; those counts are moved to the replays, each of which
    runs every recorded launch once."""
    from repro_torch.kernels import ops
    t = 0
    graph = None
    while t < steps:
        n = min(FM_FLAG_EVERY, steps - t)
        if state[0].is_cuda and n == FM_FLAG_EVERY:
            if graph is None:
                graph, recorded = _capture_fm_steps(step, state, n)
            graph.replay()
            ops.add_launch_counts(recorded)
        else:
            for _ in range(n):
                state = step(state)
        t += n
        if t % FM_FLAG_EVERY == 0 and not bool(state[-1].any()):
            break
    return state


def _capture_fm_steps(step, state: tuple, n: int):
    """A CUDA graph of ``n`` consecutive ``step`` calls that reads the
    tensors of ``state`` and writes the result back into them, and the
    kernel launches it recorded, by wrapper name; those are taken off the
    wrappers' counters, since the capture ran none of them."""
    from repro_torch.kernels import ops
    dev = state[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    # capture_begin/end rather than ``torch.cuda.graph``, whose entry
    # empties the allocator's cache: once per pass, that would hand every
    # later allocation back to cudaMalloc
    with torch.cuda.stream(side):
        # load every kernel once outside the capture, on a scratch state
        step(tuple(x.clone() for x in state))
        side.synchronize()
        before = ops.launch_counts()
        graph.capture_begin()
        try:
            out = state
            for _ in range(n):
                out = step(out)
            for dst, src in zip(state, out):
                dst.copy_(src)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    recorded = {name: c - before[name]
                for name, c in ops.launch_counts().items()
                if c != before[name]}
    ops.add_launch_counts({name: -c for name, c in recorded.items()})
    return graph, recorded


def _fm_pass_impl(hga: HypergraphArrays, part: torch.Tensor, k: int,
                  cap: torch.Tensor, steps: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FM pass of a single partition [n_pad]: the population pass
    with one member.  Returns (best prefix partition, its cut)."""
    best_part, best_cut = _fm_pass_population_impl(hga, part[None], k, cap,
                                                   steps)
    return best_part[0], best_cut[0]


def fm_refine(hga: HypergraphArrays, part, k: int, eps: float,
              max_passes: int = 8, step_budget: int | None = None
              ) -> Tuple[np.ndarray, float]:
    """Repeated FM passes of one partition until no pass improves the
    cut.  Returns (part [n_pad] numpy, cut)."""
    cap = _cap_for(hga, k, eps)
    part = pad_part(part, hga.n_pad, hga.device)
    cut = float(metrics.cutsize(hga, part, k))
    steps = step_budget or int(min(hga.n_pad, 1024))
    for _ in range(max_passes):
        cand, c = _fm_pass_impl(hga, part, k, cap, steps)
        c = float(c)
        if c < cut - 1e-6:
            part, cut = cand, c
        else:
            break
    return part.cpu().numpy(), cut


def fm_refine_population(hga: HypergraphArrays, parts, k: int, eps: float,
                         max_passes: int = 8,
                         step_budget: int | None = None,
                         edge_weights_pop=None, shard: str | None = None,
                         incumbent=None, mig_budget: float | None = None,
                         model_shard: str | None = None
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """Batched FM with per-member pass acceptance: a member stops
    improving exactly when the scalar loop would have broken.
    ``incumbent`` [n] + ``mig_budget`` bound migration move by move
    inside every pass.  ``shard`` ``mesh`` runs each pass over the
    pool's shards (rows padded to the "pop" size, each shard's move loop
    ending when its own lanes are done), ``chunk`` splits the pass's rows
    over the pool's devices, ``off`` stays on hga's device; every route
    gives the same bits.  Returns (parts [alpha, n_pad], cuts [alpha]
    float64)."""
    dev = hga.device
    path = _check_slice_options(shard, model_shard, dev)
    cap = _cap_for(hga, k, eps)
    parts = pad_parts(parts, hga.n_pad, dev)
    inc, mb = _migration_args(incumbent, mig_budget, hga.n_pad, dev)
    alpha = parts.shape[0]
    if alpha <= 1:
        path = "off"
    ew_pop = (None if edge_weights_pop is None else torch.as_tensor(
        edge_weights_pop, dtype=torch.float32, device=dev))
    steps = step_budget or int(min(hga.n_pad, 1024))
    devs = _population_shard_devices(dev) if path == "chunk" else None
    if path == "mesh":
        mesh, npop, pop_sh, hga_d, cap_d = _mesh_dispatch(hga, k, eps)
        devs = list(mesh.pop_devices)
    else:
        popshard.enforce_structure_budget(hga, 1)
        if devs:
            hga_d = [popshard.device_put_cached(hga, d) for d in devs]
            cap_d = [_cap_for(hga, k, eps, d) for d in devs]
    if devs:
        inc_d = [None if inc is None else inc.to(d) for d in devs]
        mb_d = [None if mb is None else mb.to(d) for d in devs]

    def on_shards(blocks, ew_blocks):
        # one pass on each shard's rows, each on its own device
        outs = []
        for di, (p, ew) in enumerate(zip(blocks, ew_blocks)):
            with popshard.on_device(devs[di]):
                outs.append(_fm_pass_population_impl(
                    hga_d[di], p, k, cap_d[di], steps, ew,
                    incumbent=inc_d[di], mig_budget=mb_d[di]))
        return (torch.cat([o[0].to(dev) for o in outs]),
                torch.cat([o[1].to(dev) for o in outs]))

    cuts = _member_cuts(hga, parts, ew_pop, k).cpu().numpy().astype(
        np.float64)
    done = np.zeros(alpha, bool)
    for _ in range(max_passes):
        idx = np.nonzero(~done)[0]  # compact: finished members drop out
        if len(idx) == 0:
            break
        idx_t = torch.as_tensor(idx, device=dev)
        sub = parts[idx_t]
        sub_ew = None if ew_pop is None else ew_pop[idx_t]
        if path == "mesh":
            na = len(idx)
            cands, cs = on_shards(
                _put_rows(sub, npop, pop_sh),
                [None] * npop if sub_ew is None
                else _put_rows(sub_ew, npop, pop_sh))
            cands, cs = cands[:na], cs[:na]
        elif devs and len(idx) > 1:
            ndev = min(len(devs), len(idx))
            bounds = [len(idx) * d // ndev for d in range(ndev + 1)]
            chunk = [slice(bounds[d], bounds[d + 1]) for d in range(ndev)]
            cands, cs = on_shards(
                [sub[c].to(devs[d]) for d, c in enumerate(chunk)],
                [None if sub_ew is None else sub_ew[c].to(devs[d])
                 for d, c in enumerate(chunk)])
        else:
            cands, cs = _fm_pass_population_impl(
                hga, sub, k, cap, steps, sub_ew, incumbent=inc,
                mig_budget=mb)
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
    ``hga`` must live; ``incumbent`` + ``mig_budget`` bound migration
    through both tiers.  Returns (parts [alpha, n_pad] int32 on the
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
        parts, cuts = fm_refine_population(hga, parts, k, eps,
                                           edge_weights_pop=edge_weights_pop,
                                           shard=shard, incumbent=incumbent,
                                           mig_budget=mig_budget,
                                           model_shard=model_shard)
    return parts, cuts


def refine(hga: HypergraphArrays, part, k: int, eps: float,
           fm_node_limit: int = 4096, **kw) -> Tuple[np.ndarray, float]:
    """Two-tier refinement of one partition: scalar LP, then FM on
    levels with at most ``fm_node_limit`` vertices.  Returns
    (part [n_pad] numpy, cut)."""
    part, cut = lp_refine(hga, part, k, eps, **kw)
    if int(hga.n) <= fm_node_limit:
        part, cut = fm_refine(hga, part, k, eps)
    return part, cut


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
