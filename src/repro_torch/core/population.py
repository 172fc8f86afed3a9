"""Distributed population step: IMPart's ring topology over the pool's
("pop", "model") mesh (port of ``repro.core.population``; DESIGN.md §3,
§6).

Layout: one member (or a contiguous block of members) per "pop" shard,
the paper's ring (Fig. 1c) running over the members in pop order; the
flat pin arrays split over "model" (``popshard.model_blocks``), so every
Phi and gain computation is a segment sum on each pin block whose
partials are added on the pop shard's ``q = 0`` device
(``metrics``' ``pin_axis``), the counterpart of the reference's ``psum``
over "model".  The reference ``shard_map``s one body per device with
``ppermute``s for the ring; here one controller runs each phase on
every shard and exchanges the members between phases.

Operators (device-side adaptations, see DESIGN.md):
  * refinement: ``refine_rounds`` balanced label-propagation sweeps;
  * recombination: greedy binary recombination, each vertex may adopt
    its ring partner's label when that single move has a positive gain
    and keeps balance; elitism keeps the member if the round regressed;
  * mutation: if the edge distance to the other ring neighbour is below
    the threshold, one sweep on the reweighted gains
    ``w'_e = w_e * (1 + mu * cut_e(neighbour))``.

Integer edge weights make every partial sum of the refinement and
recombination sweeps exact, so a step over (pop, model) is bit-equal to
the step over (pop, 1).  Mutation's reweighted gains are not integers:
their pin blocks' partials add up to the replicated gains within
rounding.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from .hypergraph import HypergraphArrays, is_real_valued
from .refine import NEG, accept_moves
from . import metrics, popshard


# --------------------------------------------------------------------------
# the sweep, on one shard's rows (pins over ``pin_axis`` blocks)
# --------------------------------------------------------------------------
def _phi(h: HypergraphArrays, pin_axis, parts: torch.Tensor, k: int):
    return metrics.pins_in_block_population(h, parts, k, pin_axis)


def _cut(h: HypergraphArrays, phi: torch.Tensor) -> torch.Tensor:
    return metrics.cuts_from_phi(h, phi)


def _connectivity(phi: torch.Tensor) -> torch.Tensor:
    return (phi > 0).sum(-1).to(torch.int32)


def _sweep(h: HypergraphArrays, pin_axis, parts: torch.Tensor, k: int,
           cap: torch.Tensor, frac: float,
           edge_weights: Optional[torch.Tensor] = None,
           target_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One balanced parallel-move sweep of every row of ``parts`` [R,
    n_pad] (optionally toward fixed targets, optionally on each row's
    reweighted gains ``edge_weights`` [R, m_pad])."""
    rows, n_pad = parts.shape
    dev = parts.device
    phi = _phi(h, pin_axis, parts, k)
    gains = metrics._gain_matrix_population_impl(
        h, parts, k, assemble="segsum", phi=phi, ew_pop=edge_weights,
        pin_axis=pin_axis)
    valid = ((torch.arange(n_pad, device=dev) < h.n)
             & (h.vertex_weights > 0))
    if target_override is None:
        own = parts.long()[..., None] == torch.arange(k, device=dev)
        tgt = torch.argmax(torch.where(own, NEG, gains), -1).to(torch.int32)
    else:
        tgt = target_override
    g = torch.gather(gains, 2, tgt.long()[..., None])[..., 0]
    propose = valid & (g > 1e-9) & (tgt != parts)
    bw = metrics.block_weights_population(h, parts, k)
    fracs = torch.full((rows,), frac, dtype=torch.float32, device=dev)
    return accept_moves(parts, tgt, g, propose, h.vertex_weights, bw, cap,
                        fracs, k)


def _roll(blocks: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """The ring exchange: the members of every shard's rows, in pop
    order, rolled by ``shift`` (``+1``: each member receives the previous
    one's), each block back on its own device."""
    home = blocks[0].device
    rolled = torch.roll(torch.cat([b.to(home) for b in blocks]), shift, 0)
    out, at = [], 0
    for b in blocks:
        out.append(rolled[at:at + b.shape[0]].to(b.device))
        at += b.shape[0]
    return out


def population_step_fn(levels, parts: List[torch.Tensor], *, k: int,
                       eps: float, refine_rounds: int,
                       sim_threshold: float, mu: float = 0.1
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One population step over the "pop" shards.

    ``levels`` holds, per pop shard, ``(h, pin_axis)``: the level on the
    shard's device (its replicated leaves serve the row-level work) and
    its pin blocks over "model" (None: ``h``'s own pins); ``parts`` the
    shard's members [R, n_pad].  Returns every shard's new members and
    their cuts [R] f32."""
    caps = [metrics.balance_cap(h.total_weight, k, eps) for h, _ in levels]
    shards = list(zip(levels, caps))

    # 1. local refinement sweeps
    for r in range(refine_rounds):
        parts = [_sweep(h, ax, p, k, cap, 0.5 + 0.5 / (r + 1))
                 for ((h, ax), cap), p in zip(shards, parts)]
    my_cut = [_cut(h, _phi(h, ax, p, k))
              for ((h, ax), _), p in zip(shards, parts)]

    # 2. ring recombination (greedy binary, paper Fig. 1c)
    partner = _roll(parts, 1)
    pre = parts
    for _ in range(2):
        parts = [_sweep(h, ax, p, k, cap, 1.0, target_override=t)
                 for ((h, ax), cap), p, t in zip(shards, parts, partner)]
    new_parts = []
    for ((h, ax), _), p, old, c in zip(shards, parts, pre, my_cut):
        new_cut = _cut(h, _phi(h, ax, p, k))
        new_parts.append(torch.where((new_cut <= c)[:, None], p, old))
    parts = new_parts

    # 3. mutation: diversity against the other ring neighbour
    other = _roll(parts, -1)
    out_parts, out_cuts = [], []
    for ((h, ax), cap), p, o in zip(shards, parts, other):
        lam_o = _connectivity(_phi(h, ax, o, k))
        lam_s = _connectivity(_phi(h, ax, p, k))
        d_e = (lam_o - lam_s).abs().sum(-1)
        too_similar = d_e < sim_threshold
        cut_ind = ((lam_o > 1) & (torch.arange(h.m_pad, device=p.device)
                                  < h.m)).to(torch.float32)
        w_mut = h.edge_weights * (1.0 + mu * cut_ind)
        part_mut = _sweep(h, ax, p, k, cap, 1.0, edge_weights=w_mut)
        p = torch.where(too_similar[:, None], part_mut, p)
        out_parts.append(p)
        out_cuts.append(_cut(h, _phi(h, ax, p, k)))
    return out_parts, out_cuts


# --------------------------------------------------------------------------
# the step over a mesh
# --------------------------------------------------------------------------
def make_population_step(mesh, *, n: int, m: int, k: int, eps: float = 0.03,
                         refine_rounds: int = 4,
                         sim_threshold: float = 20.0):
    """The population step over ``mesh`` (a ``popshard.PopMesh``).

    Call signature of the returned function:
      (pin_vertex[Pp], pin_edge[Pp], vertex_weights[n_pad],
       edge_weights[m_pad], edge_sizes[m_pad], parts[POP, n_pad])
        -> (parts[POP, n_pad], cuts[POP])
    on the mesh's first device, POP a multiple of the "pop" size (each
    pop shard refines its block of members; the ring runs over all POP
    in pop order).  With a "model" axis larger than 1 the pins split
    over it (their padded length must divide by its size).  The
    structure is placed on the mesh once and placed again only when a
    call passes a structure whose values differ.
    """
    home = mesh.devices[0][0]
    npop, nmodel = mesh.shape["pop"], mesh.shape["model"]
    placed = {}

    def place(h):
        if nmodel == 1:
            return [(popshard._put_one(h, d), None)
                    for d in mesh.pop_devices]
        if h.p_pad % nmodel:
            raise ValueError(f"{h.p_pad} pins do not split over "
                             f"{nmodel} model shards")
        return [(blocks[0], blocks) for blocks in
                (popshard.model_blocks(h, mesh, p) for p in range(npop))]

    def step(pv, pe, vw, ew, es, parts):
        put = lambda x, dt: (x if torch.is_tensor(x) else torch.from_numpy(
            np.array(x))).to(home, dt)
        leaves = (put(pv, torch.int32), put(pe, torch.int32),
                  put(vw, torch.float32), put(ew, torch.float32),
                  put(es, torch.int32))
        parts = put(parts, torch.int32)
        if parts.shape[0] % npop:
            raise ValueError(f"{parts.shape[0]} members do not split over "
                             f"{npop} pop shards")
        old = placed.get("leaves")
        if old is None or not all(a.shape == b.shape and torch.equal(a, b)
                                  for a, b in zip(old, leaves)):
            h = HypergraphArrays(
                pin_vertex=leaves[0], pin_edge=leaves[1],
                vertex_weights=leaves[2], edge_weights=leaves[3],
                edge_sizes=leaves[4], n=n, m=m)
            h.real_edge_weights = is_real_valued(h.edge_weights)
            h.real_vertex_weights = is_real_valued(h.vertex_weights)
            placed.update(leaves=leaves, levels=place(h))
        sh = popshard.pop_sharding(mesh)
        out, cuts = population_step_fn(
            placed["levels"], sh.put(parts), k=k, eps=eps,
            refine_rounds=refine_rounds, sim_threshold=sim_threshold)
        return sh.gather(out, home), sh.gather(cuts, home)

    return step


def make_local_population_step(*, n: int, m: int, k: int,
                               device: str | torch.device = "cuda", **kw):
    """The population step on the local ("pop", "model") mesh of
    ``device``'s pool (``popshard.pop_mesh``): the mesh the sharded
    refinement tiers dispatch over, so the ring operators and the tiers
    share one device layout.  Returns (step_fn, mesh)."""
    mesh = popshard.pop_mesh(resolve_device(device))
    return make_population_step(mesh, n=n, m=m, k=k, **kw), mesh
