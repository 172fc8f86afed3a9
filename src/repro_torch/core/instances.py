"""Instance axis: independent partition requests refined together
(port of ``repro.core.instances``; DESIGN.md §12).

The population axis batches many candidate solutions of one hypergraph;
this module adds the axis above it: many hypergraphs, each with its own
population, refined as one ``[instance, alpha, n_pad]`` stack.

Shape buckets.  Instances group by ``(n_pad bucket, k bucket)`` (the
pow2 rebucketing of the coarsener, optionally rounded up to a ``grid``)
and a group stacks after every level is re-padded to the group maxima.
Re-padding keeps every answer: padded vertices carry zero weight and
never propose, padded edges carry zero weight and no pins, new pad pins
point at the old ghosts, and under the stable sort of
``refine.accept_moves`` non-proposers rank after every proposer.  The FM
step budget ``min(n_pad, 1024)`` and the balance cap are taken from the
ORIGINAL arrays, so bucketing never changes a trip count or a cap.

Per-instance k.  A bucket's gain tensors are ``k_pad`` wide (the pow2
bucket) and a per-row ``k_live`` masks the columns a row's instance does
not have to NEG; the first maximum of the masked row-major order is the
solo one, so proposals, FM moves and tie-breaks are the solo run's.

How a stack runs.  The reference ``jax.vmap``s its population tiers
over the instance axis; the port has no ``vmap`` of its hand-written
kernels and needs none.  A group's instances are laid end to end in one
*union* level (instance i's vertex ids offset by ``i * n_pad``, its edge
ids by ``i * m_pad``, its incidence layout's edge ids likewise), and the
stack is refined as one population of ``alpha * I`` rows, row
``a * I + i`` being member a of instance i.  Pin-level work (Φ, the gain
assembly) runs once on the union: in that order a member's rows of all
instances are one contiguous union row, so ``[R, n_pad]`` and
``[alpha, I * n_pad]`` are views of one tensor, and one LP round's gains
of every instance and member are ONE launch of the gain kernel (#1 at
``k_pad <= 32``, #2 above) on the card.  Row-level work (argmax,
``accept_moves``, block weights, the cut, FM's moves) runs per row, each
row with its instance's cap, ``k_live``, ``live`` flag and FM budget as
device tensors.  All gains are integer-valued sums, so the union's
kernel path gives the solo segment-sum path's bits.

The loops follow the solo ones (``refine.lp_refine_population``,
``fm_refine_population``) with masks where those compact: a row that
improved or converged stays in the dispatch with ``live`` False, and
since every row's trajectory depends on its own state alone, each
instance gets the bits of ``refine.refine_population`` on it alone.

Incumbent entries (bounded migration, DESIGN.md §14) carry an
incumbent row and a migration budget per instance, broadcast to the
instance's alpha rows; cold entries of a mixed stack ride with a zeros
incumbent and an infinite budget, whose masks pass everything, so they
keep their bits.

Routes (``shard``, None = ``REPRO_POP_SHARD``, DESIGN.md §11): on
``mesh`` a stack's instances are padded to a multiple of the pool's
"pop" size with mirrors of instance 0 (``_pad_i``) and split into
contiguous blocks, each shard refining the stack of its block
(``_take_i``) on its device, the LP flags ORed after every attempt as
on the population route; ``chunk`` splits the instances in
``_chunk_bounds`` over the pool's devices without padding; ``off`` keeps
the stack on one device.  A shard's sub-stack is placed once per stack.
Since every per-row sum has a fixed order whatever the rows beside it
(``metrics.row_sums``), each instance keeps its solo bits on every route.

The model axis (``model_shard``, DESIGN.md §15): on the ``mesh`` route
with a real "model" axis dividing the stack's pin padding, each shard's
sub-stack is also split into pin blocks over "model"
(``popshard.model_blocks`` of its stacked leaves), and its rows' Phi,
cuts, gains and FM pin counts add the blocks' partials
(``_StackRows``'s ``pin_axis``), as on a single level.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.env import resolve_device
from repro_torch.kernels.common import RATING_TILE
from .hypergraph import HypergraphArrays, _round_pow2
from . import metrics, popshard
from . import refine as refine_mod

#: Extents the gain kernel indexes with 32-bit integers
#: (``kernels/gain.py``): a group whose union would pass one splits into
#: sub-groups.
_INT32_LIMIT = 2 ** 31


def k_bucket(k: int) -> int:
    """pow2 bucket of a block count (floor 2): instances of different k
    share a stack at ``k_pad`` and mask with ``k_live``."""
    return _round_pow2(int(k), floor=2)


def bucket_n_pad(n_pad: int, grid: Optional[Sequence[int]] = None) -> int:
    """The stacking bucket of a vertex padding: the smallest ``grid``
    entry >= ``n_pad``; without a grid, or above its top entry, the
    natural pow2 padding is its own bucket."""
    if grid:
        for g in sorted(int(x) for x in grid):
            if g >= n_pad:
                return g
    return int(n_pad)


def group_key(hga: HypergraphArrays, k: int,
              grid: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """Dispatch-group key of one instance: (n_pad bucket, k bucket)."""
    return (bucket_n_pad(hga.n_pad, grid), k_bucket(k))


def _repad(h: HypergraphArrays, n_pad: int, m_pad: int, p_pad: int
           ) -> HypergraphArrays:
    """Extend a level's padding to the bucket's.  The old ghost vertex
    and edge keep zero weight, so pins that point at them stay inert,
    and the new pad pins point at them too; the incidence layout gains
    rows of pads (-1)."""
    if (h.n_pad, h.m_pad, h.p_pad) == (n_pad, m_pad, p_pad):
        return h

    def extend(x, size, fill):
        return torch.cat([x, torch.full((size - x.shape[0],) + x.shape[1:],
                                        fill, dtype=x.dtype,
                                        device=x.device)])

    return HypergraphArrays(
        pin_vertex=extend(h.pin_vertex, p_pad, h.n_pad - 1),
        pin_edge=extend(h.pin_edge, p_pad, h.m_pad - 1),
        vertex_weights=extend(h.vertex_weights, n_pad, 0.0),
        edge_weights=extend(h.edge_weights, m_pad, 0.0),
        edge_sizes=extend(h.edge_sizes, m_pad, 0),
        n=h.n, m=h.m,
        incident=None if h.incident is None else extend(h.incident, n_pad,
                                                        -1),
        real_edge_weights=h.real_edge_weights,
        real_vertex_weights=h.real_vertex_weights)


@dataclasses.dataclass
class InstanceBatch:
    """A stacked shape bucket.  ``hga`` holds the re-padded levels'
    leaves stacked over the instance axis ([I, ...]; ``n``/``m`` are [I]
    tensors and ``incident``, when every level has one, [I, n_pad, D]),
    so its shape properties do not apply: use ``n_pad``/``m_pad`` here,
    ``union()`` for the levels end to end, and ``rows(alpha)`` for the
    row geometry the refinement tiers run on.  ``incumbent``/``mig_budget``
    are None for a stack without incumbent entries (the program without
    the bounded-migration branch)."""
    hga: HypergraphArrays
    k_pad: int                   # block-count bucket
    k_live: torch.Tensor         # [I] int32 true k of each instance
    cap: torch.Tensor            # [I] f32 balance cap of each instance
    fm_steps: torch.Tensor       # [I] int32 solo FM budget min(n_pad, 1024)
    ns: Tuple[int, ...]          # true vertex counts
    ks: Tuple[int, ...]          # true block counts
    orig_n_pads: Tuple[int, ...]  # natural paddings before bucketing
    incumbent: Optional[torch.Tensor] = None   # [I, n_pad] int32
    mig_budget: Optional[torch.Tensor] = None  # [I] f32 (inf: unbounded)
    _union: Optional[HypergraphArrays] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the shards of a routed dispatch, per (route, pool token)
    _shards: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_instances(self) -> int:
        return len(self.ns)

    @property
    def n_pad(self) -> int:
        return int(self.hga.vertex_weights.shape[1])

    @property
    def m_pad(self) -> int:
        return int(self.hga.edge_weights.shape[1])

    @property
    def device(self) -> torch.device:
        return self.hga.vertex_weights.device

    def union(self) -> HypergraphArrays:
        """The instances end to end as one level (built once): vertex ids
        offset by ``i * n_pad``, edge ids by ``i * m_pad``, in the
        incidence layout too (pads stay -1).  Its ``n``/``m`` are the
        padded totals; the true sizes live in the rows' masks.  Each
        instance's pins start at a multiple of the rating kernel's tile
        (a pin block shorter than it gains pad pins of its ghost vertex
        on its ghost edge, both of zero weight), so a vertex's fixed-order
        gain sum starts where it does on the solo level."""
        if self._union is None:
            h, num = self.hga, self.n_instances
            ids = torch.arange(num, dtype=torch.int32, device=self.device)
            v_off, e_off = ids[:, None] * self.n_pad, ids[:, None] * self.m_pad
            pv, pe = h.pin_vertex, h.pin_edge
            grow = (-pv.shape[1]) % RATING_TILE
            if grow:
                pad = torch.nn.functional.pad
                pv = pad(pv, (0, grow), value=self.n_pad - 1)
                pe = pad(pe, (0, grow), value=self.m_pad - 1)
            inc = None
            if h.incident is not None:
                inc = torch.where(h.incident >= 0,
                                  h.incident + e_off[:, :, None], -1)
                inc = inc.reshape(num * self.n_pad, -1).contiguous()
            self._union = HypergraphArrays(
                pin_vertex=(pv + v_off).reshape(-1),
                pin_edge=(pe + e_off).reshape(-1),
                vertex_weights=h.vertex_weights.reshape(-1),
                edge_weights=h.edge_weights.reshape(-1),
                edge_sizes=h.edge_sizes.reshape(-1),
                n=num * self.n_pad, m=num * self.m_pad, incident=inc,
                real_edge_weights=h.real_edge_weights,
                real_vertex_weights=h.real_vertex_weights)
        return self._union

    def rows(self, alpha: int, blocks=None) -> "_StackRows":
        """The stack as ``alpha * I`` rows of one population; ``blocks``
        (the model route) are the stack's pin blocks, each a stack whose
        pin tables hold one row block of this one's."""
        return _StackRows(self, alpha, blocks)


class _StackRows:
    """The rows of a stack, row ``a * I + i`` member a of instance i:
    the attributes and methods ``refine._Level`` gives a single level,
    so ``refine``'s population tiers run the stack unchanged.  Pin-level
    work goes through the union, row-level work per row."""

    def __init__(self, batch: InstanceBatch, alpha: int, blocks=None):
        h = batch.hga
        self.batch, self.alpha = batch, alpha
        self.n_pad, self.m_pad = batch.n_pad, batch.m_pad
        self.union = batch.union()
        # the model route: the pin blocks' unions, whose partials add up
        # to the union's pin-level sums
        self.blocks = blocks
        self.pin_axis = (None if blocks is None
                         else [b.union() for b in blocks])
        self.vertex_weights = h.vertex_weights.repeat(alpha, 1)  # [R, n_pad]
        self.edge_weights = h.edge_weights.repeat(alpha, 1)      # [R, m_pad]
        self.n = h.n.repeat(alpha)
        self.n_lens, self.m_lens = h.n, h.m  # true sizes per instance
        self.real_vertex_weights = self.union.real_vertex_weights
        self.cap = batch.cap.repeat(alpha)[:, None]               # [R, 1]
        self.k_live = batch.k_live.repeat(alpha)
        self.fm_steps = batch.fm_steps.repeat(alpha)
        self.incumbent = self.mig_budget = None
        if batch.incumbent is not None:
            self.incumbent = batch.incumbent.repeat(alpha, 1)      # [R, n_pad]
            self.mig_budget = batch.mig_budget.repeat(alpha)      # [R]
        self._pins = None

    @property
    def valid(self) -> torch.Tensor:
        arange = torch.arange(self.n_pad, device=self.n.device)
        return (arange[None] < self.n[:, None]) & (self.vertex_weights > 0)

    def _union_view(self, x: torch.Tensor) -> torch.Tensor:
        """[R, n, ...] rows as [alpha, I * n, ...] union rows (a view)."""
        return x.reshape((self.alpha, -1) + tuple(x.shape[2:]))

    @property
    def single_device(self) -> bool:
        """Whether every pin block lives on the rows' device."""
        return self.blocks is None or all(
            b.device == self.batch.device for b in self.blocks)

    def phi(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        phi = metrics.pins_in_block_population(
            self.union, self._union_view(parts), k, self.pin_axis)
        return phi.reshape(parts.shape[0], self.m_pad, k)

    def block_weights(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        return metrics.block_weight_sums(parts, self.vertex_weights, k,
                                         self.union.real_vertex_weights,
                                         self.n)

    def cuts(self, parts: torch.Tensor, k: int) -> torch.Tensor:
        """[R] f32: ``metrics.cutsize_population``'s sum, per row, over
        the row's own instance's edges."""
        lam = (self.phi(parts, k) > 0).sum(-1)
        return metrics.row_sums(torch.where(lam > 1, self.edge_weights, 0.0),
                                self.union.real_edge_weights, self.m_lens)

    def gains(self, parts: torch.Tensor, k: int, assemble: str = "auto",
              phi: torch.Tensor | None = None) -> torch.Tensor:
        """[R, n_pad, k]: the union's gains, one dispatch for every row
        (``ops.gain_path`` on the union picks the path)."""
        g = metrics._gain_matrix_population_impl(
            self.union, self._union_view(parts), k, assemble=assemble,
            phi=None if phi is None else self._union_view(phi),
            pin_axis=self.pin_axis)
        return g.reshape(parts.shape[0], self.n_pad, k)

    def prepare_fm(self) -> None:
        """Each row's own pins (of every pin block on the model route),
        built before a CUDA graph captures FM."""
        stacks = [self.batch] if self.blocks is None else self.blocks
        self._pins = [(b.hga.pin_vertex.repeat(self.alpha, 1),
                       b.hga.pin_edge.long().repeat(self.alpha, 1))
                      for b in stacks]
        if self.union.real_edge_weights:
            for u in ([self.union] if self.pin_axis is None
                      else self.pin_axis):
                metrics.pins_by_vertex(u)

    def pin_delta(self, v: torch.Tensor) -> torch.Tensor:
        """[R, m_pad] int32: the pins of vertex ``v[r]`` of row r's
        instance on each of its edges."""
        out = []
        for pv, pe in self._pins:
            d = (pv == v.to(pv.device)[:, None]).to(torch.int32)  # [R, P]
            out.append(torch.zeros((v.shape[0], self.m_pad),
                                   dtype=torch.int32,
                                   device=pv.device).scatter_add_(1, pe, d))
        return metrics._model_psum(out, v.device)


def stack_instances(hgas: Sequence[HypergraphArrays], ks: Sequence[int],
                    epss: Sequence[float],
                    grid: Optional[Sequence[int]] = None,
                    incumbents: Optional[Sequence] = None,
                    mig_budgets: Optional[Sequence] = None) -> InstanceBatch:
    """Stack independent levels (all on one device) into one bucket
    batch: the targets are the group's per-axis maxima (``grid`` rounds
    the vertex axis), each level re-padded inertly first.

    ``incumbents``/``mig_budgets`` (optional, DESIGN.md §14): each
    instance's incumbent assignment [n_i] and migration budget; a None
    incumbent (a cold instance in the stack) rides with zeros and an
    infinite budget, a None budget is infinite."""
    if not (len(hgas) == len(ks) == len(epss)):
        raise ValueError("hgas/ks/epss length mismatch")
    dev = hgas[0].device
    if any(h.device != dev for h in hgas):
        raise ValueError("instances of one stack must share a device")
    n_pad = bucket_n_pad(max(h.n_pad for h in hgas), grid)
    m_pad = max(h.m_pad for h in hgas)
    p_pad = max(h.p_pad for h in hgas)
    k_pad = max(k_bucket(k) for k in ks)
    # caps and FM budgets from the ORIGINAL arrays: the step budget must
    # be the one a solo run at the natural padding uses
    cap = torch.stack([refine_mod._cap_for(h, k, eps).to(torch.float32)
                       for h, k, eps in zip(hgas, ks, epss)])
    fm_steps = torch.tensor([min(h.n_pad, 1024) for h in hgas],
                            dtype=torch.int32, device=dev)
    rep = [_repad(h, n_pad, m_pad, p_pad) for h in hgas]
    incident = None
    if all(r.incident is not None for r in rep):
        d = max(r.incident.shape[1] for r in rep)
        incident = torch.stack([torch.nn.functional.pad(
            r.incident, (0, d - r.incident.shape[1]), value=-1)
            for r in rep])
    stacked = HypergraphArrays(
        **{f: torch.stack([getattr(r, f) for r in rep])
           for f in ("pin_vertex", "pin_edge", "vertex_weights",
                     "edge_weights", "edge_sizes")},
        n=torch.tensor([int(h.n) for h in hgas], device=dev),
        m=torch.tensor([int(h.m) for h in hgas], device=dev),
        incident=incident,
        real_edge_weights=any(h.real_edge_weights for h in hgas),
        real_vertex_weights=any(h.real_vertex_weights for h in hgas))
    inc = mb = None
    if incumbents is not None and any(x is not None for x in incumbents):
        inc_rows = np.zeros((len(hgas), n_pad), np.int32)
        mb_rows = np.full(len(hgas), np.inf, np.float32)
        for i, x in enumerate(incumbents):
            if x is None:
                continue
            x = np.asarray(torch.as_tensor(x).cpu(), np.int32)
            inc_rows[i, : x.shape[0]] = x
            b = None if mig_budgets is None else mig_budgets[i]
            mb_rows[i] = np.inf if b is None else float(b)
        inc = torch.from_numpy(inc_rows).to(dev)
        mb = torch.from_numpy(mb_rows).to(dev)
    return InstanceBatch(
        hga=stacked, k_pad=k_pad,
        k_live=torch.tensor([int(k) for k in ks], dtype=torch.int32,
                            device=dev),
        cap=cap, fm_steps=fm_steps,
        ns=tuple(int(h.n) for h in hgas), ks=tuple(int(k) for k in ks),
        orig_n_pads=tuple(h.n_pad for h in hgas),
        incumbent=inc, mig_budget=mb)


def stack_parts(parts_list: Sequence, n_pad: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """[A, n_i]-per-instance populations -> one [I, A, n_pad] int32
    stack (on ``device``, else where the populations are)."""
    rows = [refine_mod.pad_parts(p, n_pad, device) for p in parts_list]
    alphas = {r.shape[0] for r in rows}
    if len(alphas) != 1:
        raise ValueError(f"instances must share alpha, got {alphas}")
    return torch.stack(rows)


def _take_i(batch: InstanceBatch, idx) -> InstanceBatch:
    """Slice an instance subset out of a stacked batch (host indices)."""
    idx = [int(i) for i in idx]
    j = torch.as_tensor(idx, device=batch.device)
    h = batch.hga
    sub = HypergraphArrays(
        pin_vertex=h.pin_vertex[j], pin_edge=h.pin_edge[j],
        vertex_weights=h.vertex_weights[j], edge_weights=h.edge_weights[j],
        edge_sizes=h.edge_sizes[j], n=h.n[j], m=h.m[j],
        incident=None if h.incident is None else h.incident[j],
        real_edge_weights=h.real_edge_weights,
        real_vertex_weights=h.real_vertex_weights)
    return InstanceBatch(
        hga=sub, k_pad=batch.k_pad, k_live=batch.k_live[j],
        cap=batch.cap[j], fm_steps=batch.fm_steps[j],
        ns=tuple(batch.ns[i] for i in idx),
        ks=tuple(batch.ks[i] for i in idx),
        orig_n_pads=tuple(batch.orig_n_pads[i] for i in idx),
        incumbent=None if batch.incumbent is None else batch.incumbent[j],
        mig_budget=None if batch.mig_budget is None else batch.mig_budget[j])


def _cutsize_instances(batch: InstanceBatch, parts) -> torch.Tensor:
    """[I, A] f32 cut of every member of every instance (blocks
    ``>= k_live`` are empty, so the ``k_pad`` sum is exact)."""
    parts = torch.as_tensor(parts, device=batch.device)
    num, alpha, _ = parts.shape
    rows = parts.transpose(0, 1).reshape(alpha * num, -1)
    return batch.rows(alpha).cuts(rows, batch.k_pad).reshape(
        alpha, num).T


def _to_rows(batch: InstanceBatch, parts) -> torch.Tensor:
    """[I, A, n_pad] -> rows [A * I, n_pad] (row a * I + i)."""
    parts = torch.as_tensor(parts, device=batch.device).to(torch.int32)
    return parts.transpose(0, 1).reshape(-1, batch.n_pad).contiguous()


def _from_rows(batch: InstanceBatch, rows: torch.Tensor) -> torch.Tensor:
    num = batch.n_instances
    return rows.reshape(-1, num, batch.n_pad).transpose(0, 1).contiguous()


def _pad_i(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Mirror instance 0 up to a multiple of ``mult`` (the ``pad_rows``
    pattern): mirror lanes repeat instance 0's computation, so trip
    counts and results are unchanged; callers slice them off."""
    return popshard.pad_rows(x, mult)


def _chunk_bounds(n: int, ndev: int) -> List[int]:
    return [n * d // ndev for d in range(ndev + 1)]


def _batch_to(batch: InstanceBatch, dev: torch.device) -> InstanceBatch:
    """``batch`` on ``dev`` (itself when it is there)."""
    if batch.device == dev:
        return batch
    move = lambda x: None if x is None else x.to(dev)
    return dataclasses.replace(
        batch, hga=popshard._put_one(batch.hga, dev), k_live=move(
            batch.k_live), cap=move(batch.cap),
        fm_steps=move(batch.fm_steps), incumbent=move(batch.incumbent),
        mig_budget=move(batch.mig_budget), _union=None, _shards={})


def _model_active(batch: InstanceBatch, mesh,
                  model_shard: Optional[str]) -> bool:
    """Does this stacked dispatch split its pin tables over "model"?
    (the ``model_shard``/``REPRO_MODEL_SHARD`` route and a real "model"
    axis dividing the stack's pin padding, DESIGN.md §15)."""
    return (popshard.resolve_model(model_shard) == "mesh"
            and popshard.model_axis_active(int(batch.hga.pin_vertex.shape[-1]),
                                           mesh))


def _shards_for(batch: InstanceBatch, path: str,
                model_shard: Optional[str] = None):
    """The shards of a routed dispatch, built once per (stack, route,
    pool, model route): ``(ids, keep, sub, blocks)`` per shard, ``ids``
    its instances (a mesh's pad entries mirror instance 0), ``keep``
    which of them are real, ``sub`` its sub-stack on its device,
    ``blocks`` the sub-stack's pin blocks over "model" (None off the
    model route).  None for the ``off`` route, or ``chunk`` over a pool
    of one device."""
    if path == "off":
        return None
    mesh = popshard.pop_mesh(batch.device) if path == "mesh" else None
    model = mesh is not None and _model_active(batch, mesh, model_shard)
    key = (path, popshard._pool_token(batch.device),
           None if mesh is None else mesh.shape["model"], model)
    if key not in batch._shards:
        num = batch.n_instances
        if path == "mesh":
            devs = mesh.pop_devices
            ids = _pad_i(torch.arange(num), len(devs)).tolist()
            b = len(ids) // len(devs)
            blocks = [range(s * b, (s + 1) * b) for s in range(len(devs))]
        else:
            devs = popshard.local_devices(batch.device)
            ndev = min(len(devs), num)
            if ndev <= 1:
                batch._shards[key] = None
                return None
            ids = list(range(num))
            bounds = _chunk_bounds(num, ndev)
            blocks = [range(bounds[d], bounds[d + 1]) for d in range(ndev)]
        shards = []
        for s, blk in enumerate(blocks):
            sub = _batch_to(_take_i(batch, [ids[q] for q in blk]), devs[s])
            pins = None
            if model:
                pins = [dataclasses.replace(sub, hga=h, _union=None,
                                            _shards={})
                        for h in popshard.model_blocks(sub.hga, mesh, s)]
            shards.append(([ids[q] for q in blk], [q < num for q in blk],
                           sub, pins))
        batch._shards[key] = shards
    return batch._shards[key]


def _shard_rows(x: torch.Tensor, num: int, ids, dev) -> torch.Tensor:
    """The rows of instances ``ids`` of the stack rows ``x`` [A * num,
    ...] (row ``a * num + i``), in their own stack's order, on ``dev``."""
    view = x.reshape((-1, num) + tuple(x.shape[1:]))
    j = torch.as_tensor(ids, device=x.device)
    return view[:, j].reshape((-1,) + tuple(x.shape[1:])).to(dev)


def _merge_rows(shards, outs, like: torch.Tensor, num: int) -> torch.Tensor:
    """The shards' rows written back into a copy of the stack rows
    ``like`` (mirror instances dropped)."""
    merged = like.clone().reshape((-1, num) + tuple(like.shape[1:]))
    for (ids, keep, _, _), out in zip(shards, outs):
        out = out.to(like.device).reshape(
            (merged.shape[0], len(ids)) + tuple(like.shape[1:]))
        real = [q for q, ok in enumerate(keep) if ok]
        merged[:, [ids[q] for q in real]] = out[:, real]
    return merged.reshape(like.shape)


def _dispatch_lp(batch: InstanceBatch, shards, rows, cuts, fracs, live,
                 remaining: int):
    """One grouped LP attempt loop over the stack rows, on one device
    or over the shards; returns ``(rows, cuts, improved, fracs, used)``."""
    k, num = batch.k_pad, batch.n_instances
    if shards is None:
        lv = batch.rows(rows.shape[0] // num)
        return refine_mod._lp_attempt_population_impl(
            lv, rows, cuts, fracs, remaining, k, lv.cap, live=live,
            k_live=lv.k_live, incumbent=lv.incumbent,
            mig_budget=lv.mig_budget)
    work = []
    for ids, _, sub, blocks in shards:
        lv = sub.rows(rows.shape[0] // num, blocks)
        put = lambda x: _shard_rows(x, num, ids, sub.device)
        work.append(dict(lv=lv, parts=put(rows), cuts=put(cuts),
                         fracs=put(fracs), cap=lv.cap, live=put(live),
                         k_live=lv.k_live, incumbent=lv.incumbent,
                         mig_budget=lv.mig_budget))
    used = refine_mod._lp_attempt_shards(work, remaining, k)
    merged = [_merge_rows(shards, [w[f] for w in work], x, num)
              for f, x in (("parts", rows), ("cuts", cuts),
                           ("improved", live), ("fracs", fracs))]
    return (*merged, used)


def _dispatch_fm(batch: InstanceBatch, shards, rows, live):
    """One grouped FM pass over the stack rows, on one device or over
    the shards (each shard's move loop ends when its own rows are done);
    returns the best prefixes and their cuts."""
    k, num = batch.k_pad, batch.n_instances

    def run(sub, rows_s, live_s, blocks=None):
        lv = sub.rows(rows_s.shape[0] // sub.n_instances, blocks)
        with popshard.on_device(sub.device):
            return refine_mod._fm_pass_population_impl(
                lv, rows_s, k, lv.cap, lv.fm_steps, k_live=lv.k_live,
                live=live_s, incumbent=lv.incumbent,
                mig_budget=lv.mig_budget)
    if shards is None:
        return run(batch, rows, live)
    outs = [run(sub, _shard_rows(rows, num, ids, sub.device),
                _shard_rows(live, num, ids, sub.device), blocks)
            for ids, _, sub, blocks in shards]
    return (_merge_rows(shards, [o[0] for o in outs], rows, num),
            _merge_rows(shards, [o[1] for o in outs],
                        torch.zeros(rows.shape[0], device=rows.device),
                        num))


def lp_refine_instances(batch: InstanceBatch, parts, max_iters: int = 24,
                        patience: int = 3, shard: Optional[str] = None,
                        model_shard: Optional[str] = None
                        ) -> Tuple[torch.Tensor, np.ndarray]:
    """``refine.lp_refine_population`` for a stacked bucket: the solo
    loop with a ``live`` row mask where it compacts, per-row stall
    counters, and one read of the improvement flag per attempt for the
    whole group (ORed over the shards on the ``mesh`` and ``chunk``
    routes).  Returns (parts [I, A, n_pad] int32 on the batch's device,
    cuts [I, A] float64), each instance bit-equal to its solo run."""
    path = refine_mod._routes(shard, model_shard, batch.device)
    shards = _shards_for(batch, path, model_shard)
    dev, k = batch.device, batch.k_pad
    rows = _to_rows(batch, parts)
    num_rows = rows.shape[0]
    lv = batch.rows(num_rows // batch.n_instances)
    cuts = lv.cuts(rows, k)  # f32 on the device, as the solo loop passes
    stall = np.zeros(num_rows, np.int32)
    done = np.zeros(num_rows, bool)
    for _ in range(max_iters):
        if done.all():
            break
        active = ~done
        improved_round = np.zeros(num_rows, bool)
        live_h = active.copy()
        fracs = torch.ones(num_rows, dtype=torch.float32, device=dev)
        remaining = 5
        while remaining > 0 and live_h.any():
            live = torch.as_tensor(live_h, device=dev)
            rows, cuts, improved, fracs, used = _dispatch_lp(
                batch, shards, rows, cuts, fracs, live, remaining)
            improved = improved.cpu().numpy()
            improved_round |= improved
            remaining -= used
            live_h &= ~improved
        stall = np.where(active, np.where(improved_round, 0, stall + 1),
                         stall)
        done |= stall >= patience
    cuts = cuts.cpu().numpy().astype(np.float64)
    return (_from_rows(batch, rows),
            cuts.reshape(-1, batch.n_instances).T.copy())


def fm_refine_instances(batch: InstanceBatch, parts,
                        max_passes: int = 8, shard: Optional[str] = None,
                        model_shard: Optional[str] = None
                        ) -> Tuple[torch.Tensor, np.ndarray]:
    """``refine.fm_refine_population`` for a stacked bucket: every pass
    runs all rows, converged rows frozen through ``live``, each row
    capped at its instance's solo step budget.  The pass is as long as
    the largest budget; on the card it replays one CUDA graph."""
    path = refine_mod._routes(shard, model_shard, batch.device)
    shards = _shards_for(batch, path, model_shard)
    dev, k = batch.device, batch.k_pad
    rows = _to_rows(batch, parts)
    num_rows = rows.shape[0]
    lv = batch.rows(num_rows // batch.n_instances)
    cuts = lv.cuts(rows, k).cpu().numpy().astype(np.float64)
    done = np.zeros(num_rows, bool)
    for _ in range(max_passes):
        if done.all():
            break
        cands, cs = _dispatch_fm(batch, shards, rows,
                                 torch.as_tensor(~done, device=dev))
        cs = cs.cpu().numpy().astype(np.float64)
        take = (cs < cuts - 1e-6) & ~done
        rows = torch.where(torch.as_tensor(take, device=dev)[:, None],
                           cands, rows)
        cuts = np.where(take, cs, cuts)
        done |= ~take
    return (_from_rows(batch, rows),
            cuts.reshape(-1, batch.n_instances).T.copy())


def refine_instances(batch: InstanceBatch, parts,
                     fm_node_limit: int = 4096, max_iters: int = 24,
                     patience: int = 3, shard: Optional[str] = None,
                     model_shard: Optional[str] = None
                     ) -> Tuple[torch.Tensor, np.ndarray]:
    """Two-tier refinement of a stacked bucket, the instance-axis mirror
    of ``refine.refine_population``: LP on every instance, then FM on
    the sub-batch of instances whose true n is within
    ``fm_node_limit``, the decision the solo driver makes."""
    parts, cuts = lp_refine_instances(batch, parts, max_iters=max_iters,
                                      patience=patience, shard=shard,
                                      model_shard=model_shard)
    fm_idx = [i for i, n in enumerate(batch.ns) if n <= fm_node_limit]
    if len(fm_idx) == batch.n_instances:
        parts, cuts = fm_refine_instances(batch, parts, shard=shard,
                                          model_shard=model_shard)
    elif fm_idx:
        sel = torch.as_tensor(fm_idx, device=batch.device)
        sp, sc = fm_refine_instances(_take_i(batch, fm_idx), parts[sel],
                                     shard=shard, model_shard=model_shard)
        parts[sel] = sp
        cuts[fm_idx] = sc
    return parts, cuts


def _entry_d(hga: HypergraphArrays) -> int:
    return 0 if hga.incident is None else int(hga.incident.shape[1])


def dispatch_groups(entries, grid: Optional[Sequence[int]] = None
                    ) -> List[List[int]]:
    """The stacks ``refine_grouped`` dispatches: entry indices grouped
    by ``group_key`` (first-seen order), each group cut, in order, into
    runs whose union stays inside the gain kernel's int32 extents
    (alpha * I * m_pad * k_pad, alpha * I * n_pad * k_pad and
    I * n_pad * D below 2**31)."""
    groups: dict = {}
    for i, e in enumerate(entries):
        groups.setdefault(group_key(e[0], e[2], grid), []).append(i)
    out: List[List[int]] = []
    for (n_pad, k_pad), idx in groups.items():
        run: List[int] = []
        m_pad = d = 0
        for i in idx:
            hga, parts = entries[i][0], entries[i][1]
            alpha = len(parts)
            m_try, d_try = max(m_pad, hga.m_pad), max(d, _entry_d(hga))
            size = len(run) + 1
            if run and max(alpha * size * m_try * k_pad,
                           alpha * size * n_pad * k_pad,
                           size * n_pad * d_try) >= _INT32_LIMIT:
                out.append(run)
                run, m_try, d_try = [], hga.m_pad, _entry_d(hga)
            run.append(i)
            m_pad, d = m_try, d_try
        out.append(run)
    return out


def _entry_migration(entry) -> tuple:
    """``(incumbent, mig_budget)`` of a ``refine_grouped`` entry, both
    None for a 4-tuple."""
    return (entry[4] if len(entry) > 4 else None,
            entry[5] if len(entry) > 5 else None)


def refine_grouped(entries, grid: Optional[Sequence[int]] = None,
                   fm_node_limit: int = 4096, max_iters: int = 24,
                   patience: int = 3, shard: Optional[str] = None,
                   model_shard: Optional[str] = None,
                   device: str | torch.device = "cuda"
                   ) -> List[Tuple[torch.Tensor, np.ndarray]]:
    """Refine a heterogeneous set of instances by bucketed stacks on
    ``device``, where every entry's level must live.

    ``entries``: ``(hga, parts [A, n_pad_i], k, eps)`` tuples, or
    ``(hga, parts, k, eps, incumbent, mig_budget)`` for incremental
    entries (DESIGN.md §14): an incumbent assignment [n_i] and a
    moved-weight budget.  Both kinds share a stack.  Returns per-entry
    ``(parts [A, n_pad_i] int32 on the device, cuts [A] float64)`` in
    input order, each bit-equal to ``refine.refine_population`` on that
    entry alone (with its incumbent and budget), which is what a stack of
    one entry runs.  This is the dispatch unit the V-cycle drivers and
    the partition service share.
    """
    dev = resolve_device(device)
    refine_mod._routes(shard, model_shard, dev)
    for e in entries:
        if e[0].device.type != dev.type:
            raise ValueError(f"an entry's level lives on {e[0].device}, "
                             f"device={device!r} was requested")
    out: List = [None] * len(entries)
    for idx in dispatch_groups(entries, grid):
        if len(idx) == 1:
            # a stack of one is the solo level: refine it unpadded, with
            # the population tiers' compaction of finished members
            hga, parts, k, eps = entries[idx[0]][:4]
            inc, mb = _entry_migration(entries[idx[0]])
            out[idx[0]] = refine_mod.refine_population(
                hga, parts, k, eps, fm_node_limit=fm_node_limit,
                max_iters=max_iters, patience=patience, shard=shard,
                incumbent=inc, mig_budget=mb, model_shard=model_shard,
                device=dev)
            continue
        incs, mbs = zip(*(_entry_migration(entries[i]) for i in idx))
        if all(x is None for x in incs):
            incs = mbs = None
        batch = stack_instances([entries[i][0] for i in idx],
                                [entries[i][2] for i in idx],
                                [entries[i][3] for i in idx], grid=grid,
                                incumbents=incs, mig_budgets=mbs)
        parts = stack_parts([entries[i][1] for i in idx], batch.n_pad,
                            batch.device)
        rp, rc = refine_instances(batch, parts,
                                  fm_node_limit=fm_node_limit,
                                  max_iters=max_iters, patience=patience,
                                  shard=shard, model_shard=model_shard)
        for j, i in enumerate(idx):
            out[i] = (rp[j][:, : batch.orig_n_pads[j]].contiguous(), rc[j])
    return out
