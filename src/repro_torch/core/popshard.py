"""Population sharding over a ("pop", "model") pool of devices (port
of ``repro.core.popshard``; DESIGN.md §11): the survivor pool, the
routing of ``REPRO_POP_SHARD``, the mesh and its placements, the
placement cache, the device-memory budget and the ring partner exchange.

The pool is the torch devices of one type: ``cuda:0 .. cuda:N-1``, or
``[cpu]`` for a CPU caller.  ``set_device_limit(n)`` caps it to the
first ``max(1, n)`` survivors, as the reference caps its JAX pool: the
simulation of a device loss (``runtime.elastic.simulate_device_loss``,
the service's fault harness, DESIGN.md §13).  ``set_logical_shards(p)``
makes the pool P logical shards of the type's first device, the
counterpart of the reference's ``--xla_force_host_platform_device_count``
(its shard tests run on forced host devices): every route then splits,
pads and exchanges as on P devices and launches the real kernels on
each shard, one shard after the other on the device's current stream.
One limit and one shard count serve every device type.

Where the reference ``shard_map``s a tier over the mesh, the port has
one controller drive the pool: a placement descriptor (``pop_sharding``:
contiguous row blocks over "pop"; ``replicated``: one copy a device)
puts a tensor on the shards, each shard runs the single-device code on
its rows, and the one cross-shard value of the LP tier, the "any lane
improved" flag the reference ``psum``s, is ORed on the host from the
shards' flags in one read.  The "model" axis has size 1 in this slice.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import weakref
from collections import OrderedDict
from contextlib import nullcontext
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.env import warn_env_once

POP_SHARD_PATHS = ("mesh", "chunk", "off")

# ``None`` = every device of the type; an integer caps the pool to the
# first N devices
_DEVICE_LIMIT: Optional[int] = None
# ``None`` = the physical devices; an integer P = P logical shards of the
# type's first device
_LOGICAL_SHARDS: Optional[int] = None


def local_devices(device: str | torch.device = "cuda"
                  ) -> List[torch.device]:
    """The device pool of ``device``'s type, capped to the survivor
    count after a device loss (``set_device_limit``): the CUDA devices
    the process sees, or the one CPU device; or, after
    ``set_logical_shards(p)``, ``p`` logical shards of the first one."""
    dev = torch.device(device)
    base = (torch.device("cuda", 0) if dev.type == "cuda"
            else torch.device(dev.type))
    if _LOGICAL_SHARDS is not None:
        devs = [base] * _LOGICAL_SHARDS
    elif dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [base]
    if _DEVICE_LIMIT is not None:
        return devs[: max(1, _DEVICE_LIMIT)]
    return devs


def set_device_limit(n: Optional[int],
                     device: str | torch.device = "cuda"
                     ) -> List[torch.device]:
    """Cap the pool to ``n`` survivors (``None`` restores the full pool).
    Returns the new pool of ``device``'s type.  Meshes are cached per
    pool token, so the next ``pop_mesh`` after a shrink is the
    survivors' mesh; populations re-pad to its "pop" size."""
    global _DEVICE_LIMIT
    _DEVICE_LIMIT = None if n is None else max(1, int(n))
    return local_devices(device)


def set_logical_shards(p: Optional[int],
                       device: str | torch.device = "cuda"
                       ) -> List[torch.device]:
    """Make the pool ``p`` logical shards of the type's first device
    (``None`` restores the physical devices).  Returns the new pool of
    ``device``'s type."""
    global _LOGICAL_SHARDS
    _LOGICAL_SHARDS = None if p is None else max(1, int(p))
    return local_devices(device)


def on_device(dev: torch.device):
    """The context that makes ``dev`` current for a shard's launches (the
    port's kernels launch on the current device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def pop_shard_path(device: str | torch.device = "cuda") -> str:
    """Routing: ``REPRO_POP_SHARD=mesh|chunk|off`` forces a path; ``auto``
    (unset) picks ``mesh`` when the pool of ``device``'s type holds more
    than one device, else ``off``."""
    env = os.environ.get("REPRO_POP_SHARD", "auto").strip().lower()
    if env in POP_SHARD_PATHS:
        return env
    if env not in ("", "auto"):
        warn_env_once("REPRO_POP_SHARD", env, "auto routing")
    return "mesh" if len(local_devices(device)) > 1 else "off"


def resolve(shard: Optional[str],
            device: str | torch.device = "cuda") -> str:
    """Validate an explicit ``shard=`` override (None/"auto" defers to
    ``REPRO_POP_SHARD``)."""
    if shard is None:
        return pop_shard_path(device)
    s = shard.strip().lower()
    if s == "auto":
        return pop_shard_path(device)
    if s not in POP_SHARD_PATHS:
        raise ValueError(f"unknown population shard path {shard!r}; "
                         f"expected one of {POP_SHARD_PATHS} (or 'auto')")
    return s


# --------------------------------------------------------------------------
# The mesh and its placements
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PopMesh:
    """The pool's devices in a (pop, model) grid, ``devices[p][q]``."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"pop": len(self.devices), "model": len(self.devices[0])}

    @property
    def pop_devices(self) -> Tuple[torch.device, ...]:
        """The device of each "pop" shard (model index 0)."""
        return tuple(row[0] for row in self.devices)


_MESH_CACHE: dict = {}


def _pool_token(device: str | torch.device = "cuda") -> tuple:
    """Identity of the CURRENT pool: its devices in order (a pool of
    logical shards repeats one).  Keying the mesh cache on it means a
    pool change (a device loss, a restore, another shard count) is never
    served a mesh built over other devices."""
    return tuple((d.type, d.index) for d in local_devices(device))


def pop_mesh(device: str | torch.device = "cuda") -> PopMesh:
    """The ("pop", "model") mesh of ``device``'s pool, cached per pool
    token; "model" is 1, so every device of the pool holds a slice of
    the population."""
    key = (_pool_token(device), 1)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = PopMesh(tuple((d,) for d in local_devices(device)))
        _MESH_CACHE[key] = mesh
    return mesh


@dataclasses.dataclass(frozen=True)
class PopSharding:
    """Leading axis in contiguous blocks over "pop" (partitions, member
    weights, cuts, flags, instances)."""
    mesh: PopMesh

    def put(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The shards' blocks of ``x`` (rows a multiple of the "pop"
        size, ``pad_rows``), each on its shard's device."""
        devs = self.mesh.pop_devices
        b = x.shape[0] // len(devs)
        return [x[s * b:(s + 1) * b].to(d) for s, d in enumerate(devs)]

    @staticmethod
    def gather(blocks, home: torch.device) -> torch.Tensor:
        """The shards' blocks back in order, on ``home``."""
        return torch.cat([b.to(home) for b in blocks])


@dataclasses.dataclass(frozen=True)
class Replicated:
    """One copy a device (structure, incidence, caps, scalars)."""
    mesh: PopMesh


def pop_sharding(mesh: PopMesh) -> PopSharding:
    """Leading axis over "pop"."""
    return PopSharding(mesh)


def replicated(mesh: PopMesh) -> Replicated:
    """Fully replicated."""
    return Replicated(mesh)


def pad_rows(arr, mult: int):
    """Pad the leading (population) axis up to a multiple of ``mult`` by
    repeating row 0 (a numpy array or a tensor).  Pad rows mirror member
    0 exactly, so per-member results and the ORed any-improved flag are
    unchanged; callers slice the pad rows off after the dispatch."""
    r = arr.shape[0] % mult
    if r == 0:
        return arr
    if torch.is_tensor(arr):
        return torch.cat([arr, arr[:1].expand(mult - r,
                                             *arr.shape[1:])])
    arr = np.asarray(arr)
    return np.concatenate([arr, np.repeat(arr[:1], mult - r, axis=0)])


# --------------------------------------------------------------------------
# Mesh-driven placement cache
# --------------------------------------------------------------------------
# Placements of refinement inputs, keyed on (placement_token(obj),
# device or placement).  A level's HypergraphArrays object is stable
# across passes (``Hypergraph.arrays`` caches it), so its structure ships
# once per (level, device), not once per pass; on a shard of the level's
# own device the placement is the level itself.
#
# Keys go through a monotonic token, NOT a raw id(): CPython recycles
# addresses, so a freed level's id can reappear on a brand-new object
# before any finalizer has run, and an id-keyed cache would hand the new
# level the dead level's device tensors.  ``placement_token`` validates
# the id -> token entry against a live weakref on every lookup, so a
# recycled id always mints a fresh token, whatever the finalizers' timing.
_TOKEN_COUNTER = itertools.count()
_TOKEN_CACHE: dict = {}


def placement_token(obj) -> int:
    """A process-unique token for ``obj``, stable while ``obj`` is alive.

    Two distinct objects never share a token, even if one's id() is
    recycled from the other (the weakref check catches reuse and mints a
    new token).  Keys the placement cache and refine's cap cache."""
    key = id(obj)
    hit = _TOKEN_CACHE.get(key)
    if hit is not None:
        ref, tok = hit
        if ref() is obj:
            return tok
    tok = next(_TOKEN_COUNTER)
    _TOKEN_CACHE[key] = (weakref.ref(obj), tok)
    # housekeeping only: correctness never depends on this running
    weakref.finalize(obj, _TOKEN_CACHE.pop, key, None)
    return tok


_PLACEMENT_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_PLACEMENT_CACHE_MAX = 64


def _put_one(obj, dev: torch.device):
    """``obj`` (a tensor or a level's arrays) on ``dev``: itself when it
    is there already."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if obj.device == dev:
        return obj
    moved = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    for name, val in moved.items():
        if torch.is_tensor(val):
            moved[name] = val.to(dev)
    moved.update(pin_sort=None, pin_sort_edge=None)
    return type(obj)(**moved)


def device_put_cached(obj, target):
    """``obj`` placed on ``target`` (a ``torch.device``, or ``Replicated``
    for a list of one copy a shard), memoised on
    ``(placement_token(obj), target)``."""
    key = (placement_token(obj), target)
    hit = _PLACEMENT_CACHE.get(key)
    if hit is not None:
        _PLACEMENT_CACHE.move_to_end(key)
        return hit
    if isinstance(target, Replicated):
        placed = [_put_one(obj, d) for d in target.mesh.pop_devices]
    else:
        placed = _put_one(obj, target)
    _PLACEMENT_CACHE[key] = placed
    # release the device tensors as soon as the level dies, not when 64
    # newer placements eventually evict the entry
    weakref.finalize(obj, _PLACEMENT_CACHE.pop, key, None)
    while len(_PLACEMENT_CACHE) > _PLACEMENT_CACHE_MAX:
        _PLACEMENT_CACHE.popitem(last=False)
    return placed


# --------------------------------------------------------------------------
# Artificial per-device structure-memory budget
# --------------------------------------------------------------------------
# ``REPRO_DEVICE_MEM_BUDGET`` (bytes per device) is checked at the
# population refinement dispatch against the structure bytes each device
# would hold: pin tables divided by the model-axis shard count, edge and
# vertex tables replicated.  Unset = no check.  The single-device path
# checks a shard count of 1.
class DeviceBudgetExceeded(RuntimeError):
    """Structure bytes per device exceed ``REPRO_DEVICE_MEM_BUDGET``."""


def device_mem_budget() -> Optional[int]:
    """The artificial per-device budget in bytes, or None when unset (or
    not a positive integer: warned once)."""
    raw = os.environ.get("REPRO_DEVICE_MEM_BUDGET", "").strip()
    if not raw:
        return None
    try:
        b = int(raw)
    except ValueError:
        warn_env_once("REPRO_DEVICE_MEM_BUDGET", raw, "no budget check")
        return None
    if b <= 0:
        warn_env_once("REPRO_DEVICE_MEM_BUDGET", raw,
                      "no budget check (must be > 0)")
        return None
    return b


def structure_bytes_per_device(hga, nmodel: int) -> int:
    """Structure bytes ONE device holds: the two int32 pin tables are
    row-sharded ``nmodel`` ways; vertex weights, edge weights and edge
    sizes stay replicated."""
    p_pad = int(hga.pin_vertex.shape[-1])
    n_pad = int(hga.vertex_weights.shape[-1])
    m_pad = int(hga.edge_weights.shape[-1])
    pins = 2 * 4 * p_pad // max(1, nmodel)
    return pins + 4 * n_pad + 2 * 4 * m_pad


def enforce_structure_budget(hga, nmodel: int) -> None:
    """Raise ``DeviceBudgetExceeded`` when the per-device structure bytes
    for an ``nmodel``-way shard exceed ``REPRO_DEVICE_MEM_BUDGET``.
    No-op when the budget knob is unset."""
    budget = device_mem_budget()
    if budget is None:
        return
    need = structure_bytes_per_device(hga, nmodel)
    if need > budget:
        raise DeviceBudgetExceeded(
            f"structure needs {need} bytes/device ({nmodel}-way model "
            f"shard) but REPRO_DEVICE_MEM_BUDGET={budget}")


# --------------------------------------------------------------------------
# Ring partner exchange (paper Fig. 1c) over the "pop" axis
# --------------------------------------------------------------------------
@lru_cache(maxsize=8)
def _ring_exchange_fn(mesh: PopMesh):
    devs = mesh.pop_devices
    npop = len(devs)

    def body(blocks):
        # a shard holds contiguous members: the global roll by -1 is a
        # local shift plus the first row of the next shard, which each
        # shard passes to the previous one (the wrap-around closes the
        # ring)
        recv = [blocks[(s + 1) % npop][:1].to(devs[s]) for s in range(npop)]
        return [torch.cat([b[1:], r]) for b, r in zip(blocks, recv)]

    return body


def ring_partners(parts, shard: Optional[str] = None,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """``partner[i] = parts[(i + 1) % alpha]``: the paper's ring pairing.

    On the ``mesh`` path (``shard``, None = ``REPRO_POP_SHARD``, over the
    pool of ``device``'s type) the exchange runs on the shards whenever
    the population divides the "pop" size; the host roll is the
    single-device reference.  Both give the same partner tensor."""
    parts = np.asarray(parts)
    alpha = parts.shape[0]
    if resolve(shard, device) == "mesh" and alpha > 1:
        mesh = pop_mesh(device)
        if alpha % mesh.shape["pop"] == 0:
            sh = pop_sharding(mesh)
            out = _ring_exchange_fn(mesh)(sh.put(torch.from_numpy(parts)))
            return sh.gather(out, torch.device("cpu")).numpy()
    return np.roll(parts, -1, axis=0)
