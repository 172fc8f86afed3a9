"""The survivor device pool, the device-memory budget and the ring
partner exchange of the population (port of ``repro.core.popshard``'s
``local_devices``, ``set_device_limit``, the budget helpers and the
single-device branch of ``ring_partners``).

The pool is the torch devices of one type: ``cuda:0 .. cuda:N-1``, or
``[cpu]`` for a CPU caller.  ``set_device_limit(n)`` caps it to the
first ``max(1, n)`` survivors, as the reference caps its JAX pool: the
simulation of a device loss (``runtime.elastic.simulate_device_loss``,
the service's fault harness, DESIGN.md §13).  One limit serves every
device type.

The reference exchanges recombination partners with a ``ppermute`` over
the "pop" mesh axis when the population is sharded; on one device it is
a host roll, the one this module keeps.  The mesh and its ring belong
to the multi-device slice and raise.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.env import warn_env_once

# ``None`` = every device of the type; an integer caps the pool to the
# first N devices
_DEVICE_LIMIT: Optional[int] = None


def local_devices(device: str | torch.device = "cuda"
                  ) -> List[torch.device]:
    """The device pool of ``device``'s type, capped to the survivor
    count after a device loss (``set_device_limit``): the CUDA devices
    the process sees, or the one CPU device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(dev.type)]
    if _DEVICE_LIMIT is not None:
        return devs[: max(1, _DEVICE_LIMIT)]
    return devs


def set_device_limit(n: Optional[int],
                     device: str | torch.device = "cuda"
                     ) -> List[torch.device]:
    """Cap the pool to ``n`` survivors (``None`` restores the full pool).
    Returns the new pool of ``device``'s type."""
    global _DEVICE_LIMIT
    _DEVICE_LIMIT = None if n is None else max(1, int(n))
    return local_devices(device)


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


def ring_partners(parts, shard: Optional[str] = None) -> np.ndarray:
    """``partner[i] = parts[(i + 1) % alpha]``: the paper's ring pairing.

    ``shard`` (None = ``REPRO_POP_SHARD``): ``"mesh"`` raises
    ``NotImplementedError``; every other value takes the host roll."""
    path = (shard or os.environ.get("REPRO_POP_SHARD", "")).strip().lower()
    if path == "mesh":
        raise NotImplementedError(
            "the mesh ring exchange (shard='mesh') belongs to a later slice "
            "of the port (multi-device paths)")
    return np.roll(np.asarray(parts), -1, axis=0)
