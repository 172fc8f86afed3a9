"""The survivor device pool and the ring partner exchange of the
population (port of ``repro.core.popshard``'s ``local_devices``,
``set_device_limit`` and the single-device branch of ``ring_partners``).

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
