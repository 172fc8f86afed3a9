"""Ring partner exchange of the population (port of the single-device
branch of ``repro.core.popshard.ring_partners``).

The reference exchanges recombination partners with a ``ppermute`` over
the "pop" mesh axis when the population is sharded; on one device it is
a host roll, the one this module keeps.  The mesh path belongs to the
multi-device slice and raises.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


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
