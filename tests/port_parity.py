"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Both packages get the same numpy inputs: a reference hypergraph or
padded array bundle is copied field by field into the port's objects,
and results come back to numpy for comparison.  JAX stays on the CPU
(``tests/conftest.py``) and the port runs with ``device="cpu"``.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.hypergraph import (Hypergraph as PortHypergraph,  # noqa: E402
                                         HypergraphArrays as PortArrays)

# JAX's CPU thread pool and torch's OpenMP pool contend for the same
# cores when both run in one process; the port's small CPU runs were
# measured 30x slower with torch's default thread count beside JAX.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARRAY_FIELDS = ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
                "edge_sizes")


def port_hg(hg) -> PortHypergraph:
    """The port's copy of a reference ``Hypergraph``."""
    return PortHypergraph.from_numpy(hg.n, hg.m, hg.pins, hg.edge_offsets,
                                     hg.vertex_weights, hg.edge_weights)


def port_arrays(hga) -> PortArrays:
    """The port's copy of a reference ``HypergraphArrays`` (on the CPU)."""
    fields = {f: np.asarray(getattr(hga, f)) for f in ARRAY_FIELDS}
    fields.update(n=int(hga.n), m=int(hga.m),
                  incident=(None if hga.incident is None
                            else np.asarray(hga.incident)))
    return PortArrays.from_numpy(fields, device=CPU)


def to_np(x) -> np.ndarray:
    """A tensor (either package's) or array as numpy."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_bit_equal(got, want, what: str = "") -> None:
    """Exact equality of values (dtypes may differ: int32 vs int64)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), (
        what, int((got != want).sum()), "elements differ")
