"""Kernel dispatcher of the port (counterpart of ``repro.kernels.ops``).

Where the reference asks ``interpret_mode()`` (is the backend the CPU),
the port asks whether the tensors lie on a CUDA device: the kernel
wrappers launch their CUDA kernel there and run their plain version on
CPU tensors.

Gain-path dispatch
------------------
``gain_path(m, k, incidence)`` picks how ``core.metrics`` assembles the
[alpha, n_pad, k] gain tensor from the per-edge tables:

============  ==========================================================
path          chosen when
============  ==========================================================
``"table"``   the dense incidence layout is on a CUDA device and
              ``k <= GAIN_WARP_MAX_K``: kernel ``gain_gather_batch``
              (a group of lanes sized to k per (member, vertex) row,
              16-byte loads), or ``gain_gather`` for the scalar LP
              tier's one member
``"stream"``  the layout is on a CUDA device and k is larger: kernel
              ``gain_stream_batch`` (the same kernel of ``gain.cu``), or
              ``gain_stream`` for one member
``"segsum"``  no layout on a CUDA device (CPU tensors, or a level whose
              layout the expansion guard dropped), ``k <= SEGSUM_MAX_K``:
              per-pin gather + segment-sum
``"compact"`` the same, larger k: at most two scattered columns per pin
============  ==========================================================

``REPRO_GAIN_PATH=table|stream|segsum|compact`` forces a path (the
kernel paths only where a layout exists); ``auto``/unset means the table
above.  ``REPRO_RATING_PATH=kernel|plain`` forces the rating
aggregation, scalar and batched alike; auto routes every round to the
kernels (on CPU tensors the kernel wrappers run their plain versions).

Public ops
----------
The rest of ``repro.kernels.ops``'s public API, with the same names and
arguments: the host layout converters ``edge_pin_matrix`` and
``vertex_incidence_matrix``, ``edge_terms``, and the kernel-or-plain ops
``connectivity``, ``cutsize``, ``gain_gather``, ``gain_gather_batch`` and
``embedding_bag`` (``use_kernel=False`` runs the plain version).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.env import warn_env_once
from . import connectivity as _connectivity
from . import embedding_bag as _embedding_bag
from . import gain, rating, ref
from .common import GAIN_WARP_MAX_K, KERNEL_MAX_K, SEGSUM_MAX_K

GAIN_PATHS = ("table", "stream", "segsum", "compact")
RATING_PATHS = ("kernel", "plain")

#: every kernel wrapper of the port, by the name ``chip_smoke.py`` reports
KERNELS = {
    "gain_table": gain.gain_gather_batch,
    "gain_stream": gain.gain_stream_batch,
    "rating_segment_sum": rating.rating_segment_sum,
    "rating_segment_sum_batch": rating.rating_segment_sum_batch,
    "gain_table_one": gain.gain_gather,
    "gain_stream_one": gain.gain_stream,
    "connectivity": _connectivity.connectivity,
    "cutsize": _connectivity.cutsize,
    "embedding_bag": _embedding_bag.embedding_bag,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by kernel name) to the wrappers' counters: the
    launches of a CUDA graph's replay, which runs no wrapper."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def _gain_env() -> str:
    env = os.environ.get("REPRO_GAIN_PATH", "auto").strip().lower()
    if env not in GAIN_PATHS and env not in ("", "auto"):
        warn_env_once("REPRO_GAIN_PATH", env, "auto routing")
        return "auto"
    return env


def gain_layout_enabled(device: torch.device | str) -> bool:
    """Should the dense incidence layout be attached to arrays on
    ``device``?  True iff a kernel gain path is reachable there (a CUDA
    device, or a kernel path forced via ``REPRO_GAIN_PATH``)."""
    env = _gain_env()
    if env in ("table", "stream"):
        return True
    if env in ("segsum", "compact"):
        return False
    return torch.device(device).type == "cuda"


def gain_path(m: int, k: int, incidence: Optional[torch.Tensor] = None
              ) -> str:
    """Resolve the gain-assembly path for padded table size ``m`` and
    ``k`` blocks; ``incidence`` is the level's dense layout (None when
    absent).  ``m`` does not enter the auto choice on this card: the
    tables are read from device memory or L2 on either kernel path."""
    del m
    env = _gain_env()
    if env in ("segsum", "compact"):
        return env
    if env in ("table", "stream") and incidence is not None:
        return env
    if incidence is None or not incidence.is_cuda:
        return "segsum" if k <= SEGSUM_MAX_K else "compact"
    return "table" if k <= GAIN_WARP_MAX_K else "stream"


def gain_assemble(incident: torch.Tensor, becomes_internal: torch.Tensor,
                  was_internal: torch.Tensor, path: str) -> torch.Tensor:
    """Kernel-path gain assembly of one member (``path`` in {"table",
    "stream"}): tables [M, k] / [M] -> [N, k]."""
    if path == "table":
        return gain.gain_gather(incident, becomes_internal, was_internal)
    if path == "stream":
        return gain.gain_stream(incident, becomes_internal, was_internal)
    raise ValueError(f"not a kernel gain path: {path!r}")


def gain_assemble_batch(incident: torch.Tensor,
                        becomes_internal: torch.Tensor,
                        was_internal: torch.Tensor, path: str
                        ) -> torch.Tensor:
    """Kernel-path population gain assembly (``path`` in {"table",
    "stream"}): [alpha, N, k]."""
    if path == "table":
        return gain.gain_gather_batch(incident, becomes_internal,
                                      was_internal)
    if path == "stream":
        return gain.gain_stream_batch(incident, becomes_internal,
                                      was_internal)
    raise ValueError(f"not a kernel gain path: {path!r}")


def rating_path(c: int) -> str:
    """How the device coarsener aggregates ``c`` candidate ratings.  The
    kernel is linear in ``c``, so auto always picks it;
    ``REPRO_RATING_PATH=kernel|plain`` forces a path."""
    del c
    env = os.environ.get("REPRO_RATING_PATH", "auto").strip().lower()
    if env in RATING_PATHS:
        return env
    if env not in ("", "auto"):
        warn_env_once("REPRO_RATING_PATH", env, "auto routing")
    return "kernel"


def rating_segment_sum(vals: torch.Tensor, segs: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment-sum of candidate-pair ratings by sorted segment id (ids
    outside [0, num_segments) dropped), routed by ``rating_path()``."""
    if rating_path(vals.shape[0]) == "kernel":
        return rating.rating_segment_sum(vals, segs, num_segments)
    return ref.rating_segment_sum_ref(vals, segs, num_segments)


def rating_segment_sum_batch(vals: torch.Tensor, segs: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Per-member segment-sums of the mutation cohort's ratings
    ``vals[alpha, C]`` over one shared sorted ``segs[C]``, routed by
    ``rating_path()``; every row equals ``rating_segment_sum`` on it."""
    if rating_path(vals.shape[-1]) == "kernel":
        return rating.rating_segment_sum_batch(vals, segs, num_segments)
    return ref.rating_segment_sum_batch_ref(vals, segs, num_segments)


# --------------------------------------------------------------------------
# host layout converters
# --------------------------------------------------------------------------
def edge_pin_matrix(hg, block_m: int = 512, lane_pad: int = 8) -> np.ndarray:
    """CSR -> padded [M_pad, S_pad] int32 pin matrix (pad = -1): M rounded
    up to a multiple of ``block_m``, S to a power of two (>= ``lane_pad``);
    byte-equal to the reference's."""
    from repro_torch.core.hypergraph import _round_pow2
    sizes = hg.edge_sizes()
    s_pad = max(int(_round_pow2(int(sizes.max()) if hg.m else 1, lane_pad)),
                lane_pad)
    m_pad = ((hg.m + block_m - 1) // block_m) * block_m
    out = np.full((m_pad, s_pad), -1, np.int32)
    rows = hg.pin_edge_ids()
    cols = (np.arange(hg.num_pins, dtype=np.int64)
            - np.repeat(hg.edge_offsets[:-1], sizes))
    out[rows, cols] = hg.pins
    return out


def vertex_incidence_matrix(hg, block_n: int = 256,
                            lane_pad: int = 8) -> np.ndarray:
    """Dual CSR -> padded [N_pad, D_pad] int32 incident-edge matrix (pad =
    -1), N rounded up to a multiple of ``block_n``; the cached layout of
    ``hg.incidence_matrix``."""
    n_rows = ((hg.n + block_n - 1) // block_n) * block_n
    return hg.incidence_matrix(max(n_rows, block_n), lane_pad=lane_pad)


# --------------------------------------------------------------------------
# public ops (kernel or plain version, same signature)
# --------------------------------------------------------------------------
def connectivity(pins: torch.Tensor, part: torch.Tensor, k: int,
                 use_kernel: bool = True) -> torch.Tensor:
    """lambda(e) [M] int32 of the pin matrix ``pins[M, S]``.  Routed as the
    reference routes it: kernel #7 when ``use_kernel`` and
    ``k <= KERNEL_MAX_K`` (a uint32 block mask), else the plain version on
    either device.  That is the reference's routing by k, not a fallback:
    on a CUDA tensor the kernel path launches or raises."""
    if use_kernel and k <= KERNEL_MAX_K:
        return _connectivity.connectivity(pins, part, k)
    return ref.connectivity_ref(pins, part, k)


def cutsize(pins: torch.Tensor, part: torch.Tensor,
            edge_weights: torch.Tensor, k: int,
            use_kernel: bool = True) -> torch.Tensor:
    """f32 scalar cut of the pin matrix, routed like ``connectivity``
    (kernel #8 at ``k <= KERNEL_MAX_K``)."""
    if use_kernel and k <= KERNEL_MAX_K:
        return _connectivity.cutsize(pins, part, edge_weights, k)
    return ref.cutsize_ref(pins, part, edge_weights, k)


def edge_terms(phi: torch.Tensor, edge_sizes: torch.Tensor,
               edge_weights: torch.Tensor):
    """Per-edge FM terms from Phi [..., M, k] (stage 1 of the gain
    pipeline): ``(becomes_internal [..., M, k], was_internal [..., M])``;
    ``edge_weights`` is [M], or [alpha, M] with one row per member."""
    sizes = edge_sizes[:, None]
    w = edge_weights[..., None]
    becomes_internal = torch.where(phi == sizes - 1, w, 0.0)
    was_internal = torch.where((phi == sizes) & (sizes > 0), w, 0.0).sum(-1)
    return becomes_internal, was_internal


def gain_gather(incident: torch.Tensor, becomes_internal: torch.Tensor,
                was_internal: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """One-member gain assembly [N, k]: the ``table`` kernel (#5) at
    ``k <= GAIN_WARP_MAX_K``, the ``stream`` kernel (#6) above it, or the
    plain version with ``use_kernel=False``."""
    if use_kernel:
        k = becomes_internal.shape[-1]
        return gain_assemble(incident, becomes_internal, was_internal,
                             "table" if k <= GAIN_WARP_MAX_K else "stream")
    return ref.gain_gather_ref(incident, becomes_internal, was_internal)


def gain_gather_batch(incident: torch.Tensor, becomes_internal: torch.Tensor,
                      was_internal: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """Population gain assembly [alpha, N, k] in one launch (#1 at
    ``k <= GAIN_WARP_MAX_K``, #2 above it), or the plain version."""
    if use_kernel:
        k = becomes_internal.shape[-1]
        return gain_assemble_batch(incident, becomes_internal, was_internal,
                                   "table" if k <= GAIN_WARP_MAX_K
                                   else "stream")
    return ref.gain_gather_batch_ref(incident, becomes_internal,
                                     was_internal)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  combiner: str = "sum",
                  use_kernel: bool = True) -> torch.Tensor:
    """EmbeddingBag [B, D] (kernel #9), or the plain version."""
    if use_kernel:
        return _embedding_bag.embedding_bag(table, indices, combiner)
    return ref.embedding_bag_ref(table, indices, combiner)
