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
              (one warp per (member, vertex) row), or ``gain_gather``
              for the scalar LP tier's one member
``"stream"``  the layout is on a CUDA device and k is larger: kernel
              ``gain_stream_batch`` (one block per member and vertex
              tile), or ``gain_stream`` for one member
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
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from repro_torch.env import warn_env_once
from . import gain, rating, ref
from .common import GAIN_WARP_MAX_K, SEGSUM_MAX_K

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
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


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
