"""Gain-assembly kernels (ports of ``repro.kernels.gain``'s batch kernels).

``gain_gather_batch`` (entry ``table``, k <= ``GAIN_WARP_MAX_K``) and
``gain_stream_batch`` (entry ``stream``) compute

    gains[a, v, :] = sum_d bi[a, inc[v, d], :] - sum_d wi[a, inc[v, d]]

for the whole population in one launch (``csrc/gain.cu`` says how each
maps to the card).  On CPU tensors each wrapper runs its plain version
from ``ref``; on CUDA tensors it launches its kernel or raises.  Each
wrapper counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .common import (GAIN_BLOCK_THREADS, GAIN_TILE_SMEM_BYTES,
                     GAIN_TILE_VERTICES)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("gain")
    if not getattr(lib, "_typed", False):
        lib.gain_table_launch.argtypes = [_P, _P, _P, _P] + [_I] * 6 + [_P]
        lib.gain_table_launch.restype = _I
        lib.gain_stream_launch.argtypes = [_P, _P, _P, _P] + [_I] * 7 + [_P]
        lib.gain_stream_launch.restype = _I
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _checked(incident, becomes_internal, was_internal):
    """Validate the kernel's operands; returns (alpha, n, d, m, k)."""
    if incident.dim() != 2 or becomes_internal.dim() != 3:
        raise ValueError("expected incident [N, D] and tables [alpha, M, k]")
    alpha, m, k = becomes_internal.shape
    n, d = incident.shape
    if tuple(was_internal.shape) != (alpha, m):
        raise ValueError(f"was_internal {tuple(was_internal.shape)} != "
                         f"{(alpha, m)}")
    dev = incident.device
    for name, t, dt in (("incident", incident, torch.int32),
                        ("becomes_internal", becomes_internal, torch.float32),
                        ("was_internal", was_internal, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev} (got {t.dtype} on {t.device})")
    if max(alpha * m * k, alpha * n * k, n * d) >= 2 ** 31:
        raise ValueError("gain kernel operands exceed int32 extents")
    return alpha, n, d, m, k


def _launch(entry: str, wrapper, incident, becomes_internal, was_internal):
    alpha, n, d, m, k = _checked(incident, becomes_internal, was_internal)
    out = torch.empty((alpha, n, k), dtype=torch.float32,
                      device=incident.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(incident.device).cuda_stream
    args = [incident.data_ptr(), becomes_internal.data_ptr(),
            was_internal.data_ptr(), out.data_ptr(), alpha, n, d, m, k]
    if entry == "table":
        err = lib.gain_table_launch(*args, GAIN_BLOCK_THREADS, stream)
    else:
        # the staged tile (tile * (d + 1) * 4 bytes) must fit the 48 KB a
        # block gets without an opt-in
        tile = max(1, min(GAIN_TILE_VERTICES,
                          GAIN_TILE_SMEM_BYTES // (4 * (d + 1))))
        if tile * (d + 1) * 4 > GAIN_TILE_SMEM_BYTES:
            raise ValueError(f"incidence rows of width {d} do not fit the "
                             "stream kernel's shared memory")
        err = lib.gain_stream_launch(*args, tile, GAIN_BLOCK_THREADS, stream)
    build.check(err, f"gain_{entry}_launch", lib)
    wrapper.launches += 1
    return out


def gain_gather_batch(incident: torch.Tensor, becomes_internal: torch.Tensor,
                      was_internal: torch.Tensor) -> torch.Tensor:
    """Entry ``table``: incident [N, D] int32 (pad -1), becomes_internal
    [alpha, M, k] f32, was_internal [alpha, M] f32 -> [alpha, N, k] f32."""
    if not incident.is_cuda:
        return ref.gain_gather_batch_ref(incident, becomes_internal,
                                         was_internal)
    return _launch("table", gain_gather_batch, incident, becomes_internal,
                   was_internal)


def gain_stream_batch(incident: torch.Tensor, becomes_internal: torch.Tensor,
                      was_internal: torch.Tensor) -> torch.Tensor:
    """Entry ``stream``: same contract as ``gain_gather_batch``, for any
    k; the plain version is the edge-tile-order one."""
    if not incident.is_cuda:
        return ref.gain_stream_batch_ref(incident, becomes_internal,
                                         was_internal)
    return _launch("stream", gain_stream_batch, incident, becomes_internal,
                   was_internal)


gain_gather_batch.launches = 0
gain_stream_batch.launches = 0
