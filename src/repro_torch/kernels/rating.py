"""Pair-rating segment-sum kernel (port of
``repro.kernels.rating.rating_scatter_pallas``).

``rating_segment_sum(vals, segs, S)`` sums the device coarsener's
candidate-pair ratings by sorted segment id: ``out[s] = sum vals[c]``
over ``segs[c] == s``, ids outside [0, S) dropped.  On the card it is a
linear, deterministic segmented reduction (``csrc/rating.cu``): no float
atomics, so a rerun on the same inputs is bit-identical.  On CPU tensors
the wrapper runs the plain version from ``ref``.  The wrapper counts its
kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .common import RATING_BLOCK_THREADS, RATING_CHUNK

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("rating")
    if not getattr(lib, "_typed", False):
        lib.rating_segsum_launch.argtypes = ([_P, _P, _I, _P, _I]
                                             + [_P] * 4 + [_I, _I, _P])
        lib.rating_segsum_launch.restype = _I
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def rating_segment_sum(vals: torch.Tensor, segs: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """vals [C] f32, segs [C] int32 with equal ids contiguous (ascending)
    -> [num_segments] f32."""
    if not vals.is_cuda:
        return ref.rating_segment_sum_ref(vals, segs, num_segments)
    c = vals.shape[0]
    dev = vals.device
    if vals.dim() != 1 or tuple(segs.shape) != (c,):
        raise ValueError("expected vals [C] and segs [C]")
    for name, t, dt in (("vals", vals, torch.float32),
                        ("segs", segs, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev} (got {t.dtype} on {t.device})")
    if c >= 2 ** 30:
        raise ValueError("rating kernel takes fewer than 2**30 candidates")
    out = torch.zeros(num_segments, dtype=torch.float32, device=dev)
    if c == 0:
        return out
    scratch = 2 * ((c + RATING_CHUNK - 1) // RATING_CHUNK)
    seg_a = torch.empty(scratch, dtype=torch.int32, device=dev)
    seg_b = torch.empty_like(seg_a)
    val_a = torch.empty(scratch, dtype=torch.float32, device=dev)
    val_b = torch.empty_like(val_a)
    lib = _lib()
    err = lib.rating_segsum_launch(
        segs.data_ptr(), vals.data_ptr(), c, out.data_ptr(), num_segments,
        seg_a.data_ptr(), val_a.data_ptr(), seg_b.data_ptr(),
        val_b.data_ptr(), RATING_CHUNK, RATING_BLOCK_THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "rating_segsum_launch", lib)
    rating_segment_sum.launches += 1
    return out


rating_segment_sum.launches = 0
