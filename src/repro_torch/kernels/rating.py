"""Pair-rating segment-sum kernels (ports of
``repro.kernels.rating.rating_scatter_pallas`` and
``rating_scatter_batch_pallas``).

``rating_segment_sum(vals, segs, S)`` sums the device coarsener's
candidate-pair ratings by sorted segment id: ``out[s] = sum vals[c]``
over ``segs[c] == s``, ids outside [0, S) dropped.
``rating_segment_sum_batch(vals, segs, S)`` does the same for the
mutation cohort's ``vals[alpha, C]`` over one shared ``segs[C]`` (and
for the per-vertex sums of mutation's FM steps, ``alpha * (k + 1)``
rows of pins sorted by vertex).  On the card both launch the same two
passes of ``csrc/rating.cu``, a linear segmented reduction in a fixed
order: no float atomics, so a rerun on the same inputs is bit-identical,
and every batch row is bit-equal to the scalar entry on that row.  The
launch needs no host sync and allocates only the output and scratch
sized by the shapes, so it can be captured in a CUDA graph.  On CPU
tensors the wrappers run the plain versions from ``ref``.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .common import RATING_ROWS, RATING_TILE

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("rating")
    if not getattr(lib, "_typed", False):
        lib.rating_segsum_launch.argtypes = ([_P, _P, _I, _I, _P, _I, _P, _P]
                                             + [_I, _I, _P])
        lib.rating_segsum_launch.restype = _I
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _checked(vals: torch.Tensor, segs: torch.Tensor,
             num_segments: int) -> tuple:
    """Validate ``vals [R, C]`` and ``segs [C]`` for the kernel; returns
    ``(R, C)``."""
    rows, c = vals.shape
    dev = vals.device
    if tuple(segs.shape) != (c,):
        raise ValueError(f"segs {tuple(segs.shape)} does not match vals "
                         f"{tuple(vals.shape)}")
    for name, t, dt in (("vals", vals, torch.float32),
                        ("segs", segs, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev} (got {t.dtype} on {t.device})")
    if c >= 2 ** 30 or rows > 65535 or rows * max(num_segments, c) >= 2 ** 31:
        raise ValueError("rating operands exceed the kernel's grid or int32 "
                         "extents")
    if num_segments < 0:
        raise ValueError(f"num_segments {num_segments} < 0")
    return rows, c


def _launch(wrapper, vals: torch.Tensor, segs: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """Launch the kernel's two passes on the current stream; returns
    ``[R, num_segments]``."""
    rows, c = _checked(vals, segs, num_segments)
    dev = vals.device
    if c == 0 or rows == 0 or num_segments == 0:
        return torch.zeros((rows, num_segments), dtype=torch.float32,
                           device=dev)
    out = torch.empty((rows, num_segments), dtype=torch.float32, device=dev)
    ntiles = c // RATING_TILE + 1
    piece = torch.empty((rows, 2 * ntiles), dtype=torch.float32, device=dev)
    tail_id = torch.empty(ntiles, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.rating_segsum_launch(
        segs.data_ptr(), vals.data_ptr(), rows, c, out.data_ptr(),
        num_segments, piece.data_ptr(), tail_id.data_ptr(), RATING_TILE,
        RATING_ROWS, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "rating_segsum_launch", lib)
    wrapper.launches += 1
    return out


def rating_segment_sum(vals: torch.Tensor, segs: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """vals [C] f32, segs [C] int32 with equal ids contiguous (ascending)
    -> [num_segments] f32."""
    if not vals.is_cuda:
        return ref.rating_segment_sum_ref(vals, segs, num_segments)
    if vals.dim() != 1:
        raise ValueError("expected vals [C] and segs [C]")
    return _launch(rating_segment_sum, vals[None], segs, num_segments)[0]


def rating_segment_sum_batch(vals: torch.Tensor, segs: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """vals [alpha, C] f32, one shared segs [C] int32 (ascending) ->
    [alpha, num_segments] f32; row a equals
    ``rating_segment_sum(vals[a], segs, num_segments)`` bit for bit."""
    if not vals.is_cuda:
        return ref.rating_segment_sum_batch_ref(vals, segs, num_segments)
    if vals.dim() != 2:
        raise ValueError("expected vals [alpha, C] and segs [C]")
    return _launch(rating_segment_sum_batch, vals, segs, num_segments)


rating_segment_sum.launches = 0
rating_segment_sum_batch.launches = 0
