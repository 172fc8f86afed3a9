"""EmbeddingBag kernel (port of
``repro.kernels.embedding_bag.embedding_bag_pallas``).

``embedding_bag(table, idx, combiner)`` gathers ``table[idx[b, l]]`` for
every id >= 0 of bag b and sums the rows in f32 (``mean`` divides the
sum by L, pads counted), storing [B, D] in the table's dtype (f32 or
bf16).  On the card a group of lanes owns a bag, one 16-byte piece of
the row a lane (a warp at f32 D 128, half a warp at bf16 D 128), and
adds its rows in bag order (``csrc/embedding_bag.cu``).  On CPU tensors
the wrapper runs the plain version from ``ref``; on CUDA tensors it
launches or raises.  The wrapper counts its kernel launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = {"sum": 0, "mean": 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("embedding_bag")
    if not getattr(lib, "_typed", False):
        lib.embedding_bag_launch.argtypes = [_P, _I, _I, _P, _I, _I, _I, _I,
                                             _P, _P]
        lib.embedding_bag_launch.restype = _I
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table [R, D] f32 or bf16, indices [B, L] int32 (pad -1) ->
    [B, D] in the table's dtype."""
    if combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; expected one of "
                         f"{tuple(_COMBINERS)}")
    if not table.is_cuda:
        return ref.embedding_bag_ref(table, indices, combiner)
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("expected table [R, D] and indices [B, L]")
    if table.dtype not in _DTYPES or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous f32 or bf16 tensor "
                         f"(got {table.dtype})")
    if (indices.device != table.device or indices.dtype != torch.int32
            or not indices.is_contiguous()):
        raise ValueError(f"indices must be a contiguous int32 tensor on "
                         f"{table.device}")
    r, d = table.shape
    b, l = indices.shape
    if max(r, d, b, l, b * l, b * d) >= 2 ** 31:
        raise ValueError("embedding bag operands exceed int32 extents")
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0 or r == 0 or l == 0:
        return out.zero_()
    lib = _lib()
    err = lib.embedding_bag_launch(
        table.data_ptr(), r, d, indices.data_ptr(), b, l, _DTYPES[table.dtype],
        _COMBINERS[combiner], out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "embedding_bag_launch", lib)
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
