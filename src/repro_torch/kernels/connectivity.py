"""Connectivity and cut-size kernels (ports of
``repro.kernels.connectivity.connectivity_pallas`` and
``cutsize_pallas``).

``connectivity(pins, part, k)`` computes lambda(e), the number of
distinct blocks among the valid pins of every row of the padded pin
matrix ``pins[M, S]`` (pad = -1); ``cutsize(pins, part, w, k)`` the
weight of the edges with lambda(e) > 1.  Both take k <= ``KERNEL_MAX_K``
(a uint32 block mask per edge, ``csrc/connectivity.cu``).  The grid
is ``common.conn_grid(M, S)``, at most one resident wave.  The cut is
summed without float atomics, in an order fixed by the operands: reruns
are bit-identical, and integer weights give the plain version's value
exactly.  On CPU tensors the wrappers run the plain versions from
``ref``; on CUDA tensors they launch or raise.  Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .common import CONN_WAVE_BLOCKS, KERNEL_MAX_K, conn_grid

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("connectivity")
    if not getattr(lib, "_typed", False):
        lib.connectivity_launch.argtypes = [_P, _I, _I, _P, _I, _I, _P, _I,
                                            _P]
        lib.connectivity_launch.restype = _I
        lib.cutsize_partials.argtypes = [_I]
        lib.cutsize_partials.restype = _I
        lib.cutsize_launch.argtypes = ([_P, _I, _I, _P, _I, _I]
                                       + [_P] * 4 + [_I, _P])
        lib.cutsize_launch.restype = _I
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _checked(pins: torch.Tensor, part: torch.Tensor, k: int):
    """Validate the operands; returns (M, S, N)."""
    if pins.dim() != 2 or part.dim() != 1:
        raise ValueError("expected pins [M, S] and part [N]")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the connectivity kernels take 1 <= k <= "
                         f"{KERNEL_MAX_K} (got k={k})")
    dev = pins.device
    for name, t in (("pins", pins), ("part", part)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev} (got {t.dtype} on {t.device})")
    m, s = pins.shape
    if m * s >= 2 ** 31 or part.shape[0] == 0:
        raise ValueError("pins exceed int32 extents, or part is empty")
    return m, s, part.shape[0]


def connectivity(pins: torch.Tensor, part: torch.Tensor,
                 k: int) -> torch.Tensor:
    """pins [M, S] int32 (pad -1), part [N] int32 -> lambda [M] int32."""
    if not pins.is_cuda:
        return ref.connectivity_ref(pins, part, k)
    m, s, n = _checked(pins, part, k)
    lam = torch.empty(m, dtype=torch.int32, device=pins.device)
    if m == 0:
        return lam
    lib = _lib()
    err = lib.connectivity_launch(
        pins.data_ptr(), m, s, part.data_ptr(), n, k, lam.data_ptr(),
        conn_grid(m, s), torch.cuda.current_stream(pins.device).cuda_stream)
    build.check(err, "connectivity_launch", lib)
    connectivity.launches += 1
    return lam


_SCRATCH: dict = {}


def _cut_scratch(lib: ctypes.CDLL, dev: torch.device):
    """The cut kernel's per-block partials (for its largest grid, one
    resident wave) and its ticket, one pair per device.  The ticket
    starts at zero and every launch leaves it at zero; calls on one
    device share the pair, so they must be ordered on one stream, as the
    port's calls are."""
    if dev not in _SCRATCH:
        _SCRATCH[dev] = (
            torch.empty(lib.cutsize_partials(CONN_WAVE_BLOCKS),
                        dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return _SCRATCH[dev]


def cutsize(pins: torch.Tensor, part: torch.Tensor,
            edge_weights: torch.Tensor, k: int) -> torch.Tensor:
    """pins [M, S] int32 (pad -1), part [N] int32, edge_weights [M] f32
    -> f32 scalar cut."""
    if not pins.is_cuda:
        return ref.cutsize_ref(pins, part, edge_weights, k)
    m, s, n = _checked(pins, part, k)
    dev = pins.device
    if (tuple(edge_weights.shape) != (m,) or edge_weights.device != dev
            or edge_weights.dtype != torch.float32
            or not edge_weights.is_contiguous()):
        raise ValueError(f"edge_weights must be a contiguous f32 [{m}] tensor "
                         f"on {dev}")
    if m == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    lib = _lib()
    partials, ticket = _cut_scratch(lib, dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.cutsize_launch(
        pins.data_ptr(), m, s, part.data_ptr(), n, k,
        edge_weights.data_ptr(), partials.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), conn_grid(m, s),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cutsize_launch", lib)
    cutsize.launches += 1
    return out


connectivity.launches = 0
cutsize.launches = 0
