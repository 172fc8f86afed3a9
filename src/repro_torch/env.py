"""Environment parsing and device selection shared by the whole port.

``warn_env_once`` is the counterpart of ``repro.env.warn_env_once``: an
unparsable ``REPRO_*`` value warns once per (variable, value) and names
the fallback it resolved to.  ``resolve_device`` is the single place
that turns an entry point's ``device`` argument into a
``torch.device``: CUDA is the default, and asking for CUDA where none
is present raises instead of silently running on the CPU.
"""
from __future__ import annotations

import warnings

import torch

_WARNED: set = set()


def warn_env_once(var: str, raw: str, fallback: str) -> None:
    """``warnings.warn`` exactly once per (variable, value) that a
    ``REPRO_*`` value could not be parsed and what it fell back to."""
    key = (var, raw)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(f"{var}={raw!r} is not a valid value; "
                  f"falling back to {fallback}", stacklevel=3)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for an entry point's ``device`` argument.

    Raises ``RuntimeError`` when a CUDA device is requested and none is
    available: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
