"""Shared neural building blocks of DLRM and the GNN zoo (port of the
parts of ``repro.models.layers`` those models use).

The reference keeps parameters in dicts of arrays; here they live in
``nn.Module``s with the reference's layouts (a dense weight is
``[fan_in, fan_out]`` and applied as ``x @ w + b``), so a reference
parameter dict copies over leaf by leaf (``MLP.load_reference``).
``constrain`` and ``with_grad_sharding`` are sharding hints with no
single-device meaning and are left out; ``rms_norm`` and the rotary
embeddings come with the LM models.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def init_dense(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws times ``scale`` (default ``1/sqrt(fan_in)``, the
    reference's rule), drawn in f32 on ``device`` from ``generator``
    (which must live on ``device``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(generator=generator).mul_(s)
    return w.to(dtype)


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (a dict of numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


class MLP(nn.Module):
    """Plain MLP stack, the counterpart of ``mlp_params``/``mlp_apply``:
    ``x @ w_i + b_i`` with ReLU between layers and, with ``final_act``,
    after the last one.  ``prefix`` names the leaves as the reference's
    dict does (``{prefix}{i}``, ``b{prefix}{i}``)."""

    def __init__(self, dims: Sequence[int], dtype: torch.dtype,
                 device: torch.device, prefix: str = "w",
                 final_act: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.prefix = prefix
        self.final_act = final_act
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i in range(len(self.dims) - 1):
            shape = (self.dims[i], self.dims[i + 1])
            w = (init_dense(shape, dtype, generator, device)
                 if generator is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(
                torch.zeros(self.dims[i + 1], dtype=dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.weights)
        for i in range(n):
            x = x @ self.weights[i] + self.biases[i]
            if i < n - 1 or self.final_act:
                x = torch.relu(x)
        return x

    @torch.no_grad()
    def load_reference(self, params: Dict) -> None:
        """Copy the reference's ``{prefix}{i}``/``b{prefix}{i}`` leaves."""
        for i in range(len(self.weights)):
            self.weights[i].copy_(torch.from_numpy(
                np.array(params[f"{self.prefix}{i}"])))
            self.biases[i].copy_(torch.from_numpy(
                np.array(params[f"b{self.prefix}{i}"])))
