"""Shared neural building blocks of the substrate's models (port of
``repro.models.layers``): the dense layers of DLRM and the GNN zoo, and
the LM half (``rms_norm``, the rotary embeddings, ``cross_entropy``).

The reference keeps parameters in dicts of arrays; here they live in
``nn.Module``s with the reference's layouts (a dense weight is
``[fan_in, fan_out]`` and applied as ``x @ w + b``), so a reference
parameter dict copies over leaf by leaf (``MLP.load_reference``) and
``MLP.tree`` lists the module's parameters in that dict's layout.
``constrain`` and ``with_grad_sharding`` are sharding hints with no
single-device meaning and are left out (the latter's cast of a layer's
weight gradient to the accumulation dtype is the train step's).  The LM functions compute in
f32 and cast back to their input's dtype, as the reference's do.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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


def tensor_from_reference(a) -> torch.Tensor:
    """A reference leaf (numpy or a scalar, bf16 included) as a CPU
    tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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
        return mlp_apply(self.tree(), x, len(self.weights), self.prefix,
                         self.final_act)

    def tree(self) -> Dict[str, torch.Tensor]:
        """The parameters as the reference's dict: ``{prefix}{i}`` and
        ``b{prefix}{i}``."""
        out = {}
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            out[f"{self.prefix}{i}"] = w
            out[f"b{self.prefix}{i}"] = b
        return out

    @torch.no_grad()
    def load_reference(self, params: Dict) -> None:
        """Copy the reference's ``{prefix}{i}``/``b{prefix}{i}`` leaves."""
        for i in range(len(self.weights)):
            self.weights[i].copy_(torch.from_numpy(
                np.array(params[f"{self.prefix}{i}"])))
            self.biases[i].copy_(torch.from_numpy(
                np.array(params[f"b{self.prefix}{i}"])))


def unstack(tree, n: int) -> list:
    """A tree of stacked ``[L, ...]`` leaves (nested dicts) -> the ``n``
    trees of its layer slices.  Each leaf is ``unbind``-ed once, so
    autograd stacks its gradient once, not once a layer."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, n: int,
              prefix: str = "w", final_act: bool = False) -> torch.Tensor:
    """The reference's ``mlp_apply`` on a ``{prefix}{i}``/``b{prefix}{i}``
    dict: ``x @ w_i + b_i`` with ReLU between layers and, with
    ``final_act``, after the last one."""
    for i in range(n):
        x = x @ params[f"{prefix}{i}"] + params[f"b{prefix}{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


# ---- rotary position embeddings ------------------------------------------
def rope_frequencies(d_head: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotation of ``positions`` [..., S]: (cos, sin) [..., S, 1,
    dh/2] in f32, shared by every head and layer of one forward."""
    freqs = rope_frequencies(d_head, theta, positions.device)  # [dh/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, dh/2]
    angles = angles[..., None, :]                         # [..., S, 1, dh/2]
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate the two halves of each head of x [..., S, H, dh]
    (``x[..., :dh/2]`` with ``x[..., dh/2:]``, not interleaved pairs) by
    ``rope_cos_sin``'s angles, in f32; cast back to x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, dh]; positions broadcastable to [..., S]."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if valid is not None:
        valid = valid.to(torch.float32)
        return (nll * valid).sum() / valid.sum().clamp(min=1)
    return nll.mean()
