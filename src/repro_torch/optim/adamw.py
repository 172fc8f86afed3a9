"""AdamW with optional 8-bit quantised moments (port of
``repro.optim.adamw``): f32 ``m`` and ``v`` cost 8 bytes a parameter,
int8 block-quantised ones about 2.06.

The reference's functional API on trees of tensors (nested dicts, the
reference's parameter layout; ``models.*.param_tree`` gives a model's):

    init(params, cfg)                              -> {"m", "v", "step"}
    update(grads, state, params, cfg, lr_scale)    -> (params, state, metrics)
    sparse_row_update(p, m, v, idx, g_rows, cfg, lr_scale, step)

Unlike the reference, ``update`` and ``sparse_row_update`` write the new
parameters and moments into the given tensors and return them: a
stacked ``[L, ...]`` leaf of a large model holds gigabytes, and a
functional update would need a second copy of every leaf.  The
arithmetic is the reference's, in its order: the gradient upcast to f32
and clipped, ``m``/``v`` decayed, ``delta = mh/(sqrt(vh)+eps) + wd*p``
on ``p`` upcast to f32, the result cast back to ``p``'s dtype.  It runs
on flat pieces of at most ``CHUNK`` elements, so its temporaries stay
bounded whatever the leaf's size.  Leaves are taken in the reference's
flatten order (dict keys sorted), which is the order ``grad_norm`` sums
them in.

``sparse_row_update`` combines duplicate row ids over sorted runs; on
the card that sum goes through the batched rating kernel (#4,
``kernels.ops.rating_segment_sum_batch``), a fixed order with no float
atomics, so two runs give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    q_block: int = 256
    # block-row count padded to this multiple so QTensors shard evenly
    # over any production mesh (512 covers 2x16x16 and 16x16)
    q_row_mult: int = 512


# elements of one flat piece of a leaf in ``update`` and ``_global_norm``
# (a multiple of every ``q_block``): 256 MB of f32 per temporary
CHUNK = 1 << 26


@dataclasses.dataclass
class QTensor:
    """int8 block-quantised tensor: ``q`` [Nb, B] int8, ``scale`` [Nb]
    f32, ``shape`` the original shape.  The first ``ceil(numel / B)``
    rows hold the tensor (the last of them zero-padded); the rows past
    them, up to a multiple of ``q_row_mult``, hold zeros."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def _true_div(x, y: float, like: torch.Tensor) -> torch.Tensor:
    """``x / y`` correctly rounded on every device: the divisor is a
    tensor, since CUDA divides by a Python scalar as a product with its
    reciprocal, which may differ by an ulp."""
    return x / torch.full((), y, dtype=torch.float32, device=like.device)


def _quantize_rows(blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows [R, B] f32 -> (q [R, B] int8, scale [R] f32); rounding half
    to even, as ``jnp.round``."""
    scale = _true_div(blk.abs().amax(dim=-1), 127.0, blk) + 1e-12
    q = torch.clamp(torch.round(blk / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale.to(torch.float32)


def _quantize(x: torch.Tensor, block: int, row_mult: int = 512) -> QTensor:
    flat = x.reshape(-1)
    n_rows = -(-flat.shape[0] // block)
    n_rows = -(-n_rows // row_mult) * row_mult   # mesh-divisible rows
    pad = n_rows * block - flat.shape[0]
    blk = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    q, scale = _quantize_rows(blk)
    return QTensor(q=q, scale=scale, shape=tuple(x.shape))


def _dequantize(t: QTensor) -> torch.Tensor:
    flat = (t.q.to(torch.float32) * t.scale[:, None]).reshape(-1)
    return flat[:t.numel].reshape(t.shape)


# --------------------------------------------------------------------------
# trees: nested dicts (keys sorted), lists and tuples; a tensor or a
# QTensor is a leaf
# --------------------------------------------------------------------------
def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    that share its structure; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return None if tree is None else fn(tree, *rest)


def init(params, cfg: AdamWConfig) -> Dict:
    """Zero moments (f32 tensors, or ``QTensor``s of zeros) beside every
    leaf of ``params``, on its device, and ``step`` 0 (int32)."""
    def zeros_like_state(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.quantize_moments:
            return _quantize(z, cfg.q_block, cfg.q_row_mult)
        return z
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros_like_state, params),
            "v": tree_map(zeros_like_state, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _pieces(n: int):
    for start in range(0, n, CHUNK):
        yield start, min(start + CHUNK, n)


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (flatten order) of each leaf's f32 sum
    of squares."""
    total = 0
    for g in tree_leaves(grads):
        flat = g.reshape(-1)
        sq = sum(flat[a:b].to(torch.float32).square().sum()
                 for a, b in _pieces(flat.shape[0]))
        total = total + sq
    return torch.sqrt(total)


@dataclasses.dataclass
class _Step:
    """The scalars of one update, f32 tensors on the parameters' device."""
    clip: torch.Tensor
    b1c: torch.Tensor
    b2c: torch.Tensor
    lr: torch.Tensor


def _moments(g32, m_f, v_f, cfg: AdamWConfig):
    m_new = cfg.b1 * m_f + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v_f + (1 - cfg.b2) * g32 * g32
    return m_new, v_new


def _delta(m_new, v_new, p32, b1c, b2c, cfg: AdamWConfig):
    mh = m_new / b1c
    vh = v_new / b2c
    return mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32


def _update_piece(p, g, m_f, v_f, s: _Step, cfg: AdamWConfig):
    """One flat piece: the new (p in its dtype, m f32, v f32)."""
    g32 = g.to(torch.float32) * s.clip
    m_new, v_new = _moments(g32, m_f, v_f, cfg)
    p32 = p.to(torch.float32)
    p_new = (p32 - s.lr * _delta(m_new, v_new, p32, s.b1c, s.b2c, cfg)
             ).to(p.dtype)
    return p_new, m_new, v_new


def _update_leaf(p, g, m, v, s: _Step, cfg: AdamWConfig) -> None:
    pf, gf = p.reshape(-1), g.reshape(-1)
    if not isinstance(m, QTensor):
        mf, vf = m.reshape(-1), v.reshape(-1)
        for a, b in _pieces(pf.shape[0]):
            p_new, m_new, v_new = _update_piece(pf[a:b], gf[a:b], mf[a:b],
                                                vf[a:b], s, cfg)
            pf[a:b].copy_(p_new)
            mf[a:b].copy_(m_new)
            vf[a:b].copy_(v_new)
        return
    # quantised moments: a piece is a run of whole block rows; the last
    # row of the tensor is zero-padded as ``_quantize`` pads it
    block = m.q.shape[1]
    n = pf.shape[0]
    rows = CHUNK // block
    for r0 in range(0, -(-n // block), rows):
        r1 = min(r0 + rows, -(-n // block))
        a, b = r0 * block, min(r1 * block, n)
        m_f = (m.q[r0:r1].to(torch.float32)
               * m.scale[r0:r1, None]).reshape(-1)[:b - a]
        v_f = (v.q[r0:r1].to(torch.float32)
               * v.scale[r0:r1, None]).reshape(-1)[:b - a]
        p_new, m_new, v_new = _update_piece(pf[a:b], gf[a:b], m_f, v_f, s,
                                            cfg)
        pf[a:b].copy_(p_new)
        pad = (r1 - r0) * block - (b - a)
        for t, new in ((m, m_new), (v, v_new)):
            q, scale = _quantize_rows(torch.nn.functional.pad(
                new, (0, pad)).reshape(-1, block))
            t.q[r0:r1].copy_(q)
            t.scale[r0:r1].copy_(scale)


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig, lr_scale=1.0
           ) -> Tuple[object, Dict, Dict]:
    """One AdamW step over ``params`` (written in place) with ``grads``
    (same tree).  ``state["m"]``/``["v"]`` are written in place too;
    returns ``(params, {"m", "v", "step": step + 1}, {"grad_norm",
    "lr"})``."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    stepf = step.to(torch.float32)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=step.device) * cfg.lr
    clip_num = torch.full((), cfg.grad_clip, dtype=torch.float32,
                          device=gnorm.device)    # tensor / tensor: exact
    s = _Step(clip=torch.clamp(clip_num / (gnorm + 1e-9), max=1.0),
              b1c=1.0 - torch.pow(cfg.b1, stepf),
              b2c=1.0 - torch.pow(cfg.b2, stepf), lr=lr)
    m_leaves = tree_leaves(state["m"])
    v_leaves = tree_leaves(state["v"])
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), m_leaves,
                          v_leaves):
        _update_leaf(p, g, m, v, s, cfg)
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})


def run_sums(g_sorted: torch.Tensor, run_id: torch.Tensor,
             n_runs: int) -> torch.Tensor:
    """Sum the rows g_sorted [T, D] f32 over ascending run ids [T] ->
    [n_runs, D]: the batched rating sum (#4 on the card: every column in
    a fixed order) over the transposed rows."""
    return ops.rating_segment_sum_batch(
        g_sorted.t().contiguous(), run_id.to(torch.int32).contiguous(),
        n_runs).t()


@torch.no_grad()
def sparse_row_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      flat_idx: torch.Tensor, g_rows: torch.Tensor,
                      cfg: AdamWConfig, lr_scale, step: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lazy (touched-rows-only) AdamW for embedding tables, in place.

    p/m/v: [R, D]; flat_idx: [T] row ids (duplicates allowed); g_rows:
    [T, D] per-occurrence gradients; ``step`` the step after the
    increment.  Duplicate occurrences are combined over sorted runs and
    every duplicate writes the identical updated row, so the scatter is
    deterministic.  Untouched rows skip the moment decay and the weight
    decay (lazy semantics); the gradient is not clipped, as in the
    reference.  Returns (p, m, v)."""
    t = flat_idx.shape[0]
    order = torch.argsort(flat_idx, stable=True)
    si = flat_idx[order].long()
    sg = g_rows[order].to(torch.float32)
    run_start = torch.ones(t, dtype=torch.int32, device=si.device)
    run_start[1:] = (si[1:] != si[:-1]).to(torch.int32)
    run_id = torch.cumsum(run_start, dim=0) - 1
    g_sum = run_sums(sg, run_id, t)[run_id]

    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=p.device) * cfg.lr
    m_i = m[si].to(torch.float32)
    v_i = v[si].to(torch.float32)
    p_i = p[si].to(torch.float32)
    m_new, v_new = _moments(g_sum, m_i, v_i, cfg)
    p_new = p_i - lr * _delta(m_new, v_new, p_i, b1c, b2c, cfg)
    p[si] = p_new.to(p.dtype)
    m[si] = m_new.to(m.dtype)
    v[si] = v_new.to(v.dtype)
    return p, m, v


# --------------------------------------------------------------------------
# the reference's optimizer state as the port's
# --------------------------------------------------------------------------
def from_reference_state(state: Dict, device: str | torch.device = "cuda"
                         ) -> Dict:
    """The port's optimizer state from the reference's (``{"m", "v",
    "step"}`` with numpy leaves, ``jax.tree.map(np.asarray, ...)``): its
    ``QTensor``s become the port's, bf16 leaves stay bf16."""
    from repro_torch.env import resolve_device
    from repro_torch.models.layers import tensor_from_reference
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QTensor(q=tensor_from_reference(node.q).to(dev),
                           scale=tensor_from_reference(node.scale).to(dev),
                           shape=tuple(int(s) for s in node.shape))
        return tensor_from_reference(node).to(dev)

    return {"m": conv(state["m"]), "v": conv(state["v"]),
            "step": tensor_from_reference(state["step"]).to(dev)}
