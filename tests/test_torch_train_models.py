"""Port parity of the models' gradients: the flash attention backward,
the LM, GNN and DLRM losses and every gradient of each, and the MoE's
routing under autograd (``repro_torch.models`` against
``repro.models`` through ``jax.value_and_grad``), on the CPU.

Both packages get the same parameters (the reference's draws, through
``from_reference_params``) and the same numpy inputs.  Tolerances:

- flash backward: rtol 1e-5, atol 1e-6 against ``jax.vjp`` through the
  reference's ``flash_attention`` (f32 sums over head widths and KV
  blocks in another order; values of order 1), and against torch
  autograd of the plain softmax attention in f64 (rounded to f32);
- LM: loss rtol 1e-5, gradients rtol 1e-4 and atol 1e-6 (each leaf's
  gradient sums over the batch, sequence and width in another order;
  the largest are of order 0.1);
- GNN: loss rtol 1e-5, gradients rtol 1e-4 and atol 1e-6 (the segment
  sums add in another order through up to three residual layers);
- DLRM: rtol 1e-5, atol 1e-7;
- the MoE's dispatch and combine masks bit for bit (from the
  reference's own router probabilities).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal
from train_parity import np_tree

from repro.configs import registry as jregistry
from repro.data import graphs as jgraphs
from repro.data import recsys as jrecsys
from repro.data import sampler as jsampler
from repro.models import attention as jattention
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import registry
from repro_torch.models import attention, dlrm, gnn, moe, transformer
from repro_torch.models.layers import batch_to
from repro_torch.optim import adamw

LM_ARCHS = ("codeqwen1.5-7b", "stablelm-12b", "mistral-large-123b",
            "phi3.5-moe-42b-a6.6b", "grok-1-314b")
GNN_ARCHS = ("gatedgcn", "gin-tu", "meshgraphnet", "graphsage-reddit")
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _grads_close(got_tree, want_tree, **tol):
    got = adamw.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a is not None
        a = a.detach().float().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def _grads_of(tree):
    """Each leaf's gradient; zeros for a leaf the loss does not reach (as
    ``jax.grad`` gives)."""
    return adamw.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        tree)


def _with_grad(tree):
    for p in adamw.tree_leaves(tree):
        p.requires_grad_(True)
    return tree


# ---------------------------------------------------------------- flash
# (B, S, H, KV, dh, block_kv, causal): several KV blocks, GQA n_rep 2
# and 4, a single block, causal and not
FLASH = [(2, 32, 4, 2, 16, 8, True), (2, 32, 4, 2, 16, 8, False),
         (1, 24, 4, 1, 8, 8, True), (2, 16, 2, 2, 16, 64, True)]


@pytest.mark.parametrize("b,s,h,kv,dh,blk,causal", FLASH)
def test_flash_backward_matches_reference(b, s, h, kv, dh, blk, causal):
    rng = np.random.default_rng(s + h + kv)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    dout = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    out, vjp = jax.vjp(lambda q_, k_, v_: jattention.flash_attention(
        q_, k_, v_, causal=causal, block_kv=blk), *map(jnp.asarray,
                                                        (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got_out = attention.flash_attention(tq, tk, tv, causal=causal,
                                        block_kv=blk)
    got_out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)

    # the plain attention's gradient in f64
    q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_(True)
                     for a in (q, k, v))
    kr = k64.repeat_interleave(h // kv, dim=2)
    vr = v64.repeat_interleave(h // kv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q64, kr) / np.sqrt(dh)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
    plain = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vr)
    plain.backward(torch.from_numpy(dout).double())
    for t, w in zip((tq, tk, tv), (q64, k64, v64)):
        np.testing.assert_allclose(t.grad.numpy(), w.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_flash_backward_keeps_input_dtypes():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 8)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
        for _ in range(3))
    attention.flash_attention(q, k, v, block_kv=8).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


# ------------------------------------------------------------------ LM
# the MoE archs also over 2 token groups
@pytest.mark.parametrize("aid,groups", [(a, 1) for a in LM_ARCHS] + [
    ("phi3.5-moe-42b-a6.6b", 2), ("grok-1-314b", 2)])
def test_lm_loss_and_gradients_match_reference(aid, groups):
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jtransformer.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(len(aid))
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32),
             "mask": (rng.random((2, 12)) < 0.8).astype(np.float32)}
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b_: jtransformer.loss_fn(p, b_, jcfg, moe_groups=groups))
    )(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tree = _with_grad(transformer.param_tree(
        transformer.from_reference_params(cfg, params, device=CPU)))
    loss = transformer.loss_fn(tree, batch_to(batch, CPU), groups, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    _grads_close(_grads_of(tree), want_g, **GRAD_TOL)


def test_lm_remat_gives_the_same_gradients():
    """``cfg.remat`` (each layer under ``torch.utils.checkpoint``) changes
    no bit of the loss or a gradient."""
    aid = "phi3.5-moe-42b-a6.6b"
    params = np_tree(jtransformer.init_params(jregistry.SMOKES[aid],
                                              jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    batch = batch_to({"tokens": rng.integers(0, 256, (2, 8)),
                      "labels": rng.integers(0, 256, (2, 8))}, CPU)
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(registry.SMOKES[aid], remat=remat)
        tree = _with_grad(transformer.param_tree(
            transformer.from_reference_params(cfg, params, device=CPU)))
        loss = transformer.loss_fn(tree, batch, 1, cfg)
        loss.backward()
        out.append([loss.detach()] + [g.clone() for g in
                                      adamw.tree_leaves(_grads_of(tree))])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ MoE
def test_moe_masks_bit_equal_under_autograd(monkeypatch):
    """The masks from the reference's router probabilities, taken by the
    port with those probabilities requiring grad: bit for bit; dispatch
    carries no gradient, combine carries the gate values'."""
    seen = {}
    real_top_k = jax.lax.top_k

    def top_k(probs, k):
        seen["probs"] = probs
        return real_top_k(probs, k)

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    rw = (rng.normal(size=(32, 4)) / 6).astype(np.float32)
    w1, w3 = ((rng.normal(size=(4, 32, 48)) / 6).astype(np.float32)
              for _ in range(2))
    w2 = (rng.normal(size=(4, 48, 32)) / 7).astype(np.float32)
    cf = 0.75                                  # full experts drop tokens
    args = [jnp.asarray(a) for a in (x, rw, w1, w3, w2)]

    def ref_loss(*a):
        out, aux = jmoe.moe_ffn_grouped(*a, 2, cf)
        return (out * jnp.asarray(x)).sum() + aux

    jmoe.moe_ffn_grouped(*args, 2, cf)          # eager: concrete probs
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    want_l, want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *args)
    probs = torch.from_numpy(np.array(seen["probs"])).requires_grad_(True)
    cap = moe.capacity(2, 16, cf, 4)
    onehot, dispatch, combine = moe.route_masks(probs, 2, cap,
                                                torch.float32)
    assert not dispatch.requires_grad and combine.requires_grad
    _, jdispatch, jcombine = _ref_masks(np.array(seen["probs"]), 2, cap)
    assert_bit_equal(dispatch.detach(), jdispatch, "dispatch")
    assert_bit_equal(combine.detach(), jcombine, "combine")
    assert float(dispatch.sum()) < 2 * 16 * 2            # some dropped
    # the gradient through the gates and the aux loss, from x
    tx, trw, tw1, tw3, tw2 = (torch.from_numpy(a).requires_grad_(True)
                              for a in (x, rw, w1, w3, w2))
    out, aux = moe.moe_ffn_grouped(tx, trw, tw1, tw3, tw2, 2, cf)
    loss = (out * torch.from_numpy(x)).sum() + aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    for t, w in zip((tx, trw, tw1, tw3, tw2), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)


def _ref_masks(probs, top_k, cap):
    """The reference's mask lines (``moe_ffn_grouped``) on its own
    probabilities."""
    probs = jnp.asarray(probs)
    g, t, e = probs.shape
    gate_vals, expert_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32)
    flat = onehot.reshape(g, t * top_k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(g, t, top_k, e)
    keep = (pos < cap) & (onehot > 0)
    disp = (jax.nn.one_hot(jnp.where(keep, pos, 0), cap, dtype=jnp.float32)
            * keep[..., None].astype(jnp.float32))
    return (np.asarray(onehot), np.asarray(disp.sum(2)),
            np.asarray((disp * gate_vals[..., None, None]).sum(2)))


# ------------------------------------------------------------------ GNN
def _gnn_batch(regime, cfg, seed):
    fe = jgnn._edge_feat_dim(cfg)
    if regime == "full_graph":
        b = jgraphs.full_graph_batch(40, 100, cfg.d_feat, cfg.n_classes,
                                     seed=seed, need_edge_feat=fe)
        b["edge_mask"] = (np.random.default_rng(seed).random(100) < 0.9
                          ).astype(np.float32)
        return b
    if regime == "minibatch":
        ei = jgraphs.power_law_graph(200, 800, seed=seed)
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(200, cfg.d_feat)).astype(np.float32)
        labels = rng.integers(0, cfg.n_classes, 200).astype(np.int32)
        return jsampler.NeighborSampler(ei, 200, feats, labels, (4, 3),
                                        seed=seed).batch(12)
    b = jgraphs.molecule_batch(6, 8, 14, cfg.d_feat, cfg.n_classes,
                               seed=seed, need_edge_feat=fe)
    b["node_mask"][:, -1] = 0.0
    return b


LOSSES = {"full_graph": ("full_graph_loss",),
          "minibatch": ("minibatch_loss",),
          "molecule": ("molecule_loss",)}


@pytest.mark.parametrize("regime", ["full_graph", "minibatch", "molecule"])
@pytest.mark.parametrize("aid", GNN_ARCHS)
def test_gnn_loss_and_gradients_match_reference(aid, regime):
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jgnn.init_params(jcfg, jax.random.PRNGKey(5),
                                      d_feat=cfg.d_feat,
                                      n_classes=cfg.n_classes))
    # the reference draws zero biases and eps: give them values
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(scale=0.1, size=a.shape).astype(
            np.float32) if str(path[-1]).startswith("['b")
            or "eps" in str(path[-1]) else a), params)
    batch = _gnn_batch(regime, cfg, seed=2)
    name = LOSSES[regime][0]
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b_: getattr(jgnn, name)(p, b_, jcfg)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tree = _with_grad(gnn.param_tree(gnn.from_reference_params(
        cfg, params, cfg.d_feat, cfg.n_classes, device=CPU)))
    loss = getattr(gnn, name)(tree, batch_to(batch, CPU), cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    _grads_close(_grads_of(tree), want_g, **GRAD_TOL)


# ----------------------------------------------------------------- DLRM
def test_dlrm_losses_and_gradients_match_reference():
    aid = "dlrm-mlperf"
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jdlrm.init_params(jcfg, jax.random.PRNGKey(6)))
    batch = jrecsys.click_batch(jcfg, 48, seed=3)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    want_l, want_g = jax.value_and_grad(jdlrm.loss_fn)(jp, jb, jcfg)
    tree = _with_grad(dlrm.param_tree(dlrm.from_reference_params(
        cfg, params, device=CPU)))
    tb = batch_to(batch, CPU)
    loss = dlrm.loss_fn(tree, tb, cfg)
    loss.backward()
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    _grads_close(_grads_of(tree), want_g, **tol)

    # the rows as an explicit argument: a [B, S, D] row gradient
    other = {"bot": jp["bot"], "top": jp["top"]}
    rows = jnp.take(jp["tables"], jb["sparse_idx"], axis=0)
    (want_l2, (want_go, want_gr)) = jax.value_and_grad(
        jdlrm.loss_from_rows, argnums=(0, 1))(other, rows, jb, jcfg)
    tother = _with_grad({"bot": {k: v.detach().clone()
                                 for k, v in tree["bot"].items()},
                         "top": {k: v.detach().clone()
                                 for k, v in tree["top"].items()}})
    trows = tree["tables"].detach()[tb["sparse_idx"].long()].requires_grad_(
        True)
    loss2 = dlrm.loss_from_rows(tother, trows, tb, cfg)
    loss2.backward()
    np.testing.assert_allclose(float(loss2.detach()), float(want_l2), rtol=1e-5)
    assert float(loss2.detach()) == float(loss.detach())
    _grads_close(_grads_of(tother), want_go, **tol)
    np.testing.assert_allclose(trows.grad.numpy(), np.asarray(want_gr),
                               **tol)
