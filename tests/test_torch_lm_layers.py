"""Port parity of the LM's building blocks: ``rms_norm``, the rotary
embeddings, ``cross_entropy``, flash and decode attention, and the MoE
FFN.

Both packages see the same numpy inputs (seeded) on the CPU, in f32.
Tolerances:

- rtol 1e-5, atol 1e-5 for every float result: f32 sums (norms,
  softmax denominators, dot products over the head or model width)
  add in another order in XLA and in torch, and ``exp``/``sin``/``cos``
  may round their last bit differently; 1e-5 is about a hundred f32
  ulps at the values these tests see (|x| up to about 4).
- Bit for bit: the GQA head mapping, and the MoE's dispatch and combine
  masks built from the reference's own router probabilities.  From the
  same ``x`` the dispatch mask is bit-equal too; the combine weights
  come through each package's softmax and differ in their last bits
  (up to about 3e-7 here), so they are held at the float tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.models import attention, layers, moe

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), **(tol or TOL))


# --------------------------------------------------------------------------
# rms_norm, RoPE, cross_entropy
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(scale), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))


@pytest.mark.parametrize("d_head,theta", [(16, 10_000.0), (128, 1e6)])
def test_rope_frequencies_match_reference(d_head, theta):
    _close(layers.rope_frequencies(d_head, theta),
           jlayers.rope_frequencies(d_head, theta), rtol=1e-6, atol=0)


@pytest.mark.parametrize("b,s,h,dh,start", [(2, 8, 4, 16, 0),
                                             (1, 16, 2, 128, 497)])
def test_apply_rope_matches_reference(b, s, h, dh, start):
    """Positions from 0, and up to 512 (the angles' f32 rounding)."""
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s), (b, s)).astype(np.int32)
    got = layers.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   10_000.0))
    # the two halves rotate together: position 0 is the identity, and the
    # rotation keeps each (x[i], x[i + dh/2]) pair's length
    half = dh // 2
    norm = lambda a: np.hypot(a[..., :half], a[..., half:])  # noqa: E731
    np.testing.assert_allclose(norm(got.numpy()), norm(x), rtol=1e-5)
    if start == 0:
        np.testing.assert_array_equal(got[:, 0].numpy(), x[:, 0])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    valid = (rng.random((3, 9)) < 0.6).astype(np.float32) if masked else None
    got = layers.cross_entropy(_t(logits), _t(labels),
                               None if valid is None else _t(valid))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if valid is None else jnp.asarray(valid))
    _close(got, want)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def test_repeat_kv_maps_query_head_to_kv_head_exactly():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    got = attention._repeat_kv(_t(k), 4)
    assert_bit_equal(got, jattn._repeat_kv(jnp.asarray(k), 4))
    for h in range(12):
        assert torch.equal(got[:, :, h], _t(k)[:, :, h // 4])


def _qkv(b, sq, skv, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, dh)).astype(np.float32)
    return q, k, v


# (S, block_kv, H, KV, causal): S a multiple of the block (4 and 2
# blocks), S below the block (one block of S), and n_rep 1, 2 and 4
@pytest.mark.parametrize("s,block,h,kv,causal", [
    (64, 16, 4, 4, True), (64, 32, 4, 2, True), (40, 1024, 8, 2, True),
    (48, 16, 8, 2, False), (24, 1024, 4, 1, False)])
def test_flash_attention_matches_reference(s, block, h, kv, causal):
    q, k, v = _qkv(2, s, s, h, kv, 16, seed=s + h)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    block_kv=block)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 block_kv=block)
    assert got.shape == (2, s, h, 16)
    _close(got, want)
    # the log-sum-exp rows the backward will need
    n_rep = h // kv
    kr, vr = (jattn._repeat_kv(jnp.asarray(a), n_rep) for a in (k, v))
    _, lse = attention.flash_forward(_t(q), _t(np.asarray(kr)),
                                     _t(np.asarray(vr)), causal,
                                     min(block, s))
    _close(lse, jattn._fwd(jnp.asarray(q), kr, vr, causal, min(block, s))[1])


@pytest.mark.parametrize("kv", [4, 2, 1])
@pytest.mark.parametrize("cache_len", [1, 9, 32])
def test_decode_attention_matches_reference(kv, cache_len):
    q, k, v = _qkv(3, 1, 32, 4, kv, 16, seed=cache_len + kv)
    got = attention.decode_attention(_t(q), _t(k), _t(v), cache_len)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(cache_len))
    _close(got, want)
    # rows at and past cache_len take no part
    k2, v2 = k.copy(), v.copy()
    k2[:, cache_len:], v2[:, cache_len:] = 7.0, -7.0
    assert torch.equal(attention.decode_attention(_t(q), _t(k2), _t(v2),
                                                  cache_len), got)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
class _Over:
    """A module stand-in: ``name`` from ``over`` where given, else from
    ``base``."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._base, name)


@pytest.fixture
def moe_spy(monkeypatch):
    """Record the reference ``moe_ffn_grouped``'s router probabilities
    (the input of ``lax.top_k``) and its dispatch and combine masks (the
    mask operands of its first and last einsums), without changing what
    it computes."""
    seen = {}

    def einsum(sub, *ops, **kw):
        seen[sub] = ops
        return jnp.einsum(sub, *ops, **kw)

    def top_k(probs, k):
        seen["probs"] = probs
        return jax.lax.top_k(probs, k)

    monkeypatch.setattr(jmoe, "jnp", _Over(jnp, einsum=einsum))
    monkeypatch.setattr(jmoe, "jax", _Over(jax, lax=_Over(jax.lax,
                                                          top_k=top_k)))
    return seen


def _moe_inputs(g, t, d, e, f, seed, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, t, d)).astype(np.float32)
    rw = (rng.normal(size=(d, e)) / 8).astype(np.float32)
    if tie:          # experts 0 and 1 tie on every token
        rw[:, 1] = rw[:, 0]
    w1, w3 = ((rng.normal(size=(e, d, f)) / 8).astype(np.float32)
              for _ in range(2))
    w2 = (rng.normal(size=(e, f, d)) / 10).astype(np.float32)
    return x, rw, w1, w3, w2


# (G, T, E, top_k, capacity factor, tie): capacity 4 of 32 choices over 4
# experts (drops), ties between two experts, grok's 2 experts top-2
# (capacity 8 of 16: no drops), and phi's 16 experts top-2 at decode's
# one group of 16 tokens (capacity 2)
@pytest.mark.parametrize("g,t,e,k,cf,tie", [
    (3, 16, 4, 2, 0.5, False), (2, 16, 4, 2, 1.0, True),
    (2, 8, 2, 2, 1.25, False), (1, 16, 16, 2, 1.25, False)])
def test_moe_ffn_grouped_matches_reference(moe_spy, g, t, e, k, cf, tie):
    x, rw, w1, w3, w2 = _moe_inputs(g, t, 64, e, 96, seed=t + e, tie=tie)
    want, want_aux = jmoe.moe_ffn_grouped(
        *(jnp.asarray(a) for a in (x, rw, w1, w3, w2)), k, cf)
    ref_dispatch = np.asarray(moe_spy["gtd,gtec->gecd"][1])
    ref_combine = np.asarray(moe_spy["gecd,gtec->gtd"][1])
    ref_probs = _t(np.array(moe_spy["probs"]))
    cap = moe.capacity(k, t, cf, e)
    assert ref_dispatch.shape == (g, t, e, cap)
    # the masks from the reference's own probabilities: bit for bit
    onehot, dispatch, combine = moe.route_masks(ref_probs, k, cap,
                                                torch.float32)
    assert_bit_equal(dispatch, ref_dispatch, "dispatch")
    assert_bit_equal(combine, ref_combine, "combine")
    if cf < 1.0:
        assert ref_dispatch.sum() < g * t * k      # some choices dropped
    if tie:
        # a tie goes to the lower index: expert 1 is never chosen before 0
        first = onehot[:, :, 0].argmax(dim=-1)
        assert not bool((first == 1).any())
    # from x, through the port's own router
    route = moe.moe_route(_t(x), _t(rw), k, cf)
    assert_bit_equal(route.dispatch, ref_dispatch, "dispatch from x")
    _close(route.combine, ref_combine)
    out, aux = moe.moe_ffn_grouped(*(_t(a) for a in (x, rw, w1, w3, w2)),
                                   k, cf)
    _close(out, want)
    _close(aux, want_aux)


def test_moe_ffn_ungrouped_matches_reference():
    x, rw, w1, w3, w2 = _moe_inputs(1, 6, 64, 4, 96, seed=11)
    out, aux = moe.moe_ffn(*(_t(a) for a in (x[0], rw, w1, w3, w2)), 2, 1.25)
    want, want_aux = jmoe.moe_ffn(
        *(jnp.asarray(a) for a in (x[0], rw, w1, w3, w2)), 2, 1.25)
    assert out.shape == (6, 64)
    _close(out, want)
    _close(aux, want_aux)
