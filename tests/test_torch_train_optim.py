"""Port parity of the optimizers: the LR schedules, AdamW with f32 and
int8 moments, ``sparse_row_update`` and ``topk_compress``
(``repro_torch.optim`` against ``repro.optim``), on the CPU.

Both packages get the same numpy parameters, gradients and states.
Tolerances:

- the schedule: rtol 1e-6 (``cos`` in f32 may differ by an ulp);
- AdamW: ``m`` and ``v`` bit for bit when the gradient norm is below the
  clip (the clip is then exactly 1 and the moments are the same f32
  products and sums, in the reference's order); parameters, ``grad_norm``
  and the clipped case rtol 1e-6 (``b ** step`` and the norm's sum order
  may differ by an ulp); int8 ``q`` bit for bit and ``scale`` rtol 1e-6;
- ``sparse_row_update``: rtol 1e-6, atol 1e-9 (the duplicate rows'
  gradients add in another order), and equal to the dense update on the
  touched rows with the same tolerance;
- ``topk_compress``: bit for bit (an f32 add and a selection).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import CPU
from train_parity import np_tree

from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedule as jschedule
from repro_torch.optim import adamw, compression, schedule


@pytest.mark.parametrize("step", [0, 1, 200, 5000, 10_000])
def test_schedule_matches_reference(step):
    got = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32))
    want = jschedule.cosine_with_warmup(jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if step == 0:
        assert float(got) == 0.0
    got_c = schedule.constant(torch.tensor(step, dtype=torch.int32))
    assert float(got_c) == float(jschedule.constant(jnp.int32(step))) == 1.0


def _tree(rng, scale=1.0):
    """A parameter tree with the reference's kinds of leaf: a stacked
    matrix, a vector, a scalar, a bf16 leaf and one bigger than a
    quantiser block."""
    t = {"layers": {"w": rng.normal(size=(2, 8, 24)),
                    "ln": rng.normal(size=(2, 8))},
         "eps": rng.normal(size=()),
         "head": rng.normal(size=(300,)),
         "emb": rng.normal(size=(5, 7))}
    t = jax.tree.map(lambda a: (a * scale).astype(np.float32), t)
    return t


def _to_port(tree, bf16=("emb",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_port(v, bf16)
        else:
            x = torch.from_numpy(np.array(v))
            out[k] = x.to(torch.bfloat16) if k in bf16 else x
    return out


def _to_ref(tree, bf16=("emb",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_ref(v, bf16)
        else:
            out[k] = jnp.asarray(v, jnp.bfloat16 if k in bf16 else
                                 jnp.float32)
    return out


def _leaves(tree):
    return [x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32) for x in adamw.tree_leaves(tree)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("gscale", [1e-3, 1.0], ids=["unclipped", "clipped"])
def test_adamw_matches_reference_over_three_steps(quant, gscale):
    rng = np.random.default_rng(1)
    cfg = adamw.AdamWConfig(quantize_moments=quant)
    jcfg = jadamw.AdamWConfig(quantize_moments=quant)
    host = _tree(rng)
    params, jparams = _to_port(host), _to_ref(host)
    state = adamw.init(params, cfg)
    jstate = jadamw.init(jparams, jcfg)
    for i in range(3):
        g = _tree(rng, gscale)
        params, state, m = adamw.update(_to_port(g, ()), state, params, cfg,
                                        lr_scale=0.5)
        jparams, jstate, jm = jadamw.update(_to_ref(g, ()), jstate, jparams,
                                            jcfg, lr_scale=0.5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for a, b in zip(_leaves(params), _leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    exact = gscale < 1.0
    for name in ("m", "v"):
        got, want = adamw.tree_leaves(state[name]), jax.tree.leaves(
            jstate[name])
        if quant:
            want = [want[i:i + 2] for i in range(0, len(want), 2)]
            for qt, (q, sc) in zip(got, want):
                assert isinstance(qt, adamw.QTensor)
                if exact:
                    assert np.array_equal(qt.q.numpy(), np.asarray(q))
                else:   # an ulp of the clip may move a value across a
                    # rounding boundary of the quantiser
                    d = np.abs(qt.q.numpy().astype(int) - np.asarray(q))
                    assert d.max() <= 1
                np.testing.assert_allclose(qt.scale.numpy(), np.asarray(sc),
                                           rtol=1e-6)
        else:
            for a, b in zip(got, want):
                if exact:
                    assert np.array_equal(a.numpy(), np.asarray(b)), name
                else:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               rtol=1e-6, atol=1e-12)


def test_adamw_pieces_of_a_large_leaf(monkeypatch):
    """A leaf updated in flat pieces (``CHUNK`` cut to 2 quantiser blocks)
    equals the same update in one piece, int8 moments included."""
    rng = np.random.default_rng(2)
    cfg = adamw.AdamWConfig(quantize_moments=True, q_block=256)
    host = {"w": rng.normal(size=(3, 700)).astype(np.float32)}
    grads = {"w": torch.from_numpy(
        rng.normal(size=(3, 700)).astype(np.float32))}
    out = []
    for chunk in (adamw.CHUNK, 512):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        params = _to_port(host, ())
        state = adamw.init(params, cfg)
        adamw.update(grads, state, params, cfg)
        adamw.update(grads, state, params, cfg)
        out.append((params["w"].clone(), state["m"]["w"].q.clone(),
                    state["v"]["w"].scale.clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(7,), (3, 300), (2, 5, 256), (513,)])
def test_qtensor_round_trip_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    t = adamw._quantize(torch.from_numpy(x), 256, 4)
    j = jadamw._quantize(jnp.asarray(x), 256, 4)
    assert t.shape == j.shape == shape
    assert tuple(t.q.shape) == j.q.shape and t.q.dtype == torch.int8
    assert np.array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    back = adamw._dequantize(t)
    assert np.array_equal(back.numpy(), np.asarray(jadamw._dequantize(j)))
    # within half a quantiser step of each block's largest |x|
    step = np.repeat(t.scale.numpy(), 256)[:x.size].reshape(shape)
    assert np.all(np.abs(back.numpy() - x) <= 0.5 * step + 1e-7)


def test_quantised_init_matches_reference():
    rng = np.random.default_rng(3)
    host = _tree(rng)
    cfg = adamw.AdamWConfig(quantize_moments=True)
    st = adamw.init(_to_port(host), cfg)
    jst = jadamw.init(_to_ref(host), jadamw.AdamWConfig(
        quantize_moments=True))
    got = adamw.tree_leaves(st["m"])
    want = jax.tree.leaves(jst["m"])
    assert len(want) == 2 * len(got)
    for qt, q, sc in zip(got, want[::2], want[1::2]):
        assert tuple(qt.q.shape) == q.shape and not qt.q.any()
        assert np.array_equal(qt.scale.numpy(), np.asarray(sc))


def _sparse_case(seed=4, r=40, d=8, t=60):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(r, d)).astype(np.float32)
    m = rng.normal(scale=1e-2, size=(r, d)).astype(np.float32)
    v = rng.uniform(1e-5, 1e-4, size=(r, d)).astype(np.float32)
    idx = rng.integers(0, r // 2, size=t).astype(np.int32)   # duplicates
    g = rng.normal(size=(t, d)).astype(np.float32)
    return p, m, v, idx, g


def test_sparse_row_update_matches_reference():
    p, m, v, idx, g = _sparse_case()
    cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
    jcfg = jadamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    adamw.sparse_row_update(tp, tm, tv, torch.from_numpy(idx),
                            torch.from_numpy(g), cfg, 0.7,
                            torch.tensor(201, dtype=torch.int32))
    jp, jm, jv = jadamw.sparse_row_update(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(g), jcfg, 0.7, jnp.int32(201))
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    untouched = np.setdiff1d(np.arange(p.shape[0]), idx)
    assert untouched.size and np.array_equal(tp.numpy()[untouched],
                                             p[untouched])


def test_sparse_row_update_equals_dense_update_on_touched_rows():
    """The lazy update's touched rows are the dense update's rows for the
    table gradient that sums each row's occurrences (no clipping: a
    ``grad_clip`` above the norm)."""
    p, m, v, idx, g = _sparse_case(seed=5)
    cfg = adamw.AdamWConfig(lr=1e-3, grad_clip=1e9)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    adamw.sparse_row_update(tp, tm, tv, torch.from_numpy(idx),
                            torch.from_numpy(g), cfg, 1.0,
                            torch.tensor(12, dtype=torch.int32))
    dense_g = np.zeros_like(p)
    np.add.at(dense_g, idx, g)
    params = {"t": torch.from_numpy(p.copy())}
    state = {"m": {"t": torch.from_numpy(m.copy())},
             "v": {"t": torch.from_numpy(v.copy())},
             "step": torch.tensor(11, dtype=torch.int32)}
    adamw.update({"t": torch.from_numpy(dense_g)}, state, params, cfg)
    rows = np.unique(idx)
    for a, b in ((tp, params["t"]), (tm, state["m"]["t"]),
                 (tv, state["v"]["t"])):
        np.testing.assert_allclose(a.numpy()[rows], b.numpy()[rows],
                                   rtol=1e-6, atol=1e-9)


def test_sparse_row_sums_take_the_rating_sum():
    """The run sums go through ``ops.rating_segment_sum_batch`` (its
    plain version on the CPU): equal to a sequential sum per run."""
    rng = np.random.default_rng(6)
    runs = torch.tensor([0, 0, 0, 1, 2, 2, 3], dtype=torch.int64)
    g = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    got = adamw.run_sums(g, runs, 7)
    assert tuple(got.shape) == (7, 5)
    for r in range(4):
        want = torch.zeros(5)
        for i in np.flatnonzero(runs.numpy() == r):
            want = want + g[i]
        assert torch.equal(got[r], want)
    assert not got[4:].any()


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference(frac):
    rng = np.random.default_rng(7)
    g = rng.normal(size=(30, 40)).astype(np.float32)
    res = rng.normal(scale=0.1, size=(30, 40)).astype(np.float32)
    kept, new_res = compression.topk_compress(
        torch.from_numpy(g), torch.from_numpy(res), frac)
    jkept, jres = jcompression.topk_compress(jnp.asarray(g),
                                             jnp.asarray(res), frac)
    assert np.array_equal(kept.numpy(), np.asarray(jkept))
    assert np.array_equal(new_res.numpy(), np.asarray(jres))
    assert int((kept != 0).sum()) == max(int(frac * g.size), 1)
    bf = compression.topk_compress(torch.from_numpy(g).to(torch.bfloat16),
                                   torch.from_numpy(res), frac)[0]
    assert bf.dtype == torch.bfloat16
