"""Port parity of LM serving: the transformer's prefill and decode steps,
``ServeSession.generate``/``score``, the token stream and the analytic
FLOP counts, over the SMOKE configs of all five LM architectures (f32,
2 layers; two of them MoE).

The reference's parameters (drawn by its own ``init_params``) go into
the port through ``from_reference_params``; both packages then see the
same numpy tokens on the CPU.  Tolerances: rtol 1e-5, atol 1e-5 for
logits (|logit| up to about 4: f32 sums over the model width and the
vocabulary's log-sum-exp in another order in XLA and in torch), and
rtol 1e-5 for a score (a sum of up to 23 log-probs of about -5 each).
Exact: the generated tokens, the cache layout, the token stream's
batches and the FLOP counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal

from repro.configs import registry as jregistry
from repro.data import lm_data as jlm_data
from repro.launch import analytic as janalytic
from repro.models import transformer as jtransformer
from repro.serve import ServeSession as JServeSession
from repro_torch.configs import registry
from repro_torch.data import lm_data
from repro_torch.launch import analytic
from repro_torch.models import transformer
from repro_torch.serve import ServeSession

TOL = dict(rtol=1e-5, atol=1e-5)
LM_ARCHS = ("codeqwen1.5-7b", "stablelm-12b", "mistral-large-123b",
            "phi3.5-moe-42b-a6.6b", "grok-1-314b")
B, S0, STEPS, MAX_SEQ, DECODE_STEPS = 2, 6, 5, 24, 4


@dataclasses.dataclass
class Pair:
    """One architecture's SMOKE model in both packages, and what the
    reference returned for the shared inputs."""
    cfg: object
    jcfg: object
    params: dict
    model: transformer.Transformer
    prompt: np.ndarray
    ref_prefill: np.ndarray
    ref_decode: list
    ref_cache: dict
    ref_gen: np.ndarray
    ref_gen_logits: np.ndarray
    ref_score: np.ndarray


@pytest.fixture(scope="module", params=LM_ARCHS)
def pair(request):
    aid = request.param
    cfg = jregistry.SMOKES[aid]
    params = jax.tree.map(np.asarray,
                          jtransformer.init_params(cfg, jax.random.PRNGKey(1)))
    model = transformer.from_reference_params(registry.SMOKES[aid], params,
                                              device=CPU)
    rng = np.random.default_rng(len(aid))
    prompt = rng.integers(0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    sess = JServeSession(cfg=cfg, params=params, max_seq=MAX_SEQ, batch=B)
    ref_prefill = np.asarray(sess._prefill(params, jnp.asarray(prompt)))
    cache = jtransformer.init_cache(cfg, B, MAX_SEQ)
    ref_decode = []
    for i in range(DECODE_STEPS):
        logits, cache = sess._decode(params, cache,
                                     jnp.asarray(prompt[:, i:i + 1]),
                                     jnp.int32(i))
        ref_decode.append(np.asarray(logits))
    gen, gen_logits = sess.generate(jnp.asarray(prompt[:, :S0]), STEPS)
    return Pair(cfg=registry.SMOKES[aid], jcfg=cfg, params=params,
                model=model,
                prompt=prompt, ref_prefill=ref_prefill, ref_decode=ref_decode,
                ref_cache={k: np.asarray(v) for k, v in cache.items()},
                ref_gen=np.asarray(gen),
                ref_gen_logits=np.asarray(gen_logits),
                ref_score=np.asarray(sess.score(jnp.asarray(prompt))))


def test_params_and_cache_layout_match_reference(pair):
    cfg = pair.cfg
    want = jax.tree.map(np.asarray, jtransformer.init_params(
        pair.jcfg, jax.random.PRNGKey(2)))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=CPU)
    got = dict(embed=model.embed, lm_head=model.lm_head,
               final_norm=model.final_norm, layers=dict(model.layers))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == 3 + len(got["layers"])
    for path, leaf in flat_want:
        keys = [p.key for p in path]
        t = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape, keys
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name, keys
    for name in ("ln1", "ln2"):
        assert bool((model.layers[name] == 1).all())
    assert bool((model.final_norm == 1).all())
    cache = transformer.init_cache(cfg, B, MAX_SEQ, CPU)
    jcache = jtransformer.init_cache(pair.jcfg, B, MAX_SEQ)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}


def test_prefill_logits_match_reference(pair):
    got = transformer.prefill_logits(pair.model, torch.from_numpy(pair.prompt))
    assert got.shape == pair.ref_prefill.shape
    np.testing.assert_allclose(got.numpy(), pair.ref_prefill, **TOL)


def test_decode_steps_match_reference(pair):
    cache = transformer.init_cache(pair.cfg, B, MAX_SEQ, CPU)
    for i, want in enumerate(pair.ref_decode):
        logits, cache = transformer.decode_step(
            pair.model, cache, torch.from_numpy(pair.prompt[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), want, **TOL)
    for name, want in pair.ref_cache.items():
        np.testing.assert_allclose(cache[name].numpy(), want, **TOL)
        # rows past the last step stay zero
        assert not bool(cache[name][:, :, DECODE_STEPS:].any())


def test_generate_gives_reference_tokens(pair):
    sess = ServeSession(cfg=pair.cfg, params=pair.model, max_seq=MAX_SEQ,
                        batch=B)
    gen, logits = sess.generate(torch.from_numpy(pair.prompt[:, :S0]), STEPS)
    assert gen.dtype == torch.int32
    assert_bit_equal(gen, pair.ref_gen, "generated tokens")
    np.testing.assert_allclose(logits.numpy(), pair.ref_gen_logits, **TOL)
    with pytest.raises(ValueError):
        sess.generate(torch.from_numpy(pair.prompt[:, :S0]), MAX_SEQ)


def test_score_matches_reference(pair):
    sess = ServeSession(cfg=pair.cfg, params=pair.model, max_seq=MAX_SEQ,
                        batch=B)
    got = sess.score(torch.from_numpy(pair.prompt))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pair.ref_score, rtol=1e-5)


@pytest.mark.parametrize("aid", [a for a in LM_ARCHS
                                 if registry.SMOKES[a].moe_experts])
def test_moe_prefill_over_token_groups_matches_reference(aid):
    """B * S = 512 tokens: the MoE runs 256 groups of 2 tokens (on phi's
    4 experts at capacity 1, a full expert drops a token)."""
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(4)))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 256)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jtransformer.prefill_logits(p, t, jcfg))(
        params, jnp.asarray(toks))
    got = transformer.prefill_logits(
        transformer.from_reference_params(cfg, params, device=CPU),
        torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("aid", [a for a in LM_ARCHS
                                 if not registry.SMOKES[a].moe_experts])
def test_greedy_decode_equals_prefill_argmax(aid):
    """The reference's decode-consistency bar, on the port alone: prefill
    over [prompt | generated] picks every generated token (dense models;
    a MoE model's decode routes one group of B tokens, its prefill one
    group per token here, so the two may differ by design)."""
    cfg = registry.SMOKES[aid]
    model = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device=CPU)
    sess = ServeSession(cfg=cfg, params=model, max_seq=MAX_SEQ, batch=B)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32))
    gen, _ = sess.generate(prompt, STEPS)
    greedy = transformer.prefill_logits(
        model, torch.cat([prompt, gen], dim=1)).argmax(dim=-1)
    assert torch.equal(greedy[:, S0 - 1:S0 - 1 + STEPS].to(torch.int32), gen)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(256, 2, 12, 0),
                                                  (92416, 3, 40, 5)])
def test_token_stream_is_bit_equal(vocab, batch, seq, seed):
    got = lm_data.TokenStream(vocab, batch, seq, seed=seed)
    want = jlm_data.TokenStream(vocab, batch, seq, seed=seed)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype
            assert np.array_equal(g[key], w[key]), (step, key)
        if step == 2:
            break
    pre = lm_data.Prefetcher(iter(lm_data.TokenStream(vocab, batch, seq,
                                                      seed=seed)))
    try:
        first = next(pre)
    finally:
        pre.close()
    again = jlm_data.TokenStream(vocab, batch, seq, seed=seed).next_batch(0)
    assert np.array_equal(first["tokens"], again["tokens"])


def test_model_flops_equal_reference_on_every_cell():
    cells = registry.all_cells()
    assert len(cells) == 40
    for aid, shape in cells:
        got = analytic.model_flops(registry.get_arch(aid), shape)
        want = janalytic.model_flops(jregistry.get_arch(aid), shape)
        assert got == want, (aid, shape)
    cfg = registry.get_arch("codeqwen1.5-7b").config
    assert analytic._lm_fwd_flops(cfg, 8192, 2048) == \
        janalytic._lm_fwd_flops(jregistry.get_arch("codeqwen1.5-7b").config,
                                8192, 2048)
