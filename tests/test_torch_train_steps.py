"""Port parity of the train steps (``repro_torch.train.steps``), the train
CLI and train-state checkpoints.

Each cell's step runs 3 times in both packages from one state at step
200 (the end of the warm-up, so every step moves the parameters; random
moments, ``train_parity.moments_at``): the port's ``build_cell(...).fn``
on the CPU against the reference's ``jax.jit(build_cell(...).fn)``, fed
the same numpy batches.  Tolerances, from f32 sums over model widths in
another order in XLA and in torch, carried through 3 updates:

- loss, ``grad_norm``: rtol 1e-5 (LM, DLRM), 1e-4 (GNN: the segment sums
  add in another order through up to three residual layers);
- ``lr``: rtol 1e-6 (``cos`` in f32 may differ by an ulp);
- parameters: rtol 1e-5, atol 1e-6 (an update is ``lr * delta`` with
  ``lr`` <= 1e-3 and ``|delta|`` of order 1, so a gradient that differs in
  its 5th digit moves a parameter by under 1e-7);
- ``m``: atol 1e-6 and ``v`` atol 1e-9 on top of rtol 1e-4 (the GNN's
  rtol 1e-3): each holds the gradient or its square, which the other
  order of the sums moves by about 1e-6 of its size;
- int8 moments of grok-1's SMOKE config: within 1 step of the
  quantiser (the f32 moment may fall on the other side of a rounding
  boundary), scales as ``m`` and ``v``.  Its state starts with v ~
  U(1e-4, 1e-3): a ``v`` that quantises to a few steps of its block's
  scale (the block's largest ``g^2`` over 127) makes ``m/sqrt(v)``
  ill-conditioned in both packages, and with v near 1e-7 that happens in
  a third of a step's blocks; each port step also starts from the
  reference's state (two trajectories part at the first moment one
  quantiser step apart).

bf16 gradient accumulation (``grad_accum_dtype="bfloat16"``) rounds each
microbatch's gradient to 8 bits of mantissa in both packages, and the
f32 partial sums before that rounding differ in their last digits, so a
gradient may land one or two bf16 ulps (2^-8 of its size) apart: its
parameters and ``m`` are held to rtol 1e-2, the parameters atol 3e-5
(3 updates of ``lr`` 3e-4 whose ``delta``, up to about 3, moves by about
1% with its gradient), ``m`` atol 5e-5 (0.1 of two ulps of a gradient
near 0.05), ``v`` to rtol 2e-2 (two ulps of a
gradient, 2^-7 of it, double in its square), ``grad_norm`` rtol 1e-2,
loss and ``lr`` as in f32.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import CPU
from train_parity import (assert_states_close, leaves, moments_at, np_tree,
                          port_state)

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import graphs as jgraphs
from repro.data import lm_data as jlm_data
from repro.data import recsys as jrecsys
from repro.data import sampler as jsampler
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.layers import batch_to
from repro_torch.optim import adamw
from repro_torch.train import steps

LM_ARCHS = ("codeqwen1.5-7b", "stablelm-12b", "mistral-large-123b",
            "phi3.5-moe-42b-a6.6b", "grok-1-314b")
GNN_ARCHS = ("gatedgcn", "gin-tu", "meshgraphnet", "graphsage-reddit")
STEPS = 3
LM_B, LM_S = 4, 16

F32_TOL = {"params": (1e-5, 1e-6), "['m']": (1e-4, 1e-6),
           "['v']": (1e-4, 1e-9)}
GNN_STATE_TOL = {"params": (1e-5, 1e-6), "['m']": (1e-3, 1e-6),
                 "['v']": (1e-3, 1e-9)}
BF16_ACC_TOL = {"params": (1e-2, 3e-5), "['m']": (1e-2, 5e-5),
                "['v']": (2e-2, 1e-9)}


def _run_both(aid, cfg, jcfg, shape, jshape, ref_state, batches, family,
              opt_cfg=None, sparse=False, resync=False, **kw):
    """STEPS steps of the cell in both packages from ``ref_state``;
    returns (port state, port metrics, ref state, ref metrics).  With
    ``resync`` each port step starts from the reference's state before
    that step (a copy), not from its own."""
    opt_cfg = opt_cfg or registry.get_opt(aid)
    jopt = jregistry.get_opt(aid) if opt_cfg == registry.get_opt(aid) \
        else jadamw.AdamWConfig(**dataclasses.asdict(opt_cfg))
    spec = dataclasses.replace(registry.get_arch(aid), config=cfg)
    jspec = dataclasses.replace(jregistry.ARCHS[aid], config=jcfg)
    if sparse:
        cell = steps.dlrm_train_cell(spec, shape, opt_cfg,
                                     sparse_update=True)
        jcell = jsteps.dlrm_train_cell(jspec, jshape, False, jopt,
                                       sparse_update=True)
    else:
        cell = steps.build_cell(spec, shape, opt_cfg=opt_cfg, n_devices=1)
        jcell = jsteps.build_cell(jspec, jshape, multi_pod=False,
                                  opt_cfg=jopt, n_devices=1)
    state = port_state(family, cfg, ref_state, **kw)
    jfn = jax.jit(jcell.fn)
    jstate = jax.tree.map(jnp.asarray, ref_state)
    got_m, want_m = [], []
    for batch in batches:
        if resync:
            state = port_state(family, cfg, np_tree(jstate), **kw)
        state, m = cell.fn(state, batch_to(batch, CPU))
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        got_m.append({k: float(v) for k, v in m.items()})
        want_m.append({k: float(v) for k, v in jm.items()})
    return state, got_m, jstate, want_m


def _check_metrics(got, want, rtol):
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=rtol)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert w["lr"] > 0


def _lm_case(aid, resync=False, **over):
    jcfg = dataclasses.replace(jregistry.SMOKES[aid], **over)
    cfg = dataclasses.replace(registry.SMOKES[aid], **over)
    params = np_tree(jtransformer.init_params(jcfg, jax.random.PRNGKey(2)))
    opt_cfg = jregistry.get_opt(aid)
    ref_state = {"params": params, "opt": moments_at(
        params, opt_cfg, v_range=((1e-4, 1e-3) if opt_cfg.quantize_moments
                                  else (1e-7, 1e-6)))}
    ts = jlm_data.TokenStream(cfg.vocab, LM_B, LM_S, seed=1)
    batches = [ts.next_batch(i) for i in range(STEPS)]
    shape = ShapeSpec("t", "train", (("seq_len", LM_S),
                                     ("global_batch", LM_B)))
    jshape = JShapeSpec("t", "train", (("seq_len", LM_S),
                                       ("global_batch", LM_B)))
    return _run_both(aid, cfg, jcfg, shape, jshape, ref_state, batches,
                     "lm", resync=resync)


@pytest.mark.parametrize("aid", LM_ARCHS)
def test_lm_train_step_matches_reference(aid):
    # grok-1's int8 moments: a moment one quantiser step apart (a
    # rounding boundary) divides by a v that may quantise to 0, so two
    # trajectories part after a step or two; each port step starts from
    # the reference's state instead
    state, got, jstate, want = _lm_case(aid, resync=aid == "grok-1-314b")
    _check_metrics(got, want, 1e-5)
    q = aid == "grok-1-314b"
    tol = dict(F32_TOL)
    if q:       # the moments' scales: the f32 moments' tolerance
        tol.update({"['m']": (1e-4, 1e-9), "['v']": (1e-4, 1e-12)})
    assert_states_close(state, jstate, tol, q_tol=1 if q else 0)
    assert int(state["opt"]["step"]) == 200 + STEPS


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_lm_microbatches_and_accumulation_dtype(acc):
    """``microbatches=2`` through ``dataclasses.replace``: the batch split
    contiguously, each part's gradient accumulated in ``acc``."""
    state, got, jstate, want = _lm_case("codeqwen1.5-7b", microbatches=2,
                                        grad_accum_dtype=acc)
    if acc == "float32":
        _check_metrics(got, want, 1e-5)
        assert_states_close(state, jstate, F32_TOL)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-2)
        assert_states_close(state, jstate, BF16_ACC_TOL)


def _gnn_batches(aid, regime, cfg):
    fe = jgnn._edge_feat_dim(cfg)
    out = []
    for i in range(STEPS):
        if regime == "full_graph":
            b = jgraphs.full_graph_batch(40, 100, cfg.d_feat, cfg.n_classes,
                                         seed=i, need_edge_feat=fe)
            b = steps.pad_edges(b)      # the cell's multiple of 512
        elif regime == "minibatch":
            ei = jgraphs.power_law_graph(200, 800, seed=i)
            feats = np.random.default_rng(i).normal(
                size=(200, cfg.d_feat)).astype(np.float32)
            labels = np.random.default_rng(i + 9).integers(
                0, cfg.n_classes, 200).astype(np.int32)
            b = jsampler.NeighborSampler(ei, 200, feats, labels, (4, 3),
                                         seed=i).batch(12)
        else:
            b = jgraphs.molecule_batch(6, 8, 14, cfg.d_feat, cfg.n_classes,
                                       seed=i, need_edge_feat=fe)
        out.append(b)
    return out


GNN_SHAPE = {"full_graph": (("n_nodes", 40), ("n_edges", 100)),
             "minibatch": (("n_nodes", 200), ("n_edges", 800),
                           ("batch_nodes", 12), ("fanout", (4, 3))),
             "molecule": (("n_nodes", 8), ("n_edges", 14), ("batch", 6))}


@pytest.mark.parametrize("regime", ["full_graph", "minibatch", "molecule"])
@pytest.mark.parametrize("aid", GNN_ARCHS)
def test_gnn_train_step_matches_reference(aid, regime):
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jgnn.init_params(jcfg, jax.random.PRNGKey(4),
                                      d_feat=cfg.d_feat,
                                      n_classes=cfg.n_classes))
    ref_state = {"params": params,
                 "opt": moments_at(params, jregistry.get_opt(aid))}
    p = GNN_SHAPE[regime] + ((("d_feat", cfg.d_feat),)
                             if regime == "full_graph" else ())
    state, got, jstate, want = _run_both(
        aid, cfg, jcfg, ShapeSpec("g", regime, p), JShapeSpec("g", regime, p),
        ref_state, _gnn_batches(aid, regime, cfg), "gnn", d_feat=cfg.d_feat,
        n_classes=cfg.n_classes)
    _check_metrics(got, want, 1e-4)
    assert_states_close(state, jstate, GNN_STATE_TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_dlrm_train_step_matches_reference(sparse):
    aid = "dlrm-mlperf"
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jdlrm.init_params(jcfg, jax.random.PRNGKey(5)))
    ref_state = {"params": params,
                 "opt": moments_at(params, jregistry.get_opt(aid))}
    batches = [jrecsys.click_batch(jcfg, 64, seed=i) for i in range(STEPS)]
    shape = ShapeSpec("d", "train_batch", (("batch", 64),))
    jshape = JShapeSpec("d", "train_batch", (("batch", 64),))
    state, got, jstate, want = _run_both(aid, cfg, jcfg, shape, jshape,
                                         ref_state, batches, "dlrm",
                                         sparse=sparse)
    _check_metrics(got, want, 1e-5)
    assert_states_close(state, jstate, F32_TOL)


def test_train_cli_resume_equals_unbroken_run(tmp_path):
    """The CLI on the CPU: 4 steps with a checkpoint every 2, against 2
    steps then ``--resume`` to 4; the final states bit for bit."""
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(ckpt, steps_, *extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "codeqwen1.5-7b", "--steps", str(steps_), "--ckpt-every", "2",
             "--batch", "4", "--seq", "16", "--device", "cpu",
             "--ckpt-dir", str(ckpt), *extra],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout

    run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    log = run(tmp_path / "b", 4, "--resume")
    assert "[train] resumed from step 2" in log
    ma, la = CheckpointManager(str(tmp_path / "a"))._load(None)
    mb_, lb = CheckpointManager(str(tmp_path / "b"))._load(None)
    assert ma["step"] == mb_["step"] == 4
    assert ma["paths"] == mb_["paths"]
    for x, y in zip(la, lb):
        assert np.array_equal(x, y)
    assert mb_["extra"]["data_cursor"] == 4


def test_quantised_train_checkpoint_cross_reads(tmp_path):
    """A grok-1 SMOKE train state with int8 moments: the port's
    checkpoint restored by the reference's manager, and the reference's
    by the port's, every leaf bit for bit (``QTensor`` paths and shapes
    included)."""
    aid = "grok-1-314b"
    jcfg, cfg = jregistry.SMOKES[aid], registry.SMOKES[aid]
    params = np_tree(jtransformer.init_params(jcfg, jax.random.PRNGKey(6)))
    ref_state = {"params": params,
                 "opt": moments_at(params, jregistry.get_opt(aid), seed=3)}
    state = port_state("lm", cfg, ref_state)
    assert isinstance(state["opt"]["m"]["layers"]["we1"], adamw.QTensor)
    CheckpointManager(str(tmp_path / "port")).save(7, state,
                                                   extra={"data_cursor": 7})
    jstate, extra = JCheckpointManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, ref_state))
    assert extra == {"data_cursor": 7}
    gp, gx = leaves(state, port=True)
    wp, wx = leaves(jstate, port=False)
    assert gp == wp and any("[<flat index 1>]" in p for p in gp)
    for a, b in zip(gx, wx):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jstate["opt"]["m"]["layers"]["we1"].shape == \
        tuple(state["opt"]["m"]["layers"]["we1"].shape)

    JCheckpointManager(str(tmp_path / "ref")).save(
        9, jax.tree.map(jnp.asarray, ref_state), extra={"data_cursor": 9})
    like = port_state("lm", cfg, ref_state)
    back, extra = CheckpointManager(str(tmp_path / "ref")).restore(
        like, device=CPU)
    assert extra == {"data_cursor": 9}
    q = back["opt"]["v"]["layers"]["wqkv"]
    assert isinstance(q, adamw.QTensor) and q.q.dtype == torch.int8
    assert q.shape == tuple(params["layers"]["wqkv"].shape)
    assert_states_close(back, ref_state, {"": (0.0, 0.0)})


def test_bf16_leaves_cross_read(tmp_path):
    """bf16 leaves: the reference's file read by the port, and the port's
    file holding the reference's words and dtype name."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
    JCheckpointManager(str(tmp_path / "ref")).save(1, {"w": x})
    back, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        {"w": torch.zeros((3, 5), dtype=torch.bfloat16)}, device=CPU)
    assert back["w"].dtype == torch.bfloat16
    assert np.array_equal(back["w"].float().numpy(), np.asarray(x, np.float32))
    CheckpointManager(str(tmp_path / "port")).save(1, back)
    m_port = json.load(open(tmp_path / "port" / "step_1" / "manifest.json"))
    m_ref = json.load(open(tmp_path / "ref" / "step_1" / "manifest.json"))
    assert m_port["dtypes"] == m_ref["dtypes"] == ["bfloat16"]
    a = np.load(tmp_path / "port" / "step_1" / "arrays.npz")["a0"]
    b = np.load(tmp_path / "ref" / "step_1" / "arrays.npz")["a0"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_train_entry_points_ask_for_the_card():
    """Without a card, the train entry points called for ``cuda`` raise:
    the CLI's default device, the parameter draw and the optimizer state's
    conversion; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda entry points run there")
    from repro_torch.launch import train as train_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "codeqwen1.5-7b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.init_params(registry.SMOKES["gatedgcn"],
                              torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adamw.from_reference_state({"m": {}, "v": {},
                                    "step": np.int32(0)})
