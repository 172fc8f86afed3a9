"""Port parity of checkpointing and the elastic runtime: atomic keep-K
checkpoints that round-trip bit for bit and cross-read with the
reference's (one on-disk format, the same manifest paths), the straggler
watchdog, the restart loop with a torch SGD step, and the device-loss
repartition (a forced k-change solve) against the reference.

Bars: checkpoints and the restart loop are exact (the same bits);
``repartition_after_loss`` on integer weights under host coarsening is
bit-equal to the reference (every sum exact in any order).
"""
import os

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_hg

from repro.checkpoint import CheckpointManager as RefManager
from repro.data import hypergraphs as jdata
from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.runtime import (ElasticTrainer, FailureInjector,
                                 NodeFailure, Runner, StragglerWatchdog,
                                 repartition_after_loss)


def _state(seed=0):
    """A nested training-like state: tensors, numpy, a tuple and a list."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 4, generator=g),
                       "b": torch.zeros(4)},
            "opt": (torch.randn(4, 4, generator=g),
                    np.arange(5, dtype=np.int64)),
            "hist": [np.float32(1.5), torch.tensor([3, 1], dtype=torch.int32)],
            "skip": None}


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    return _flatten_with_paths(tree)[1]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.is_tensor(x) == torch.is_tensor(y)
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype
        assert_bit_equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip_bitwise(tmp_path, async_save):
    state = _state()
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    ckpt.save(3, state, extra={"data_cursor": 3})
    # the host copy was taken on this thread: later writes do not leak in
    state["params"]["b"].add_(7.0)
    ckpt.wait()
    restored, extra = ckpt.restore(_state())
    assert extra["data_cursor"] == 3
    _assert_same(restored, _state())
    assert restored["skip"] is None
    assert isinstance(restored["opt"], tuple)
    assert isinstance(restored["hist"], list)


def test_restore_onto_a_device_gives_tensors(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"a": np.arange(6, dtype=np.int32).reshape(2, 3)})
    restored, _ = ckpt.restore({"a": np.zeros(1)}, device="cpu")
    assert torch.is_tensor(restored["a"])
    assert restored["a"].dtype == torch.int32
    assert_bit_equal(restored["a"], np.arange(6).reshape(2, 3))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"a": np.zeros(1), "b": np.zeros(1)})


def test_checkpoint_keep_k_and_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _state(s))
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4
    _assert_same(ckpt.restore(_state(), step=3)[0], _state(3))


def test_checkpoint_atomicity_no_partial_dir(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert ckpt.latest_step() is None
    ckpt.save(1, _state())
    assert ckpt.latest_step() == 1
    assert not os.path.exists(os.path.join(str(tmp_path), "step_9.tmp"))


def test_crash_mid_write_previous_restorable_orphan_gcd(tmp_path,
                                                        monkeypatch):
    """A writer that dies between the tmp write and the rename: the
    previous checkpoint stays restorable, and the next save collects the
    orphaned ``step_<N>.tmp``."""
    import repro_torch.checkpoint.manager as manager_mod
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    ckpt.save(1, _state(1), extra={"data_cursor": 1})

    def dying_rename(src, dst):
        raise OSError("injected crash between tmp write and rename")
    real_rename = manager_mod.os.rename
    monkeypatch.setattr(manager_mod.os, "rename", dying_rename)
    with pytest.raises(OSError, match="injected crash"):
        ckpt.save(2, _state(2))
    monkeypatch.setattr(manager_mod.os, "rename", real_rename)
    assert os.path.isdir(os.path.join(str(tmp_path), "step_2.tmp"))
    assert ckpt.all_steps() == [1]
    restored, extra = ckpt.restore(_state())
    assert extra["data_cursor"] == 1
    _assert_same(restored, _state(1))
    ckpt.save(3, _state(3), extra={"data_cursor": 3})
    assert not os.path.exists(os.path.join(str(tmp_path), "step_2.tmp"))
    assert ckpt.all_steps() == [1, 3]


def test_restore_items_flat_dict(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    state = {"slot0.parts": torch.arange(12, dtype=torch.int32).reshape(3, 4),
             "slot2.parts": np.ones((2, 5), np.int32)}
    ckpt.save(7, state, extra={"slots": {"0": {"name": "a", "li": 1}}})
    items, extra = ckpt.restore_items()
    assert set(items) == {"slot0.parts", "slot2.parts"}
    assert_bit_equal(items["slot0.parts"], state["slot0.parts"])
    assert_bit_equal(items["slot2.parts"], state["slot2.parts"])
    assert extra["slots"]["0"] == {"name": "a", "li": 1}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_items()


# --------------------------------------------------------------------------
# one on-disk format: each package reads the other's snapshots
# --------------------------------------------------------------------------
def _numpy_state():
    rng = np.random.default_rng(4)
    return {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": np.arange(3, dtype=np.int32)},
            "slot1.parts": rng.integers(0, 8, (2, 9)).astype(np.int32),
            # float32: the reference's restore places leaves as JAX
            # arrays, which hold no float64 without x64
            "step": np.float32(2.25)}


def _numpy_leaves(tree):
    return [np.asarray(x) for x in _leaves(tree)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_read(tmp_path, writer):
    state = _numpy_state()
    extra = {"slots": {"1": {"name": "r", "li": 2}}, "tick": 5}
    if writer == "reference":
        RefManager(str(tmp_path)).save(5, state, extra=extra)
        reader = CheckpointManager(str(tmp_path))
        got, got_extra = reader.restore(_numpy_state())
        items, items_extra = reader.restore_items()
        ref_items, _ = RefManager(str(tmp_path)).restore_items()
    else:
        CheckpointManager(str(tmp_path)).save(5, state, extra=extra)
        reader = RefManager(str(tmp_path))
        got, got_extra = reader.restore(_numpy_state())
        items, items_extra = reader.restore_items()
        ref_items, _ = CheckpointManager(str(tmp_path)).restore_items()
    assert got_extra == items_extra == extra
    want = _numpy_leaves(state)
    for g, w in zip(_numpy_leaves(got), want):
        assert np.asarray(g).dtype == w.dtype
        assert_bit_equal(np.asarray(g), w)
    assert set(items) == set(ref_items)
    assert_bit_equal(items["slot1.parts"], state["slot1.parts"])
    for key in items:
        assert_bit_equal(np.asarray(items[key]), np.asarray(ref_items[key]))


def test_manifest_paths_equal_reference(tmp_path):
    import json
    state = _numpy_state()
    RefManager(str(tmp_path / "ref")).save(1, state)
    CheckpointManager(str(tmp_path / "port")).save(1, state)
    man = [json.load(open(tmp_path / d / "step_1" / "manifest.json"))
           for d in ("ref", "port")]
    for key in ("paths", "shapes", "dtypes", "step"):
        assert man[0][key] == man[1][key]


# --------------------------------------------------------------------------
# the straggler watchdog and the restart loop
# --------------------------------------------------------------------------
def test_straggler_watchdog_equals_reference():
    rng = np.random.default_rng(9)
    times = 0.1 + 0.01 * rng.random(60)
    times[[5, 17, 18, 40, 59]] *= np.array([6.0, 5.0, 2.0, 9.0, 4.5])
    mine = StragglerWatchdog(factor=3.0, window=8, grace_steps=3)
    ref = jelastic.StragglerWatchdog(factor=3.0, window=8, grace_steps=3)
    for i, t in enumerate(times):
        got, want = mine.observe(i, float(t)), ref.observe(i, float(t))
        assert (got is None) == (want is None)
    assert [(r.step, r.step_time, r.deadline) for r in mine.reports] == \
        [(r.step, r.step_time, r.deadline) for r in ref.reports]
    assert len(mine.reports) >= 3


def _toy_sgd():
    """A torch SGD step on a least-squares toy (a fixed batch per step)."""
    target = torch.full((4, 4), 2.0, dtype=torch.float64)

    def step(state, batch):
        w = state["w"].clone().requires_grad_(True)
        loss = ((w @ batch["x"] - batch["y"]) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            w_new = w - 0.1 * w.grad
        return {"w": w_new.detach(), "t": state["t"] + 1}, {
            "loss": float(loss.detach())}

    def batch_fn(i):
        g = torch.Generator().manual_seed(i)
        x = torch.randn(4, 8, generator=g, dtype=torch.float64)
        return {"x": x, "y": target @ x}

    state0 = {"w": torch.ones(4, 4, dtype=torch.float64),
              "t": torch.zeros((), dtype=torch.int64)}
    return step, state0, batch_fn


def test_elastic_restart_after_injected_failure(tmp_path):
    """Kill at step 7, restart from the step-5 checkpoint, finish: the
    final state equals an uninterrupted run bit for bit."""
    step, state0, batch_fn = _toy_sgd()
    total = 12
    s = state0
    for i in range(total):
        s, _ = step(s, batch_fn(i))
    reference = s

    injector = FailureInjector({7: "node"})

    def make_runner(attempt):
        ckpt = CheckpointManager(str(tmp_path), keep=3)
        if attempt == 0 and ckpt.latest_step() is None:
            st, start = state0, 0
        else:
            st, extra = ckpt.restore(state0)
            start = extra["data_cursor"]
        return Runner(step_fn=step, state=st, next_batch=batch_fn,
                      ckpt=ckpt, step=start, ckpt_every=5,
                      injector=injector,
                      watchdog=StragglerWatchdog(grace_steps=100))

    result = ElasticTrainer(make_runner, max_restarts=2).run(total)
    assert result["restarts"] == 1
    assert result["final_step"] == total
    assert result["history"][0][0] == 7
    assert torch.equal(result["state"]["w"], reference["w"])
    assert int(result["state"]["t"]) == total


def test_elastic_trainer_gives_up_after_max_restarts(tmp_path):
    step, state0, batch_fn = _toy_sgd()
    injector = FailureInjector({1: "a", 2: "b"})

    def make_runner(attempt):
        return Runner(step_fn=step, state=state0, next_batch=batch_fn,
                      ckpt=CheckpointManager(str(tmp_path)), step=attempt,
                      injector=injector)

    with pytest.raises(NodeFailure, match="injected"):
        ElasticTrainer(make_runner, max_restarts=1).run(5)


# --------------------------------------------------------------------------
# the device-loss repartition against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k_new,frac", [(4, 0.25), (6, None)])
def test_repartition_after_loss_equals_reference(k_new, frac, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hg = jdata._modular_netlist(500, 700, seed=11, n_modules=8, p_local=0.8,
                                fanout_tail=1.5)
    mine = port_hg(hg)
    inc = impart_partition(
        mine, ImpartConfig(k=8, eps=0.08, alpha=2, lp_iters=4,
                           recombination_enabled=False,
                           mutation_enabled=False, final_vcycles=0,
                           contraction_limit_factor=16),
        device="cpu").part.astype(np.int32)
    got = repartition_after_loss(mine, inc, k_new, migration_frac=frac,
                                 alpha=2, lp_iters=4, device="cpu")
    want = jelastic.repartition_after_loss(hg, inc, k_new,
                                           migration_frac=frac, alpha=2,
                                           lp_iters=4)
    assert_bit_equal(got.part, want.part)
    assert got.cut == want.cut
    assert got.migration_weight == want.migration_weight
    assert got.budget_weight == want.budget_weight
    assert got.part.max() < k_new
