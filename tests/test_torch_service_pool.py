"""The partition service over a pool of devices (DESIGN.md §11-13) and
the sharded restore of its checkpoints.

The pool is P logical shards of the CPU (``popshard.set_logical_shards``),
the counterpart of the reference's forced host devices.  Bars, under
host coarsening with integer weights (modular netlists of n 120 and
150, k 3, alpha 2, lp_iters 4, ``contraction_limit_factor`` 16: four
levels each, with recombination, mutation and a final V-cycle):

* ``PartitionService(shard="mesh"|"chunk")`` at pools of 1, 2 and 4
  answers every request bit-equal to ``solve_solo`` (one device, ``off``);
* under the device-loss plan the pool shrinks in mid-run (a pool of
  logical shards too), the next dispatches run on the survivors' mesh,
  and every answer still equals solo; so under a corruption plan;
* ``model_shard="mesh"`` over a (pop 2, model 2) grid equals solo;
* ``CheckpointManager.restore(..., shardings=)`` places every leaf on
  the current pool (its row blocks or its copies), a shrunk pool
  included, and reads the reference's files.
"""
import os

import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_hg

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.data.hypergraphs import _modular_netlist
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import popshard
from repro_torch.runtime.elastic import restore_device_pool
from repro_torch.serve import faults
from repro_torch.serve.partition_service import (PartitionRequest,
                                                 PartitionService)

ROUTES = ("mesh", "chunk")


@pytest.fixture(scope="module", autouse=True)
def _host_coarsening():
    old = os.environ.get("REPRO_COARSEN_PATH")
    os.environ["REPRO_COARSEN_PATH"] = "host"
    yield
    if old is None:
        del os.environ["REPRO_COARSEN_PATH"]
    else:
        os.environ["REPRO_COARSEN_PATH"] = old


@pytest.fixture
def pool(monkeypatch):
    """``pool(p, model=1)``: the CPU pool as p logical shards in a (p /
    model, model) grid; the pool, its limit and the shard count are
    restored after."""
    def make(p, model=1):
        monkeypatch.setenv("REPRO_POP_MESH_MODEL", str(model))
        return popshard.set_logical_shards(p, CPU)
    yield make
    restore_device_pool(CPU)
    popshard.set_logical_shards(None)


@pytest.fixture(scope="module")
def stream():
    return [port_hg(_modular_netlist(120 + 30 * i, 160 + 40 * i,
                                     seed=30 + i, n_modules=5, p_local=0.8,
                                     fanout_tail=1.5)) for i in range(2)]


def _svc(**kw):
    return PartitionService(slots=2, alpha=2, lp_iters=4,
                            contraction_limit_factor=16, device=CPU, **kw)


def _requests(stream):
    return [PartitionRequest(name=f"pool-{i}", hg=hg, k=3, eps=0.08, seed=i)
            for i, hg in enumerate(stream)]


@pytest.fixture(scope="module")
def solo(stream):
    svc = _svc()
    return {r.name: svc.solve_solo(r) for r in _requests(stream)}


def _serve(stream, **kw):
    svc = _svc(**kw)
    for r in _requests(stream):
        svc.submit(r)
    svc.drain()
    return svc


def _assert_solo(svc, solo, status="ok"):
    for name, (part, cut) in solo.items():
        res = svc.results[name]
        assert res.status == status, (name, res.status)
        assert_bit_equal(res.part, part, name)
        assert res.cut == cut


@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("route", ROUTES)
def test_service_routes_equal_solo(route, p, stream, solo, pool):
    pool(p)
    svc = _serve(stream, shard=route)
    _assert_solo(svc, solo)


@pytest.mark.parametrize("p", (2, 4))
@pytest.mark.parametrize("route", ROUTES)
def test_device_loss_shrinks_the_pool_and_rebuilds_the_mesh(route, p, stream,
                                                            solo, pool):
    """A device loss at tick 2 with the default survivor count (one
    fewer): the pool of logical shards shrinks to p - 1, the mesh is the
    survivors' (its "pop" size p - 1), every request resumes from its
    snapshot and equals solo."""
    pool(p)
    before = popshard.pop_mesh(CPU)
    svc = _serve(stream, shard=route, ckpt_every=1,
                 fault_plan=faults.FaultPlan.parse("2:device_loss"))
    loss = [e for e in svc.events if e["kind"] == "device_loss"]
    assert len(loss) == 1 and loss[0]["survivors"] == p - 1
    assert loss[0]["resumed_from_ckpt"] == 2
    for key in ("tick", "kind", "survivors", "resumed_from_ckpt",
                "restarted_from_scratch", "recovery_s"):
        assert key in loss[0]
    assert len(popshard.local_devices(CPU)) == p - 1
    after = popshard.pop_mesh(CPU)
    assert after is not before and after.shape["pop"] == p - 1
    _assert_solo(svc, solo, "recovered")


@pytest.mark.parametrize("route", ROUTES)
def test_corruption_over_a_pool_equals_solo(route, stream, solo, pool):
    pool(2)
    svc = _serve(stream, shard=route, ckpt_every=1,
                 fault_plan=faults.FaultPlan.parse(
                     "2:corrupt:slot=0,mode=nan_cut"))
    faulted = {e["request"] for e in svc.events
               if e["kind"] == "corrupt_injected"}
    assert faulted and any(e["kind"] == "quarantine" for e in svc.events)
    for name, (part, cut) in solo.items():
        res = svc.results[name]
        assert res.status == ("recovered" if name in faulted else "ok")
        assert_bit_equal(res.part, part, name)
        assert res.cut == cut


def test_model_route_service_equals_solo(stream, solo, pool):
    pool(4, model=2)
    assert popshard.pop_mesh(CPU).shape == {"pop": 2, "model": 2}
    svc = _serve(stream, shard="mesh", model_shard="mesh")
    _assert_solo(svc, solo)


# --------------------------------------------------------------------------
# the sharded restore
# --------------------------------------------------------------------------
def _state(rng):
    return {"parts": rng.integers(0, 5, (4, 30)).astype(np.int32),
            "cuts": rng.random(4).astype(np.float32),
            "meta": {"cap": np.float32(3.5), "w": rng.random(7)}}


def _placements(mesh):
    row, rep = popshard.pop_sharding(mesh), popshard.replicated(mesh)
    return {"parts": row, "cuts": row, "meta": {"cap": rep, "w": rep}}


def _assert_placed(got, state, mesh):
    npop = mesh.shape["pop"]
    for key in ("parts", "cuts"):
        blocks = got[key]
        assert len(blocks) == npop
        assert [b.device for b in blocks] == list(mesh.pop_devices)
        assert_bit_equal(torch.cat(blocks), state[key], key)
    for key in ("cap", "w"):
        copies = got["meta"][key]
        assert len(copies) == npop
        for c in copies:
            assert_bit_equal(c, state["meta"][key], key)


@pytest.mark.parametrize("shrink", [False, True], ids=["pool4", "shrunk2"])
def test_sharded_restore_places_leaves_on_the_pool(shrink, pool, tmp_path):
    """A snapshot written over 4 shards restores over the pool as it is
    now: 4 shards, or 2 after a device loss (the placements of the
    survivors' mesh)."""
    rng = np.random.default_rng(0)
    state = _state(rng)
    pool(4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, extra={"tick": 3})
    if shrink:
        popshard.set_device_limit(2)
    mesh = popshard.pop_mesh(CPU)
    assert mesh.shape["pop"] == (2 if shrink else 4)
    got, extra = mgr.restore(state, 3, shardings=_placements(mesh))
    assert extra == {"tick": 3}
    _assert_placed(got, state, mesh)
    # rows that do not split over the pool are refused
    popshard.set_device_limit(3)
    with pytest.raises(ValueError, match="do not split"):
        mgr.restore(state, 3, shardings=_placements(popshard.pop_mesh(CPU)))


def test_sharded_restore_cross_reads_reference_files(pool, tmp_path):
    rng = np.random.default_rng(1)
    state = _state(rng)
    RefManager(str(tmp_path)).save(5, state, extra={"k": 4})
    pool(2)
    mesh = popshard.pop_mesh(CPU)
    got, extra = CheckpointManager(str(tmp_path)).restore(
        state, 5, shardings=_placements(mesh))
    assert extra == {"k": 4}
    _assert_placed(got, state, mesh)
    with pytest.raises(ValueError, match="placements"):
        CheckpointManager(str(tmp_path)).restore(
            state, 5, shardings={"parts": popshard.replicated(mesh)})
