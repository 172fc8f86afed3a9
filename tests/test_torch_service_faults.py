"""Port parity of the service's fault handling (DESIGN.md §13): fault
plans, deadlines and admission control, corruption and quarantine,
crashes and stragglers, snapshots and device loss, and the chaos soak.

The contract: every request ends in a structured terminal state, and
every request that no fault left on another seed stays bit-identical to
``solve_solo``, as in the reference.  Under host coarsening with
integer weights the port's answers also equal the reference's under the
same plan, the seed-bumped restart included; the chaos soak compares
the outcome histogram, the event sequence and every partition and cut.
The straggler watchdog's reports are wall-based and stay out of the
comparison.  Sizes are the reference's (four modular netlists of n
360-480, k 3, alpha 2, lp_iters 4, ``contraction_limit_factor`` 16 for
ladders deep enough that faults land mid-flight).
"""
import dataclasses
import os
import time
import warnings

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_hg

from repro.data.hypergraphs import _modular_netlist
from repro.runtime import elastic as jelastic
from repro.serve import faults as jfaults
from repro.serve import partition_service as jsvc
from repro_torch.core import popshard
from repro_torch.runtime.elastic import (FailureInjector, restore_device_pool,
                                         simulate_device_loss)
from repro_torch.serve import faults
from repro_torch.serve import partition_service as psvc
from repro_torch.serve.partition_service import (PartitionRequest,
                                                 PartitionService)

ALPHA = 2
CLF = 16
TERMINAL = {"ok", "degraded", "rejected", "timed_out", "recovered",
            "quarantined"}
CHAOS = ("2:straggler:delay_ms=40;3:device_loss:survivors=2;"
         "4:corrupt:slot=0,mode=block_range;5:crash")


@pytest.fixture(scope="module", autouse=True)
def _host_coarsening():
    old = os.environ.get("REPRO_COARSEN_PATH")
    os.environ["REPRO_COARSEN_PATH"] = "host"
    yield
    if old is None:
        del os.environ["REPRO_COARSEN_PATH"]
    else:
        os.environ["REPRO_COARSEN_PATH"] = old


@pytest.fixture(autouse=True)
def _full_device_pool():
    # device-loss tests shrink the module-level pools; never leak that
    yield
    restore_device_pool("cpu")
    jelastic.restore_device_pool()


@pytest.fixture(scope="module")
def stream():
    out = []
    for i in range(4):
        hg = _modular_netlist(360 + 40 * i, 460 + 50 * i, seed=20 + i,
                              n_modules=5, p_local=0.8, fanout_tail=1.5)
        out.append({"name": f"svc-fault-{i}", "hg": hg, "mine": port_hg(hg),
                    "k": 3, "eps": 0.08})
    return out


def _svc(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("alpha", ALPHA)
    kw.setdefault("lp_iters", 4)
    kw.setdefault("contraction_limit_factor", CLF)
    kw.setdefault("device", "cpu")
    return PartitionService(**kw)


def _ref_svc(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("alpha", ALPHA)
    kw.setdefault("lp_iters", 4)
    kw.setdefault("contraction_limit_factor", CLF)
    return jsvc.PartitionService(**kw)


def _req(r, seed=0, **kw):
    return PartitionRequest(name=r["name"], hg=r["mine"], k=r["k"],
                            eps=r["eps"], seed=seed, **kw)


def _ref_req(r, seed=0, **kw):
    return jsvc.PartitionRequest(name=r["name"], hg=r["hg"], k=r["k"],
                                 eps=r["eps"], seed=seed, **kw)


@pytest.fixture(scope="module")
def solo(stream):
    svc = _svc()
    return {r["name"]: svc.solve_solo(_req(r, seed=i))
            for i, r in enumerate(stream)}


def _assert_solo(res, solo_pc, status="ok"):
    sp, sc = solo_pc
    assert res.status == status, (res.name, res.status)
    assert_bit_equal(res.part, sp, res.name)
    assert res.cut == sc


# --------------------------------------------------------------------------
# fault plans: the reference's events, bad specs, the env knob
# --------------------------------------------------------------------------
SPECS = [
    "2:straggler:delay_ms=80;3:device_loss:survivors=2;"
    "4:corrupt:slot=1,mode=nan_cut;5:crash",
    CHAOS,
    "3:device_loss",
    "5:crash;1:corrupt:mode=imbalance; ;2:straggler",
    "2:corrupt:slot=3,mode=block_range,",
]


def _events(plan):
    return [dataclasses.asdict(e) for e in plan.events]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_equals_reference(spec):
    got, want = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert _events(got) == _events(want)
    assert got.pending == want.pending == len(want.events)
    # each event fires once, late events on the next poll
    for tick in (1, 3, 3, 9):
        assert ([dataclasses.asdict(e) for e in got.events_for(tick)]
                == [dataclasses.asdict(e) for e in want.events_for(tick)])
    assert got.pending == want.pending == 0
    assert got.reset().pending == len(want.events)


@pytest.mark.parametrize("spec,match", [
    ("2:meteor", "unknown fault kind"), ("nonsense", "tick:kind"),
    ("2:crash:sever=9", "unknown key"), ("0:crash", ">= 1"),
    ("2:corrupt:mode=melt", "unknown corrupt mode"),
    ("x:crash", "invalid literal")])
def test_bad_fault_specs_raise_like_reference(spec, match):
    with pytest.raises(ValueError, match=match) as got:
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_fault_plan_env_warns_once(monkeypatch):
    import repro_torch.env as tenv
    monkeypatch.setattr(tenv, "_WARNED", set())
    monkeypatch.setenv("REPRO_FAULT_PLAN", "not:a:plan:at:all")
    with pytest.warns(UserWarning, match="REPRO_FAULT_PLAN"):
        assert faults.fault_plan_env() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert faults.fault_plan_env() is None
    monkeypatch.setenv("REPRO_FAULT_PLAN",
                       "2:crash;3:device_loss:survivors=1")
    plan = faults.fault_plan_env()
    assert plan is not None and plan.pending == 2
    monkeypatch.setenv("REPRO_FAULT_PLAN", " ")
    assert faults.fault_plan_env() is None


def test_failure_injector_lifts_to_fault_plan():
    sched = {3: "generic failure", 5: "straggler", 7: "nan corruption",
             9: "node loss", 11: "pod down", 13: "slow host"}
    got = FailureInjector(dict(sched)).as_fault_plan()
    want = jelastic.FailureInjector(dict(sched)).as_fault_plan()
    assert _events(got) == _events(want)
    assert [e.kind for e in got.events] == [
        "crash", "straggler", "corrupt", "device_loss", "device_loss",
        "straggler"]


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
def test_corrupt_state_equals_reference(mode):
    rng = np.random.default_rng(3)
    parts = rng.integers(0, 5, (3, 40)).astype(np.int32)
    cuts = rng.random(3) * 100
    gp, gc = faults.corrupt_state(parts, cuts, 5, mode=mode)
    wp, wc = jfaults.corrupt_state(parts, cuts, 5, mode=mode)
    assert_bit_equal(gp, wp)
    np.testing.assert_array_equal(gc, wc)
    assert gp.dtype == np.int32 and gc.dtype == np.float64
    # the inputs are never mutated
    assert parts.max() < 5 and np.isfinite(cuts).all()


def test_corrupt_state_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        faults.corrupt_state(np.zeros((1, 4), np.int32), np.zeros(1), 2,
                             mode="melt")


# --------------------------------------------------------------------------
# deadlines, admission control, load shedding
# --------------------------------------------------------------------------
def test_admission_control_rejects_over_capacity(stream):
    svc = _svc(slots=1, max_queue=2)
    assert svc.submit(_req(stream[0])) is None
    assert svc.submit(_req(stream[1])) is None
    res = svc.submit(_req(stream[2]))
    assert res is not None and res.status == "rejected"
    assert res.part is None and "queue full" in res.error
    assert svc.results[stream[2]["name"]].status == "rejected"
    assert svc.events[-1]["kind"] == "rejected"


def test_queue_timeout_sheds_structured(stream):
    svc = _svc(slots=1)
    svc.submit(_req(stream[0], max_queue_s=0.0))
    time.sleep(0.01)
    svc.step()
    res = svc.results[stream[0]["name"]]
    assert res.status == "timed_out" and res.part is None
    assert "max_queue_s" in res.error


def test_expired_deadline_sheds_from_queue(stream):
    svc = _svc(slots=1)
    svc.submit(_req(stream[0], deadline_s=1e-6))
    time.sleep(0.01)
    svc.step()
    res = svc.results[stream[0]["name"]]
    assert res.status == "timed_out" and "while queued" in res.error


def test_near_deadline_finishes_degraded():
    hg = port_hg(_modular_netlist(420, 540, seed=11, n_modules=5,
                                  p_local=0.8, fanout_tail=1.5))
    svc = _svc(slots=1)
    req = PartitionRequest(name="deep", hg=hg, k=3, seed=0,
                           deadline_s=3600.0)
    svc.submit(req)
    svc.step()
    s = svc.slots[0]
    assert s.occupied and s.li > 0, "graph too shallow for a mid-flight test"
    s.request.deadline_s = (time.perf_counter() - req.submitted_s) + 1e-4
    svc.step()
    res = svc.results["deep"]
    assert res.status == "degraded" and res.degraded
    assert res.part is not None and len(res.part) == hg.n
    assert 0 <= res.part.min() and res.part.max() < 3
    assert np.isfinite(res.cut)
    assert any(e["kind"] == "degraded" for e in svc.events)
    assert not svc.slots[0].occupied


# --------------------------------------------------------------------------
# corruption -> validation -> quarantine / recovery
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
def test_corruption_detected_and_recovered(stream, solo, mode):
    a, b = stream[0], stream[1]
    plan = faults.FaultPlan.parse(f"2:corrupt:slot=0,mode={mode}")
    svc = _svc(slots=2, ckpt_every=1, fault_plan=plan)
    svc.submit(_req(a, seed=0))
    svc.submit(_req(b, seed=1))
    svc.drain()
    faulted = {e["request"] for e in svc.events
               if e["kind"] == "corrupt_injected"}
    assert faulted, "corruption never fired"
    for r in (a, b):
        res = svc.results[r["name"]]
        _assert_solo(res, solo[r["name"]],
                     "recovered" if r["name"] in faulted else "ok")
    assert any(e["kind"] == "quarantine" for e in svc.events)


def test_seed_bumped_restart_equals_reference(stream):
    """No snapshot: the retry restarts from scratch with a bumped seed,
    the reference's bumped seed, and gives the reference's answer."""
    r = stream[0]
    spec = "2:corrupt:slot=0"
    mine = _svc(slots=1, ckpt_every=0, fault_plan=faults.FaultPlan.parse(spec))
    theirs = _ref_svc(slots=1, ckpt_every=0,
                      fault_plan=jfaults.FaultPlan.parse(spec))
    mine.submit(_req(r))
    theirs.submit(_ref_req(r))
    mine.drain()
    theirs.drain()
    got, want = mine.results[r["name"]], theirs.results[r["name"]]
    assert got.status == want.status == "recovered"
    assert_bit_equal(got.part, want.part)
    assert got.cut == want.cut
    assert 0 <= got.part.min() and got.part.max() < r["k"]


def test_repeated_corruption_quarantines_terminally(stream):
    r, r2 = stream[0], stream[1]
    plan = faults.FaultPlan(
        [faults.FaultEvent(tick=t, kind="corrupt", slot=0)
         for t in range(1, 30)])
    svc = _svc(slots=1, ckpt_every=0, fault_plan=plan)
    svc.submit(_req(r))
    svc.drain()
    res = svc.results[r["name"]]
    assert res.status == "quarantined" and res.part is None
    assert "balance cap" in res.error or "block id" in res.error
    assert not svc.slots[0].occupied
    svc.fault_plan = None
    svc.submit(_req(r2, seed=1))
    svc.drain()
    assert svc.results[r2["name"]].status == "ok"


# --------------------------------------------------------------------------
# crash + straggler injection
# --------------------------------------------------------------------------
def test_mid_tick_crash_retries_bit_identical(stream, solo):
    svc = _svc(slots=2, fault_plan=faults.FaultPlan.parse("2:crash"))
    for i, r in enumerate(stream[:2]):
        svc.submit(_req(r, seed=i))
    svc.drain()
    assert any(e["kind"] == "crash" for e in svc.events)
    for r in stream[:2]:
        _assert_solo(svc.results[r["name"]], solo[r["name"]])


def test_straggler_injection_leaves_results_unchanged(stream, solo):
    plan = faults.FaultPlan.parse("2:straggler:delay_ms=60")
    svc = _svc(slots=2, fault_plan=plan)
    svc.submit(_req(stream[0], seed=0))
    svc.drain()
    assert any(e["kind"] == "straggler_injected" for e in svc.events)
    _assert_solo(svc.results[stream[0]["name"]], solo[stream[0]["name"]])


# --------------------------------------------------------------------------
# checkpoint/restore + device loss
# --------------------------------------------------------------------------
def test_slot_snapshots_round_trip(stream, tmp_path):
    svc = _svc(slots=2, ckpt_every=1, ckpt_dir=str(tmp_path))
    svc.submit(_req(stream[0]))
    svc.step()
    items, extra = svc._latest_snapshot()
    assert items is not None
    meta = extra["slots"]["0"]
    assert meta["name"] == stream[0]["name"]
    assert meta["li"] == svc.slots[0].li
    assert meta["need_project"] is True
    assert_bit_equal(items["slot0.parts"], svc.slots[0].parts)


@pytest.mark.parametrize("ckpt_every", [1, 0])
def test_device_loss_resumes_bit_identical(stream, solo, ckpt_every):
    """Lose all but one device mid-flight: every in-flight request loses
    its device state and resumes from its snapshot (or, without one,
    restarts with its original seed), bit-identical to solo either way."""
    plan = faults.FaultPlan.parse("2:device_loss:survivors=1")
    svc = _svc(slots=2, ckpt_every=ckpt_every, fault_plan=plan)
    for i, r in enumerate(stream[:2]):
        svc.submit(_req(r, seed=i))
    svc.drain()
    losses = [e for e in svc.events if e["kind"] == "device_loss"]
    assert len(losses) == 1 and losses[0]["survivors"] == 1
    key = "resumed_from_ckpt" if ckpt_every else "restarted_from_scratch"
    assert losses[0][key] == 2
    assert losses[0]["drop_s"] >= 0.0 and losses[0]["rebuild_s"] >= 0.0
    assert losses[0]["recovery_s"] == pytest.approx(
        losses[0]["drop_s"] + losses[0]["rebuild_s"])
    assert losses[0]["allocated_before"] is None  # no card here
    assert len(popshard.local_devices("cpu")) == 1
    for r in stream[:2]:
        _assert_solo(svc.results[r["name"]], solo[r["name"]], "recovered")


def test_device_loss_drops_the_device_state(stream):
    """The drop itself: every occupied slot loses its hierarchy and
    population, and its request's cached arrays, before the resume."""
    svc = _svc(slots=2, ckpt_every=1)
    for i, r in enumerate(stream[:2]):
        svc.submit(_req(r, seed=i))
    svc.step()
    old = [(s.hier, s.hier.level_arrays(0)) for s in svc.slots]
    assert all(s.request.hg._arrays_cache for s in svc.slots)
    svc._drop_device_state()
    for s in svc.slots:
        assert s.hier is None and s.parts is None
        assert not s.request.hg._arrays_cache
    svc.fault_plan = faults.FaultPlan.parse("1:device_loss:survivors=1")
    svc.step()
    for s, (hier, hga0) in zip(svc.slots, old):
        assert s.hier is not hier
        assert s.hier.level_arrays(0) is not hga0


def test_device_loss_drops_queued_requests_arrays(stream):
    """A request still in the queue loses its cached arrays too, and is
    installed from new ones after the loss."""
    svc = _svc(slots=1, ckpt_every=1)
    for i, r in enumerate(stream[:2]):
        svc.submit(_req(r, seed=i))
    svc.step()
    queued = svc.queue[0]
    old = queued.hg.arrays(device="cpu")
    svc._drop_device_state()
    assert not queued.hg._arrays_cache
    assert queued.hg.arrays(device="cpu") is not old


def test_device_loss_moves_the_service_to_a_survivor(stream, solo,
                                                      monkeypatch):
    """When the service's own device is not among the survivors, the
    service moves to the first survivor and resumes there bit-identical
    to solo.  ``cpu:0`` stands for a lost device: it is not equal to the
    pool's ``cpu``."""
    monkeypatch.setattr(psvc, "simulate_device_loss",
                        lambda survivors, device: [torch.device("cpu")])
    svc = _svc(slots=2, ckpt_every=1,
               fault_plan=faults.FaultPlan.parse("2:device_loss"))
    svc.device = torch.device("cpu", 0)
    for i, r in enumerate(stream[:2]):
        svc.submit(_req(r, seed=i))
    svc.drain()
    assert svc.device == torch.device("cpu")
    for r in stream[:2]:
        _assert_solo(svc.results[r["name"]], solo[r["name"]], "recovered")


def test_device_pool_shrinks_and_restores():
    full = len(popshard.local_devices("cpu"))
    assert full == 1
    assert simulate_device_loss(1, "cpu") == popshard.local_devices("cpu")
    assert len(popshard.set_device_limit(0, "cpu")) == 1  # capped at 1
    assert len(restore_device_pool("cpu")) == full
    assert popshard._DEVICE_LIMIT is None


# --------------------------------------------------------------------------
# the chaos soak: all four fault kinds in one run, against the reference
# --------------------------------------------------------------------------
def _events_without_walls(svc):
    """Every event but the watchdog's wall-based ``straggler`` reports,
    without its wall-clock and memory fields."""
    drop = {"recovery_s", "drop_s", "rebuild_s", "delay_s",
            "allocated_before", "allocated_after"}
    return [{k: v for k, v in e.items() if k not in drop}
            for e in svc.events if e["kind"] != "straggler"]


def test_chaos_soak_equals_reference(stream, solo):
    mine_plan = faults.FaultPlan.parse(CHAOS)
    ref_plan = jfaults.FaultPlan.parse(CHAOS)
    mine = _svc(slots=4, ckpt_every=1, fault_plan=mine_plan)
    theirs = _ref_svc(slots=4, ckpt_every=1, fault_plan=ref_plan)
    for i, r in enumerate(stream):
        mine.submit(_req(r, seed=i))
        theirs.submit(_ref_req(r, seed=i))
    res = mine.drain()
    theirs.drain()
    assert mine_plan.pending == 0 == ref_plan.pending
    assert len(res) == len(stream) and not mine.busy
    assert mine.outcome_counts() == theirs.outcome_counts()
    assert sum(mine.outcome_counts().values()) == len(stream)
    assert _events_without_walls(mine) == _events_without_walls(theirs)
    kinds = {e["kind"] for e in mine.events}
    assert {"straggler_injected", "device_loss", "corrupt_injected",
            "quarantine", "crash"} <= kinds
    faulted = {e.get("request") for e in mine.events
               if e["kind"] in ("corrupt_injected", "quarantine")}
    for r in stream:
        got, want = mine.results[r["name"]], theirs.results[r["name"]]
        assert got.status in TERMINAL
        assert got.status == want.status
        assert_bit_equal(got.part, want.part, r["name"])
        assert got.cut == want.cut
        _assert_solo(got, solo[r["name"]], got.status)
        if got.status == "ok":
            assert r["name"] not in faulted
