"""Port parity of the partition service (DESIGN.md §12): the
``REPRO_SERVE_*`` parsers, ``PartitionService`` against its own
``solve_solo`` and against the reference's service, the slot reset, the
coalesce window, the bandit service, and the options of later slices.

The bar is bit equality: under host coarsening both packages build the
same hierarchies, every weight is integer-valued f32 (so every sum is
exact in any order), and the service's answer for each request equals
its solo run in the port and the reference service's answer.  Cold and
incremental requests (an incumbent and a ``migration_frac``) share one
service.  Sizes are the reference's own test sizes
(``request_stream(4, scale=0.35)``: n 140-315, alpha 2, lp_iters 4).
The bandit service's rewards are dispatch walls, so it is held to
structure only, as in the reference.
"""
import os
import time
import warnings

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_hg

import repro.env as jenv
from repro.data import hypergraphs as jdata
from repro.serve import partition_service as jsvc
import repro_torch.env as tenv
from repro_torch.core.scheduler import OperatorScheduler
from repro_torch.serve import partition_service as tsvc
from repro_torch.serve.partition_service import (PartitionRequest,
                                                 PartitionService)

ALPHA, LP_ITERS = 2, 4
# incremental requests of the mixed stream: index -> migration_frac
INCREMENTAL = {1: None, 3: 0.1}


@pytest.fixture(scope="module", autouse=True)
def _host_coarsening():
    """Both packages coarsen on the host (the port's hierarchies are
    then bit-equal to the reference's)."""
    old = os.environ.get("REPRO_COARSEN_PATH")
    os.environ["REPRO_COARSEN_PATH"] = "host"
    yield
    if old is None:
        del os.environ["REPRO_COARSEN_PATH"]
    else:
        os.environ["REPRO_COARSEN_PATH"] = old


def _svc(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("alpha", ALPHA)
    kw.setdefault("lp_iters", LP_ITERS)
    kw.setdefault("device", "cpu")
    return PartitionService(**kw)


@pytest.fixture(scope="module")
def stream():
    """The reference test's stream, with the incremental requests'
    incumbents: the port's cold answer of the same request under
    another seed, shared by both packages."""
    reqs = jdata.request_stream(4, tag="svc-test", scale=0.35)
    for i, r in enumerate(reqs):
        r["mine"] = port_hg(r["hg"])
        r["seed"] = i
        if i in INCREMENTAL:
            part, _ = _svc().solve_solo(PartitionRequest(
                name="incumbent", hg=r["mine"], k=r["k"], eps=r["eps"],
                seed=7))
            r["incumbent"] = np.asarray(part, np.int32)
            r["migration_frac"] = INCREMENTAL[i]
    return reqs


def _req(r, cls=PartitionRequest, port=True, **kw):
    extra = {}
    if "incumbent" in r:
        extra = dict(incumbent=r["incumbent"].copy(),
                     migration_frac=r["migration_frac"])
    extra.update(kw)
    return cls(name=r["name"], hg=r["mine"] if port else r["hg"], k=r["k"],
               eps=r["eps"], seed=r["seed"], **extra)


@pytest.fixture(scope="module")
def served(stream):
    """The port's service and the reference's, each fed the whole mixed
    stream through 2 slots (later arrivals join mid-flight)."""
    mine = _svc()
    theirs = jsvc.PartitionService(slots=2, alpha=ALPHA, lp_iters=LP_ITERS)
    for r in stream:
        mine.submit(_req(r))
        theirs.submit(_req(r, jsvc.PartitionRequest, port=False))
    mine.drain()
    theirs.drain()
    return mine, theirs


# --------------------------------------------------------------------------
# REPRO_SERVE_* parsers: the reference's value and warning
# --------------------------------------------------------------------------
PARSER_CASES = [
    ("serve_slots", "REPRO_SERVE_SLOTS", v) for v in (None, "3", "0", "many")
] + [
    ("serve_buckets", "REPRO_SERVE_BUCKETS", v)
    for v in (None, "auto", "", "4096,1024", "big,bigger", "0,-4,1024")
] + [
    ("serve_coalesce_s", "REPRO_SERVE_COALESCE_MS", v)
    for v in (None, "250", "-5", "soon")
] + [
    ("serve_deadline_s", "REPRO_SERVE_DEADLINE_S", v)
    for v in (None, "2.5", "0", "-1", "whenever")
] + [
    ("serve_max_queue", "REPRO_SERVE_MAX_QUEUE", v)
    for v in (None, "7", "-3", "lots")
] + [
    ("serve_ckpt_every", "REPRO_SERVE_CKPT_EVERY", v)
    for v in (None, "4", "-2", "often")
] + [
    ("serve_ckpt_dir", "REPRO_SERVE_CKPT_DIR", v)
    for v in (None, "", " /srv/ckpt ")
]


def _parse(module, name):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = getattr(module, name)()
    return value, [str(w.message) for w in caught]


@pytest.mark.parametrize("name,var,raw", PARSER_CASES)
def test_serve_parsers_equal_reference(name, var, raw, monkeypatch):
    # the warn-once memories of both packages start empty
    monkeypatch.setattr(jenv, "_WARNED", set())
    monkeypatch.setattr(tenv, "_WARNED", set())
    if raw is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, raw)
    got, got_warn = _parse(tsvc, name)
    want, want_warn = _parse(jsvc, name)
    assert got == want
    assert got_warn == want_warn
    # and only once per (variable, value)
    assert _parse(tsvc, name) == (want, [])


def test_status_constants_equal_reference():
    names = [n for n in dir(jsvc) if n.startswith("STATUS_")]
    assert len(names) == 6
    assert {n: getattr(tsvc, n) for n in names} == \
        {n: getattr(jsvc, n) for n in names}


def test_bucket_sizes_must_be_positive():
    with pytest.raises(ValueError, match="must be > 0"):
        _svc(buckets=(0, 1024))


# --------------------------------------------------------------------------
# the batching contract: service == solo == the reference's service
# --------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(4))
def test_service_equals_solo_and_reference(stream, served, i):
    mine, theirs = served
    r = stream[i]
    got, ref = mine.results[r["name"]], theirs.results[r["name"]]
    part, cut = _svc().solve_solo(_req(r))
    assert got.status == ref.status == "ok"
    assert_bit_equal(got.part, part, f"{r['name']} vs solo")
    assert got.cut == cut
    assert_bit_equal(got.part, ref.part, f"{r['name']} vs reference")
    assert got.cut == ref.cut
    assert got.migration_weight == ref.migration_weight
    assert got.latency_s >= 0.0
    if i in INCREMENTAL:
        vw = np.asarray(r["hg"].vertex_weights, np.float64)
        moved = float(vw[got.part != r["incumbent"]].sum())
        assert moved == got.migration_weight
        if r["migration_frac"] is not None:
            assert moved <= r["migration_frac"] * vw.sum() + 1e-6
    else:
        assert got.migration_weight is None


def test_invalid_incumbent_is_rejected(stream):
    r = stream[1]
    svc = _svc()
    res = svc.submit(_req(r, incumbent=r["incumbent"][:-1]))
    assert res.status == "rejected" and res.part is None
    assert "invalid incumbent" in res.error
    res = svc.submit(_req(r, incumbent=np.full(r["hg"].n, r["k"])))
    assert res.status == "rejected"


def test_vacated_slot_leaks_nothing(stream):
    """One slot, two occupants in turn: the slot is fully reset between
    them, and the second answer is what a fresh service gives."""
    a, b = stream[1], stream[2]
    svc = _svc(slots=1)
    svc.submit(_req(a))
    svc.drain()
    slot = svc.slots[0]
    assert not slot.occupied
    assert slot.request is None and slot.cfg is None
    assert slot.hier is None and slot.parts is None
    assert slot.li == 0 and not slot.need_project
    assert slot.incs is None and slot.buds is None
    assert slot.scheduler is None and slot.best_cut is None
    svc.submit(_req(b))
    svc.drain()
    part, cut = _svc(slots=1).solve_solo(_req(b))
    got = svc.results[b["name"]]
    assert_bit_equal(got.part, part)
    assert got.cut == cut


def test_coalesce_window_holds_then_dispatches(stream):
    svc = _svc(coalesce_ms=150.0)
    svc.submit(_req(stream[0]))
    assert svc.step() == 0          # idle engine inside the window: hold
    assert not any(s.occupied for s in svc.slots)
    time.sleep(0.16)
    while svc.busy:
        svc.step()
    assert svc.results[stream[0]["name"]].status == "ok"


def test_degraded_incremental_slot_keeps_its_budget(stream):
    """A deadline that runs out mid-flight fast-forwards an incremental
    slot with its incumbent and budget: the degraded answer stays within
    the budget."""
    r = stream[3]
    svc = _svc(slots=1, contraction_limit_factor=16)
    req = _req(r, deadline_s=3600.0)
    svc.submit(req)
    svc.step()
    s = svc.slots[0]
    assert s.occupied and s.li > 0, "graph too shallow for a mid-flight test"
    s.request.deadline_s = (time.perf_counter() - req.submitted_s) + 1e-4
    svc.step()
    res = svc.results[r["name"]]
    assert res.status == "degraded" and res.degraded
    assert res.part.shape == (r["hg"].n,)
    vw = np.asarray(r["hg"].vertex_weights, np.float64)
    moved = float(vw[res.part != r["incumbent"]].sum())
    assert moved == res.migration_weight
    assert moved <= r["migration_frac"] * vw.sum() + 1e-6


def test_bandit_service_terminal_and_scheduler_through_snapshot(stream,
                                                                tmp_path):
    """The bandit service (rewards are dispatch walls, so no bit bar):
    every request ends in a terminal state, and each slot's scheduler
    state goes through a snapshot and back unchanged."""
    svc = _svc(sched="bandit", ckpt_every=1, ckpt_dir=str(tmp_path),
               contraction_limit_factor=16)
    for r in stream[::-1]:
        svc.submit(_req(r))
    svc.step()
    items, extra = svc._latest_snapshot()
    metas = extra["slots"]
    assert len(metas) == 2, "ladders too shallow for a mid-flight snapshot"
    for idx, m in metas.items():
        live = svc.slots[int(idx)]
        assert m["name"] == live.request.name
        assert items[f"slot{idx}.parts"].shape[0] == ALPHA
        state = live.scheduler.state_dict()
        assert m["sched"]["trace"] == state["trace"]
        back = OperatorScheduler.from_state(m["sched"]).state_dict()
        assert back == m["sched"]
        assert m["best_cut"] == live.best_cut
    svc.drain()
    assert not svc.busy
    assert len(svc.results) == len(stream)
    for r in stream:
        got = svc.results[r["name"]]
        assert got.status == "ok" and got.part.shape == (r["hg"].n,)
        assert 0 <= got.part.min() and got.part.max() < r["k"]


# --------------------------------------------------------------------------
# options of later slices, and the card by default
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(shard="mesh"), dict(shard="chunk"),
                                dict(model_shard="mesh")])
def test_multi_device_options_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        _svc(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(device="cuda"),
                                dict(device="cuda:0")])
def test_service_needs_a_card_unless_asked_for_the_cpu(kw):
    """Without ``device=`` the service asks for the card, and raises where
    there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionService(slots=1, alpha=ALPHA, **kw)
