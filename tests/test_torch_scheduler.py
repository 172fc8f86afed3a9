"""The port's operator scheduler (``repro_torch.core.scheduler``) and the
bandit-scheduled driver, against the reference on the CPU.

* ``OperatorScheduler`` is a numpy copy: the same seeds and the same
  scripted ``choose``/``observe`` sequence give the same decisions,
  ``state_dict`` and trace JSON in both packages, under both policies.
* Replay is the bandit's contract: under host coarsening with mutation
  off, every arm is a dispatch that is bit-equal between the packages,
  so a reference trace replayed in the port gives the reference's arm
  sequence and partition bit for bit.  With mutation on, the port's
  cohort hierarchy draws its own jitter (ROADMAP queue 3), so the replay
  is held to the arm sequence.
"""
import json
import warnings
import zlib

import numpy as np
import pytest

from port_parity import assert_bit_equal, port_hg

from repro.core import scheduler as ref_sched
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
from repro_torch.core import scheduler as sched_mod
from repro_torch.core.impart import ImpartConfig, impart_partition
from repro_torch.core.scheduler import (OperatorScheduler, SchedulerTrace,
                                        resolve_sched, sched_path,
                                        sched_prng_seed)

K = 4


def _hg(n=120, m=240, seed=1):
    """The reference scheduler tests' 120-vertex instance."""
    rng = np.random.default_rng(seed)
    edges = [rng.choice(n, size=int(rng.integers(2, 5)), replace=False)
             for _ in range(m)]
    return RefHypergraph.from_edge_lists(edges, n=n)


def _kw(**kw):
    out = dict(k=K, eps=0.10, alpha=3, beta=2, seed=0, final_vcycles=0)
    out.update(kw)
    return out


def _script(sch, menu, steps=12):
    """A fixed choose/observe sequence over a few contexts; the rewards
    depend on the step only, so both packages see the same outcomes."""
    arms = []
    for i in range(steps):
        level, phase = i % 3, i % 2
        arm = sch.choose(level, phase, menu)
        sch.observe(level, phase, arm, improvement=float((i * 7) % 5),
                    wall_s=0.25 + 0.125 * (i % 4))
        arms.append(arm)
    return arms


@pytest.mark.parametrize("policy", sched_mod.POLICIES)
def test_scheduler_matches_reference(policy):
    assert sched_mod.ARMS == ref_sched.ARMS
    assert sched_mod.REFINE_ARMS == ref_sched.REFINE_ARMS
    assert sched_mod.SCHED_VCYCLE_PHASE == ref_sched.SCHED_VCYCLE_PHASE
    ours = OperatorScheduler(seed=11, policy=policy, epsilon=0.5)
    theirs = ref_sched.OperatorScheduler(seed=11, policy=policy, epsilon=0.5)
    menu = list(sched_mod.ARMS)
    assert _script(ours, menu) == _script(theirs, menu)
    assert ours.state_dict() == theirs.state_dict()
    assert (json.dumps(ours.trace.to_json())
            == json.dumps(theirs.trace.to_json()))
    assert ours.trace.histogram() == theirs.trace.histogram()
    # a trace written by either package loads in the other
    wire = json.loads(json.dumps(theirs.trace.to_json()))
    assert SchedulerTrace.from_json(wire).to_json() == wire
    assert ref_sched.SchedulerTrace.from_json(
        ours.trace.to_json()).to_json() == wire


@pytest.mark.parametrize("policy", sched_mod.POLICIES)
def test_state_roundtrip_and_replay(policy):
    menu = list(sched_mod.ARMS)
    a = OperatorScheduler(seed=3, policy=policy)
    _script(a, menu, steps=6)
    b = OperatorScheduler.from_state(json.loads(json.dumps(a.state_dict())))
    assert b.state_dict() == a.state_dict()
    assert _script(a, menu, steps=6) == _script(b, menu, steps=6)
    # replay returns the logged arms and refuses a different context
    rep = OperatorScheduler(replay=a.trace)
    for d in a.trace.decisions:
        assert rep.replay_pending(d.level, d.phase)
        assert rep.choose(d.level, d.phase, menu) == d.arm
    with pytest.raises(RuntimeError, match="exhausted"):
        rep.choose(0, 0, menu)
    rep = OperatorScheduler(replay=a.trace)
    with pytest.raises(RuntimeError, match="divergence"):
        rep.choose(99, 0, menu)


def test_sched_env_routing(monkeypatch):
    monkeypatch.delenv("REPRO_SCHED", raising=False)
    assert sched_path() == "static"
    monkeypatch.setenv("REPRO_SCHED", "bandit")
    assert sched_path() == "bandit"
    assert resolve_sched(None) == "bandit"
    assert resolve_sched("auto") == "bandit"
    assert resolve_sched("static") == "static"
    with pytest.raises(ValueError, match="unknown sched path"):
        resolve_sched("roundrobin")
    monkeypatch.setenv("REPRO_SCHED", "bandit-port")
    with pytest.warns(UserWarning, match="REPRO_SCHED"):
        assert sched_path() == "static"
    with warnings.catch_warnings():          # once per value
        warnings.simplefilter("error")
        assert sched_path() == "static"
    with pytest.raises(ValueError, match="sched"):
        ImpartConfig(k=2, sched="roundrobin")
    with pytest.raises(ValueError, match="sched_policy"):
        ImpartConfig(k=2, sched_policy="thompson")


def test_sched_seed_env(monkeypatch):
    monkeypatch.delenv("REPRO_SCHED_SEED", raising=False)
    base = sched_prng_seed(7)
    assert base == ref_sched.sched_prng_seed(7) == zlib.crc32(b"sched:7")
    assert base != sched_prng_seed(8)
    monkeypatch.setenv("REPRO_SCHED_SEED", "12345")
    assert sched_prng_seed(7) == zlib.crc32(b"sched:12345")
    monkeypatch.setenv("REPRO_SCHED_SEED", "not-an-int-port")
    with pytest.warns(UserWarning, match="REPRO_SCHED_SEED"):
        assert sched_prng_seed(7) == base


@pytest.fixture(scope="module")
def ref_trace():
    """A reference bandit run (host coarsening, mutation off, one final
    V-cycle) and its trace after a JSON round-trip."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_COARSEN_PATH", "host")
    try:
        hg = _hg(seed=2)
        kw = _kw(sched="bandit", seed=5, final_vcycles=1,
                 mutation_enabled=False)
        live = ref_impart(hg, RefConfig(**kw))
    finally:
        mp.undo()
    return hg, kw, live, json.loads(json.dumps(live.sched_trace.to_json()))


def test_port_replays_reference_trace_bit_equal(ref_trace, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hg, kw, live, wire = ref_trace
    got = impart_partition(port_hg(hg), ImpartConfig(
        sched_replay=SchedulerTrace.from_json(wire), **kw), device="cpu")
    assert got.sched_trace.arm_sequence() == live.sched_trace.arm_sequence()
    assert [(d.level, d.phase) for d in got.sched_trace.decisions] == \
        [(d.level, d.phase) for d in live.sched_trace.decisions]
    assert got.sched_trace.final_vcycles == live.sched_trace.final_vcycles
    assert got.cut == live.cut
    assert got.population_cuts == live.population_cuts
    assert_bit_equal(got.part, live.part)
    assert [t[2] for t in got.trace] == [t[2] for t in live.trace]


def test_port_replays_reference_trace_with_mutation(monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hg = _hg(seed=2)
    kw = _kw(sched="bandit", seed=5, final_vcycles=1)
    live = ref_impart(hg, RefConfig(**kw))
    assert "mutate" in live.sched_trace.arm_sequence()
    wire = json.loads(json.dumps(live.sched_trace.to_json()))
    got = impart_partition(port_hg(hg), ImpartConfig(
        sched_replay=SchedulerTrace.from_json(wire), **kw), device="cpu")
    assert got.sched_trace.arm_sequence() == live.sched_trace.arm_sequence()
    assert got.sched_trace.final_vcycles == live.sched_trace.final_vcycles


@pytest.fixture(scope="module")
def port_bandit_run():
    hg = port_hg(_hg(seed=2))
    kw = _kw(sched="bandit", seed=5, final_vcycles=1)
    return hg, kw, impart_partition(hg, ImpartConfig(**kw), device="cpu")


def test_port_live_then_replay_bit_identical(port_bandit_run):
    hg, kw, live = port_bandit_run
    trace = live.sched_trace
    assert trace is not None and trace.decisions
    wire = SchedulerTrace.from_json(json.loads(json.dumps(trace.to_json())))
    rep = impart_partition(hg.structural_copy(),
                           ImpartConfig(sched_replay=wire, **kw),
                           device="cpu")
    assert_bit_equal(rep.part, live.part)
    assert rep.cut == live.cut
    assert rep.sched_trace.arm_sequence() == trace.arm_sequence()
    assert rep.sched_trace.final_vcycles == trace.final_vcycles
    # the reported cut is the partition's
    lam = [len(set(live.part[hg.pins[a:b]]))
           for a, b in zip(hg.edge_offsets[:-1], hg.edge_offsets[1:])]
    assert live.cut == float(hg.edge_weights[np.asarray(lam) > 1].sum())


def test_vcycle_decisions_log_under_vcycle_phase(port_bandit_run):
    _, _, live = port_bandit_run
    phases = {d.phase for d in live.sched_trace.decisions}
    assert sched_mod.SCHED_VCYCLE_PHASE in phases
    assert all(p >= 0 or p == sched_mod.SCHED_VCYCLE_PHASE for p in phases)
    vc = [d for d in live.sched_trace.decisions
          if d.phase == sched_mod.SCHED_VCYCLE_PHASE]
    assert all(d.arm in sched_mod.REFINE_ARMS for d in vc)
    assert live.sched_trace.final_vcycles == 1


def test_reward_accounting_telescopes():
    from repro_torch.core.dcoarsen import build_hierarchy
    from repro_torch.core.initial_partition import \
        initial_partition_population
    hg = port_hg(_hg(seed=4))
    kw = _kw(sched="bandit", seed=9)
    res = impart_partition(hg, ImpartConfig(**kw), device="cpu")
    trace = res.sched_trace
    assert trace.decisions
    for d in trace.decisions:
        assert d.reward == pytest.approx(d.improvement / max(d.wall_s, 1e-9))
    hier = build_hierarchy(hg.structural_copy(), K, seed=9, device="cpu")
    top = hier.num_levels - 1
    _, init_cuts = initial_partition_population(
        hier.level_host(top), K, kw["eps"],
        seeds=[9 * 101 + i for i in range(kw["alpha"])],
        tries_per_strategy=1, hga=hier.level_arrays(top))
    total = sum(d.improvement for d in trace.decisions)
    assert total == pytest.approx(float(np.min(init_cuts)) - res.cut)
    hist = trace.histogram()
    assert sum(v["pulls"] for v in hist.values()) == len(trace.decisions)


@pytest.mark.parametrize("how", ["config", "env"])
def test_static_schedule_bit_equal_to_default(how, monkeypatch):
    """``sched="static"`` (by config or by ``REPRO_SCHED``) is the
    default program, with no scheduler trace."""
    hg = port_hg(_hg(seed=3))
    monkeypatch.delenv("REPRO_SCHED", raising=False)
    default = impart_partition(hg.structural_copy(), ImpartConfig(**_kw()),
                               device="cpu")
    if how == "env":
        monkeypatch.setenv("REPRO_SCHED", "static")
        res = impart_partition(hg.structural_copy(), ImpartConfig(**_kw()),
                               device="cpu")
    else:
        res = impart_partition(hg.structural_copy(),
                               ImpartConfig(sched="static", **_kw()),
                               device="cpu")
    assert default.sched_trace is None and res.sched_trace is None
    assert_bit_equal(res.part, default.part)
    assert res.cut == default.cut
    assert res.trace == default.trace
