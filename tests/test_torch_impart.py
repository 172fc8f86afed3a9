"""The port's driver as a whole: ``impart_partition`` with the static
schedule on one device, with the memetic operators off and in its
default configuration (recombination, mutation, one final V-cycle).

* Under host coarsening both packages run the same numpy hierarchy, so
  with mutation off (recombination and the final V-cycle on or off)
  every member's partition and cut, and the trace, must be bit-equal.
* Under the device engine, and with mutation on, the partitions differ
  from the reference's: those cut tolerances are in
  ``tests/test_torch_impart_tolerance.py``.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_hg

from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
from repro_torch.core import popshard
from repro_torch.core.impart import ImpartConfig, impart_partition

SLICE = dict(recombination_enabled=False, mutation_enabled=False,
             final_vcycles=0)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("k", [4, 8])
def test_impart_bit_equal_under_host_coarsening(k, small_hg, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    kw = dict(k=k, eps=0.08, alpha=3, beta=2, seed=1, **SLICE)
    want = ref_impart(small_hg.structural_copy(), RefConfig(**kw))
    got = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                           device="cpu")
    assert got.levels == want.levels
    assert got.population_cuts == want.population_cuts
    assert got.cut == want.cut
    assert_bit_equal(got.part, want.part)
    assert [t[1] for t in got.trace] == [t[1] for t in want.trace]


@pytest.mark.parametrize("k", [4, 8])
def test_impart_full_config_mutation_off_bit_equal(k, small_hg,
                                                   monkeypatch):
    """Recombination at the beta thresholds and the final V-cycle, under
    host coarsening: parts, cuts and the trace bit-equal."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    kw = dict(k=k, eps=0.08, alpha=3, beta=2, seed=1, mutation_enabled=False)
    want = ref_impart(small_hg.structural_copy(), RefConfig(**kw))
    got = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                           device="cpu")
    assert got.population_cuts == want.population_cuts
    assert got.cut == want.cut
    assert_bit_equal(got.part, want.part)
    assert [t[2] for t in got.trace] == [t[2] for t in want.trace]
    assert [t[1] for t in got.trace] == [t[1] for t in want.trace]
    assert any(t[2] == "final-vcycle@0" for t in got.trace)


def test_bandit_schedule_routing(tiny_hg, monkeypatch):
    """The bandit schedule runs whether asked for by config or by
    ``REPRO_SCHED``, and returns its decision trace; an explicit
    ``sched="static"`` overrides the environment."""
    monkeypatch.delenv("REPRO_SCHED", raising=False)
    cfg = dict(k=2, alpha=2, beta=1, **SLICE)
    res = impart_partition(port_hg(tiny_hg), ImpartConfig(sched="bandit",
                                                          **cfg),
                           device="cpu")
    assert res.sched_trace is not None and res.sched_trace.decisions
    assert all(t[2].startswith("sched:") for t in res.trace[1:])
    monkeypatch.setenv("REPRO_SCHED", "bandit")
    env = impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg),
                           device="cpu")
    assert env.sched_trace.arm_sequence() == \
        res.sched_trace.arm_sequence()
    static = impart_partition(port_hg(tiny_hg),
                              ImpartConfig(sched="static", **cfg),
                              device="cpu")
    assert static.sched_trace is None


@pytest.mark.parametrize("kw", [
    dict(pop_shard="mesh"), dict(pop_shard="chunk"),
    dict(model_shard="mesh")],
    ids=["pop_mesh", "pop_chunk", "model_mesh"])
def test_shard_options_equal_off(kw, tiny_hg, monkeypatch):
    """The population routes over the CPU's pool of one device, and the
    model axis (with ``pop_shard="mesh"``) over a (2, 2) pool of logical
    shards of the CPU, give the single-device run's bits."""
    cfg = dict(k=2, alpha=2, **SLICE)
    want = impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg),
                            device="cpu")
    if "model_shard" in kw:
        kw = dict(kw, pop_shard="mesh")
        monkeypatch.setenv("REPRO_POP_MESH_MODEL", "2")
        popshard.set_logical_shards(4, "cpu")
    try:
        got = impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg, **kw),
                               device="cpu")
    finally:
        popshard.set_logical_shards(None)
    assert np.array_equal(got.part, want.part) and got.cut == want.cut


def test_budgets_fast_forward(small_hg, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    res = impart_partition(port_hg(small_hg),
                           ImpartConfig(k=4, alpha=2, level_budget=1,
                                        lp_iters=2, **SLICE), device="cpu")
    assert res.degraded and res.trace[-1][2] == "budget-exhausted"
    assert res.part.shape == (small_hg.n,)


def test_default_device_is_cuda(tiny_hg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        impart_partition(port_hg(tiny_hg), ImpartConfig(k=2, **SLICE))


def test_port_never_imports_jax_or_reference():
    """Neither the package nor chip_smoke.py imports jax or anything of
    ``repro``."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
