"""The port's driver as a whole: ``impart_partition`` with the static
schedule on one device, with the memetic operators off and in its
default configuration (recombination, mutation, one final V-cycle).

* Under host coarsening both packages run the same numpy hierarchy, so
  with mutation off (recombination and the final V-cycle on or off)
  every member's partition and cut, and the trace, must be bit-equal.
* Under the device engine the tie-jitter bits differ (``jax.random`` vs
  ``torch.Generator``), so the matchings and hence the partitions
  differ.  Mutation always coarsens with the device engine, so runs
  with mutation differ the same way.  As in the reference's own
  engine-parity test, single-seed cuts on this 600-vertex instance
  spread by about +-20%, so those checks compare cuts averaged over
  three seeds: their ratio must lie within [0.8, 1.25].
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from port_parity import assert_bit_equal, port_hg

from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
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


def test_impart_device_engine_cut_within_tolerance(small_hg, monkeypatch):
    monkeypatch.setenv("REPRO_COARSEN_PATH", "device")
    cuts = {"ref": [], "port": []}
    for seed in (11, 12, 13):
        kw = dict(k=4, eps=0.08, alpha=2, beta=2, seed=seed, lp_iters=4,
                  **SLICE)
        cuts["ref"].append(ref_impart(small_hg.structural_copy(),
                                      RefConfig(**kw)).cut)
        res = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                               device="cpu")
        cuts["port"].append(res.cut)
        # balanced, and the reported cut is the partition's
        bw = np.bincount(res.part, small_hg.vertex_weights, minlength=4)
        assert bw.max() <= 1.08 * np.ceil(small_hg.vertex_weights.sum() / 4)
    ratio = np.mean(cuts["port"]) / max(np.mean(cuts["ref"]), 1e-9)
    assert 0.8 <= ratio <= 1.25, cuts


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


def test_impart_default_config_cut_within_tolerance(small_hg):
    """The reference defaults with mutation on: cuts averaged over three
    seeds within [0.8, 1.25] of the reference's, every result balanced
    and the reported cut the partition's."""
    cuts = {"ref": [], "port": []}
    for seed in (1, 2, 3):
        kw = dict(k=4, eps=0.08, alpha=3, beta=2, seed=seed, lp_iters=4)
        want = ref_impart(small_hg.structural_copy(), RefConfig(**kw))
        got = impart_partition(port_hg(small_hg), ImpartConfig(**kw),
                               device="cpu")
        assert [t[2] for t in got.trace] == [t[2] for t in want.trace]
        assert any(t[2].startswith("mutate@") for t in got.trace)
        cuts["ref"].append(want.cut)
        cuts["port"].append(got.cut)
        bw = np.bincount(got.part, small_hg.vertex_weights, minlength=4)
        assert bw.max() <= 1.08 * np.ceil(small_hg.vertex_weights.sum() / 4)
        lam = [len(set(got.part[small_hg.pins[a:b]]))
               for a, b in zip(small_hg.edge_offsets[:-1],
                               small_hg.edge_offsets[1:])]
        assert got.cut == float(small_hg.edge_weights[np.asarray(lam) > 1]
                                .sum())
    ratio = np.mean(cuts["port"]) / max(np.mean(cuts["ref"]), 1e-9)
    assert 0.8 <= ratio <= 1.25, cuts


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
def test_later_slice_options_raise(kw, tiny_hg):
    """The model axis belongs to a later slice and raises; the population
    routes are ported and, over the CPU's pool of one device, give the
    single-device run's bits."""
    cfg = dict(k=2, alpha=2, **SLICE)
    if "model_shard" in kw:
        with pytest.raises(NotImplementedError, match="later slice"):
            impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg, **kw),
                             device="cpu")
        return
    got = impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg, **kw),
                           device="cpu")
    want = impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg),
                            device="cpu")
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
