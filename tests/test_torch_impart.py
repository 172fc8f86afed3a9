"""The port's slice as a whole: ``impart_partition`` with the memetic
operators off (``recombination_enabled=False, mutation_enabled=False,
final_vcycles=0``), static schedule, one device.

* Under host coarsening both packages run the same numpy hierarchy, so
  every member's partition and cut must be bit-equal.
* Under the device engine the tie-jitter bits differ (``jax.random`` vs
  ``torch.Generator``), so the matchings and hence the partitions
  differ.  As in the reference's own engine-parity test, single-seed
  cuts on this 600-vertex instance spread by about +-20%, so the check
  compares cuts averaged over three seeds: their ratio must lie within
  [0.8, 1.25].
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


@pytest.mark.parametrize("kw", [
    dict(recombination_enabled=True), dict(mutation_enabled=True),
    dict(final_vcycles=1), dict(sched="bandit"), dict(pop_shard="mesh"),
    dict(pop_shard="chunk"), dict(model_shard="mesh")],
    ids=["recombination", "mutation", "vcycle", "bandit", "pop_mesh",
         "pop_chunk", "model_mesh"])
def test_later_slice_options_raise(kw, tiny_hg):
    cfg = dict(k=2, alpha=2, **SLICE)
    cfg.update(kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        impart_partition(port_hg(tiny_hg), ImpartConfig(**cfg), device="cpu")


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
