"""Port parity of the artificial device-memory budget
(``REPRO_DEVICE_MEM_BUDGET``) on the single-device path.

Both packages check the structure bytes of a level against the knob at
the population LP and FM dispatches (``enforce_structure_budget(hga,
1)``).  Below the level's bytes both raise ``DeviceBudgetExceeded`` with
the same message (so at the same level); unset, above the bytes, or not
a positive integer (warned once), the results are bit-equal.
"""
import warnings

import numpy as np
import pytest

from port_parity import assert_bit_equal, port_arrays, port_hg

from repro.core import popshard as jpopshard
from repro.core import refine as jrefine
from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
from repro_torch import env
from repro_torch.core import popshard, refine
from repro_torch.core.impart import ImpartConfig, impart_partition

KNOB = "REPRO_DEVICE_MEM_BUDGET"
SLICE = dict(recombination_enabled=False, mutation_enabled=False,
             final_vcycles=0)
# the knob against the finest level's structure bytes: None = unset
SETTINGS = {"unset": None, "above": 1, "below": -1, "lots": "lots",
            "zero": "0", "negative": "-5"}


def _parts(hg, k, alpha, seed, n_pad):
    rng = np.random.default_rng(seed)
    parts = np.zeros((alpha, n_pad), np.int32)
    for a in range(alpha):
        parts[a, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
            0.08)
    return parts


def _set_knob(monkeypatch, setting, nbytes):
    value = SETTINGS[setting]
    if value is None:
        monkeypatch.delenv(KNOB, raising=False)
    elif isinstance(value, int):
        monkeypatch.setenv(KNOB, str(nbytes + value))
    else:
        monkeypatch.setenv(KNOB, value)


def _run(fn):
    """(result, None) or (None, the DeviceBudgetExceeded message)."""
    try:
        return fn(), None
    except (jpopshard.DeviceBudgetExceeded,
            popshard.DeviceBudgetExceeded) as err:
        assert type(err).__name__ == "DeviceBudgetExceeded"
        return None, str(err)


@pytest.mark.parametrize("raw", [None, "1048576", "lots", "0", "-5"])
def test_budget_knob_parsing_matches_reference(raw, monkeypatch):
    """Both packages read the knob alike; a value that is not a positive
    integer warns once (per value) and checks nothing."""
    monkeypatch.setattr(env, "_WARNED", set())
    if raw is None:
        monkeypatch.delenv(KNOB, raising=False)
    else:
        monkeypatch.setenv(KNOB, raw)
    with warnings.catch_warnings(record=True) as first:
        warnings.simplefilter("always")
        got = popshard.device_mem_budget()
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        assert popshard.device_mem_budget() == got
    assert got == jpopshard.device_mem_budget()
    invalid = raw is not None and got is None
    assert len(first) == int(invalid)
    assert not again
    if invalid:
        assert KNOB in str(first[0].message)
        assert "no budget check" in str(first[0].message)


@pytest.mark.parametrize("nmodel", [1, 2])
def test_structure_bytes_equal_reference(nmodel, small_hg):
    hga = small_hg.structural_copy().arrays()
    got = popshard.structure_bytes_per_device(port_arrays(hga), nmodel)
    assert got == jpopshard.structure_bytes_per_device(hga, nmodel)
    p_pad = int(hga.pin_vertex.shape[-1])
    assert got == (2 * 4 * p_pad // nmodel + 4 * hga.n_pad
                   + 2 * 4 * hga.m_pad)


@pytest.mark.parametrize("entry", ["lp", "fm", "impart"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_budget_parity(setting, entry, small_hg, monkeypatch):
    """The knob around the finest level's bytes: below them both packages
    refuse with the same message; otherwise parts and cuts bit-equal."""
    monkeypatch.setattr(env, "_WARNED", set())
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hga = small_hg.structural_copy().arrays()
    nbytes = jpopshard.structure_bytes_per_device(hga, 1)
    _set_knob(monkeypatch, setting, nbytes)
    k = 4
    if entry == "impart":
        kw = dict(k=k, eps=0.08, alpha=2, beta=2, seed=3, lp_iters=4,
                  **SLICE)
        want, want_err = _run(lambda: ref_impart(
            small_hg.structural_copy(), RefConfig(**kw)))
        got, got_err = _run(lambda: impart_partition(
            port_hg(small_hg), ImpartConfig(**kw), device="cpu"))
        if want is not None and got is not None:
            assert got.cut == want.cut
            assert got.population_cuts == want.population_cuts
            assert_bit_equal(got.part, want.part, "part")
    else:
        parts = _parts(small_hg, k, 3, seed=5, n_pad=hga.n_pad)
        ref_fn, port_fn = {
            "lp": (jrefine.lp_refine_population, refine.lp_refine_population),
            "fm": (jrefine.fm_refine_population,
                   refine.fm_refine_population)}[entry]
        opts = dict(max_iters=4) if entry == "lp" else dict(max_passes=2)
        want, want_err = _run(lambda: ref_fn(hga, parts.copy(), k, 0.08,
                                             shard="off", **opts))
        got, got_err = _run(lambda: port_fn(port_arrays(hga), parts.copy(),
                                            k, 0.08, **opts))
        if want is not None and got is not None:
            assert_bit_equal(got[1], want[1], "cuts")
            assert_bit_equal(got[0], want[0], "parts")
    assert got_err == want_err
    if setting == "below":
        assert f"structure needs {nbytes} bytes/device" in got_err
    else:
        assert got_err is None
