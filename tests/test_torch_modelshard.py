"""Port parity of the model axis (``model_shard``, DESIGN.md §15): the
pin tables split into row blocks over the mesh's "model" axis, the
pin-level sums added over the blocks, the shard-local contraction.

The port of ``tests/test_model_shard.py``, its 13 functions one for one.
Its two subprocess lanes (8 forced host devices with a model axis of 2)
run in-process here over ``popshard.set_logical_shards(8)`` with
``REPRO_POP_MESH_MODEL=2``, a 4 x 2 grid of logical shards of the CPU.
Bars:

* routing, config validation, the budget knob and the mesh cache behave
  as the reference's;
* integer weights: every route of the grid is bit-equal to the
  reference's ``off`` run (parts and cuts), and the sharded contraction
  builds the replicated engine's hierarchy bit for bit (every level's
  leaves, partitions and ``ew_pop``);
* fractional member weights (mutation's ``w * (1 + 0.1 * C)``): the
  reference's own grid avoids them, since the blocks' partial sums round
  in another order; the model route's gains and cuts of one population
  hold to ``off``'s within rtol 1e-6;
* the giant-instance OOM claim at a reduced size (the n = 10**6 run is
  the chip script's): unsharded raises ``DeviceBudgetExceeded``, sharded
  completes, and its cut is the partition's recomputed cut.
"""
import types

import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays, port_hg

from repro.core import popshard as jpopshard
from repro.core import refine as jrefine
from repro.data import hypergraphs as jdata
from repro_torch.core import metrics, popshard, refine
from repro_torch.core.dcoarsen import build_hierarchy, population_coarsen
from repro_torch.core.impart import ImpartConfig
from repro_torch.core.vcycle import vcycle_population
from repro_torch.data.hypergraphs import giant_netlist


@pytest.fixture
def grid42(monkeypatch):
    """The CPU pool as 8 logical shards in a (pop 4, model 2) grid;
    restored after."""
    monkeypatch.setenv("REPRO_POP_MESH_MODEL", "2")
    popshard.set_logical_shards(8, CPU)
    yield popshard.pop_mesh(CPU)
    popshard.set_logical_shards(None)
    popshard.set_device_limit(None)


def _netlist(n, m, seed, modules=8):
    return jdata._modular_netlist(n, m, seed=seed, n_modules=modules,
                                  p_local=0.8, fanout_tail=1.5)


def _population(hg, k, eps, alpha, seed, n_pad=None):
    rng = np.random.default_rng(seed)
    out = np.zeros((alpha, n_pad or hg.n), np.int32)
    for a in range(alpha):
        out[a, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
            eps)
    return out


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def test_resolve_model_rejects_unknown():
    with pytest.raises(ValueError, match="unknown model shard"):
        popshard.resolve_model("pod")
    assert popshard.resolve_model("MESH ") == "mesh"
    assert popshard.resolve_model("off") == "off"
    assert popshard.resolve_model("auto") in popshard.MODEL_SHARD_PATHS
    assert popshard.resolve_model(None) in popshard.MODEL_SHARD_PATHS
    assert popshard.MODEL_SHARD_PATHS == jpopshard.MODEL_SHARD_PATHS


def test_model_env_routing(monkeypatch):
    for p in popshard.MODEL_SHARD_PATHS:
        monkeypatch.setenv("REPRO_MODEL_SHARD", p)
        assert popshard.model_shard_path() == p
        assert popshard.resolve_model(None) == p
    monkeypatch.setenv("REPRO_MODEL_SHARD", "bogus")  # invalid -> auto
    assert popshard.model_shard_path() == "off"       # auto = off (§15)
    monkeypatch.delenv("REPRO_MODEL_SHARD", raising=False)
    assert popshard.model_shard_path() == "off"


def test_model_axis_active_eligibility():
    # a stub mesh isolates the rule from the pool's device count
    assert popshard.model_axis_active(
        1024, types.SimpleNamespace(shape={"model": 2}))
    assert not popshard.model_axis_active(        # axis of 1 is inert
        1024, types.SimpleNamespace(shape={"model": 1}))
    assert not popshard.model_axis_active(        # indivisible p_pad
        1023, types.SimpleNamespace(shape={"model": 2}))


def test_configs_validate_model_shard():
    with pytest.raises(ValueError, match="unknown model_shard"):
        ImpartConfig(k=4, model_shard="pod")
    assert ImpartConfig(k=4, model_shard="MESH").model_shard == "mesh"
    assert ImpartConfig(k=4).model_shard is None


# --------------------------------------------------------------------------
# artificial device-memory budget
# --------------------------------------------------------------------------
def test_budget_knob_parsing(monkeypatch):
    monkeypatch.delenv("REPRO_DEVICE_MEM_BUDGET", raising=False)
    assert popshard.device_mem_budget() is None
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "1048576")
    assert popshard.device_mem_budget() == 1048576
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "lots")
    assert popshard.device_mem_budget() is None
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "-3")
    assert popshard.device_mem_budget() is None


def test_structure_bytes_accounting(tiny_hg):
    hga = port_arrays(tiny_hg.arrays())
    p_pad, n_pad, m_pad = hga.p_pad, hga.n_pad, hga.m_pad
    full = popshard.structure_bytes_per_device(hga, 1)
    assert full == 2 * 4 * p_pad + 4 * n_pad + 2 * 4 * m_pad
    half = popshard.structure_bytes_per_device(hga, 2)
    # only the pin tables shard; the replicated leaves don't shrink
    assert full - half == 4 * p_pad
    assert half == jpopshard.structure_bytes_per_device(tiny_hg.arrays(), 2)


def test_budget_enforced_on_replicated_dispatch(tiny_hg, monkeypatch):
    hga = port_arrays(tiny_hg.arrays())
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "64")
    with pytest.raises(popshard.DeviceBudgetExceeded, match="bytes/device"):
        popshard.enforce_structure_budget(hga, 1)
    rng = np.random.default_rng(0)
    parts = [jrefine.rebalance(tiny_hg.vertex_weights,
                               rng.integers(0, 2, tiny_hg.n).astype(np.int32),
                               2, 0.1) for _ in range(2)]
    for shard in ("off", "mesh"):
        with pytest.raises(popshard.DeviceBudgetExceeded):
            refine.lp_refine_population(hga, [p.copy() for p in parts],
                                        2, 0.1, max_iters=1, shard=shard)
    # a budget above the instance is a no-op
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", str(1 << 30))
    popshard.enforce_structure_budget(hga, 1)


# --------------------------------------------------------------------------
# mesh cache: keyed per (pool token, model-axis size)
# --------------------------------------------------------------------------
def test_pop_mesh_cache_key_carries_model_size(monkeypatch):
    monkeypatch.delenv("REPRO_POP_MESH_MODEL", raising=False)
    m1 = popshard.pop_mesh(CPU)
    assert (popshard._pool_token(CPU), 1) in popshard._MESH_CACHE
    assert popshard.pop_mesh(CPU) is m1          # cached
    # an indivisible model-axis request falls back to 1 and reuses the
    # same cache entry, not a mesh per bogus size
    ndev = len(popshard.local_devices(CPU))
    monkeypatch.setenv("REPRO_POP_MESH_MODEL", str(2 * ndev + 1))
    assert popshard.pop_mesh(CPU) is m1


def test_pop_mesh_rebuilds_on_model_axis_and_pool_change(monkeypatch):
    """The regression the reference runs on 8 forced devices, here on 8
    logical shards: a cache keyed on the bare device count would serve a
    stale (8, 1) mesh after ``REPRO_POP_MESH_MODEL=2`` or a device loss."""
    monkeypatch.delenv("REPRO_POP_MESH_MODEL", raising=False)
    popshard.set_logical_shards(8, CPU)
    try:
        m0 = popshard.pop_mesh(CPU)
        monkeypatch.setenv("REPRO_POP_MESH_MODEL", "2")
        m1 = popshard.pop_mesh(CPU)              # mid-run axis change
        popshard.set_device_limit(4)             # mid-run pool change
        m2 = popshard.pop_mesh(CPU)
    finally:
        popshard.set_device_limit(None)
        popshard.set_logical_shards(None)
    assert m0.shape == {"pop": 8, "model": 1}
    assert m1.shape == {"pop": 4, "model": 2}
    assert m2.shape == {"pop": 2, "model": 2}
    assert len({id(m0), id(m1), id(m2)}) == 3


# --------------------------------------------------------------------------
# sharded contraction parity over the (4, 2) grid
# --------------------------------------------------------------------------
def _hier_leaves(hier):
    out = []
    for li in range(hier.num_levels):
        hga = hier.level_arrays(li)
        out.append(tuple(np.asarray(x) if not torch.is_tensor(x)
                         else x.numpy() for x in (
            hga.pin_vertex, hga.pin_edge, hga.vertex_weights,
            hga.edge_weights, hga.edge_sizes, hga.n, hga.m)))
    return out


@pytest.mark.parametrize("restrict", [False, True])
def test_device_coarsen_model_parity(small_hg, restrict, grid42):
    """The device engine's hierarchy of n 600 (at least two contracted
    levels) with the sharded contraction over "model": bit-equal to the
    replicated engine at every level, ghosts included."""
    hg = port_hg(small_hg)
    part = None
    if restrict:
        rng = np.random.default_rng(2)
        part = rng.integers(0, 4, small_hg.n).astype(np.int32)
    kw = dict(seed=3, restrict_part=part, path="device",
              contraction_limit_factor=16, device=CPU)
    base = build_hierarchy(hg, 8, model_shard="off", **kw)
    got = build_hierarchy(hg, 8, model_shard="mesh", **kw)
    assert got.num_levels == base.num_levels >= 3
    for lb, lg in zip(_hier_leaves(base), _hier_leaves(got)):
        for a, b in zip(lb, lg):
            np.testing.assert_array_equal(a, b)


def test_population_coarsen_model_parity(small_hg, grid42):
    """The mutation cohort's shared hierarchy (members that agree on
    most vertices, so it coarsens over several levels) with the sharded
    contraction: every level's structure, partitions and real-valued
    ``ew_pop`` bit-equal to the replicated engine's (the rows ride the
    replicated edge map)."""
    k, alpha = 4, 3
    hg = port_hg(small_hg)
    rng = np.random.default_rng(5)
    base = (np.arange(hg.n) * k // hg.n).astype(np.int32)
    parts = np.stack([np.where(rng.random(hg.n) < 0.02,
                               rng.integers(0, k, hg.n), base)
                      for _ in range(alpha)]).astype(np.int32)
    w_pop = np.stack([
        small_hg.edge_weights * (1.0 + 0.1 * rng.integers(0, 3, small_hg.m))
        for _ in range(alpha)]).astype(np.float32)
    kw = dict(seed=7, contraction_limit_factor=8, device=CPU)
    base = population_coarsen(hg, parts, w_pop, k, model_shard="off", **kw)
    got = population_coarsen(hg, parts, w_pop, k, model_shard="mesh", **kw)
    assert got.num_levels == base.num_levels >= 4
    for lb, lg in zip(base.levels, got.levels):
        assert_bit_equal(lg.hga.pin_vertex, lb.hga.pin_vertex)
        assert_bit_equal(lg.hga.pin_edge, lb.hga.pin_edge)
        assert_bit_equal(lg.parts, lb.parts)
        assert_bit_equal(lg.ew_pop, lb.ew_pop)


# --------------------------------------------------------------------------
# acceptance bar: the parity grid over a real model axis (pop 4 x model 2)
# --------------------------------------------------------------------------
def test_model_mesh_parity_grid_8_devices(grid42):
    """Both tiers of 4 members over every (pop route, model route) of the
    (4, 2) grid: parts and cuts bit-equal to the reference's ``off`` run
    on one device; ``vcycle_population`` with integer-valued member
    weights under both mutation paths and both pop routes, the model
    route on: every level's leaves, ``ew_pop`` and the result bit-equal
    to the port's replicated run (the device coarsener's jitter is the
    port's own, so the reference's hierarchy differs).  Fractional
    member rows: one population's gains and cuts on the model route hold
    to ``off``'s within rtol 1e-6 (the blocks' partials of non-integer
    weights round in another order, so whole trajectories may part)."""
    assert grid42.shape == {"pop": 4, "model": 2}
    hg = _netlist(150, 200, 11)
    jh = hg.arrays()
    hga = port_arrays(jh)
    k, eps, alpha = 8, 0.08, 4
    parts = _population(hg, k, eps, alpha, seed=3)
    want = jrefine.refine_population(jh, [p.copy() for p in parts], k, eps,
                                     max_iters=4, shard="off",
                                     model_shard="off")
    for pop in ("off", "chunk", "mesh"):
        for model in (None, "mesh"):
            got = refine.refine_population(hga, parts, k, eps, max_iters=4,
                                           shard=pop, model_shard=model,
                                           device=CPU)
            assert_bit_equal(got[0], want[0], f"{pop}/{model} parts")
            assert_bit_equal(got[1], want[1], f"{pop}/{model} cuts")

    rng = np.random.default_rng(3)
    hg_p = port_hg(hg)
    w_pop = np.stack([hg.edge_weights * rng.integers(1, 4, hg.m)
                      for _ in range(3)]).astype(np.float32)
    mp = np.stack([parts[0]] * 3)
    base = vcycle_population(hg_p, mp, w_pop, k, eps, seed=9, shard="off",
                             model_shard="off", device=CPU)
    for mutate in ("batch", "loop"):
        for pop in ("off", "mesh"):
            got = vcycle_population(hg_p, mp, w_pop, k, eps, seed=9,
                                    shard=pop, model_shard="mesh",
                                    path=mutate, device=CPU)
            for g, b in zip(got, base):
                assert_bit_equal(g, b, f"vcycle {mutate}/{pop}")

    ew = np.zeros((alpha, hga.m_pad), np.float32)
    ew[:, : hg.m] = hg.edge_weights * (1.0 + 0.1 * rng.integers(
        0, 4, (alpha, hg.m)))
    ew_t = torch.from_numpy(ew)
    rows = torch.from_numpy(refine.pad_parts(parts, hga.n_pad).numpy())
    blocks = popshard.model_put_cached(hga, grid42)[1]
    off = refine._Level(hga, ew_t)
    mod = refine._Level(blocks[0], ew_t, pin_axis=blocks)
    np.testing.assert_allclose(mod.gains(rows, k).numpy(),
                               off.gains(rows, k).numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mod.cuts(rows, k).numpy(),
                               off.cuts(rows, k).numpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# OOM regression: the giant instance the model axis exists for, reduced
# --------------------------------------------------------------------------
def test_giant_netlist_equals_reference():
    got = giant_netlist(20_000, 26_000, seed=5)
    want = jdata.giant_netlist(20_000, 26_000, seed=5)
    for f in ("pins", "edge_offsets", "vertex_weights", "edge_weights"):
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    assert (got.n, got.m) == (want.n, want.m)


def test_giant_instance_oom_unsharded_completes_sharded(grid42, monkeypatch):
    """``giant_netlist`` at n 20,000 (the chip script runs n 10**6) with
    the budget between its 1-way and 2-way structure bytes: the
    replicated mesh dispatch raises, the model route completes, and the
    reported cut is the partition's recomputed cut, no worse than the
    warm start's."""
    hg = giant_netlist(20_000, 26_000, seed=5)
    hga = hg.arrays(device=CPU)
    one = popshard.structure_bytes_per_device(hga, 1)
    two = popshard.structure_bytes_per_device(hga, 2)
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", str((one + two) // 2))
    k, eps = 8, 0.05
    # block warm start: balanced by construction (unit weights)
    base = (np.arange(hg.n, dtype=np.int64) * k // hg.n).astype(np.int32)
    parts = [base.copy(), np.roll(base, 1)]
    with pytest.raises(popshard.DeviceBudgetExceeded):
        refine.lp_refine_population(hga, [p.copy() for p in parts], k, eps,
                                    max_iters=1, shard="mesh",
                                    model_shard="off")
    out, cuts = refine.lp_refine_population(
        hga, [p.copy() for p in parts], k, eps, max_iters=1, shard="mesh",
        model_shard="mesh")
    want = float(metrics.cutsize(hga, out[0], k))
    assert float(cuts[0]) == want
    assert want <= float(metrics.cutsize(
        hga, refine.pad_part(base, hga.n_pad), k))
