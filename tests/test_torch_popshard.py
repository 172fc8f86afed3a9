"""Port parity of the population axis over a pool of devices
(``repro_torch.core.popshard``, the ``mesh`` and ``chunk`` routes of
``refine``, ``instances`` and the drivers; DESIGN.md §11).

The pool is P logical shards of the CPU (``popshard.set_logical_shards``),
the counterpart of the reference's forced host devices: every route
splits, pads and exchanges as on P devices.  Bars:

* routing, the mesh, ``pad_rows``, the ring exchange and the placement
  caches behave as the reference's (``tests/test_pop_shard.py``);
* on integer weights every route at pools of 1, 2 and 4 is bit-equal to
  the reference's ``off`` route (parts and cuts), and so is
  ``impart_partition`` under host coarsening;
* on real-valued member weights (mutation's ``w * (1 + 0.1 * C)``) the
  port's routes are bit-equal to the port's ``off`` route, and hold the
  reference's cuts to rtol 1e-6 (the two packages add in other orders);
* a stacked or sharded instance is bit-equal to its solo run, drifted
  real-valued weights included (the CPU side of F5's gate);
* the model axis and the service's routes still raise.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from port_parity import CPU, assert_bit_equal, port_arrays, port_hg

from repro.core import popshard as jpopshard
from repro.core import refine as jrefine
from repro.core.impart import ImpartConfig as RefConfig
from repro.core.impart import impart_partition as ref_impart
from repro.data import hypergraphs as jdata
from repro_torch.core import instances, metrics, popshard, refine
from repro_torch.core.impart import (ImpartConfig, impart_partition,
                                     impart_partition_instances)
from repro_torch.data.hypergraphs import drift_stream
from repro_torch.serve import PartitionService

ALPHA = 5
POOLS = (1, 2, 4)
ROUTES = ("mesh", "chunk")


@pytest.fixture
def pool():
    """``pool(p)`` makes the CPU pool p logical shards; restored after."""
    yield lambda p: popshard.set_logical_shards(p, CPU)
    popshard.set_logical_shards(None)


def _population(hg, k, eps, seed, alpha=ALPHA, n_pad=None):
    rng = np.random.default_rng(seed)
    out = np.zeros((alpha, n_pad or hg.n), np.int32)
    for a in range(alpha):
        out[a, : hg.n] = jrefine.rebalance(
            hg.vertex_weights, rng.integers(0, k, hg.n).astype(np.int32), k,
            eps)
    return out


def _reweights(hg, alpha, seed, m_pad):
    rng = np.random.default_rng(seed)
    out = np.zeros((alpha, m_pad), np.float32)
    out[:, : hg.m] = hg.edge_weights * (
        1.0 + 0.1 * rng.integers(0, 4, (alpha, hg.m)))
    return out


# --------------------------------------------------------------------------
# routing, the mesh, padding
# --------------------------------------------------------------------------
def test_resolve_rejects_unknown_path():
    with pytest.raises(ValueError, match="unknown population shard"):
        popshard.resolve("pod", CPU)
    assert popshard.resolve("MESH ", CPU) == "mesh"
    assert popshard.POP_SHARD_PATHS == jpopshard.POP_SHARD_PATHS
    for shard in ("auto", None):
        assert popshard.resolve(shard, CPU) == jpopshard.resolve(shard)


def test_env_routing(monkeypatch, pool):
    for p in popshard.POP_SHARD_PATHS:
        monkeypatch.setenv("REPRO_POP_SHARD", p)
        assert popshard.pop_shard_path(CPU) == p
    monkeypatch.setenv("REPRO_POP_SHARD", "bogus")  # invalid -> auto
    with pytest.warns(UserWarning, match="REPRO_POP_SHARD"):
        assert popshard.pop_shard_path(CPU) == "off"  # one CPU device
    pool(2)
    assert popshard.pop_shard_path(CPU) == "mesh"


@pytest.mark.parametrize("p", POOLS)
def test_pop_mesh_axes(p, pool):
    """The mesh spans the pool as ("pop", "model") = (P, 1), is cached
    per pool token, and a device limit reaches it."""
    pool(p)
    mesh = popshard.pop_mesh(CPU)
    assert mesh.shape == {"pop": p, "model": 1}
    assert mesh.pop_devices == tuple(popshard.local_devices(CPU))
    assert popshard.pop_mesh(CPU) is mesh
    try:
        popshard.set_device_limit(1, CPU)
        assert popshard.pop_mesh(CPU).shape["pop"] == 1
    finally:
        popshard.set_device_limit(None, CPU)
    assert popshard.pop_mesh(CPU) is mesh


def test_pad_rows_mirrors_row_zero():
    arr = np.arange(12).reshape(3, 4)
    for x in (arr, torch.from_numpy(arr)):
        out = popshard.pad_rows(x, 4)
        assert out.shape == (4, 4)
        assert_bit_equal(out[3], arr[0])
        assert_bit_equal(out, jpopshard.pad_rows(arr, 4))
        assert popshard.pad_rows(x, 3) is x  # exact multiple: no copy


def test_impart_config_validates_pop_shard():
    with pytest.raises(ValueError, match="unknown pop_shard"):
        ImpartConfig(k=4, pop_shard="pod")
    assert ImpartConfig(k=4, pop_shard="MESH").pop_shard == "mesh"


@pytest.mark.parametrize("p", POOLS)
def test_ring_partners_matches_roll(p, pool, monkeypatch):
    """The exchange over p shards (local shift, one row to the previous
    shard) gives the host roll, and the reference's partners."""
    pool(p)
    arr = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    want = np.roll(arr, -1, axis=0)
    for route in popshard.POP_SHARD_PATHS:
        monkeypatch.setenv("REPRO_POP_SHARD", route)
        assert_bit_equal(popshard.ring_partners(arr, device=CPU), want)
        assert_bit_equal(jpopshard.ring_partners(arr), want)
    # a population the pool does not divide takes the host roll
    monkeypatch.setenv("REPRO_POP_SHARD", "mesh")
    assert_bit_equal(popshard.ring_partners(arr[:5], device=CPU),
                     np.roll(arr[:5], -1, axis=0))


# --------------------------------------------------------------------------
# placement caches
# --------------------------------------------------------------------------
def test_cap_placement_cached(tiny_hg):
    hga = port_arrays(tiny_hg.arrays())
    c1 = refine._cap_for(hga, 4, 0.1, CPU)
    assert refine._cap_for(hga, 4, 0.1, CPU) is c1
    assert refine._cap_for(hga, 8, 0.1, CPU) is not c1
    assert refine._cap_for(hga, 4, 0.1) is refine._cap_for(hga, 4, 0.1)
    assert float(c1) == float(jrefine._cap_for(tiny_hg.arrays(), 4, 0.1))


def test_hga_mesh_placement_cached(tiny_hg, pool):
    """The replicated structure ships once per (level, pool); on a shard
    of the level's own device the placement is the level itself."""
    pool(4)
    hga = port_arrays(tiny_hg.arrays())
    rep = popshard.replicated(popshard.pop_mesh(CPU))
    h1 = popshard.device_put_cached(hga, rep)
    assert popshard.device_put_cached(hga, rep) is h1
    assert len(h1) == 4 and all(h is hga for h in h1)


def test_placement_token_ignores_stale_id_entry():
    """A dead object's entry under a live object's id must not hand the
    live one the dead one's token."""
    class Obj:
        pass

    dead = Obj()
    ref = weakref.ref(dead)
    del dead
    gc.collect()
    assert ref() is None
    live = Obj()
    popshard._TOKEN_CACHE[id(live)] = (ref, -12345)
    tok = popshard.placement_token(live)
    assert tok != -12345
    assert popshard.placement_token(live) == tok


def test_placement_token_fresh_after_the_object_dies():
    """A dead object's entry leaves the token cache, and no later object
    (whatever id it gets) is handed its token."""
    class Obj:
        pass

    o1 = Obj()
    t1 = popshard.placement_token(o1)
    assert popshard.placement_token(o1) == t1
    old_id = id(o1)
    del o1
    gc.collect()
    assert old_id not in popshard._TOKEN_CACHE
    later = [Obj() for _ in range(64)]
    assert t1 not in {popshard.placement_token(o) for o in later}


# --------------------------------------------------------------------------
# the refinement tiers on every route
# --------------------------------------------------------------------------
def _netlist(n, m, seed, modules=5):
    return jdata._modular_netlist(n, m, seed=seed, n_modules=modules,
                                  p_local=0.8, fanout_tail=1.5)


@pytest.fixture(scope="module")
def refine_case():
    hg = _netlist(240, 320, 3)
    k, eps = 8, 0.08
    hga = hg.arrays()
    parts = _population(hg, k, eps, seed=3, n_pad=hga.n_pad)
    want = jrefine.refine_population(hga, parts, k, eps, max_iters=6,
                                     shard="off")
    return dict(k=k, eps=eps, hga=port_arrays(hga), parts=parts, want=want)


@pytest.fixture(scope="module")
def member_case():
    """Mutation's real-valued member rows on a netlist of n 150 (the
    plain fixed-order sums of real-valued FM steps are slow on the CPU)."""
    hg = _netlist(150, 200, 8)
    k, eps = 4, 0.08
    hga = hg.arrays()
    parts = _population(hg, k, eps, seed=3, n_pad=hga.n_pad)
    ew = _reweights(hg, ALPHA, seed=4, m_pad=hga.m_pad)
    want = jrefine.refine_population(hga, parts, k, eps, max_iters=6,
                                     edge_weights_pop=ew, shard="off")
    ph = port_arrays(hga)
    off = refine.refine_population(ph, parts, k, eps, max_iters=6,
                                   edge_weights_pop=ew, shard="off",
                                   device=CPU)
    return dict(k=k, eps=eps, hga=ph, parts=parts, ew=ew, want=want,
                off=off)


@pytest.mark.parametrize("p", POOLS)
@pytest.mark.parametrize("route", ROUTES)
def test_refine_population_parity_across_routes(route, p, refine_case, pool):
    """LP and FM of 5 members over p shards (padded to 6 or 8 rows on
    the mesh): parts and cuts bit-equal to the reference's ``off``."""
    pool(p)
    c = refine_case
    got = refine.refine_population(c["hga"], c["parts"], c["k"], c["eps"],
                                   max_iters=6, shard=route, device=CPU)
    assert_bit_equal(got[1], c["want"][1], "cuts")
    assert_bit_equal(got[0], c["want"][0], "parts")


@pytest.mark.parametrize("p", (2, 4))
@pytest.mark.parametrize("route", ROUTES)
def test_member_weights_parity_across_routes(route, p, member_case, pool):
    """Real-valued member rows: bit-equal to the port's ``off`` route,
    cuts within rtol 1e-6 of the reference's."""
    pool(p)
    c = member_case
    got = refine.refine_population(c["hga"], c["parts"], c["k"], c["eps"],
                                   max_iters=6, edge_weights_pop=c["ew"],
                                   shard=route, device=CPU)
    assert_bit_equal(got[0], c["off"][0], "parts")
    assert_bit_equal(got[1], c["off"][1], "cuts")
    np.testing.assert_allclose(got[1], np.asarray(c["want"][1]), rtol=1e-6)


@pytest.mark.parametrize("p", (2, 4))
def test_lp_tier_parity_with_override_weights(p, tiny_hg, pool):
    """Mesh LP with a shared edge-weight override and a 3-member
    population stays bit-equal to ``off``."""
    pool(p)
    k, eps = 4, 0.10
    hga = port_arrays(tiny_hg.arrays())
    parts = _population(tiny_hg, k, eps, seed=7, alpha=3)
    rng = np.random.default_rng(0)
    ewo = np.zeros(hga.m_pad, np.float32)
    ewo[: tiny_hg.m] = tiny_hg.edge_weights * (
        1.0 + 0.1 * rng.integers(0, 2, tiny_hg.m))
    res = {route: refine.lp_refine_population(
        hga, parts, k, eps, max_iters=6, edge_weight_override=ewo,
        shard=route) for route in ("off", "mesh")}
    assert_bit_equal(res["mesh"][0], res["off"][0], "parts")
    assert_bit_equal(res["mesh"][1], res["off"][1], "cuts")


def test_impart_partition_mesh_over_four_shards(pool, monkeypatch):
    """The memetic driver (recombination through the ring exchange over
    the shards, the final V-cycle) on a netlist of n 300 with
    ``pop_shard="mesh"`` over 4 shards: bit-equal to the reference's
    ``off`` run under host coarsening."""
    monkeypatch.setenv("REPRO_COARSEN_PATH", "host")
    hg = _netlist(300, 400, 12)
    kw = dict(k=4, eps=0.08, alpha=4, beta=2, seed=1,
              mutation_enabled=False)
    want = ref_impart(hg.structural_copy(), RefConfig(pop_shard="off", **kw))
    pool(4)
    got = impart_partition(port_hg(hg),
                           ImpartConfig(pop_shard="mesh", **kw), device=CPU)
    assert got.population_cuts == want.population_cuts
    assert got.cut == want.cut
    assert_bit_equal(got.part, want.part)
    assert [t[1] for t in got.trace] == [t[1] for t in want.trace]


# --------------------------------------------------------------------------
# the instance axis, and F5's grouping on the CPU
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trio():
    hgs = [port_hg(h) for h in (_netlist(150, 200, 5), _netlist(200, 260, 6),
                                _netlist(180, 240, 7))]
    cfgs = [ImpartConfig(k=k, eps=0.08, alpha=2, beta=2, seed=s,
                         lp_iters=4, recombination_enabled=False,
                         mutation_enabled=False, final_vcycles=0)
            for k, s in ((3, 1), (4, 2), (5, 3))]
    solo = [impart_partition(h, c, device=CPU) for h, c in zip(hgs, cfgs)]
    return hgs, cfgs, solo


@pytest.mark.parametrize("route", ROUTES)
def test_impart_instances_routes_over_four_shards(route, trio, pool):
    """Three requests grouped over 4 shards (the mesh pads the stack
    with a mirror of instance 0): each bit-equal to its solo run."""
    hgs, cfgs, solo = trio
    pool(4)
    cfgs = [ImpartConfig(**{**c.__dict__, "pop_shard": route})
            for c in cfgs]
    got = impart_partition_instances(hgs, cfgs, device=CPU)
    for g, s in zip(got, solo):
        assert g.cut == s.cut
        assert_bit_equal(g.part, s.part)
        assert g.population_cuts == s.population_cuts


@pytest.fixture(scope="module")
def drifted():
    """A level with drifted real-valued edge and vertex weights, and an
    incumbent of it (F5's refresh at CPU size)."""
    hg = port_hg(_netlist(160, 210, 9))
    step = drift_stream(hg, 1, magnitude=0.15, vertex_magnitude=0.1,
                        tag="popshard")[0]
    k = 4
    return step, hg, k, _population(hg, k, 0.08, seed=2, alpha=1)[0]


@pytest.mark.parametrize("stacked,p", [(1, 1), (3, 1), (3, 2), (3, 4)])
def test_real_valued_stack_equals_solo(stacked, p, drifted, pool):
    """The drifted refresh (budgeted, real-valued weights) stacked with
    0 or 2 cold requests of its bucket, the stack over p shards: the
    refresh keeps its solo parts and cuts bit for bit."""
    step, hg, k, inc = drifted
    h = step.arrays(device=CPU)
    assert h.real_edge_weights and h.real_vertex_weights
    parts = _population(step, k, 0.08, seed=5, alpha=3, n_pad=h.n_pad)
    entry = (h, parts, k, 0.08, inc, 0.15 * float(step.vertex_weights.sum()))
    want = refine.refine_population(h, parts, k, 0.08, incumbent=inc,
                                    mig_budget=entry[5], device=CPU)
    others = [(hg.arrays(device=CPU), parts + 1 - (parts > 0), k, 0.08),
              (hg.arrays(device=CPU), parts, k, 0.08)][: stacked - 1]
    pool(p)
    got = instances.refine_grouped([entry] + others, shard="mesh",
                                   device=CPU)[0]
    assert_bit_equal(got[0], want[0], "parts")
    assert_bit_equal(got[1], want[1], "cuts")


def test_fixed_order_sums_keep_cpu_bits(drifted):
    """On the CPU the row sums, prefix sums and block weights of
    real-valued weights keep the bits of ``Tensor.sum``, ``torch.cumsum``
    and the sequential sorted-block sum."""
    step = drifted[0]
    h = step.arrays(device=CPU)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((4, h.m_pad)).astype(np.float32))
    assert_bit_equal(metrics.row_sums(x, True, h.m), x.sum(-1))
    assert_bit_equal(metrics.prefix_sums(x, True), torch.cumsum(x, -1))
    parts = torch.from_numpy(_population(step, 6, 0.08, seed=1, alpha=3,
                                         n_pad=h.n_pad))
    got = metrics.block_weight_sums(parts, h.vertex_weights, 6, True, h.n)
    for r in range(3):
        row = torch.zeros(6).index_add_(0, parts[r].long(), h.vertex_weights)
        assert_bit_equal(got[r], row, f"row {r}")


# --------------------------------------------------------------------------
# what stays out of this slice
# --------------------------------------------------------------------------
@pytest.mark.parametrize("where", ["refine", "impart", "grouped",
                                   "service mesh", "service chunk"])
def test_model_axis_and_service_routes_raise(where, tiny_hg):
    hga = port_arrays(tiny_hg.arrays())
    parts = np.zeros((2, hga.n_pad), np.int32)
    with pytest.raises(NotImplementedError, match="later slice"):
        if where == "refine":
            refine.refine_population(hga, parts, 2, 0.1, model_shard="mesh",
                                     device=CPU)
        elif where == "impart":
            impart_partition(port_hg(tiny_hg),
                             ImpartConfig(k=2, model_shard="mesh"),
                             device=CPU)
        elif where == "grouped":
            instances.refine_grouped([(hga, parts, 2, 0.1)],
                                     model_shard="mesh", device=CPU)
        else:
            PartitionService(shard=where.split()[1], device=CPU)
