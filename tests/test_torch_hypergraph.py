"""Port parity: generators, host hypergraph, padded arrays, contraction.

Every comparison here is exact (element for element): the generators
and the host structure code are copied numpy, the padded arrays are a
relayout, and the device contraction only sums integer-valued weights.
"""
import numpy as np
import pytest
import torch

from port_parity import (CPU, assert_bit_equal, port_arrays, port_hg,
                         to_np)

import jax.numpy as jnp

from repro.core import hypergraph as ref_hg
from repro.data import hypergraphs as ref_data
from repro_torch.core import hypergraph as port_hg_mod
from repro_torch.data import hypergraphs as port_data

CSR = ("pins", "edge_offsets", "vertex_weights", "edge_weights")


@pytest.mark.parametrize("make", [
    lambda d: d.ispd_like("ibm01_like", 0.05),
    lambda d: d.ispd_like("ibm08_like", 0.02),
    lambda d: d.titan_like("cholesky_mc_like", 0.03),
    lambda d: d.random_hypergraph(300, 400, seed=3),
    lambda d: d._modular_netlist(600, 800, seed=11, n_modules=8,
                                 p_local=0.8, fanout_tail=1.5),
], ids=["ispd01", "ispd08", "titan", "random", "modular"])
def test_generators_byte_identical(make):
    want, got = make(ref_data), make(port_data).to_numpy()
    assert (got["n"], got["m"]) == (want.n, want.m)
    for f in CSR:
        a, b = got[f], getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("which", ["tiny", "small"])
def test_arrays_match_reference_with_layout(which, tiny_hg, small_hg,
                                            monkeypatch):
    """With REPRO_GAIN_PATH=table both packages attach the dense incidence
    layout where the expansion guard allows it (not on the 24-vertex
    instance); every padded field equals the reference's."""
    monkeypatch.setenv("REPRO_GAIN_PATH", "table")
    hg = {"tiny": tiny_hg, "small": small_hg}[which].structural_copy()
    want = ref_hg.HypergraphArrays.from_host(hg)
    got = port_hg_mod.HypergraphArrays.from_host(port_hg(hg), device=CPU)
    assert (got.incident is None) == (want.incident is None) \
        == (which == "tiny")
    assert (got.n, got.m) == (int(want.n), int(want.m))
    for f in ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
              "edge_sizes") + (("incident",) if which == "small" else ()):
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    # the port's round trip through numpy is lossless
    back = port_hg_mod.HypergraphArrays.from_numpy(got.to_numpy(), CPU)
    assert_bit_equal(back.pin_vertex, got.pin_vertex)
    if which == "small":
        assert_bit_equal(back.incident, got.incident)


def test_arrays_layout_off_on_cpu_auto(small_hg, monkeypatch):
    monkeypatch.delenv("REPRO_GAIN_PATH", raising=False)
    got = port_hg_mod.HypergraphArrays.from_host(port_hg(small_hg),
                                                 device=CPU)
    assert got.incident is None
    assert got.n_pad == 1024 and got.pin_vertex.dtype == torch.int32


def test_entry_points_default_to_cuda(tiny_hg):
    """Without a CUDA device the defaults raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_hg_mod.HypergraphArrays.from_host(port_hg(tiny_hg))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_hg(tiny_hg).arrays()


@pytest.mark.parametrize("seed,n_new", [(0, 60), (1, 30), (2, 100)])
def test_host_contract_and_projection_exact(seed, n_new, small_hg):
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, n_new, small_hg.n).astype(np.int32)
    want, wmap = ref_hg.contract(small_hg, cid, n_new)
    got, gmap = port_hg_mod.contract(port_hg(small_hg), cid, n_new)
    assert (got.n, got.m) == (want.n, want.m)
    for f in CSR:
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    part_c = rng.integers(0, 4, n_new).astype(np.int32)
    assert_bit_equal(port_hg_mod.project_partition(part_c, gmap),
                     ref_hg.project_partition(part_c, wmap))


def _random_hg(seed, n=180, m=260, max_size=6):
    rng = np.random.default_rng(seed)
    edges = [rng.choice(n, size=rng.integers(2, max_size + 1), replace=False)
             for _ in range(m)]
    ew = rng.integers(1, 5, m).astype(np.float32)
    hg = ref_hg.Hypergraph.from_edge_lists(edges, n=n, edge_weights=ew)
    hg.vertex_weights[:] = rng.integers(1, 4, n).astype(np.float32)
    return hg


@pytest.mark.parametrize("seed,n_new", [(0, 60), (1, 30), (2, 100)])
def test_contract_arrays_exact(seed, n_new):
    """The device contraction equals the reference's element for element
    and reproduces the host ``contract`` given the same cluster ids."""
    hg = _random_hg(seed)
    rng = np.random.default_rng(seed + 100)
    cid = rng.integers(0, n_new, hg.n).astype(np.int32)
    hga = hg.arrays()
    cid_dev = np.full(hga.n_pad, hga.n_pad - 1, np.int32)
    cid_dev[: hg.n] = cid
    want, wp = ref_hg.contract_arrays(hga, jnp.asarray(cid_dev),
                                      jnp.int32(n_new))
    got, gp = port_hg_mod.contract_arrays(port_arrays(hga),
                                          torch.from_numpy(cid_dev), n_new)
    assert (got.n, got.m, gp) == (int(want.n), int(want.m), int(wp))
    for f in ("pin_vertex", "pin_edge", "vertex_weights", "edge_weights",
              "edge_sizes"):
        assert_bit_equal(getattr(got, f), getattr(want, f), f)
    # and the host contraction of the port agrees on the edge set
    host, _ = port_hg_mod.contract(port_hg(hg), cid, n_new)
    assert (host.n, host.m, host.num_pins) == (got.n, got.m, gp)
    pv, pe = to_np(got.pin_vertex)[:gp], to_np(got.pin_edge)[:gp]
    ew = to_np(got.edge_weights)
    dev_edges = sorted((tuple(sorted(pv[pe == e])), float(ew[e]))
                       for e in range(got.m))
    host_edges = sorted(
        (tuple(sorted(host.pins[host.edge_offsets[e]:
                                host.edge_offsets[e + 1]])),
         float(host.edge_weights[e])) for e in range(host.m))
    assert dev_edges == host_edges


def test_contract_arrays_merges_parallel_after_pin_dedup():
    hg = ref_hg.Hypergraph.from_edge_lists([[0, 1, 2], [0, 2]], n=3,
                                           edge_weights=[1.0, 2.0])
    hga = port_hg_mod.HypergraphArrays.from_host(port_hg(hg), device=CPU)
    cid = torch.full((hga.n_pad,), hga.n_pad - 1, dtype=torch.int32)
    cid[:3] = torch.tensor([0, 0, 1], dtype=torch.int32)
    got, p_new = port_hg_mod.contract_arrays(hga, cid, 2)
    assert (got.m, p_new) == (1, 2)
    assert to_np(got.edge_weights)[0] == 3.0
