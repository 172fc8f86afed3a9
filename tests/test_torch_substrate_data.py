"""Port parity of the substrate's configs and data generators.

Both are pure data or numpy, copied into the port: every config must
equal the reference's field by field, and every generator must give the
reference's arrays bit for bit from the same seed.
"""
import dataclasses

import numpy as np
import pytest

from port_parity import assert_bit_equal

from repro.configs import registry as jregistry
from repro.data import graphs as jgraphs
from repro.data import recsys as jrecsys
from repro.data import sampler as jsampler
from repro_torch.configs import registry
from repro_torch.configs.base import DLRM_SHAPES, GNN_SHAPES, LM_SHAPES
from repro_torch.data import graphs, recsys, sampler

ARCH_IDS = sorted(jregistry.ARCHS)


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_config_equal(arch):
    """SPEC (with CONFIG and the shape set), SMOKE and OPT of one arch."""
    want, got = jregistry.get_arch(arch), registry.get_arch(arch)
    assert _asdict(got) == _asdict(want)
    assert _asdict(got.config) == _asdict(want.config)
    assert _asdict(registry.SMOKES[arch]) == _asdict(jregistry.SMOKES[arch])
    assert _asdict(registry.get_opt(arch)) == _asdict(jregistry.get_opt(arch))
    cfg = got.config
    if cfg.family == "lm":
        assert cfg.param_count() == want.config.param_count()
        assert cfg.active_param_count() == want.config.active_param_count()
    for sh in want.shapes:
        assert got.shape(sh.name).p() == sh.p()


def test_registry_and_shape_sets_equal():
    from repro.configs import base as jbase
    assert registry.all_cells() == jregistry.all_cells()
    assert len(registry.all_cells()) == 40
    for ours, theirs in ((LM_SHAPES, jbase.LM_SHAPES),
                         (GNN_SHAPES, jbase.GNN_SHAPES),
                         (DLRM_SHAPES, jbase.DLRM_SHAPES)):
        assert [_asdict(s) for s in ours] == [_asdict(s) for s in theirs]
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")
    with pytest.raises(KeyError):
        registry.ARCHS["gatedgcn"].shape("no-such-shape")


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert_bit_equal(got[key], want[key], key)


@pytest.mark.parametrize("batch,seed", [(64, 0), (257, 5)])
def test_click_batch_bit_equal(batch, seed):
    cfg = registry.SMOKES["dlrm-mlperf"]
    _assert_batches_equal(recsys.click_batch(cfg, batch, seed=seed),
                          jrecsys.click_batch(jregistry.SMOKES["dlrm-mlperf"],
                                              batch, seed=seed))


@pytest.mark.parametrize("n,m,seed", [(600, 3000, 0), (2500, 15000, 3)])
def test_graph_generators_bit_equal(n, m, seed):
    ei = graphs.power_law_graph(n, m, seed)
    want = jgraphs.power_law_graph(n, m, seed)
    assert ei.dtype == want.dtype
    assert_bit_equal(ei, want, "power_law_graph")
    for got, exp in zip(graphs.to_csr(ei, n), jgraphs.to_csr(want, n)):
        assert got.dtype == exp.dtype
        assert_bit_equal(got, exp, "to_csr")
    assert_bit_equal(graphs.mesh_graph(7, 5), jgraphs.mesh_graph(7, 5),
                     "mesh_graph")


@pytest.mark.parametrize("edge_feat", [0, 4])
def test_graph_batches_bit_equal(edge_feat):
    _assert_batches_equal(
        graphs.full_graph_batch(600, 2400, 12, 8, seed=1,
                                need_edge_feat=edge_feat),
        jgraphs.full_graph_batch(600, 2400, 12, 8, seed=1,
                                 need_edge_feat=edge_feat))
    _assert_batches_equal(
        graphs.molecule_batch(6, 10, 20, 12, 8, seed=2,
                              need_edge_feat=edge_feat),
        jgraphs.molecule_batch(6, 10, 20, 12, 8, seed=2,
                               need_edge_feat=edge_feat))


def test_neighbor_sampler_bit_equal():
    n = 600
    ei = graphs.power_law_graph(n, 3000, seed=4)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(n, 12)).astype(np.float32)
    labels = rng.integers(0, 8, n).astype(np.int32)
    ours = sampler.NeighborSampler(ei, n, feats, labels, fanout=(5, 3),
                                   seed=7)
    theirs = jsampler.NeighborSampler(ei, n, feats, labels, fanout=(5, 3),
                                      seed=7)
    for _ in range(3):
        _assert_batches_equal(ours.batch(32), theirs.batch(32))
