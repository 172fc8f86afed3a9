"""Port parity of the substrate's models: DLRM and the GNN zoo.

The reference's parameters (drawn by its own ``init_params``) go into
the port's modules through ``from_reference_params``; both packages then
see the same numpy inputs on the CPU.  Tolerances:

- DLRM: rtol 1e-5, atol 1e-6.  f32 matrix products add in another order
  in XLA and in torch, and ``retrieval_scores`` sums the user bag in
  another order too (the port's plain ``embedding_bag``).
- GNN: rtol 1e-4, atol 1e-5.  On top of the products, the segment sums
  (``jax.ops.segment_sum`` against ``index_add_``) add in another order,
  through up to three layers of residual updates and norms.
"""
import jax
import numpy as np
import pytest
import torch

from port_parity import CPU

from repro.configs import registry as jregistry
from repro.data import graphs as jgraphs
from repro.data import recsys as jrecsys
from repro.data import sampler as jsampler
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro_torch.configs import registry
from repro_torch.models import dlrm, gnn
from repro_torch.models.layers import batch_to

DLRM_TOL = dict(rtol=1e-5, atol=1e-6)
GNN_TOL = dict(rtol=1e-4, atol=1e-5)
GNN_ARCHS = ("gatedgcn", "gin-tu", "meshgraphnet", "graphsage-reddit")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def dlrm_pair():
    cfg = jregistry.SMOKES["dlrm-mlperf"]
    params = _np_tree(jdlrm.init_params(cfg, jax.random.PRNGKey(3)))
    # the reference draws zero biases: give them values so the test
    # sees each one land in its place
    rng = np.random.default_rng(3)
    for mlp in ("bot", "top"):
        for key in params[mlp]:
            if key.startswith("b"):
                params[mlp][key] = rng.normal(
                    scale=0.1, size=params[mlp][key].shape).astype(np.float32)
    return cfg, params, dlrm.from_reference_params(
        registry.SMOKES["dlrm-mlperf"], params, device=CPU)


def test_dlrm_layout_exact(dlrm_pair):
    cfg, params, model = dlrm_pair
    assert np.array_equal(dlrm.table_offsets(cfg), jdlrm.table_offsets(cfg))
    assert dlrm.padded_total_rows(cfg) == jdlrm.padded_total_rows(cfg)
    assert dlrm.padded_total_rows(cfg, 7) == jdlrm.padded_total_rows(cfg, 7)
    assert tuple(model.tables.shape) == params["tables"].shape
    # the interaction's index order: features i < j, row-major
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(3, 5)).astype(np.float32)
    sparse = rng.normal(size=(3, 4, 5)).astype(np.float32)
    want = np.asarray(jdlrm._interact(dense, sparse, "dot"))
    got = dlrm._interact(torch.from_numpy(dense), torch.from_numpy(sparse),
                         "dot").numpy()
    feats = np.concatenate([dense[:, None], sparse], axis=1)
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    exact = np.stack([np.einsum("bd,bd->b", feats[:, i], feats[:, j])
                      for i, j in pairs], axis=1)
    np.testing.assert_allclose(got[:, 5:], exact, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,seed", [(64, 1), (300, 2)])
def test_dlrm_forward_matches_reference(dlrm_pair, batch, seed):
    cfg, params, model = dlrm_pair
    host = jrecsys.click_batch(cfg, batch, seed=seed)
    want = np.asarray(jdlrm.forward(params, host, cfg))
    with torch.no_grad():
        got = model(batch_to(host, CPU)).numpy()
    assert got.shape == (batch,)
    np.testing.assert_allclose(got, want, **DLRM_TOL)


def test_dlrm_retrieval_matches_reference(dlrm_pair):
    cfg, params, model = dlrm_pair
    host = jrecsys.click_batch(cfg, 1, seed=4)
    rng = np.random.default_rng(4)
    query = {"dense": host["dense"], "sparse_idx": host["sparse_idx"],
             "cand_idx": rng.integers(0, cfg.total_rows, 5000
                                      ).astype(np.int32)}
    want = np.asarray(jdlrm.retrieval_scores(params, query, cfg))
    with torch.no_grad():
        t = batch_to(query, CPU)
        got = model.retrieval_scores(t).numpy()
        bag = model.user_bag(t["sparse_idx"]).numpy()
    assert got.shape == (5000,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **DLRM_TOL)
    np.testing.assert_allclose(
        bag, params["tables"][host["sparse_idx"]].sum(axis=1), **DLRM_TOL)


def _gnn_pair(arch, d_feat, n_classes, seed=0):
    cfg = jregistry.SMOKES[arch]
    params = _np_tree(jgnn.init_params(cfg, jax.random.PRNGKey(seed),
                                       d_feat, n_classes))
    # non-trivial norms, eps and biases, so each lands in its place
    rng = np.random.default_rng(seed)

    def jitter(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif key.startswith(("ln", "eps", "b")):
                tree[key] = (leaf + rng.normal(scale=0.1, size=leaf.shape)
                             ).astype(np.float32)
    jitter(params)
    model = gnn.from_reference_params(registry.SMOKES[arch], params, d_feat,
                                      n_classes, device=CPU)
    return cfg, params, model


def _edge_dim(arch):
    return {"gatedgcn": 1, "meshgraphnet": 4}.get(arch, 0)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **GNN_TOL)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_full_graph_matches_reference(arch):
    cfg, params, model = _gnn_pair(arch, 12, 8, seed=1)
    host = jgraphs.full_graph_batch(600, 2400, 12, 8, seed=1,
                                    need_edge_feat=_edge_dim(arch))
    want = jgnn.full_graph_logits(params, host, cfg)
    with torch.no_grad():
        got = model.full_graph_logits(batch_to(host, CPU))
    assert tuple(got.shape) == (600, 8)
    _close(got, want)
    # the masked edge path (padded edges zeroed)
    host["edge_mask"] = (np.random.default_rng(1).random(
        host["edge_index"].shape[1]) < 0.8).astype(np.float32)
    want = jgnn.full_graph_logits(params, host, cfg)
    with torch.no_grad():
        _close(model.full_graph_logits(batch_to(host, CPU)), want)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_minibatch_matches_reference(arch):
    cfg, params, model = _gnn_pair(arch, 12, 8, seed=2)
    n = 600
    ei = jgraphs.power_law_graph(n, 3000, seed=2)
    rng = np.random.default_rng(2)
    smp = jsampler.NeighborSampler(
        ei, n, rng.normal(size=(n, 12)).astype(np.float32),
        rng.integers(0, 8, n).astype(np.int32), fanout=cfg.sample_sizes
        or (5, 3), seed=2)
    host = smp.batch(48)
    host.pop("labels")
    want = jgnn.minibatch_logits(params, host, cfg)
    with torch.no_grad():
        got = model.minibatch_logits(batch_to(host, CPU))
    assert tuple(got.shape) == (48, 8)
    _close(got, want)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_molecule_matches_reference(arch):
    cfg, params, model = _gnn_pair(arch, 12, 8, seed=3)
    host = jgraphs.molecule_batch(16, 10, 20, 12, 8, seed=3,
                                  need_edge_feat=_edge_dim(arch))
    host["node_mask"][:, -2:] = 0.0     # padded nodes leave the readout
    want = jgnn.molecule_logits(params, host, cfg)
    with torch.no_grad():
        got = model.molecule_logits(batch_to(host, CPU))
    assert tuple(got.shape) == (16, 8)
    _close(got, want)


def test_gnn_init_draws_from_generator():
    """The port's own init: the reference's scale rule, the same draws
    from the same generator seed, and finite logits."""
    cfg = registry.SMOKES["gatedgcn"]
    models = [gnn.init_params(cfg, torch.Generator().manual_seed(5), 12,
                              device=CPU) for _ in range(2)]
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    w = models[0].layers.p["A"][0]
    assert abs(float(w.detach().std()) * np.sqrt(cfg.d_hidden) - 1.0) < 0.2
    host = jgraphs.full_graph_batch(100, 400, 12, 8, seed=0,
                                    need_edge_feat=1)
    with torch.no_grad():
        out = models[0].full_graph_logits(batch_to(host, CPU))
    assert torch.isfinite(out).all()
    d = dlrm.init_params(registry.SMOKES["dlrm-mlperf"],
                         torch.Generator().manual_seed(5), device=CPU)
    assert abs(float(d.tables.detach().std()) - 0.01) < 1e-3
