"""Graph generators + CSR utilities for the GNN substrate (port of
``repro.data.graphs``, copied: numpy only, the same draws from the same
seeds)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def power_law_graph(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Degree-skewed random graph (reddit/products-like).  Returns
    edge_index [2, m] (directed; symmetrize upstream if needed)."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured endpoints via zipf ranks
    ranks = rng.permutation(n)
    z1 = (rng.zipf(1.3, size=m) - 1) % n
    z2 = rng.integers(0, n, size=m)
    src = ranks[z1]
    dst = ranks[z2]
    keep = src != dst
    return np.stack([src[keep], dst[keep]]).astype(np.int32)


def mesh_graph(nx: int, ny: int) -> np.ndarray:
    """Regular triangulated mesh (MeshGraphNet-style), bidirectional."""
    idx = lambda i, j: i * ny + j
    edges = []
    for i in range(nx):
        for j in range(ny):
            if i + 1 < nx:
                edges.append((idx(i, j), idx(i + 1, j)))
            if j + 1 < ny:
                edges.append((idx(i, j), idx(i, j + 1)))
            if i + 1 < nx and j + 1 < ny:
                edges.append((idx(i, j), idx(i + 1, j + 1)))
    e = np.array(edges, np.int32).T
    return np.concatenate([e, e[::-1]], axis=1)


def to_csr(edge_index: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) adjacency of dst-lists per src."""
    src, dst = edge_index
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int32)
    counts = np.bincount(src, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, indices


def full_graph_batch(n: int, m: int, d_feat: int, n_classes: int,
                     seed: int = 0, need_edge_feat: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    ei = power_law_graph(n, m, seed)
    ei = ei[:, : m] if ei.shape[1] >= m else np.concatenate(
        [ei, ei[:, : m - ei.shape[1]]], axis=1)
    batch = {
        "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
        "edge_index": ei.astype(np.int32),
        "labels": rng.integers(0, n_classes, size=n).astype(np.int32),
    }
    if need_edge_feat:
        batch["edge_feat"] = rng.normal(
            size=(ei.shape[1], need_edge_feat)).astype(np.float32)
    return batch


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int = 0,
                   need_edge_feat: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n_nodes, size=(batch, 2, n_edges)).astype(np.int32)
    out = {
        "node_feat": rng.normal(size=(batch, n_nodes, d_feat)
                                ).astype(np.float32),
        "edge_index": ei,
        "edge_mask": (rng.random((batch, n_edges)) < 0.9
                      ).astype(np.float32),
        "node_mask": np.ones((batch, n_nodes), np.float32),
        "labels": rng.integers(0, n_classes, size=batch).astype(np.int32),
    }
    if need_edge_feat:
        out["edge_feat"] = rng.normal(
            size=(batch, n_edges, need_edge_feat)).astype(np.float32)
    return out
