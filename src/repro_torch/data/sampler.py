"""Real neighbour sampler (GraphSAGE fanout sampling) — numpy CSR based
(port of ``repro.data.sampler``, copied: the same draws from the same
seed).

This is the host half of the ``minibatch_lg`` shape: roots are drawn,
each hop samples ``fanout[h]`` neighbours with replacement (standard
GraphSAGE), and the result is emitted as dense fanout tensors
x0 [R, F], x1 [R, f1, F], x2 [R, f1, f2, F] + validity masks — fully
shardable over the root dimension.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .graphs import to_csr


class NeighborSampler:
    def __init__(self, edge_index: np.ndarray, n: int,
                 features: np.ndarray, labels: np.ndarray,
                 fanout: Tuple[int, int] = (15, 10), seed: int = 0):
        self.indptr, self.indices = to_csr(edge_index, n)
        self.n = n
        self.features = features
        self.labels = labels
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, k: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """nodes [...], returns (neigh [..., k], mask [..., k])."""
        deg = (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)
        r = self.rng.integers(0, 1 << 62, size=nodes.shape + (k,))
        has = deg > 0
        offs = np.where(has[..., None], r % np.maximum(deg, 1)[..., None], 0)
        idx = self.indptr[nodes][..., None] + offs
        neigh = self.indices[np.minimum(idx, len(self.indices) - 1)]
        mask = np.broadcast_to(has[..., None], neigh.shape)
        return np.where(mask, neigh, 0).astype(np.int64), \
            mask.astype(np.float32)

    def batch(self, batch_nodes: int) -> Dict[str, np.ndarray]:
        f1, f2 = self.fanout
        roots = self.rng.integers(0, self.n, size=batch_nodes)
        n1, m1 = self._sample_neighbors(roots, f1)          # [R, f1]
        n2, m2 = self._sample_neighbors(n1, f2)             # [R, f1, f2]
        return {
            "x0": self.features[roots].astype(np.float32),
            "x1": self.features[n1].astype(np.float32),
            "x2": self.features[n2].astype(np.float32),
            "mask1": m1,
            "mask2": m2 * m1[..., None],
            "labels": self.labels[roots].astype(np.int32),
        }
