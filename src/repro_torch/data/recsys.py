"""Criteo-like click-log generator for the DLRM substrate (port of
``repro.data.recsys``: numpy, the same draws from the same seed)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.models.dlrm import table_offsets


def click_batch(cfg: DLRMConfig, batch: int, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    offs = table_offsets(cfg)
    dense = rng.lognormal(0.0, 1.0, size=(batch, cfg.n_dense)
                          ).astype(np.float32)
    dense = np.log1p(dense)  # Criteo-style log transform
    idx = np.zeros((batch, cfg.n_sparse), np.int64)
    for t in range(cfg.n_sparse):
        size = cfg.table_sizes[t]
        # zipf-skewed ids (hot rows), offset into the concatenated table
        z = (rng.zipf(1.1, size=batch) - 1) % size
        idx[:, t] = offs[t] + z
    # labels correlated with a couple of dense features => learnable
    p = 1.0 / (1.0 + np.exp(-(dense[:, 0] - dense[:, 1])))
    labels = (rng.random(batch) < p).astype(np.int32)
    return {"dense": dense, "sparse_idx": idx.astype(np.int32),
            "labels": labels}
