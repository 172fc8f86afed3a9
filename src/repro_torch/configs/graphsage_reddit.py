"""graphsage-reddit — 2L d_hidden=128 mean aggregator sample_sizes=25-10.
[arXiv:1706.02216]"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = GNNConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                   aggregator="mean", sample_sizes=(25, 10), n_classes=48)

SMOKE = GNNConfig(name="graphsage-reddit", n_layers=2, d_hidden=16,
                  aggregator="mean", sample_sizes=(5, 3), n_classes=8,
                  d_feat=12)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

SPEC = ArchSpec(arch_id="graphsage-reddit", config=CONFIG,
                shapes=GNN_SHAPES, smoke_config=SMOKE)
