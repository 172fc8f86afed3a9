"""gin-tu — 5L d_hidden=64 sum aggregator, learnable eps.
[arXiv:1810.00826]"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = GNNConfig(name="gin-tu", n_layers=5, d_hidden=64,
                   aggregator="sum", eps_learnable=True, n_classes=48)

SMOKE = GNNConfig(name="gin-tu", n_layers=2, d_hidden=16,
                  aggregator="sum", eps_learnable=True, n_classes=8,
                  d_feat=12)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

SPEC = ArchSpec(arch_id="gin-tu", config=CONFIG, shapes=GNN_SHAPES,
                smoke_config=SMOKE)
