"""meshgraphnet — 15L d_hidden=128 sum aggregator mlp_layers=2.
[arXiv:2010.03409]"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = GNNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                   aggregator="sum", mlp_layers=2, n_classes=48)

SMOKE = GNNConfig(name="meshgraphnet", n_layers=2, d_hidden=16,
                  aggregator="sum", mlp_layers=2, n_classes=8, d_feat=12)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

SPEC = ArchSpec(arch_id="meshgraphnet", config=CONFIG, shapes=GNN_SHAPES,
                smoke_config=SMOKE)
