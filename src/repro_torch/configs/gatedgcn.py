"""gatedgcn — 16L d_hidden=70 gated aggregator.  [arXiv:2003.00982]"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES
from repro_torch.optim.adamw import AdamWConfig

CONFIG = GNNConfig(name="gatedgcn", n_layers=16, d_hidden=70,
                   aggregator="gated", n_classes=48)

SMOKE = GNNConfig(name="gatedgcn", n_layers=3, d_hidden=16,
                  aggregator="gated", n_classes=8, d_feat=12)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

SPEC = ArchSpec(arch_id="gatedgcn", config=CONFIG, shapes=GNN_SHAPES,
                smoke_config=SMOKE)
