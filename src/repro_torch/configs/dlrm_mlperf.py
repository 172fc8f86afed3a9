"""dlrm-mlperf — MLPerf DLRM benchmark config (Criteo 1TB):
13 dense / 26 sparse, embed_dim 128, bot 13-512-256-128,
top 1024-1024-512-256-1, dot interaction.  [arXiv:1906.00091]

Table sizes are the MLPerf Criteo-Terabyte cardinalities
(max_ind_range = 40M), ~188M rows x 128 -> ~96 GB fp32, row-sharded
over the flattened (data, model) axes.
"""
from repro_torch.configs.base import ArchSpec, DLRMConfig, DLRM_SHAPES
from repro_torch.optim.adamw import AdamWConfig

MLPERF_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = DLRMConfig(
    name="dlrm-mlperf",
    n_dense=13, n_sparse=26, embed_dim=128,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    table_sizes=MLPERF_TABLE_SIZES,
    interaction="dot",
)

SMOKE = DLRMConfig(
    name="dlrm-smoke",
    n_dense=13, n_sparse=26, embed_dim=16,
    bot_mlp=(32, 16),
    top_mlp=(64, 32, 1),
    table_sizes=tuple([1000, 50, 20] + [100] * 23),
    interaction="dot",
)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

SPEC = ArchSpec(arch_id="dlrm-mlperf", config=CONFIG, shapes=DLRM_SHAPES,
                smoke_config=SMOKE)
