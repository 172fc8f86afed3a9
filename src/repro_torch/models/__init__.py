"""The substrate's models (counterpart of ``repro.models``): the shared
layers, DLRM, the GNN zoo, and the LM (attention, MoE, transformer)."""
from . import layers, gnn, dlrm, attention, moe, transformer
