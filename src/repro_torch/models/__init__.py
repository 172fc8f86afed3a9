"""The substrate's models (counterpart of ``repro.models``): so far the
layers DLRM and the GNN zoo use, DLRM and the GNN zoo."""
from . import layers, gnn, dlrm
