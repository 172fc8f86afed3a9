"""IMPart core of the port: data structures, metrics, refinement,
coarsening and the static driver (counterpart of ``repro.core``)."""
from .hypergraph import (Hypergraph, HypergraphArrays, HierarchyArrays,
                         contract, contract_arrays, project_partition)
from .coarsen import coarsen, recombination_thresholds, Hierarchy, Level
from .dcoarsen import build_hierarchy, device_coarsen, coarsen_path
from .initial_partition import initial_partition, initial_partition_population
from .impart import impart_partition, ImpartConfig, ImpartResult
from . import metrics, refine

__all__ = [
    "Hypergraph", "HypergraphArrays", "HierarchyArrays", "contract",
    "contract_arrays", "project_partition",
    "coarsen", "recombination_thresholds", "Hierarchy", "Level",
    "build_hierarchy", "device_coarsen", "coarsen_path",
    "initial_partition", "initial_partition_population",
    "impart_partition", "ImpartConfig", "ImpartResult",
    "metrics", "refine",
]
