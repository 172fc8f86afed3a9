"""IMPart core of the port: data structures, metrics, refinement,
coarsening, the memetic operators, the operator scheduler, the
baselines, the driver, incremental repartitioning and the distributed
population step (counterpart of
``repro.core``).  Unlike
``repro.core``, the package does not re-export the functions
``recombine`` and ``vcycle``, which would hide the modules of the same
names."""
from .hypergraph import (Hypergraph, HypergraphArrays, HierarchyArrays,
                         contract, contract_arrays, project_partition)
from .coarsen import coarsen, recombination_thresholds, Hierarchy, Level
from .dcoarsen import (build_hierarchy, device_coarsen, coarsen_path,
                       population_coarsen, PopulationHierarchy)
from .initial_partition import initial_partition, initial_partition_population
from .impart import (impart_partition, impart_partition_instances,
                     ImpartConfig, ImpartResult)
from .instances import (InstanceBatch, bucket_n_pad, group_key, k_bucket,
                        refine_grouped, stack_instances, stack_parts)
from .baselines import (multilevel_partition, multilevel_best_of,
                        external_memetic, MultilevelResult)
from .recombine import ring_recombination, overlay_clustering
from .mutate import mutate_population, mutate_path, similarity_sets
from .scheduler import (OperatorScheduler, SchedulerDecision,
                        SchedulerTrace, sched_path, resolve_sched)
from .vcycle import vcycle_instances, vcycle_population
from .population import (make_local_population_step, make_population_step,
                         population_step_fn)
from .incremental import (incremental_partition, repartition_k_change,
                          IncrementalConfig, IncrementalResult,
                          IncrementalState)
from . import incremental, instances, metrics, refine, ilp

__all__ = [
    "Hypergraph", "HypergraphArrays", "HierarchyArrays", "contract",
    "contract_arrays", "project_partition",
    "coarsen", "recombination_thresholds", "Hierarchy", "Level",
    "build_hierarchy", "device_coarsen", "coarsen_path",
    "population_coarsen", "PopulationHierarchy",
    "initial_partition", "initial_partition_population",
    "impart_partition", "impart_partition_instances", "ImpartConfig",
    "ImpartResult", "InstanceBatch", "bucket_n_pad", "group_key", "k_bucket",
    "refine_grouped", "stack_instances", "stack_parts",
    "multilevel_partition", "multilevel_best_of", "external_memetic",
    "MultilevelResult",
    "ring_recombination", "overlay_clustering",
    "mutate_population", "mutate_path", "similarity_sets",
    "OperatorScheduler", "SchedulerDecision", "SchedulerTrace",
    "sched_path", "resolve_sched", "vcycle_instances", "vcycle_population",
    "make_population_step", "make_local_population_step",
    "population_step_fn",
    "incremental_partition", "repartition_k_change", "IncrementalConfig",
    "IncrementalResult", "IncrementalState",
    "incremental", "instances", "metrics", "refine", "ilp",
]
