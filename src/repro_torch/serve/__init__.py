"""The partition service and its fault handling (counterpart of
``repro.serve``).  The reference's decode loop (``ServeSession``)
belongs to the model substrate and is not part of this package."""
from .faults import FaultEvent, FaultPlan, InjectedCrash, fault_plan_env
from .partition_service import (PartitionRequest, PartitionResult,
                                PartitionService, serve_buckets,
                                serve_ckpt_dir, serve_ckpt_every,
                                serve_coalesce_s, serve_deadline_s,
                                serve_max_queue, serve_slots)
