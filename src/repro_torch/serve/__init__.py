"""Serving (counterpart of ``repro.serve``): the LM decode loop
(``ServeSession``), and the partition service and its fault handling."""
from .decode_loop import ServeSession
from .faults import FaultEvent, FaultPlan, InjectedCrash, fault_plan_env
from .partition_service import (PartitionRequest, PartitionResult,
                                PartitionService, serve_buckets,
                                serve_ckpt_dir, serve_ckpt_every,
                                serve_coalesce_s, serve_deadline_s,
                                serve_max_queue, serve_slots)
