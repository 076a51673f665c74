"""Distributed runtime of the port — ``repro/runtime/``: an asyncio
coordinator driving socket workers over the reference's frame protocol,
the workers' segments on the card's kernels, validation against the
simulator, and elastic replanning under churn."""
from .elastic import (ClusterCollapsed, ElasticCluster, WorkerHealth,
                      plan_recovery_mesh)
from .coordinator import Coordinator, WorkerHandle
from .protocol import (ConnectionClosed, Frame, ProtocolError, encode_frame,
                       decode_body, read_frame, write_frame)
from .replan import ElasticCoordinator, PlanDiff, SegmentDiff, diff_plans
from .shards import (build_coordinator_plan, build_segment_fns,
                     build_worker_setup, delta_setup, setup_array_bytes,
                     worker_geometry_summary)
from .validate import ValidationReport, run_distributed, validate_distributed
