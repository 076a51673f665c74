"""Coordinator-first facade of the port — ``repro/api/``: ``Cluster`` →
``Planner`` → ``Plan`` → ``Session``.

``Cluster``, ``Planner`` and ``Plan`` are numpy copies of the reference's
(the same plans, byte for byte in ``Plan.to_json``); ``Plan.compile``
returns the port's ``Session``, which serves on CUDA unless the caller
passes ``device="cpu"``, and whose ``distributed()`` returns the port's
``Coordinator`` (or ``ElasticCoordinator``)."""
from .cluster import Cluster, ClusterError
from .plan import FUSIONS, Plan, build_split_plan
from .planner import (SEARCH_MODES, InfeasibleError, Objective, PlanCandidate,
                      Planner)
from .session import (InflightDispatch, RollingLatency, Session,
                      SessionStats, Ticket)

__all__ = [
    "Cluster",
    "ClusterError",
    "FUSIONS",
    "InfeasibleError",
    "InflightDispatch",
    "Objective",
    "Plan",
    "PlanCandidate",
    "Planner",
    "RollingLatency",
    "SEARCH_MODES",
    "Session",
    "SessionStats",
    "Ticket",
    "build_split_plan",
]
