"""Serving facade of the port.  This slice ports ``Session`` and its
helpers; ``Cluster``, ``Planner`` and ``Plan`` come with the planner slice."""
from .session import (InflightDispatch, RollingLatency, Session,
                      SessionStats, Ticket)

__all__ = [
    "InflightDispatch",
    "RollingLatency",
    "Session",
    "SessionStats",
    "Ticket",
]
