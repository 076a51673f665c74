"""Continuous-batching scheduler policy: which tenant dispatches next, and
with how many requests — port of ``repro/serve/scheduler.py`` (pure
policy; a copy but for this docstring).

Tenants host *different compiled plans* (or the same model at different
resolutions), so requests from two tenants can never ride the same engine
dispatch — batching is always per tenant, and the scheduling question is
purely *which tenant's queue to drain next*.  The policy here is
earliest-deadline-first over queue heads: each queued request's deadline is
``arrival + p99_target``, and the tenant whose oldest request is closest to
(or furthest past) its deadline forms the next micro-batch.  With equal SLO
targets this degenerates to FCFS on arrival order, so no tenant can be
starved: its head request's deadline only gets older.

Batch formation is greedy up to the tenant session's ``max_batch``: under
saturation every dispatch is a full bucket (max throughput), under light
load a lone request dispatches immediately at bucket 1 (min latency) — the
continuous-batching tradeoff with no tuning knob.
"""
from __future__ import annotations

from ..api.session import Ticket
from .admission import SLO


class QueuedRequest:
    """One admitted request waiting for (or riding) a dispatch."""

    __slots__ = ("x", "ticket", "tenant", "t_arrival", "deadline")

    def __init__(self, x, tenant: str, t_arrival: float, deadline: float):
        self.x = x                  # validated (C, H, W) float32 sample
        self.ticket = Ticket()      # detached: fulfilled by the scheduler
        self.tenant = tenant
        self.t_arrival = t_arrival
        self.deadline = deadline


def make_request(x, tenant: str, t_arrival: float, slo: SLO) -> QueuedRequest:
    target = slo.p99_target_s if slo.p99_target_s is not None else float("inf")
    return QueuedRequest(x, tenant, t_arrival, t_arrival + target)


class EdfBatcher:
    """Earliest-deadline-first tenant selection + greedy batch formation.

    Operates on a ``{tenant: deque[QueuedRequest]}`` view owned (and locked)
    by the server — the batcher is pure policy and holds no state, so it can
    be swapped without touching queue plumbing.
    """

    def select(self, queues: dict[str, object]) -> str | None:
        """The tenant whose head-of-line request has the earliest deadline
        (None if every queue is empty)."""
        best, best_deadline = None, None
        for tenant, q in queues.items():
            if not q:
                continue
            d = q[0].deadline
            if best_deadline is None or d < best_deadline:
                best, best_deadline = tenant, d
        return best

    def take(self, queue, max_batch: int) -> list[QueuedRequest]:
        """Pop up to ``max_batch`` head requests (arrival order preserved:
        responses stay FIFO per tenant)."""
        n = min(len(queue), max_batch)
        return [queue.popleft() for _ in range(n)]
