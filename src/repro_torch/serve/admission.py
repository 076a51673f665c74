"""Typed load shedding — the part of ``repro/serve/admission.py`` the
distributed runtime raises.

:class:`Overloaded` is copied here because the elastic runtime
(:class:`~repro_torch.runtime.replan.ElasticCoordinator`) sheds with it at
its retry-queue cap.  The SLO gates and the admission controller of the
reference module come with the port's serving slice, which raises the same
class.
"""
from __future__ import annotations


class Overloaded(RuntimeError):
    """Typed load-shed response: the tenant cannot take this request now.

    Carries enough structure for a client to back off intelligently:
    which gate fired (``reason``: ``"queue_cap"``, ``"slo"`` —
    ``"shutdown"`` for requests rejected by a non-draining stop, or
    ``"rebalancing"`` when the elastic runtime sheds at its retry-queue
    cap during a topology transition), the queue state it saw, and the
    predicted delay vs the tenant's target.
    """

    def __init__(self, tenant: str, reason: str, *, queue_depth: int,
                 predicted_delay_s: float = float("nan"),
                 p99_target_s: float = float("nan")):
        self.tenant = tenant
        self.reason = reason
        self.queue_depth = queue_depth
        self.predicted_delay_s = predicted_delay_s
        self.p99_target_s = p99_target_s
        if reason == "queue_cap":
            detail = f"queue depth {queue_depth} at cap"
        elif reason == "slo":
            detail = (f"predicted queueing delay "
                      f"{predicted_delay_s * 1e3:.1f} ms exceeds p99 target "
                      f"{p99_target_s * 1e3:.1f} ms at depth {queue_depth}")
        else:
            detail = f"rejected at queue depth {queue_depth}"
        super().__init__(f"tenant {tenant!r} overloaded ({reason}): {detail}")
