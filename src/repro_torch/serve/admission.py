"""Admission control: per-tenant SLOs enforced at submit time — port of
``repro/serve/admission.py`` (numpy and threading only; a copy but for
this docstring and the import paths).

A multi-tenant server under open-loop load has exactly one sane failure
mode: *reject early and say why*.  Queues that grow without bound convert
overload into unbounded latency for every accepted request; admission
control instead keeps the accepted population's tail latency bounded by
shedding the excess with a typed :class:`Overloaded` response the client
can back off on.  The elastic runtime
(:class:`~repro_torch.runtime.replan.ElasticCoordinator`) sheds with the
same class at its retry-queue cap.

Two independent gates, both per tenant:

* **queue-depth cap** (``SLO.queue_cap``) — a hard backstop that needs no
  latency model, so it also protects a cold tenant whose service time has
  not been measured yet;
* **SLO-aware shedding** — once the tenant's engine service time is known
  (rolling per-bucket dispatch p50 from
  :class:`~repro_torch.serve.qos.QosMonitor`, i.e. the same windows
  ``SessionStats`` reports), the predicted queueing delay of a request
  admitted *now* is ``batches_ahead x batch_service_s``; when that exceeds
  the tenant's p99 target the request is rejected rather than admitted into
  a queue position that cannot meet its SLO.  Load is shed — never served
  by collapsing the queue or silently dropping queued work.
"""
from __future__ import annotations

import dataclasses
import math
import time

from .qos import QosMonitor


@dataclasses.dataclass(frozen=True)
class SLO:
    """One tenant's service-level objective.

    ``p99_target_s`` — the tail-latency budget the admission policy defends
    (predicted queueing delay above it rejects).  ``queue_cap`` — hard cap
    on queued requests (the model-free backstop).  Either can be disabled
    with ``None``/``inf``.
    """

    p99_target_s: float = 0.5
    queue_cap: int | None = 256

    def __post_init__(self):
        if self.p99_target_s is not None and self.p99_target_s <= 0:
            raise ValueError("p99_target_s must be positive (or None)")
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1 (or None)")


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


class AdmissionController:
    """Policy over the monitor's rolling service-time estimates.

    The percentile query behind :meth:`predicted_delay_s` walks a rolling
    window, which is too heavy to pay on *every* submit at serving rates —
    the estimate is cached per tenant for ``cache_ttl_s`` (service time
    drifts over seconds, submits arrive every few hundred microseconds).
    """

    def __init__(self, monitor: QosMonitor, *, cache_ttl_s: float = 0.05,
                 clock=time.monotonic):
        self.monitor = monitor
        self.cache_ttl_s = float(cache_ttl_s)
        self._clock = clock
        self._service_cache: dict[str, tuple[float, float]] = {}

    def _service_time_s(self, tenant: str, max_batch: int) -> float:
        now = self._clock()
        hit = self._service_cache.get(tenant)
        if hit is not None and now - hit[0] < self.cache_ttl_s:
            return hit[1]
        est = self.monitor.service_time_s(tenant, bucket=max_batch)
        self._service_cache[tenant] = (now, est)
        return est

    def predicted_delay_s(self, tenant: str, *, queue_depth: int,
                          inflight_batches: int, max_batch: int) -> float:
        """Expected wait before a request admitted now is *dispatched*:
        every batch ahead of it (in flight, plus full batches formable from
        the queue in front of it — the request itself rides in the next
        partial one, which costs it nothing) costs one rolling-p50 batch
        service time.  Zero on an idle tenant; NaN while the tenant is cold
        (no dispatch measured yet)."""
        service_s = self._service_time_s(tenant, max_batch)
        if math.isnan(service_s):
            return float("nan")
        batches_ahead = inflight_batches + queue_depth // max(1, max_batch)
        return batches_ahead * service_s

    def admit(self, tenant: str, slo: SLO, *, queue_depth: int,
              inflight_batches: int, max_batch: int) -> None:
        """Raise :class:`Overloaded` if this request must be shed; record
        the submit/admit/reject outcome on the monitor either way."""
        self.monitor.on_submit(tenant)
        if slo.queue_cap is not None and queue_depth >= slo.queue_cap:
            self.monitor.on_reject(tenant)
            raise Overloaded(tenant, "queue_cap", queue_depth=queue_depth,
                             p99_target_s=slo.p99_target_s or float("nan"))
        if slo.p99_target_s is not None:
            predicted = self.predicted_delay_s(
                tenant, queue_depth=queue_depth,
                inflight_batches=inflight_batches, max_batch=max_batch)
            if not math.isnan(predicted) and predicted > slo.p99_target_s:
                self.monitor.on_reject(tenant)
                raise Overloaded(tenant, "slo", queue_depth=queue_depth,
                                 predicted_delay_s=predicted,
                                 p99_target_s=slo.p99_target_s)
        self.monitor.on_admit(tenant)
