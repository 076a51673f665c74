"""Per-tenant QoS monitoring for the multi-tenant server — port of
``repro/serve/qos.py`` (numpy and threading only; a copy but for this
docstring).

``QosMonitor`` is the serving layer's single observability surface: every
admission, rejection, dispatch and completion event flows through it, and it
answers the two questions the rest of the subsystem asks —

* *admission control*: "how long will a request admitted now wait?" —
  answered from the rolling per-bucket engine dispatch latencies of each
  tenant's registered ``Session`` (:meth:`service_time_s` delegates to
  ``Session.dispatch_latency_s``).  The monitor does NOT keep a second
  dispatch-latency store: the session's ``RollingLatency`` windows — the
  ones ``SessionStats`` reports — are the single stats implementation
  shared between the session and the serving layer;
* *operators / the load generator*: rolling end-to-end p50/p99 latency,
  queue depth, throughput and accept/reject counters per tenant
  (:meth:`snapshot`).

The push-event design is grounded in sparse_framework's monitor plumbing
(``MonitorClient`` in SNIPPETS.md): serving nodes push lifecycle events into
a rolling store; reporters sample it without perturbing the hot path.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

from ..api.session import RollingLatency


@dataclasses.dataclass(frozen=True)
class TenantQos:
    """One tenant's rolling QoS sample (NaN percentiles before traffic)."""

    tenant: str
    submitted: int                  # admission attempts seen
    accepted: int
    rejected: int                   # typed Overloaded rejections
    completed: int
    failed: int                     # tickets rejected by a raising dispatch
    queue_depth: int                # queued requests at sample time
    inflight: int                   # requests inside in-flight dispatches
    latency_p50_s: float            # end-to-end: admit -> fulfilled
    latency_p99_s: float
    throughput_rps: float           # completions / rolling-window span
    rejection_rate: float           # rejected / submitted

    def describe(self) -> str:
        return (f"{self.tenant}: p50={self.latency_p50_s * 1e3:.2f}ms "
                f"p99={self.latency_p99_s * 1e3:.2f}ms "
                f"{self.throughput_rps:.0f} req/s "
                f"depth={self.queue_depth} "
                f"acc={self.accepted} rej={self.rejected} "
                f"({self.rejection_rate:.1%})")


class _TenantTrack:
    __slots__ = ("latency", "completions", "submitted", "accepted",
                 "rejected", "completed", "failed")

    def __init__(self, window: int):
        self.latency = RollingLatency(window)
        # completion timestamps: throughput over the retained span
        self.completions = RollingLatency(window)
        self.submitted = 0
        self.accepted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0


class QosMonitor:
    """Rolling per-tenant QoS aggregation (thread-safe: submit threads and
    the scheduler thread push concurrently)."""

    def __init__(self, window: int = 1024, clock=time.monotonic):
        self.window = int(window)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantTrack] = {}
        # tenant -> Session whose rolling dispatch windows answer
        # service_time_s (one stats implementation, owned by the session)
        self._sessions: dict[str, object] = {}

    def _track(self, tenant: str) -> _TenantTrack:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _TenantTrack(self.window)
        return t

    def register_session(self, tenant: str, session) -> None:
        """Bind a tenant to the ``Session`` whose rolling per-bucket
        dispatch latencies back :meth:`service_time_s`."""
        with self._lock:
            self._sessions[tenant] = session

    # -- lifecycle events ---------------------------------------------------
    def on_submit(self, tenant: str) -> None:
        with self._lock:
            self._track(tenant).submitted += 1

    def on_admit(self, tenant: str) -> None:
        with self._lock:
            self._track(tenant).accepted += 1

    def on_reject(self, tenant: str) -> None:
        with self._lock:
            self._track(tenant).rejected += 1

    def on_complete(self, tenant: str, latency_s: float) -> None:
        self.on_complete_batch(tenant, (latency_s,))

    def on_complete_batch(self, tenant: str, latencies_s) -> None:
        """Record one dispatch's worth of completions in one pass (the
        scheduler completes per batch; per-request locking would tax the
        serving hot path)."""
        latencies_s = tuple(latencies_s)
        with self._lock:
            t = self._track(tenant)
            t.completed += len(latencies_s)
            t.latency.record_many(latencies_s)
            now = self._clock()
            t.completions.record_many(now for _ in latencies_s)

    def on_failure(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            self._track(tenant).failed += n

    # -- queries ------------------------------------------------------------
    def service_time_s(self, tenant: str, bucket: int | None = None) -> float:
        """Rolling p50 engine wall per dispatched batch (NaN when cold —
        e.g. before the tenant's first served dispatch, when only the
        model-free queue-cap gate can hold).

        Prefers the requested bucket's window in the tenant session's
        rolling stats; falls back to the all-bucket window so admission
        control has an estimate as soon as ANY batch size has been measured.
        """
        with self._lock:
            session = self._sessions.get(tenant)
        if session is None:
            return float("nan")
        v = (session.dispatch_latency_s(bucket=int(bucket))
             if bucket is not None else float("nan"))
        if math.isnan(v):
            v = session.dispatch_latency_s()
        return v

    def snapshot(self, tenant: str, queue_depth: int = 0,
                 inflight: int = 0) -> TenantQos:
        with self._lock:
            t = self._track(tenant)
            span = 0.0
            if len(t.completions) >= 2:
                stamps = t.completions.values()
                span = stamps[-1] - stamps[0]
            return TenantQos(
                tenant=tenant,
                submitted=t.submitted,
                accepted=t.accepted,
                rejected=t.rejected,
                completed=t.completed,
                failed=t.failed,
                queue_depth=queue_depth,
                inflight=inflight,
                latency_p50_s=t.latency.percentile(50),
                latency_p99_s=t.latency.percentile(99),
                throughput_rps=((len(t.completions) - 1) / span
                                if span > 0 else 0.0),
                rejection_rate=(t.rejected / t.submitted
                                if t.submitted else 0.0))

    def tenants(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._tenants)
