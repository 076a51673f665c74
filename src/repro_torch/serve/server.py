"""Multi-tenant continuous-batching server over compiled split plans —
port of ``repro/serve/server.py``.

The ``Session`` facade serves one caller at a time: every batch needs a
client-driven ``flush()`` barrier, and every client owns a whole compiled
plan.  ``Server`` is the layer above it for the millions-of-users story —
one process hosts several named *tenants* (several compiled plans, or one
model at several resolutions), each wrapped in its own ``Session``, all
sharing the class-level cross-instance constant cache (tenants with
identical shard geometry upload nothing twice) and one scheduler:

* **continuous batching** — a single scheduler thread drains per-tenant
  FIFO queues, forming bucket-padded micro-batches from *whatever is
  queued* and admitting them into in-flight dispatch slots
  (``Session.dispatch_async``: CUDA launches are asynchronous and each
  dispatch's output comes back through its own pinned copy and event, so
  while one bucket computes on the device the scheduler is already
  stacking/padding the next and fulfilling the previous — no ``flush()``
  barrier anywhere, host work overlaps device work);
* **admission control** — per-tenant :class:`~repro_torch.serve.admission.SLO`
  (queue-depth cap + predicted-queueing-delay shedding) enforced at
  ``submit()``, rejecting with a typed
  :class:`~repro_torch.serve.admission.Overloaded` instead of queueing work
  that cannot meet its target;
* **QoS monitoring** — every lifecycle event lands in the shared
  :class:`~repro_torch.serve.qos.QosMonitor` (rolling p50/p99, throughput,
  accept/reject counters), whose service-time model is the tenant
  session's own rolling dispatch stats.

Tenants run where their sessions do: on CUDA unless ``add_tenant`` is given
``device="cpu"`` (passed through to :class:`Session`); without CUDA a
tenant that names no device raises.  On the card every conv and linear
stage is the hand-written ``qgemm`` kernel and every depthwise layer
``dwconv3x3_bands`` (spatial plans) or ``dwconv3x3`` (flat plans); a CUDA
tensor never takes a plain version.

Per-request int8 results are bit-identical to ``Session.run`` on the same
plan: each sample's integer sums are exact in int32 whatever the batch's M
(``qgemm`` sums its split K in int32), so neither bucket padding nor which
requests share a micro-batch can change a sample's output.  Float tenants
may differ from ``Session.run`` in the last bit between bucket sizes, since
cuDNN may choose another algorithm for another batch; they are held at
1e-5.

Threads and the device: the scheduler thread launches the forwards while
clients may call ``Session.run`` on the main thread.  Both launch on the
session's explicit device and on its one current stream (no stream per
thread: ``qgemm``'s split-K counters are correct only while launches are
ordered on one stream), and float sections hold the process-wide TF32 lock
of ``core.executor._full_fp32``.

Failure isolation: a dispatch that raises in Python (a bad shape, an
operand check) rejects exactly the tickets that rode in it (their
``result()`` re-raises) and the scheduler keeps serving — one tenant's
poisoned batch cannot take the server down.  A device fault (an illegal
address, say) poisons the CUDA context of the whole process: it surfaces
as an error on the dispatch that sees it and on every later one, and no
server can isolate it.

Synchronous by design: clients are threads calling ``submit()`` and
blocking on tickets.  The asyncio distributed runtime
(``repro_torch.runtime``) stays a per-plan execution backend underneath a
``Session``; this scheduler is the seam where those backends plug in later.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np

from .. import trace
from ..api.plan import Plan
from ..api.session import Session, Ticket
from ..core.executor import CompiledSplitExecutor
from ..core.splitting import SplitPlan
from .admission import SLO, AdmissionController, Overloaded
from .qos import QosMonitor, TenantQos
from .scheduler import EdfBatcher, make_request


class _Tenant:
    __slots__ = ("name", "session", "slo", "queue")

    def __init__(self, name: str, session: Session, slo: SLO):
        self.name = name
        self.session = session
        self.slo = slo
        self.queue = collections.deque()


class Server:
    """Continuous-batching, SLO-guarded serving over named tenants.

    ``max_inflight`` is the dispatch pipeline depth: how many bucket
    dispatches may be in flight on the device before the scheduler blocks
    on the oldest (2 overlaps host batch-forming with device compute;
    1 degenerates to the barrier behaviour).

    Usage::

        server = Server()
        server.add_tenant("mnv2@112", plan, slo=SLO(p99_target_s=0.2))
        with server:                      # start()/stop(drain=True)
            ticket = server.submit("mnv2@112", x)   # may raise Overloaded
            y = ticket.result(timeout=5.0)
    """

    def __init__(self, *, max_inflight: int = 2, monitor_window: int = 1024,
                 batcher: EdfBatcher | None = None, clock=time.monotonic):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = int(max_inflight)
        self.monitor = QosMonitor(window=monitor_window, clock=clock)
        self.admission = AdmissionController(self.monitor)
        self.batcher = batcher or EdfBatcher()
        self._clock = clock
        self._tenants: dict[str, _Tenant] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._running = False
        self._draining = False
        self._inflight_batches = 0
        self._request_ids = itertools.count()
        self._thread: threading.Thread | None = None

    # -- tenancy -------------------------------------------------------------
    def add_tenant(self, name: str, plan: Plan | SplitPlan | Session, *,
                   slo: SLO | None = None, warmup: bool = True,
                   **session_kwargs) -> Session:
        """Host a compiled plan under ``name``.

        ``plan`` may be a ready :class:`Session` or a ``Plan``/``SplitPlan``
        (compiled here with ``session_kwargs``, ``device=`` among them:
        CUDA unless given).  ``warmup`` runs every bucket once on the
        caller's thread so the scheduler never uploads constants or builds
        kernels; identical shard geometry across tenants hits the shared
        cross-instance constant cache instead of uploading again.
        """
        if self._thread is not None:
            raise RuntimeError("add_tenant before start(): tenancy is static")
        if name in self._tenants:
            raise ValueError(f"duplicate tenant {name!r}")
        session = (plan if isinstance(plan, Session)
                   else Session(plan, **session_kwargs))
        if warmup:
            session.warmup()
        self._tenants[name] = _Tenant(name, session, slo or SLO())
        self.monitor.register_session(name, session)
        return session

    def replan_tenant(self, name: str, plan: Plan | SplitPlan) -> None:
        """Swap a live tenant onto a new plan for the same model (elastic
        topology change under load).

        Runs under the scheduler lock, so the cutover is atomic with
        respect to batch formation: requests already queued dispatch under
        the new plan, and every unchanged shard geometry hits the shared
        cross-instance constant cache (``Session.replan`` uploads only new
        geometries).  A plan built for a different model is rejected before
        anything is touched.
        """
        with self._lock:
            tenant = self._tenant(name)
            tenant.session.replan(plan)
        if self._thread is None:
            # not started yet: warm on the caller's thread like add_tenant
            tenant.session.warmup()

    def session(self, tenant: str) -> Session:
        return self._tenant(tenant).session

    def _tenant(self, name: str) -> _Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r} "
                           f"(hosted: {sorted(self._tenants)})") from None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Server":
        with self._lock:
            if self._running:
                return self
            if not self._tenants:
                raise RuntimeError("start() with no tenants")
            self._running = True
            self._draining = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-scheduler", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the scheduler.  ``drain=True`` serves everything already
        admitted first; ``drain=False`` rejects queued requests with
        :class:`Overloaded` (reason ``"shutdown"``) so no ticket is ever
        stranded."""
        with self._lock:
            if not self._running and self._thread is None:
                return
            self._running = False
            self._draining = drain
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    @property
    def running(self) -> bool:
        return self._running

    # -- client surface ------------------------------------------------------
    def submit(self, tenant: str, x) -> Ticket:
        """Admit one request for ``tenant``; returns a detached
        :class:`Ticket` (``result(timeout=...)``).  Raises
        :class:`Overloaded` when admission control sheds the request and
        ``ValueError`` on a malformed input (checked before admission).
        The request takes the server's next id and a
        ``time.perf_counter_ns()`` stamp, the key and start of its
        ``serve.queue`` span (:mod:`repro_torch.trace`)."""
        t_ns = time.perf_counter_ns()
        t = self._tenant(tenant)
        x = t.session.check_input(x)
        with self._lock:
            if not self._running:
                raise RuntimeError("server is not running")
            self.admission.admit(
                tenant, t.slo, queue_depth=len(t.queue),
                inflight_batches=self._inflight_batches,
                max_batch=t.session.max_batch)
            req = make_request(x, tenant, self._clock(), t.slo,
                               rid=next(self._request_ids), t_submit_ns=t_ns)
            t.queue.append(req)
            self._work.notify()
        return req.ticket

    def run(self, tenant: str, x, timeout: float | None = None) -> np.ndarray:
        """Submit-and-wait convenience (one request, end to end)."""
        return self.submit(tenant, x).result(timeout=timeout)

    # -- observability -------------------------------------------------------
    def stats(self, tenant: str | None = None):
        """Rolling :class:`TenantQos` for one tenant, or ``{name: TenantQos}``
        for all."""
        if tenant is not None:
            t = self._tenant(tenant)
            return self.monitor.snapshot(tenant, queue_depth=len(t.queue),
                                         inflight=self._inflight_batches)
        return {name: self.stats(name) for name in self._tenants}

    def queue_depth(self, tenant: str) -> int:
        return len(self._tenant(tenant).queue)

    @staticmethod
    def cache_stats() -> dict:
        """Hit/miss counters of the cross-instance constant cache all
        tenants share (:class:`CompiledSplitExecutor`)."""
        return CompiledSplitExecutor.cache_stats()

    # -- scheduler loop ------------------------------------------------------
    def _has_queued(self) -> bool:
        return any(t.queue for t in self._tenants.values())

    def _form_batch(self, full_only: bool = False):
        """Under the lock: pick a tenant (EDF) and take its next micro-batch.

        ``full_only`` restricts candidates to tenants with a full
        ``max_batch`` queued — the scheduler's bucket-filling rule: partial
        (padded) buckets are dispatched only when the device would otherwise
        go idle, never while another dispatch is still in flight, so
        saturation throughput is not spent on padding.
        """
        queues = {n: t.queue for n, t in self._tenants.items()
                  if not full_only or len(t.queue) >= t.session.max_batch}
        name = self.batcher.select(queues)
        if name is None:
            return None
        t = self._tenants[name]
        reqs = self.batcher.take(t.queue, t.session.max_batch)
        self._inflight_batches += 1
        return t, reqs

    def _loop(self) -> None:
        inflight: collections.deque = collections.deque()
        while True:
            batch = None
            with self._lock:
                while self._running and not self._has_queued() and not inflight:
                    self._work.wait(0.1)
                if not self._has_queued() and not inflight:
                    if not self._running:
                        break
                    continue
                if (not self._running and not self._draining):
                    # reject everything still queued: no stranded tickets
                    for t in self._tenants.values():
                        while t.queue:
                            req = t.queue.popleft()
                            req.ticket._reject(Overloaded(
                                t.name, "shutdown",
                                queue_depth=len(t.queue)))
                    batch = None
                elif len(inflight) < self.max_inflight:
                    batch = self._form_batch(full_only=bool(inflight))
                    t_taken_ns = trace.clock()
            if batch is not None:
                tenant, reqs = batch
                try:
                    xs = np.stack([r.x for r in reqs])
                    disp = tenant.session.dispatch_async(xs)
                except Exception as e:  # noqa: BLE001 — isolate the batch
                    self._fail_batch(tenant, reqs, e)
                    continue
                if t_taken_ns is not None:
                    attrs = {"dispatch": disp.dispatch_id,
                             "tenant": tenant.name}
                    for r in reqs:
                        trace.record("serve.queue", r.rid, r.t_submit_ns,
                                     t_taken_ns, attrs)
                inflight.append((disp, reqs, tenant))
                if len(inflight) < self.max_inflight:
                    continue    # keep the device pipe full before blocking
            if inflight:
                self._complete(*inflight.popleft())
            elif batch is None:
                with self._lock:
                    if not self._running and not self._has_queued():
                        break

    def _fail_batch(self, tenant: _Tenant, reqs, error: BaseException) -> None:
        for r in reqs:
            r.ticket._reject(error)
        self.monitor.on_failure(tenant.name, len(reqs))
        with self._lock:
            self._inflight_batches -= 1
            self._work.notify()

    def _complete(self, disp, reqs, tenant: _Tenant) -> None:
        try:
            outs = disp.wait()
        except Exception as e:  # noqa: BLE001 — isolate the batch
            self._fail_batch(tenant, reqs, e)
            return
        t0_ns = trace.clock()
        now = self._clock()
        for r, y in zip(reqs, outs):
            r.ticket._fulfill(np.asarray(y))
        self.monitor.on_complete_batch(
            tenant.name, [now - r.t_arrival for r in reqs])
        if t0_ns is not None:
            trace.record("serve.fulfill", disp.dispatch_id, t0_ns,
                         time.perf_counter_ns(), {"tenant": tenant.name})
        with self._lock:
            self._inflight_batches -= 1
            self._work.notify()


__all__ = ["Server", "SLO", "Overloaded", "QosMonitor", "TenantQos"]
