"""`Session`: a serving handle over a plan — port of
``repro/api/session.py``.

Wraps :class:`~repro_torch.core.executor.CompiledSplitExecutor` with the
serving conveniences: padded batch buckets (requests are padded to a small
set of batch sizes so every dispatch has a familiar shape), a
``submit()``/``flush()`` micro-batching queue plus bulk ``submit_many()``,
``warmup()`` and rolling latency/throughput stats.

Padding is numerically free: every sample of a batch is computed
independently, so a padded slot cannot influence real samples —
``submit_many`` output is bit-identical to ``run_batch`` over the same
inputs (tested in int8).

A session serves a planner :class:`~repro_torch.api.plan.Plan` (the normal
path: it carries the plan's transport and search stats into
:class:`SessionStats`) or a bare core :class:`SplitPlan`.
:meth:`Session.distributed` hands the same plan and quantization to the
port's distributed runtime (:class:`~repro_torch.runtime.Coordinator`, or
:class:`~repro_torch.runtime.ElasticCoordinator` with ``elastic=True``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from ..core.executor import (CompiledSplitExecutor, reference_forward,
                             resolve_device)
from ..core.quantize import QuantizedModel, calibrate_scales, quantize_model
from ..core.splitting import SplitPlan
from .plan import Plan

PRECISIONS = ("int8", "float")
_DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)
_ROLLING_WINDOW = 512


class RollingLatency:
    """Rolling latency window with percentile queries, optionally keyed
    (bucket size, tenant name, ...).  The single percentile implementation:
    ``SessionStats`` and a serving layer's QoS monitor both report through
    it, so serving-layer QoS numbers and session stats cannot drift apart.

    Percentiles use the linear-interpolation definition of
    ``np.percentile`` over the retained window; empty windows return NaN.
    Thread-safe: the serving layer's scheduler thread records while client
    threads query.
    """

    __slots__ = ("window", "_all", "_by_key", "_lock")

    def __init__(self, window: int = _ROLLING_WINDOW):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self._all: collections.deque[float] = collections.deque(maxlen=window)
        self._by_key: dict[object, collections.deque[float]] = {}
        self._lock = threading.Lock()

    def record(self, value: float, key: object = None) -> None:
        self.record_many((value,), key=key)

    def record_many(self, values, key: object = None) -> None:
        """Record a batch of observations under one lock acquisition (the
        serving hot path records per dispatch, not per request)."""
        with self._lock:
            self._all.extend(float(v) for v in values)
            if key is not None:
                dq = self._by_key.get(key)
                if dq is None:
                    dq = self._by_key[key] = collections.deque(
                        maxlen=self.window)
                dq.extend(float(v) for v in values)

    def __len__(self) -> int:
        return len(self._all)

    def keys(self) -> tuple:
        with self._lock:
            return tuple(self._by_key)

    def values(self, key: object = None) -> tuple[float, ...]:
        """The retained window, oldest first."""
        with self._lock:
            return tuple(self._all if key is None
                         else self._by_key.get(key, ()))

    def percentile(self, q: float, key: object = None) -> float:
        vals = self.values(key)
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals, dtype=np.float64), q))

    def snapshot(self, qs: tuple[float, ...] = (50, 99)) -> dict[float, float]:
        return {q: self.percentile(q) for q in qs}


@dataclasses.dataclass(frozen=True)
class SessionStats:
    """Rolling serving statistics (engine dispatch time only)."""

    requests: int                   # real requests served
    batches: int                    # engine dispatches issued
    padded: int                     # zero-padded slots executed
    wall_s: float                   # total dispatch wall time
    throughput_rps: float           # requests / wall_s
    mean_latency_s: float           # wall_s / batches (per-dispatch latency)
    per_bucket: dict[int, int]      # bucket size -> dispatch count
    # deployment context from the plan (defaults when serving a bare
    # core SplitPlan): the transport policy the plan was costed under and
    # the seconds/inference the planner predicts pipelining saves vs serial
    transport: str = "serial"
    predicted_overlap_saved_s: float = 0.0
    # rolling dispatch-latency percentiles over the last _ROLLING_WINDOW
    # dispatches (NaN before the first): overall and per bucket size —
    # the service-time estimates admission control predicts queueing with
    latency_p50_s: float = float("nan")
    latency_p99_s: float = float("nan")
    per_bucket_p50_s: dict[int, float] = dataclasses.field(default_factory=dict)
    per_bucket_p99_s: dict[int, float] = dataclasses.field(default_factory=dict)
    # plan-search telemetry carried over from the Plan this session serves
    # (core.search.SearchStats; zeros/NaN when serving a bare SplitPlan or
    # a plan deserialized from a pre-search-stats payload)
    search_candidates_evaluated: int = 0
    search_cache_hit_rate: float = float("nan")
    search_wall_s: float = float("nan")


class Ticket:
    """Handle for one queued request.

    Two fulfillment regimes share this class: a plain :class:`Session`
    ticket (``result()`` synchronously flushes the owning session on demand)
    and a detached ticket (``session=None``, fulfilled by another thread —
    a serving layer's scheduler — so ``result()`` waits on an event).
    ``result(timeout=...)`` raises :class:`TimeoutError` if the
    ticket is still unfulfilled after ``timeout`` seconds, and re-raises the
    dispatch exception if the batch this request rode in failed: a raising
    dispatch rejects its tickets instead of stranding them.
    """

    __slots__ = ("_session", "_value", "_error", "_event", "_t_done")

    def __init__(self, session: "Session | None" = None):
        self._session = session
        self._value = None
        self._error: BaseException | None = None
        self._event = threading.Event()
        self._t_done = float("nan")

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def completed_at(self) -> float:
        """``time.perf_counter()`` stamp of fulfillment/rejection (NaN while
        pending) — lets a load generator compute end-to-end latency without
        racing to observe the event itself."""
        return self._t_done

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.is_set() and self._session is not None:
            self._session.flush()   # synchronous path: serve the queue now
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket unfulfilled after {timeout} s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self) -> BaseException | None:
        """The dispatch error that rejected this ticket (None if none/undone)."""
        return self._error

    def _fulfill(self, value: np.ndarray) -> None:
        self._value = value
        self._t_done = time.perf_counter()
        self._event.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._t_done = time.perf_counter()
        self._event.set()


class InflightDispatch:
    """One asynchronously dispatched padded micro-batch.

    Returned by :meth:`Session.dispatch_async`: the engine's work has been
    *enqueued* on the device's stream but not waited for, so the caller
    can overlap host-side work — forming the next micro-batch, fulfilling
    the previous one's tickets — with this batch's device compute.  This is
    the in-flight bucket slot continuous batching admits into.

    ``wait()`` copies the result to the host (the one synchronization of a
    dispatch), records the dispatch into the owning session's stats (wall
    time measured enqueue -> ready, so under pipelining it includes device
    queueing — the effective per-batch service time), and returns the
    unpadded outputs.
    """

    __slots__ = ("_session", "_n", "_bucket", "_out", "_t0", "_result")

    def __init__(self, session: "Session", n: int, bucket: int, out, t0: float):
        self._session = session
        self._n = n
        self._bucket = bucket
        self._out = out
        self._t0 = t0
        self._result: np.ndarray | None = None

    @property
    def n_requests(self) -> int:
        return self._n

    @property
    def bucket(self) -> int:
        return self._bucket

    def wait(self) -> np.ndarray:
        if self._result is None:
            out = self._out.cpu().numpy()   # waits for the device's stream
            dt = time.perf_counter() - self._t0
            self._out = None
            self._session._record_dispatch(self._n, self._bucket, dt)
            self._result = out[:self._n]
        return self._result


class Session:
    """Micro-batched serving over a split plan on one device.

    Accepts a :class:`~repro_torch.api.plan.Plan` (the normal path —
    carries cluster and search context) or a bare core :class:`SplitPlan`
    (benchmarks/tests).

    ``precision="int8"`` builds the W8A8 deployment: a supplied ``qmodel``
    wins, else ``calibration`` activations (or ``calibration_samples`` seeded
    random inputs) calibrate the scales.  ``precision="float"`` serves fp32.
    ``buckets`` are the allowed padded batch sizes (ascending; the largest is
    the micro-batch chunk size).  ``device`` is where the engine runs: CUDA
    unless the caller passes another (the tests pass ``"cpu"``).
    """

    def __init__(self, plan: Plan | SplitPlan, *, precision: str = "int8",
                 qmodel: QuantizedModel | None = None,
                 calibration: list[np.ndarray] | None = None,
                 calibration_samples: int = 4, seed: int = 0, device=None,
                 max_batch: int = 32, buckets: tuple[int, ...] | None = None):
        if precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r} (want one of {PRECISIONS})")
        self.plan = plan if isinstance(plan, Plan) else None
        self.split = _split_plan(plan)
        self.transport = (self.plan.transport if self.plan is not None
                          else "serial")
        self.model = self.split.model
        self.precision = precision
        self.device = resolve_device(device)
        self._mode = "int8" if precision == "int8" else "float"
        if precision == "int8" and qmodel is None:
            qmodel = self._calibrate(calibration, calibration_samples, seed)
        self.qmodel = qmodel if precision == "int8" else None
        self.engine = CompiledSplitExecutor(self.split, self.qmodel,
                                            device=self.device)
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        bks = tuple(sorted({int(b) for b in (buckets or _DEFAULT_BUCKETS)
                            if 1 <= int(b) <= max_batch} | {1, int(max_batch)}))
        self.buckets = bks
        self.max_batch = int(max_batch)
        self._pending: list[tuple[np.ndarray, Ticket]] = []
        self._requests = 0
        self._batches = 0
        self._padded = 0
        self._wall_s = 0.0
        self._per_bucket: dict[int, int] = {}
        self._rolling = RollingLatency()

    # -- calibration ---------------------------------------------------------
    def _calibrate(self, calibration, n_samples: int, seed: int) -> QuantizedModel:
        if calibration is None:
            rng = np.random.default_rng(seed)
            calibration = [rng.standard_normal(self.model.input_shape)
                           .astype(np.float32) for _ in range(n_samples)]
        scales = calibrate_scales(
            self.model, calibration,
            lambda m, x: reference_forward(m, x, collect_activations=True,
                                           device=self.device)[1])
        return quantize_model(self.model, scales)

    # -- warmup --------------------------------------------------------------
    def warmup(self, buckets: tuple[int, ...] | None = None) -> None:
        """Upload the constants and build the kernels ahead of serving: one
        zero batch per bucket size."""
        shape = tuple(self.model.input_shape)
        for b in (buckets or self.buckets):
            self.engine.run_batch(np.zeros((int(b), *shape), np.float32),
                                  mode=self._mode)

    def bucket_for(self, n: int) -> int:
        """The padded batch size ``n`` requests dispatch at (the smallest
        configured bucket >= n, capped at the largest)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- serving -------------------------------------------------------------
    def check_input(self, x: np.ndarray) -> np.ndarray:
        """Validate/convert one request sample (public: a serving layer
        validates at admission time, before a request enters any queue)."""
        x = np.asarray(x, dtype=np.float32)
        if x.shape != tuple(self.model.input_shape):
            raise ValueError(f"request shape {x.shape} != model input "
                             f"{tuple(self.model.input_shape)}")
        return x

    def _record_dispatch(self, n: int, bucket: int, wall_s: float) -> None:
        self._requests += n
        self._batches += 1
        self._padded += bucket - n
        self._wall_s += wall_s
        self._per_bucket[bucket] = self._per_bucket.get(bucket, 0) + 1
        self._rolling.record(wall_s, key=bucket)

    def dispatch_async(self, xs: np.ndarray) -> InflightDispatch:
        """Enqueue one bucket-padded engine dispatch for ``n <= max_batch``
        requests WITHOUT waiting for the device.

        The continuous-batching seam: the engine never synchronizes inside
        a forward pass, so a scheduler can keep a bucket in flight on the
        device while it forms the next micro-batch.  Stats are recorded when
        the returned handle's ``wait()`` reads the result.
        """
        n = len(xs)
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"dispatch of {n} requests (want 1..{self.max_batch})")
        b = self.bucket_for(n)
        if b > n:
            pad = np.zeros((b - n, *xs.shape[1:]), np.float32)
            batch = np.concatenate([xs, pad])
        else:
            batch = xs
        t0 = time.perf_counter()
        out = self.engine.run_batch_async(batch, mode=self._mode)
        return InflightDispatch(self, n, b, out, t0)

    def _dispatch(self, xs: np.ndarray) -> np.ndarray:
        """One padded engine dispatch for n <= max bucket requests."""
        return self.dispatch_async(xs).wait()

    def submit_many(self, xs) -> np.ndarray:
        """Serve a bulk of requests, micro-batched into padded buckets.
        Returns outputs aligned with ``xs`` — bit-identical to
        ``run_batch(xs)`` over the same plan."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim != 4 or xs.shape[1:] != tuple(self.model.input_shape):
            raise ValueError(f"batch shape {xs.shape} != (n, "
                             f"{', '.join(map(str, self.model.input_shape))})")
        if len(xs) == 0:
            dtype = np.int8 if self._mode == "int8" else np.float32
            return np.zeros((0, *self.model.out_shape), dtype)
        return np.concatenate([self._dispatch(xs[i:i + self.max_batch])
                               for i in range(0, len(xs), self.max_batch)])

    def run(self, x) -> np.ndarray:
        """Serve one request now (bucket 1)."""
        return self.submit_many(self.check_input(x)[None])[0]

    def submit(self, x) -> Ticket:
        """Queue one request for the next :meth:`flush`; returns a
        :class:`Ticket` whose ``result()`` flushes on demand."""
        t = Ticket(self)
        self._pending.append((self.check_input(x), t))
        return t

    def flush(self) -> int:
        """Serve every queued request in bucket-padded micro-batches;
        returns the number of requests served.

        A raising dispatch REJECTS every ticket of this flush with the
        exception (their ``result()`` re-raises it) and then re-raises, so a
        poisoned batch can never leave callers blocked on tickets that will
        never be fulfilled.  Requests submitted *during* the dispatch land
        in the next flush untouched.
        """
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        try:
            ys = self.submit_many(np.stack([x for x, _ in pending]))
        except Exception as e:
            for _, ticket in pending:
                ticket._reject(e)
            raise
        for (_, ticket), y in zip(pending, ys):
            ticket._fulfill(np.asarray(y))
        return len(pending)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    # -- elastic replan ------------------------------------------------------
    def replan(self, plan: Plan | SplitPlan) -> None:
        """Swap this session onto a new plan for the *same* model, keeping
        the quantization, stats, buckets, and queued tickets.

        The new engine reuses the cross-instance constant cache
        (``CompiledSplitExecutor._fn_cache`` is keyed on plan fingerprints),
        so replanning back onto previously-seen geometry uploads nothing.
        Pending tickets simply flush under the new plan; output stays
        bit-exact because the qmodel is shared.
        """
        new_plan = plan if isinstance(plan, Plan) else None
        new_split = _split_plan(plan)
        if new_split.model is not self.model and (
                tuple(new_split.model.input_shape)
                != tuple(self.model.input_shape)):
            raise ValueError("replan target was built for a different model")
        self.plan = new_plan
        self.split = new_split
        self.transport = (new_plan.transport if new_plan is not None
                          else "serial")
        self.model = new_split.model
        self.engine = CompiledSplitExecutor(new_split, self.qmodel,
                                            device=self.device)

    # -- distributed serving -------------------------------------------------
    def distributed(self, *, elastic: bool = False, workers=None,
                    objective=None, **kwargs) -> "object":
        """A :class:`~repro_torch.runtime.Coordinator` over this session's
        plan and quantization (same qmodel, so distributed output is
        bit-identical to this session), on this session's device unless
        ``device=`` says otherwise.  Caller drives its async lifecycle::

            async with sess.distributed(spawn="process") as coord:
                y = await coord.infer(x)

        With ``elastic=True`` (requires ``workers``: the
        :class:`~repro_torch.core.allocation.WorkerParams` of the physical
        fleet), returns an :class:`~repro_torch.runtime.ElasticCoordinator`
        that re-plans and serves through worker failure, demotion, and
        rejoin::

            async with sess.distributed(elastic=True, workers=ws) as ec:
                y = await ec.infer(x)      # survives churn
        """
        kwargs.setdefault("device", self.device)
        if elastic:
            if workers is None:
                raise ValueError("distributed(elastic=True) needs workers=")
            from ..runtime.elastic import ElasticCluster
            from ..runtime.replan import ElasticCoordinator
            cluster = ElasticCluster(self.model, list(workers),
                                     objective=objective)
            return ElasticCoordinator(cluster, self.qmodel,
                                      precision=self.precision, **kwargs)
        from ..runtime.coordinator import Coordinator
        return Coordinator(self.split, self.qmodel,
                           precision=self.precision, **kwargs)

    # -- observability -------------------------------------------------------
    def dispatch_latency_s(self, bucket: int | None = None,
                           q: float = 50.0) -> float:
        """Rolling dispatch-latency percentile (NaN before any dispatch):
        the per-batch service-time estimate admission control predicts
        queueing delay with."""
        return self._rolling.percentile(q, key=bucket)

    def stats(self) -> SessionStats:
        search_stats = (getattr(self.plan, "search_stats", None)
                        if self.plan is not None else None)
        return SessionStats(
            requests=self._requests, batches=self._batches,
            padded=self._padded, wall_s=self._wall_s,
            throughput_rps=(self._requests / self._wall_s
                            if self._wall_s > 0 else 0.0),
            mean_latency_s=(self._wall_s / self._batches
                            if self._batches else 0.0),
            per_bucket=dict(self._per_bucket),
            transport=self.transport,
            predicted_overlap_saved_s=(self.plan.overlap_saved_s
                                       if self.plan is not None else 0.0),
            latency_p50_s=self._rolling.percentile(50),
            latency_p99_s=self._rolling.percentile(99),
            per_bucket_p50_s={b: self._rolling.percentile(50, key=b)
                              for b in self._rolling.keys()},
            per_bucket_p99_s={b: self._rolling.percentile(99, key=b)
                              for b in self._rolling.keys()},
            search_candidates_evaluated=(search_stats or {}).get(
                "candidates_evaluated", 0),
            search_cache_hit_rate=(search_stats or {}).get(
                "cache_hit_rate", float("nan")),
            search_wall_s=(search_stats or {}).get(
                "search_wall_s", float("nan")))


def _split_plan(plan) -> SplitPlan:
    split = plan.split if isinstance(plan, Plan) else plan
    if not isinstance(split, SplitPlan):
        raise TypeError("plan must be a repro_torch.api.Plan or a core "
                        "SplitPlan")
    return split
