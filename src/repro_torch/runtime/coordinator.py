"""Asyncio coordinator: drives one SplitPlan across socket workers — port
of ``repro/runtime/coordinator.py``.

The coordinator owns the model-level orchestration the paper assigns to the
gateway: it quantizes the request input, routes each worker its download
slice per block group, reassembles uploads (row-band concat for spatial
groups, flat-range concat otherwise), and keeps the coordinator-side ops —
residual adds, stash saves, global avgpool — exactly as the single-process
executors do (the same torch helpers, on the coordinator's device), so
distributed output is bit-identical to ``Session``.

Schedule realization (the PR 4 pipelined transport, for real): every block
group runs as its own asyncio task, and every (group, worker) feed is a
sub-task.  Per-worker send queues are FIFO links; a feed enqueues its
download as soon as its dependencies resolve, so downloads for group ``g+1``
overlap group ``g``'s compute and uploads.  Dependencies come from the
coordinator plan's boundary structure (``shards.build_coordinator_plan``):

* **clean seams** (spatial -> spatial, no coordinator-side post-op): the
  feed for worker ``w`` awaits only the band events of its
  ``_boundary_deps`` producers — the fine-grained row-overlap dependency.
* **everything else** barriers on the previous group's completion event
  (set after residual/stash post-ops), matching the simulator's model.

Each realized dependency is recorded as a ``(segment, consumer, producer)``
edge; validation checks the measured edge set is a superset of
``core.simulator.dependency_edges`` of the same plan.

Failure surfacing: every result await runs under a per-message timeout with
bounded resend (workers recompute idempotently); worker death (EOF,
truncated frame, protocol garbage) fails all of that worker's pending
futures; a heartbeat monitor catches silent wedges.  All of these surface
as ``RuntimeError`` naming the worker — never a hang.  ``close()`` cancels
every task the coordinator created (no orphans) and reaps spawned
processes.

Device: the coordinator's own ops (input quantization, residual adds,
the global average pool) run on its device, CUDA unless the caller passes
another; its workers compute on the same device.  Spawned workers are
``python -m repro_torch.runtime.worker --device <device>``; on CUDA the
coordinator builds the kernels once before it spawns any, so the workers
load them instead of each compiling them.
"""
from __future__ import annotations

import asyncio
import os
import sys
import time

import numpy as np
import torch

from ..core.executor import _avgpool_int8, _residual_add_int8, resolve_device
from ..core.quantize import QuantizedModel, quantize_activation_t
from ..core.simulator import Timeline, TimelineEvent
from ..core.splitting import SplitPlan
from .protocol import ConnectionClosed, ProtocolError, read_frame, write_frame
from .shards import (SEGMENT_CACHE_CAP, build_coordinator_plan,
                     build_worker_setup, delta_setup, setup_array_bytes)

SPAWN_MODES = ("process", "inprocess", "external")


class WorkerHandle:
    """Coordinator-side state for one connected worker."""

    def __init__(self, worker: int, loop: asyncio.AbstractEventLoop):
        self.worker = worker
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.send_q: asyncio.Queue = asyncio.Queue()
        self.pending: dict[tuple, asyncio.Future] = {}
        self.ready_fut: asyncio.Future = loop.create_future()
        self.failed: BaseException | None = None
        self.last_heartbeat = time.monotonic()
        self.setup_s = 0.0
        self.proc = None                    # asyncio subprocess, if spawned
        self.log_file = None
        # warm-store bookkeeping for elastic delta setups.  held_segments
        # mirrors the worker's compiled-segment LRU (same order, same
        # SEGMENT_CACHE_CAP), so "expected cache hit" never claims a
        # fingerprint the worker has already evicted.
        self.held_arrays: dict[str, int] = {}    # content fp -> nbytes
        self.held_segments: dict[str, None] = {}  # fp -> None, LRU order


class _RequestCtx:
    """Per-request dataflow state."""

    def __init__(self, seq: int, x0: np.ndarray, n_groups: int,
                 n_workers: int):
        self.seq = seq
        self.x0 = x0
        self.raw: list[np.ndarray | None] = [None] * n_groups
        self.final: list[np.ndarray | None] = [None] * n_groups
        self.band_ev = [{w: asyncio.Event() for w in range(n_workers)}
                        for _ in range(n_groups)]
        self.complete = [asyncio.Event() for _ in range(n_groups)]
        self.stash: dict = {}
        self.edges: set[tuple[int, int, int]] = set()


class Coordinator:
    """Distributed executor for one compiled split plan.

    Async context manager::

        async with Coordinator(split, qmodel, spawn="process") as coord:
            y = await coord.infer(x)
            tl = coord.last_timeline
    """

    def __init__(self, split: SplitPlan, qmodel: QuantizedModel | None = None,
                 *, precision: str = "int8", spawn: str = "process",
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 60.0, max_retries: int = 2,
                 setup_timeout: float = 300.0, heartbeat_s: float = 0.5,
                 heartbeat_timeout: float = 30.0, log_dir: str | None = None,
                 device=None):
        if spawn not in SPAWN_MODES:
            raise ValueError(f"unknown spawn mode {spawn!r} "
                             f"(want one of {SPAWN_MODES})")
        self.split = split
        self.qmodel = qmodel
        self.precision = precision
        self.spawn = spawn
        self.host = host
        self.port = port
        self.request_timeout = request_timeout
        self.max_retries = max_retries
        self.setup_timeout = setup_timeout
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout = heartbeat_timeout
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.cplan = build_coordinator_plan(split, qmodel, precision)
        self.expected = sorted({w for g in self.cplan.groups
                                for w in g.actives})
        self.handles: dict[int, WorkerHandle] = {}
        self.last_timeline: Timeline | None = None
        self.last_edges: set[tuple[int, int, int]] = set()
        self.measured_edges: set[tuple[int, int, int]] = set()
        self.setup_s = 0.0
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()
        self._retired: list[WorkerHandle] = []
        self._seq = 0
        self._infer_lock = asyncio.Lock()
        self._fatal: asyncio.Future | None = None
        self._int8 = precision == "int8"
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    async def __aenter__(self) -> "Coordinator":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _track(self, coro) -> asyncio.Task:
        t = asyncio.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    async def start(self) -> None:
        """Bind the server, spawn/attach workers, ship setups, await ready."""
        loop = asyncio.get_running_loop()
        self._fatal = loop.create_future()
        self.handles = {w: WorkerHandle(w, loop) for w in self.expected}
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        t0 = time.monotonic()
        if self.device.type == "cuda" and self.spawn != "external":
            # one build before any worker starts: workers then load the
            # kernels instead of each running nvcc
            from ..kernels import backend
            await loop.run_in_executor(None, backend.build)
        if self.spawn == "process":
            await self._spawn_processes()
        elif self.spawn == "inprocess":
            from .worker import run_worker
            for w in self.expected:
                self._track(run_worker(self.host, self.port, w,
                                       heartbeat_s=self.heartbeat_s,
                                       device=self.device))
        ready = asyncio.gather(*(h.ready_fut
                                 for h in self.handles.values()))
        done, _ = await asyncio.wait(
            {asyncio.ensure_future(ready), self._fatal},
            timeout=self.setup_timeout,
            return_when=asyncio.FIRST_COMPLETED)
        if self._fatal in done or not done:
            ready.cancel()
            await asyncio.gather(ready, return_exceptions=True)
            if self._fatal in done:
                raise RuntimeError(f"runtime setup failed: "
                                   f"{self._fatal.result()}")
            missing = [w for w, h in self.handles.items()
                       if not h.ready_fut.done()]
            raise RuntimeError(
                f"runtime setup timed out after {self.setup_timeout}s "
                f"waiting for workers {missing}")
        await ready                         # re-raise per-worker failures
        self.setup_s = time.monotonic() - t0
        self._track(self._monitor())
        self._started = True

    async def _spawn_one(self, w: int) -> None:
        import repro_torch
        src = os.path.dirname(os.path.dirname(os.path.abspath(
            repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        h = self.handles[w]
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            h.log_file = open(os.path.join(self.log_dir,
                                           f"worker{w}.log"), "wb")
            out = h.log_file
        else:
            out = asyncio.subprocess.DEVNULL
        h.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "repro_torch.runtime.worker",
            "--host", self.host, "--port", str(self.port),
            "--id", str(w), "--heartbeat-s", str(self.heartbeat_s),
            "--device", str(self.device),
            env=env, stdout=out, stderr=out)

    async def _spawn_processes(self) -> None:
        for w in self.expected:
            await self._spawn_one(w)

    async def close(self) -> None:
        """Shut everything down; cancels every coordinator-created task."""
        for h in self.handles.values():
            if h.writer is not None and h.failed is None:
                try:
                    await write_frame(h.writer, "shutdown", drain=False)
                except (ConnectionError, RuntimeError, OSError):
                    pass
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        for h in list(self.handles.values()) + self._retired:
            if h.writer is not None:
                h.writer.close()
            if h.proc is not None:
                try:
                    await asyncio.wait_for(h.proc.wait(), timeout=10)
                except asyncio.TimeoutError:
                    h.proc.kill()
                    await h.proc.wait()
            if h.log_file is not None:
                h.log_file.close()
        self._retired.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection handling -----------------------------------------------

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            hello = await read_frame(reader)
            if hello.type != "hello":
                raise ProtocolError(f"expected hello, got {hello.type!r}")
            w = hello.meta["worker"]
            h = self.handles.get(w)
            if h is None or h.reader is not None:
                raise ProtocolError(f"unexpected worker id {w!r}")
        except (ProtocolError, KeyError, TypeError) as e:
            writer.close()
            if self._fatal is not None and not self._fatal.done():
                self._fatal.set_result(
                    f"unidentified peer rejected during attach: {e}")
            return
        h.reader, h.writer = reader, writer
        h.last_heartbeat = time.monotonic()
        self._track(self._sender_loop(h))
        self._track(self._reader_loop(h))
        meta, arrays = build_worker_setup(self.split, self.qmodel,
                                          self.precision, w)
        meta["worker"] = w
        self._record_held(h, meta, arrays)
        h.send_q.put_nowait(("setup", {"plan": meta}, arrays))

    @staticmethod
    def _record_held(h: WorkerHandle, meta: dict, arrays: dict) -> None:
        """Track which array contents / segment geometries a worker holds,
        so a later replan ships only the delta."""
        for spec in meta["segments"]:
            for key, fp in spec.get("array_fps", {}).items():
                h.held_arrays[fp] = int(arrays[key].nbytes)
            fp = spec.get("fingerprint")
            if fp is None:
                continue
            # replay the worker's LRU: hit -> most-recent, miss -> insert,
            # evict oldest beyond the cap (build_segment_fns does the same
            # in the same spec order)
            h.held_segments.pop(fp, None)
            h.held_segments[fp] = None
            while len(h.held_segments) > SEGMENT_CACHE_CAP:
                del h.held_segments[next(iter(h.held_segments))]

    async def _sender_loop(self, h: WorkerHandle) -> None:
        try:
            while True:
                ftype, meta, arrays = await h.send_q.get()
                await write_frame(h.writer, ftype, meta, arrays)
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError, RuntimeError) as e:
            self._fail_worker(h, f"send to worker {h.worker} failed: {e}")

    async def _reader_loop(self, h: WorkerHandle) -> None:
        try:
            while True:
                frame = await read_frame(h.reader)
                t = frame.type
                if t == "result":
                    key = (frame.meta["seq"], frame.meta["gi"])
                    fut = h.pending.get(key)
                    if fut is not None and not fut.done():
                        fut.set_result(frame)
                elif t in ("heartbeat", "pong"):
                    h.last_heartbeat = time.monotonic()
                elif t == "events":
                    key = ("events", frame.meta.get("seq"))
                    fut = h.pending.get(key)
                    if fut is not None and not fut.done():
                        fut.set_result(frame.meta.get("events", []))
                elif t == "ready":
                    h.setup_s = float(frame.meta.get("setup_s", 0.0))
                    h.last_heartbeat = time.monotonic()
                    fut = h.pending.get(("ready",))
                    if fut is not None and not fut.done():
                        fut.set_result(frame.meta)   # replan re-setup ack
                    elif not h.ready_fut.done():
                        h.ready_fut.set_result(frame.meta)
                else:
                    raise ProtocolError(f"unexpected frame {t!r}")
        except asyncio.CancelledError:
            raise
        except ConnectionClosed:
            self._fail_worker(
                h, f"worker {h.worker} closed its connection "
                   f"({len(h.pending)} request(s) in flight)")
        except (ProtocolError, OSError, Exception) as e:
            self._fail_worker(
                h, f"worker {h.worker} stream failure: {e}")

    def _fail_worker(self, h: WorkerHandle, msg: str) -> None:
        if h.failed is not None:
            return
        exc = RuntimeError(msg)
        h.failed = exc
        if not h.ready_fut.done():
            h.ready_fut.set_exception(exc)
        else:
            h.ready_fut.exception()         # may be unretrieved; silence
        for fut in h.pending.values():
            if not fut.done():
                fut.set_exception(exc)

    async def _monitor(self) -> None:
        """Heartbeat-staleness watchdog: a silent worker fails loudly."""
        while True:
            await asyncio.sleep(self.heartbeat_timeout / 4)
            now = time.monotonic()
            for h in self.handles.values():
                if (h.failed is None and h.ready_fut.done()
                        and not h.ready_fut.cancelled()
                        and h.ready_fut.exception() is None
                        and now - h.last_heartbeat > self.heartbeat_timeout):
                    self._fail_worker(
                        h, f"worker {h.worker} heartbeat silent for "
                           f"{now - h.last_heartbeat:.1f}s "
                           f"(timeout {self.heartbeat_timeout}s)")

    # -- elastic replan ----------------------------------------------------

    def _retire(self, h: WorkerHandle) -> None:
        """Queue a handle for teardown: polite shutdown if still healthy,
        process reaped in close().  Never blocks the replan."""
        if h.failed is None and h.writer is not None:
            h.send_q.put_nowait(("shutdown", {}, None))
        self._retired.append(h)

    async def replan_to(self, split: SplitPlan, *,
                        worker_map: dict[int, int] | None = None) -> dict:
        """Atomically cut the cluster over to a new SplitPlan.

        Runs entirely under the infer lock: in-flight requests finish (or
        fail) under the old plan, queued submissions resume under the new
        one — no request ever observes a half-shipped topology.

        ``worker_map`` maps each *new* plan worker index to the *old* index
        whose live connection it inherits.  Inherited workers get a delta
        setup (arrays they already hold are omitted; unchanged segment
        geometry reuses their warm compiled cache); unmapped indices get
        freshly spawned workers; old workers with no successor are retired.

        Returns a transition report: ``downtime_s``, ``reshipped_bytes``
        vs ``full_setup_bytes``, warm-cache ``cache_hits`` /
        ``cache_misses`` vs ``expected_cache_hits`` and the resulting
        ``hit_rate``.
        """
        if not self._started:
            raise RuntimeError("Coordinator.start() has not completed")
        worker_map = dict(worker_map or {})
        loop = asyncio.get_running_loop()
        async with self._infer_lock:
            t0 = time.monotonic()
            cplan = build_coordinator_plan(split, self.qmodel,
                                           self.precision)
            expected = sorted({w for g in cplan.groups for w in g.actives})
            new_handles: dict[int, WorkerHandle] = {}
            waiters: dict[int, asyncio.Future] = {}
            inherited: list[int] = []
            fresh: list[int] = []
            full_setup_bytes = 0
            reshipped_bytes = 0
            expected_cache_hits = 0
            for w in expected:
                meta, arrays = build_worker_setup(split, self.qmodel,
                                                  self.precision, w)
                meta["worker"] = w
                full_setup_bytes += setup_array_bytes(arrays)
                old = worker_map.get(w)
                h = self.handles.get(old) if old is not None else None
                if (h is not None and h.failed is None
                        and h.reader is not None):
                    ship = delta_setup(meta, arrays, set(h.held_arrays))
                    reshipped_bytes += setup_array_bytes(ship)
                    expected_cache_hits += sum(
                        1 for spec in meta["segments"]
                        if spec.get("fingerprint") in h.held_segments)
                    fut = loop.create_future()
                    h.pending[("ready",)] = fut
                    waiters[w] = fut
                    self._record_held(h, meta, arrays)
                    h.worker = w
                    h.send_q.put_nowait(("setup", {"plan": meta}, ship))
                    new_handles[w] = h
                    inherited.append(w)
                else:
                    nh = WorkerHandle(w, loop)
                    self._record_held(nh, meta, arrays)
                    reshipped_bytes += setup_array_bytes(arrays)
                    new_handles[w] = nh
                    waiters[w] = nh.ready_fut
                    fresh.append(w)
            kept = {id(h) for h in new_handles.values()}
            retired = [w for w, h in self.handles.items()
                       if id(h) not in kept]
            for w in retired:
                self._retire(self.handles[w])
            # atomic cutover: requests queued on the infer lock see this
            self.split, self.cplan, self.expected = split, cplan, expected
            self.handles = new_handles
            if self.spawn == "process":
                for w in fresh:
                    await self._spawn_one(w)
            elif self.spawn == "inprocess":
                from .worker import run_worker
                for w in fresh:
                    self._track(run_worker(self.host, self.port, w,
                                           heartbeat_s=self.heartbeat_s,
                                           device=self.device))
            ready = asyncio.gather(*waiters.values())
            try:
                metas = await asyncio.wait_for(ready, self.setup_timeout)
            except asyncio.TimeoutError:
                missing = [w for w, f in waiters.items() if not f.done()]
                raise RuntimeError(
                    f"replan setup timed out after {self.setup_timeout}s "
                    f"waiting for workers {missing}") from None
            finally:
                for w in inherited:
                    new_handles[w].pending.pop(("ready",), None)
            cache_hits = sum(int(m.get("cache_hits", 0)) for m in metas)
            cache_misses = sum(int(m.get("cache_misses", 0)) for m in metas)
            received_bytes = sum(int(m.get("received_bytes", 0))
                                 for m in metas)
            downtime_s = time.monotonic() - t0
            return {
                "downtime_s": downtime_s,
                "full_setup_bytes": int(full_setup_bytes),
                "reshipped_bytes": int(reshipped_bytes),
                "received_bytes": int(received_bytes),
                "cache_hits": cache_hits,
                "cache_misses": cache_misses,
                "expected_cache_hits": int(expected_cache_hits),
                "hit_rate": (cache_hits / expected_cache_hits
                             if expected_cache_hits else 1.0),
                "inherited": inherited,
                "spawned": fresh,
                "retired": retired,
            }

    # -- request-level messaging -------------------------------------------

    async def _await_result(self, h: WorkerHandle, key: tuple, gi: int,
                            seq: int, send) -> "object":
        """Send and await one result with bounded retry.  Raises a
        RuntimeError naming the worker on failure or timeout — never hangs.
        """
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        h.pending[key] = fut
        try:
            if h.failed is not None:
                raise RuntimeError(str(h.failed)) from h.failed
            send()
            attempts = 0
            while True:
                attempts += 1
                done, _ = await asyncio.wait(
                    {fut}, timeout=self.request_timeout)
                if done:
                    return fut.result()     # worker-failure excs re-raise
                if attempts > self.max_retries:
                    age = time.monotonic() - h.last_heartbeat
                    raise RuntimeError(
                        f"worker {h.worker} timed out on segment {gi} of "
                        f"request {seq}: {attempts} attempt(s) x "
                        f"{self.request_timeout}s each, last heartbeat "
                        f"{age:.1f}s ago")
                send()                      # idempotent recompute on worker
        finally:
            h.pending.pop(key, None)
            if not fut.done():
                fut.cancel()

    # -- dataflow ----------------------------------------------------------

    def _slice_download(self, g, w: int, src: np.ndarray,
                        pad_cache: dict) -> np.ndarray:
        spec = g.downloads[w]
        if spec["kind"] == "rows":
            return src[:, spec["lo"]:spec["hi"], :]
        if spec["kind"] == "full":
            return src
        # conv: slice the padded-input row window the shard's rows need
        if "pad" not in pad_cache:
            ph, pw = spec["ph"], spec["pw"]
            pad_cache["pad"] = np.pad(src, ((0, 0), (ph, ph), (pw, pw)))
        x_pad = pad_cache["pad"]
        xs = x_pad[:, spec["r0"]:spec["r1"], :]
        if spec["c_lo"] is not None:
            xs = xs[spec["c_lo"]:spec["c_hi1"]]
        return xs

    def _t(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the coordinator's device (a copy where numpy
        hands out a read-only view of a frame)."""
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _post(self, g, cur: np.ndarray, ctx: _RequestCtx) -> np.ndarray:
        """Coordinator-side residual/stash bookkeeping (Alg. 4 line 9),
        bit-identical to the single-process executors."""
        if g.residual_from is not None:
            if self._int8:
                oth_scale, oth_q = ctx.stash[g.residual_from]
                cur = _residual_add_int8(
                    self._t(cur), g.out_scale, self._t(oth_q),
                    oth_scale).cpu().numpy()
            else:
                cur = (self._t(cur) + self._t(ctx.stash[g.residual_from])
                       ).cpu().numpy()
        if g.save_as is not None:
            ctx.stash[g.save_as] = ((g.out_scale, cur) if self._int8
                                    else cur)
        return cur

    def _record_boundary(self, g, ctx: _RequestCtx,
                         workers=None) -> None:
        """Record realized dependency edges for the seam into group g.gi.
        A barrier (completion-event wait) happens-after every producer
        upload, so every predicted edge is realized; the clean path records
        per-consumer as each awaited band lands."""
        if g.deps is None:
            return
        for w, producers in enumerate(g.deps):
            if workers is not None and w not in workers:
                continue
            for p in producers:
                ctx.edges.add((g.gi, w, p))

    async def _run_group(self, gi: int, ctx: _RequestCtx) -> None:
        g = self.cplan.groups[gi]
        if g.kind == "local":
            if gi:
                await ctx.complete[gi - 1].wait()
                self._record_boundary(g, ctx)
            src = (ctx.final[gi - 1] if gi else ctx.x0).reshape(g.in_shape)
            _, in_scale, out_scale = g.local
            if self._int8:
                y = _avgpool_int8(self._t(src), in_scale,
                                  out_scale).cpu().numpy()
            else:
                y = self._t(src).mean(dim=(1, 2),
                                      keepdim=True).cpu().numpy()
            ctx.raw[gi] = y
            ctx.final[gi] = self._post(g, y, ctx)
            ctx.complete[gi].set()
            return

        dtype = np.int8 if self._int8 else np.float32
        buf = (np.zeros(g.out_shape, dtype) if g.kind == "spatial"
               else np.zeros(int(np.prod(g.out_shape)), dtype))
        ctx.raw[gi] = buf
        pad_cache: dict = {}
        fine = g.clean and gi > 0

        async def feed_gather(w: int) -> None:
            h = self.handles[w]
            if gi == 0:
                src = ctx.x0.reshape(g.in_shape)
            elif fine:
                for p in g.deps[w]:
                    await ctx.band_ev[gi - 1][p].wait()
                    ctx.edges.add((gi, w, p))
                src = ctx.raw[gi - 1]       # clean seam: post is identity
            else:
                await ctx.complete[gi - 1].wait()
                src = ctx.final[gi - 1].reshape(g.in_shape)
            xs = self._slice_download(g, w, src, pad_cache)
            key = (ctx.seq, gi)

            def send() -> None:
                h.send_q.put_nowait(("infer_input",
                                     {"seq": ctx.seq, "gi": gi}, {"x": xs}))

            frame = await self._await_result(h, key, gi, ctx.seq, send)
            y = np.asarray(frame.arrays["y"])
            spec = g.assembly[w]
            if spec["kind"] == "rows":
                buf[:, spec["lo"]:spec["hi"], :] = y.reshape(
                    buf.shape[0], spec["hi"] - spec["lo"], buf.shape[2])
            else:
                buf[spec["start"]:spec["stop"]] = y.reshape(-1)
            ctx.band_ev[gi][w].set()

        feeds = [asyncio.ensure_future(feed_gather(w)) for w in g.actives]
        try:
            await asyncio.gather(*feeds)
        except BaseException:
            for f in feeds:
                f.cancel()
            await asyncio.gather(*feeds, return_exceptions=True)
            raise
        if gi and not fine:
            self._record_boundary(g, ctx)
        elif fine:
            # inactive consumers have no download; their predicted edges
            # hold vacuously
            self._record_boundary(
                g, ctx, workers=set(range(self.split.n_workers))
                - set(g.actives))
        cur = buf if g.kind == "spatial" else buf.reshape(g.out_shape)
        ctx.final[gi] = self._post(g, cur, ctx)
        ctx.complete[gi].set()

    async def infer(self, x: np.ndarray) -> np.ndarray:
        """Run one request through the cluster; bit-exact vs ``Session``.

        Also populates ``last_timeline`` (measured per-worker events in the
        simulator's schema) and ``last_edges`` (realized dependency edges).
        """
        if not self._started:
            raise RuntimeError("Coordinator.start() has not completed")
        async with self._infer_lock:
            seq = self._seq
            self._seq += 1
            t0 = time.monotonic()
            if self._int8:
                x0 = quantize_activation_t(
                    self._t(np.array(x, np.float32)),
                    self.cplan.input_scale).cpu().numpy()
            else:
                x0 = np.asarray(x, np.float32)
            ctx = _RequestCtx(seq, x0, len(self.cplan.groups),
                              self.split.n_workers)
            tasks = [asyncio.ensure_future(self._run_group(gi, ctx))
                     for gi in range(len(self.cplan.groups))]
            try:
                await asyncio.gather(*tasks)
            except BaseException:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
            t_end = time.monotonic()
            out = np.asarray(ctx.final[-1])
            self.last_timeline = await self._collect_timeline(seq, t0, t_end)
            self.last_edges = set(ctx.edges)
            self.measured_edges |= ctx.edges
            return out

    async def infer_many(self, xs) -> list[np.ndarray]:
        return [await self.infer(x) for x in xs]

    async def _collect_timeline(self, seq: int, t0: float,
                                t_end: float) -> Timeline:
        """Pull each worker's event log and assemble a measured Timeline in
        the simulator's schema, normalized to request start."""
        loop = asyncio.get_running_loop()
        futs: dict[int, asyncio.Future] = {}
        for w, h in self.handles.items():
            if h.failed is not None:
                continue
            fut = loop.create_future()
            h.pending[("events", seq)] = fut
            h.send_q.put_nowait(("collect", {"seq": seq}, None))
            futs[w] = fut
        events: list[TimelineEvent] = []
        for w, fut in futs.items():
            h = self.handles[w]
            try:
                done, _ = await asyncio.wait(
                    {fut}, timeout=self.request_timeout)
                if not done or fut.exception() is not None:
                    continue                # timeline stays partial, not fatal
                for ev in fut.result():
                    events.append(TimelineEvent(
                        worker=ev["worker"], kind=ev["kind"],
                        segment=ev["segment"], layer=ev["layer"],
                        start_s=max(ev["start_s"] - t0, 0.0),
                        end_s=max(ev["end_s"] - t0, 0.0),
                        nbytes=ev.get("nbytes", 0)))
            finally:
                h.pending.pop(("events", seq), None)
                if not fut.done():
                    fut.cancel()
        events.sort(key=lambda e: (e.start_s, e.worker, e.segment))
        return Timeline(n_workers=self.split.n_workers,
                        events=tuple(events), makespan_s=t_end - t0)
