"""Worker process for the distributed runtime — port of
``repro/runtime/worker.py``.

One worker owns the shard fragments a
:class:`~repro_torch.core.splitting.SplitPlan` assigns it, connects to the
coordinator over TCP, and serves per-segment compute requests.
Lifecycle::

    connect -> hello{worker} -> (setup frame: specs + weight fragments)
            -> compile + warm every segment fn -> ready{setup_s}
            -> serve: infer_input{seq,gi}+x  ->  result{seq,gi}+y
                      ping -> pong · collect{seq} -> events · shutdown -> exit
            -> (setup frame mid-serve: delta re-setup for a replan)
            -> ready{...} again, with warm-cache stats

Concurrency shape (all on one event loop):

* the **reader** loop pulls frames off the socket and dispatches; it never
  blocks on compute, so the next segment's input downloads while the current
  one computes — the worker-side half of the pipelined overlap.
* **compute** runs in a single-thread executor (torch releases the GIL in
  its ops), so computes serialize in arrival order while the loop stays
  responsive.
* the **writer** task drains a FIFO queue — result uploads keep link order,
  and upload timing is measured around the actual ``write + drain``.
* a **heartbeat** task pings the coordinator every ``heartbeat_s`` so
  liveness is observable independently of request traffic.

Elastic re-setup: the worker keeps two warm stores across setups — an
**array store** (content fingerprint -> ndarray) so a replan only ships
arrays the worker does not already hold (the setup frame's specs name the
fingerprints; missing entries are resolved from the store), and a
**compiled-segment cache** (segment fingerprint -> segment function with
its constants on the device) so unchanged shard geometry uploads nothing.
A mid-serve ``setup`` frame rebuilds the segment table in the compute pool
(heartbeats keep flowing) and answers with a fresh ``ready`` frame
carrying ``cache_hits``/``cache_misses`` / ``received_bytes`` so the
coordinator can assert warm-recompile and delta-shipping invariants.

Event bookkeeping: download windows come from ``read_frame``'s receive
timestamps, compute windows bracket the segment call up to the copy of its
output to the host (``.cpu().numpy()``, which waits for the device),
upload windows bracket the socket write.  ``collect``
is answered from the *writer* queue (a marker sentinel), so the snapshot is
taken only after every previously queued result frame — and its upload
event — has flushed.  All timestamps are raw ``time.monotonic()``; the
coordinator normalizes to request start when assembling the Timeline.

Workers are stateless across requests (every ``infer_input`` carries its
full input slice), so a coordinator retry is an idempotent recompute.

Device: a worker computes on CUDA unless it is given ``cpu``
(``--device``), and raises when CUDA is absent and no device is given.
Every launch goes to the device's current stream of the computing thread,
which no worker changes: a worker process has one compute thread, and the
in-process workers of one coordinator (one thread each) all launch on the
device's default stream, in launch order.  That is what the kernels'
process-wide state relies on: ``qgemm``'s split-K arrival counters are one
buffer per device, reset by each launch's last CTA and reallocated when a
launch needs more, which is safe only while launches are ordered on one
stream.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.executor import resolve_device
from .protocol import ConnectionClosed, read_frame, write_frame
from .shards import _array_fp, build_segment_fns, warmup_segments

_SHUTDOWN = object()


class _WorkerLoop:
    def __init__(self, worker_id: int, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, heartbeat_s: float, device):
        self.worker_id = worker_id
        self.device = device
        self.reader = reader
        self.writer = writer
        self.heartbeat_s = heartbeat_s
        self.segments: dict = {}
        self.events: list[dict] = []
        self.out_q: asyncio.Queue = asyncio.Queue()
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.tasks: set[asyncio.Task] = set()
        # warm stores, persistent across setups (elastic replans)
        self.array_store: dict[str, np.ndarray] = {}
        self.seg_cache: collections.OrderedDict = collections.OrderedDict()

    def _event(self, kind: str, gi: int, layer: int, t0: float, t1: float,
               nbytes: int = 0) -> None:
        self.events.append({"worker": self.worker_id, "kind": kind,
                            "segment": gi, "layer": layer,
                            "start_s": t0, "end_s": t1, "nbytes": nbytes})

    # -- setup -------------------------------------------------------------
    def _resolve_arrays(self, meta: dict,
                        shipped: dict[str, np.ndarray]) -> dict:
        """Merge shipped arrays with the warm store.

        Arrays present in the frame are stored under their content
        fingerprint; keys the frame omitted must resolve from the store via
        the spec's ``array_fps`` — a miss is a coordinator protocol error.
        """
        fps: dict[str, str] = {}
        for spec in meta["segments"]:
            fps.update(spec.get("array_fps", {}))
        arrays: dict[str, np.ndarray] = {}
        for key, fp in fps.items():
            if key in shipped:
                arrays[key] = shipped[key]
                self.array_store[fp] = shipped[key]
            elif fp in self.array_store:
                arrays[key] = self.array_store[fp]
            else:
                raise RuntimeError(
                    f"worker {self.worker_id}: setup omitted array {key!r} "
                    f"(fp {fp}) but it is not in the local store")
        # legacy payloads without fingerprints ship everything
        for key, a in shipped.items():
            arrays.setdefault(key, a)
            self.array_store.setdefault(_array_fp(a), a)
        return arrays

    def _apply_setup(self, meta: dict, shipped: dict[str, np.ndarray],
                     received_bytes: int) -> dict:
        """Build + warm the segment table; returns the ready-frame meta."""
        self.worker_id = int(meta.get("worker", self.worker_id))
        arrays = self._resolve_arrays(meta, shipped)
        stats: dict = {}
        self.segments = build_segment_fns(meta, arrays,
                                          cache=self.seg_cache, stats=stats,
                                          device=self.device)
        setup_s = warmup_segments(self.segments, meta["precision"])
        return {"worker": self.worker_id, "setup_s": setup_s,
                "segments": sorted(self.segments),
                "cache_hits": stats.get("cache_hits", 0),
                "cache_misses": stats.get("cache_misses", 0),
                "received_bytes": int(received_bytes)}

    # -- writer ------------------------------------------------------------
    async def _writer_loop(self) -> None:
        while True:
            item = await self.out_q.get()
            if item is _SHUTDOWN:
                return
            if item[0] == "collect":
                # marker: every result queued before it has flushed, so the
                # snapshot includes their upload events
                snapshot, self.events = self.events, []
                await write_frame(self.writer, "events",
                                  {"worker": self.worker_id, "seq": item[1],
                                   "events": snapshot})
                continue
            _, ftype, meta, arrays, record = item
            t0 = time.monotonic()
            n = await write_frame(self.writer, ftype, meta, arrays)
            t1 = time.monotonic()
            if record is not None:
                gi, layer = record
                self._event("upload", gi, layer, t0, t1, n)

    # -- heartbeat ---------------------------------------------------------
    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_s)
            self.out_q.put_nowait(("frame", "heartbeat",
                                   {"worker": self.worker_id,
                                    "t": time.monotonic()}, None, None))

    # -- compute -----------------------------------------------------------
    async def _compute_and_send(self, seq: int, gi: int,
                                x: np.ndarray) -> None:
        seg = self.segments[gi]
        loop = asyncio.get_running_loop()

        def run():
            t0 = time.monotonic()
            y = seg.fn(x).cpu().numpy()     # waits for the device
            return t0, time.monotonic(), y

        t0, t1, y = await loop.run_in_executor(self.pool, run)
        self._event("compute", gi, seg.layer_first, t0, t1)
        self.out_q.put_nowait(("frame", "result",
                               {"seq": seq, "gi": gi,
                                "worker": self.worker_id},
                               {"y": y}, (gi, seg.layer_first)))

    async def _resetup_and_ack(self, frame) -> None:
        """Mid-serve re-setup: rebuild segments off-loop, then ack ready."""
        loop = asyncio.get_running_loop()
        ready_meta = await loop.run_in_executor(
            self.pool, self._apply_setup, frame.meta["plan"], frame.arrays,
            frame.nbytes)
        self.out_q.put_nowait(("frame", "ready", ready_meta, None, None))

    # -- main --------------------------------------------------------------
    async def run(self) -> None:
        await write_frame(self.writer, "hello", {"worker": self.worker_id})
        setup = await read_frame(self.reader)
        if setup.type != "setup":
            raise RuntimeError(f"worker {self.worker_id}: expected setup "
                               f"frame, got {setup.type!r}")
        ready_meta = self._apply_setup(setup.meta["plan"], setup.arrays,
                                       setup.nbytes)
        for coro in (self._writer_loop(), self._heartbeat_loop()):
            t = asyncio.create_task(coro)
            self.tasks.add(t)
            t.add_done_callback(self.tasks.discard)
        self.out_q.put_nowait(("frame", "ready", ready_meta, None, None))
        try:
            while True:
                frame = await read_frame(self.reader)
                if frame.type == "infer_input":
                    seq, gi = frame.meta["seq"], frame.meta["gi"]
                    self._event("download", gi,
                                self.segments[gi].layer_first,
                                frame.recv_start, frame.recv_end,
                                frame.nbytes)
                    t = asyncio.create_task(self._compute_and_send(
                        seq, gi, frame.arrays["x"]))
                    self.tasks.add(t)
                    t.add_done_callback(self.tasks.discard)
                elif frame.type == "setup":
                    # elastic replan: adopt the new plan without dropping
                    # the connection; build runs in the compute pool so
                    # heartbeats keep flowing during compilation
                    t = asyncio.create_task(self._resetup_and_ack(frame))
                    self.tasks.add(t)
                    t.add_done_callback(self.tasks.discard)
                elif frame.type == "collect":
                    # wait for in-flight computes so their results (and
                    # upload events) precede the snapshot marker
                    pending = [t for t in self.tasks
                               if not t.done()
                               and t.get_coro().__name__
                               == "_compute_and_send"]
                    if pending:
                        await asyncio.gather(*pending)
                    self.out_q.put_nowait(("collect",
                                           frame.meta.get("seq", 0)))
                elif frame.type == "ping":
                    self.out_q.put_nowait(("frame", "pong",
                                           {"worker": self.worker_id},
                                           None, None))
                elif frame.type == "shutdown":
                    return
                else:
                    raise RuntimeError(
                        f"worker {self.worker_id}: unexpected frame "
                        f"{frame.type!r}")
        except ConnectionClosed:
            return                          # coordinator went away cleanly
        finally:
            for t in self.tasks:
                t.cancel()
            self.pool.shutdown(wait=False)
            self.writer.close()


async def run_worker(host: str, port: int, worker_id: int,
                     heartbeat_s: float = 0.5, device=None) -> None:
    """Connect to the coordinator and serve until shutdown/EOF, computing
    on ``device`` (CUDA unless the caller passes another)."""
    dev = resolve_device(device)
    reader, writer = await asyncio.open_connection(host, port)
    await _WorkerLoop(worker_id, reader, writer, heartbeat_s, dev).run()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="distributed runtime worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--id", type=int, required=True)
    p.add_argument("--heartbeat-s", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: CUDA)")
    args = p.parse_args(argv)
    print(f"[worker {args.id}] connecting to {args.host}:{args.port} "
          f"(device {args.device or 'cuda'})", file=sys.stderr, flush=True)
    asyncio.run(run_worker(args.host, args.port, args.id,
                           heartbeat_s=args.heartbeat_s, device=args.device))
    print(f"[worker {args.id}] exit", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
