"""Closed loop of back-to-back batches through ``Session.dispatch_async``
and ``InflightDispatch.wait``, ``inflight`` batches on the device at once.

Parameters: ``batch`` (requests a dispatch), ``inflight`` (dispatches
enqueued before the oldest is waited for), ``pool`` (distinct images, a
multiple of ``batch``; batch k carries images k*batch.. of the pool, in
the seed's order).  Trace: after ``skip`` batches, ``batches`` batches,
with the device drained before and after them.
"""
from __future__ import annotations

import collections
import time

from .. import system
from ..window import Window


def setup(run) -> None:
    p = run.params
    if p["pool"] % p["batch"]:
        raise ValueError("pool must be a multiple of batch")
    run.session = system.session(run, max_batch=p["batch"])
    run.session.warmup(buckets=(p["batch"],))
    run.batch = p["batch"]


def drive(run) -> Window:
    p, tr, sess, tracer = run.params, run.trace_params, run.session, run.tracer
    b, depth = p["batch"], p["inflight"]
    per_pool = p["pool"] // b
    inflight: collections.deque = collections.deque()
    win = Window(t_start=time.perf_counter())

    def complete_one():
        k, disp = inflight.popleft()
        t0 = time.perf_counter()
        out = disp.wait()
        t1 = time.perf_counter()
        tracer.span("wait", t0, t1)
        win.deliver(range(k * b, (k + 1) * b), out, at=t1)

    k = 0
    while time.perf_counter() - win.t_start < run.seconds:
        if k in (tr["skip"], tr["skip"] + tr["batches"]):
            while inflight:         # the trace holds whole batches
                complete_one()
            tracer.start() if k == tr["skip"] else tracer.stop()
        lo = (k % per_pool) * b
        xs = run.pool[lo:lo + b]
        t0 = time.perf_counter()
        disp = sess.dispatch_async(xs)
        t1 = time.perf_counter()
        tracer.span("enqueue", t0, t1)
        win.enqueue_s.append((t1 - t0, tracer.active))
        tracer.count(dispatches=1, requests=b)
        inflight.append((k, disp))
        win.attempted += b
        k += 1
        if len(inflight) >= depth:
            complete_one()
    while inflight:
        complete_one()
    win.t_end = time.perf_counter()
    tracer.stop()
    return win


def teardown(run) -> None:
    run.session = None
