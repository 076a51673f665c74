"""One client, one image at a time: ``Session.run`` back to back (bucket
1), the paper's single-image latency.

Parameters: ``pool`` (distinct images; request r carries image r of the
pool, in the seed's order, round the pool).  Trace: after ``skip``
requests, ``requests`` requests.  The host enqueue of each request is
timed around the session's ``dispatch_async``, which ``Session.run``
calls.
"""
from __future__ import annotations

import time

from .. import system
from ..window import Window


def setup(run) -> None:
    run.session = system.session(run, max_batch=1)
    run.session.warmup(buckets=(1,))
    run.batch = 1


def drive(run) -> Window:
    tr, sess, tracer = run.trace_params, run.session, run.tracer
    n_pool = len(run.pool)
    win = Window(t_start=time.perf_counter())
    dispatch = sess.dispatch_async

    def timed_dispatch(xs):
        t0 = time.perf_counter()
        disp = dispatch(xs)
        t1 = time.perf_counter()
        tracer.span("enqueue", t0, t1)
        win.enqueue_s.append((t1 - t0, tracer.active))
        return disp

    sess.dispatch_async = timed_dispatch
    try:
        r = 0
        while time.perf_counter() - win.t_start < run.seconds:
            if r == tr["skip"]:
                tracer.start()
            elif r == tr["skip"] + tr["requests"]:
                tracer.stop()
            t0 = time.perf_counter()
            out = sess.run(run.pool[r % n_pool])
            t1 = time.perf_counter()
            tracer.span("run", t0, t1)
            tracer.count(dispatches=1, requests=1)
            win.deliver([r], out[None], at=t1)
            win.attempted += 1
            r += 1
    finally:
        del sess.dispatch_async
    win.t_end = time.perf_counter()
    tracer.stop()
    return win


def teardown(run) -> None:
    run.session = None
