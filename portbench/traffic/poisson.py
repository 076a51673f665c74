"""Open-loop Poisson arrivals through ``Server.submit``, one tenant.

A copy of ``repro_torch/serve/loadgen.py``'s open loop with two changes:
each request is timed from when it was due, not from when the generator
got to submit it, so a stalled generator or server shows on every later
request; and the arrival gaps are the quantiles of an exponential
distribution at the cell's rate, shuffled by the seed, so every seed
offers the same gaps in another order.  The generator's own lateness is
reported on a line of its own.  A shed (``Overloaded``) or failed request
counts as failed, with the time from its due time to the end of the drain
as its latency.

Parameters: ``rate`` (req/s, fixed), ``max_batch`` and ``max_inflight``
of the server, ``slo_p99_s`` and ``queue_cap`` of the tenant's SLO,
``pool`` (distinct images; request r carries image r of the pool).
Trace: ``seconds`` of arrivals from ``from_end_s`` before the window's
end; a trace that lost its kernels (the profiler has, while the server's
thread launched) is dropped and taken again over the next ``seconds``,
as long as the window lasts.
"""
from __future__ import annotations

import time

import numpy as np

from .. import system
from ..window import Window

TENANT = "a"
DRAIN_S = 60.0       # how long past the window's close an answer may come


def setup(run) -> None:
    from repro_torch.serve import SLO, Server
    p = run.params
    run.session = system.session(run, max_batch=p["max_batch"])
    run.server = Server(max_inflight=p["max_inflight"])
    run.server.add_tenant(TENANT, run.session, warmup=True,
                          slo=SLO(p99_target_s=p["slo_p99_s"],
                                  queue_cap=p["queue_cap"]))
    run.server.start()
    run.batch = p["max_batch"]


def schedule(rate: float, seconds: float, rng) -> np.ndarray:
    """Due offsets (s) of round(rate x seconds) arrivals: exponential gaps
    taken at their quantiles, scaled to fill ``seconds``, in the order of
    ``rng``."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def open_loop(server, dues, make_input, tracer=None,
              trace_from: float = np.inf, trace_s: float = 0.0) -> Window:
    """Submit request r at ``dues[r]`` seconds after the start, whether or
    not earlier ones finished; wait for every answer afterwards.  The
    ``tracer`` traces the arrivals due in [trace_from, trace_from +
    trace_s), again later where a trace holds no kernel."""
    from repro_torch.serve import Overloaded
    win = Window(t_start=time.perf_counter())
    sent = []                                 # (r, due, ticket or None)
    late = []
    for r, off in enumerate(dues):
        due = win.t_start + off
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        if tracer is not None and off >= trace_from:
            if off < trace_from + trace_s:
                tracer.start()
            elif tracer.active:
                tracer.stop()
                if not tracer.has_kernels():
                    tracer.reset()
                    trace_from = off
        t_sub = time.perf_counter()
        try:
            ticket = server.submit(TENANT, make_input(r))
        except Overloaded:
            ticket = None
        late.append(t_sub - due)
        if tracer is not None:
            tracer.span("submit", t_sub, time.perf_counter())
            tracer.count(requests=1)
        sent.append((r, due, ticket))
        win.attempted += 1
    if tracer is not None:
        tracer.stop()
    deadline = time.perf_counter() + DRAIN_S
    failed_dues = []
    for r, due, ticket in sent:
        try:
            if ticket is None:
                raise RuntimeError("shed")
            out = ticket.result(timeout=max(1e-3,
                                            deadline - time.perf_counter()))
        except Exception:   # shed, timed out or rejected: failed, keep going
            failed_dues.append(due)
            continue
        win.deliver([r], np.asarray(out)[None], at=ticket.completed_at)
        win.latencies_s.append(ticket.completed_at - due)
    win.t_end = time.perf_counter()
    win.failed = len(failed_dues)
    win.latencies_s += [win.t_end - due for due in failed_dues]
    lat = np.asarray(late) * 1e3
    win.notes.append(f"generator lateness ms: p50 {np.percentile(lat, 50)} "
                     f"p99 {np.percentile(lat, 99)} max {lat.max()} "
                     f"over {len(lat)} arrivals")
    return win


def drive(run) -> Window:
    p, sess = run.params, run.session
    dues = schedule(p["rate"], run.seconds, run.rng)
    before = sess.stats()
    n_pool = len(run.pool)
    tr = run.trace_params
    win = open_loop(run.server, dues, lambda r: run.pool[r % n_pool],
                    run.tracer, run.seconds - tr["from_end_s"], tr["seconds"])
    after = sess.stats()
    win.stats_delta = {"requests": after.requests - before.requests,
                       "batches": after.batches - before.batches}
    return win


def teardown(run) -> None:
    run.server.stop(drain=True)
    run.server = run.session = None


def saturation_throughput(server, make_input, *, n_requests: int = 128,
                          repeats: int = 3, result_timeout_s: float = 60.0):
    """Drain rate (req/s) of a closed burst of ``n_requests``, best of
    ``repeats``: a copy of ``repro_torch/serve/loadgen.py``'s."""
    from repro_torch.serve import Overloaded
    best = 0.0
    for _ in range(repeats):
        tickets = []
        head = 0
        t0 = time.perf_counter()
        submitted = 0
        while submitted < n_requests:
            try:
                tickets.append(server.submit(TENANT, make_input(submitted)))
                submitted += 1
            except Overloaded:
                while head < len(tickets) and tickets[head].done():
                    head += 1
                if head < len(tickets):
                    tickets[head].result(timeout=result_timeout_s)
                else:
                    time.sleep(0.001)
        for t in tickets:
            t.result(timeout=result_timeout_s)
        best = max(best, n_requests / (time.perf_counter() - t0))
    return best
