"""Median (ms) of the program's ``serve.fulfill`` spans in the traced
window: a server batch's time from its ``wait`` returning until its
tickets are fulfilled and the monitor is updated (see ``_program``).
Beside ``serve.queue_p95_ms`` and ``serve.service_ms`` it tells a
request's queueing, service and fulfilment apart."""

import statistics

from ._program import traced


def read(run):
    p = traced(run)
    f = [t1 - t0 for n, _, t0, t1, _ in (p.spans if p is not None else ())
         if n == "serve.fulfill"]
    return statistics.median(f) * 1e3 if f else None
