"""Median host enqueue of the traced dispatches: the benchmark's own span
from the call of ``Session.dispatch_async`` to its return."""

import statistics


def median_ms(run):
    spans = [s for s, traced in run.window.enqueue_s if traced]
    return statistics.median(spans) * 1e3 if spans else None
