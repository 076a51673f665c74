"""Median host time (ms) of the program's ``executor.forward`` span over
the traced dispatches: the plan's forward, enqueued (see ``_program``)."""

from ._program import traced


def read(run):
    p = traced(run)
    s = p.median_s("executor.forward") if p is not None else None
    return None if s is None else s * 1e3
