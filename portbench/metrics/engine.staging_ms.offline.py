"""Median over the traced dispatches of the host time (ms) of the
program's ``executor.input`` (the batch's pinned copy and upload) and
``session.output`` (the output's pinned buffer, copy and event) spans
together (see ``_program``)."""

from ._program import traced


def read(run):
    p = traced(run)
    s = (p.median_s("executor.input", "session.output") if p is not None
         else None)
    return None if s is None else s * 1e3
