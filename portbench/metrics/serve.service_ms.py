"""Median (ms) over the traced server batches of ``session.wait``'s
``device_s``: a batch's time on the device's stream, between its two
events, from when the stream reaches it (waiting there for the host's
launches too) until its output is on the host (see ``_program``)."""

import statistics

from ._program import traced


def read(run):
    p = traced(run)
    if p is None:
        return None
    batches = {a["dispatch"] for n, _, _, _, a in p.spans
               if n == "serve.queue"}
    s = [a["device_s"] for n, k, _, _, a in p.spans
         if n == "session.wait" and k in batches]
    return statistics.median(s) * 1e3 if s else None
