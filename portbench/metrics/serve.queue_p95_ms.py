"""95th percentile (ms) of the program's ``serve.queue`` spans in the
traced window: each request's time in the server's queue, from
``Server.submit`` until it is taken into a batch (see ``_program``)."""

import numpy as np

from ._program import traced


def read(run):
    p = traced(run)
    q = [t1 - t0 for n, _, t0, t1, _ in (p.spans if p is not None else ())
         if n == "serve.queue"]
    return float(np.percentile(q, 95)) * 1e3 if q else None
