"""Host time a device kernel (us/kernel): the median ``executor.forward``
span of the traced dispatches over the device trace's kernels a dispatch
(the base of ``engine.launches_per_batch.offline``; see ``_program``)."""

from ._program import traced


def read(run):
    p, t = traced(run), run.trace
    if p is None or not t.dispatches:
        return None
    forward_s = p.median_s("executor.forward")
    per_dispatch = len(t.kernels()) / t.dispatches
    if forward_s is None or per_dispatch <= 0:
        return None
    return forward_s * 1e6 / per_dispatch
