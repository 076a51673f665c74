"""Device kernels a dispatch in the traced batches: kernel events of the
profiler's trace (no copies or fills, no trace pads) over the dispatches
traced."""


def read(run):
    t = run.trace
    if t is None or not t.dispatches:
        return None
    return len(t.kernels()) / t.dispatches
