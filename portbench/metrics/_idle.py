"""Device idle share of the traced window: 1 - the union of the device's
busy intervals (kernels, copies, fills; not the trace pads) over the traced
window's host wall time."""


def share(run):
    t = run.trace
    if t is None or not t.done or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
