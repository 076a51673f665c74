"""A kernel family's share of its roofline over the traced dispatches:
the least time of the model's layers of some kinds at the cell's batch
(``portbench.counts``, from the published shapes) times the dispatches
traced, over the device time of the kernels whose names start with the
given prefixes."""

from .. import counts


def share(run, kinds, prefixes):
    t = run.trace
    if t is None or not t.dispatches:
        return None
    device_s = t.device_s(tuple(prefixes))
    if device_s <= 0:
        return None
    least = counts.least_s_of(run.layers, kinds, run.batch) * t.dispatches
    return 100.0 * least / device_s
