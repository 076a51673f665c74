"""The 5x5 depthwise kernel's share of its roofline: the least time of the
model's depthwise layers of kernel 5 at the cell's batch (the published
shapes, ``portbench.counts``) times the dispatches traced, over the device
time of ``dwconv5x5_kernel`` (the band and the flat form launch it).  None
where the trace holds no such kernel (a model without 5x5 depthwise convs,
or a program without the kernel)."""

from .. import counts

PREFIXES = ("void (anonymous namespace)::dwconv5x5_kernel<",
            "dwconv5x5_kernel<")


def read(run):
    t = run.trace
    if t is None or not t.dispatches:
        return None
    device_s = t.device_s(PREFIXES)
    if device_s <= 0:
        return None
    least = sum(counts.least_s(lyr, run.batch) for lyr in run.layers
                if lyr.kind == "dwconv" and lyr.kernel == 5)
    return 100.0 * least * t.dispatches / device_s
