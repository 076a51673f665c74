"""The squeeze-and-excitation kernels' share of their roofline: the least
time of the model's squeeze-and-excitation pools and gates at the cell's
batch (the published shapes, ``portbench.counts``; the layers the
architecture's reference names in ``se_layers``) times the dispatches
traced, over the device time of the ``se_`` kernels.  None where the
reference names no such layer or the trace holds no such kernel.

The kernels are not templates, so the profiler names them without the
return type (``(anonymous namespace)::se_pool_kernel(...)``); the prefixes
take that form beside the two the template kernels' readers match."""

from .. import counts

PREFIXES = ("void (anonymous namespace)::se_", "(anonymous namespace)::se_",
            "se_")


def read(run):
    t = run.trace
    se_layers = getattr(run.ref, "se_layers", None)
    if t is None or not t.dispatches or se_layers is None:
        return None
    device_s = t.device_s(PREFIXES)
    if device_s <= 0:
        return None
    least = sum(counts.least_s(lyr, run.batch)
                for lyr in se_layers(run.layers))
    return 100.0 * least * t.dispatches / device_s
