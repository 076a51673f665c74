"""The depthwise kernel's share of its roofline: the model's depthwise
layers against the device time of ``dwconv3x3_kernel`` (both the band and
the flat form launch it)."""

from ._roofline import share

KINDS = ("dwconv",)
PREFIXES = ("void (anonymous namespace)::dwconv3x3_kernel<",
            "dwconv3x3_kernel<")


def read(run):
    return share(run, KINDS, PREFIXES)
