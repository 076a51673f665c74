"""``qgemm``'s share of its roofline: the model's conv and linear layers
(not depthwise) against the device time of the ``qgemm`` kernel."""

from ._roofline import share

KINDS = ("conv", "linear")
PREFIXES = ("void (anonymous namespace)::qgemm_kernel<", "qgemm_kernel<")


def read(run):
    return share(run, KINDS, PREFIXES)
