"""Device idle share (%) of the traced window (see ``_idle``)."""

from ._idle import share


def read(run):
    return share(run)
