"""Median host enqueue (ms) of the traced dispatches (see ``_enqueue``)."""

from ._enqueue import median_ms


def read(run):
    return median_ms(run)
