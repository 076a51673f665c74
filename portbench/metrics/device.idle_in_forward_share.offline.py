"""Share (%) of the traced window's device-idle time that lies inside a
program ``executor.forward`` span: the device waits while the host walks
the plan.  None unless the clock check holds (see ``_program``)."""

from ._program import traced


def read(run):
    p = traced(run)
    return p.idle_share_in(("executor.forward",)) if p is not None else None
