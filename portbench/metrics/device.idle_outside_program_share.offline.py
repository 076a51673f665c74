"""Share (%) of the traced window's device-idle time that lies inside no
program span: the host is in the caller's own code, a GC pause or its
loop.  None unless the clock check holds (see ``_program``)."""

from ._program import traced


def read(run):
    p = traced(run)
    inside = p.idle_share_in() if p is not None else None
    return None if inside is None else 100.0 - inside
