"""Share (%) of the traced dispatches whose ``executor.forward`` span says
``graph="replay"``: the forward replayed a captured CUDA graph rather than
walking the plan launch by launch (see ``_program``).  None where no
forward span of the traced dispatches carries the ``graph`` attribute (a
program that records none)."""

from ._program import traced


def read(run):
    p = traced(run)
    if p is None:
        return None
    how = [(attrs or {}).get("graph") for d in p.dispatches
           for _, _, attrs in p.by_dispatch[d].get("executor.forward", ())]
    if not any(how):
        return None
    return 100.0 * how.count("replay") / len(how)
