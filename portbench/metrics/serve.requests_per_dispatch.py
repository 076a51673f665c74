"""Requests a dispatch of the server's tenant session over the window:
the delta of ``Session.stats()``'s ``requests`` over its ``batches``."""


def read(run):
    d = run.window.stats_delta
    if not d or not d["batches"]:
        return None
    return d["requests"] / d["batches"]
