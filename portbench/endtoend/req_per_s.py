"""Requests completed in the window over the window's seconds: from the
first request to the last output on the host, closed loop."""


def read(run):
    w = run.window
    return w.completed / (w.t_end - w.t_start) if w.completed else None
