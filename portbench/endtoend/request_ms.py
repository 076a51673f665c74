"""The window over the requests completed, one client at batch 1: the
paper's single-image latency."""


def read(run):
    w = run.window
    return (w.t_end - w.t_start) * 1e3 / w.completed if w.completed else None
