"""95th percentile of every request of the window, each timed from when
it was due to when its output was on the host; a failed or shed request
counts with its time to the end of the drain."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
