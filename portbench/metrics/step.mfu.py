"""The whole split forward's share of the int8 peak over the traced
window: 2 x the model's MACs a request x the requests traced, over the
traced window's seconds x 1979 TOP/s."""

from .. import counts


def read(run):
    t = run.trace
    if t is None or not t.requests or t.window_s <= 0:
        return None
    ops = 2.0 * counts.total_macs(run.layers) * t.requests
    return 100.0 * ops / (t.window_s * counts.PEAK_INT8_OPS_S)
