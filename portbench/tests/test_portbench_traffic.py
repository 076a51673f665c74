"""The open-loop generator: its schedule, and latency timed from the due
time so that a stalled server shows its lag on later requests."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from .tiny_bench import ROOT

from portbench.harness import Bench

poisson = Bench(ROOT).code("traffic", "poisson")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 12345678901])
def test_schedule_same_gaps_every_seed(seed):
    base = poisson.schedule(200.0, 5.0, np.random.default_rng(1))
    dues = poisson.schedule(200.0, 5.0, np.random.default_rng(seed))
    assert len(dues) == len(base) == 1000
    assert dues[0] == 0.0 and np.all(np.diff(dues) > 0)
    gaps = np.sort(np.diff(np.append(dues, 5.0)))
    np.testing.assert_allclose(gaps, np.sort(np.diff(np.append(base, 5.0))))
    assert gaps.sum() == pytest.approx(5.0)


class _Ticket:
    def __init__(self, value):
        self.value = value
        self.completed_at = time.perf_counter()

    def result(self, timeout=None):
        return self.value


class _StallingServer:
    """Answers at once, but request ``stall_at``'s submit blocks for
    ``stall_s``, as a server holding the interpreter lock would."""

    def __init__(self, stall_at: int, stall_s: float):
        self.n = 0
        self.stall_at, self.stall_s = stall_at, stall_s
        self.lock = threading.Lock()

    def submit(self, tenant, x):
        with self.lock:
            self.n += 1
            if self.n - 1 == self.stall_at:
                time.sleep(self.stall_s)
        return _Ticket(np.full((1, 4), x, np.int8))


def test_open_loop_times_from_the_due_time():
    dues = np.arange(40) * 0.01            # 100 req/s for 0.4 s
    server = _StallingServer(stall_at=10, stall_s=0.2)
    win = poisson.open_loop(server, dues, lambda r: r % 100)
    lat = np.asarray(win.latencies_s)
    assert win.completed == win.attempted == 40 and win.failed == 0
    # the stalled request and those due during its stall were submitted
    # late: each waits from its due time, by less the later it was due
    # (timed from their submit, as the program's loadgen does, all ~0)
    assert lat[10] == pytest.approx(0.20, abs=0.03)
    assert lat[11] == pytest.approx(0.19, abs=0.03)
    assert lat[20] == pytest.approx(0.10, abs=0.03)
    assert np.all(lat[31:] < 0.05)
    assert "generator lateness" in win.notes[-1]
    ids, outs = win.outputs()
    np.testing.assert_array_equal(outs[:, 0], ids % 100)


def test_open_loop_counts_a_shed_request_as_failed():
    from repro_torch.serve import Overloaded

    class Shedding(_StallingServer):
        def submit(self, tenant, x):
            if x == 3:
                raise Overloaded("a", "slo", queue_depth=0)
            return super().submit(tenant, x)

    win = poisson.open_loop(Shedding(-1, 0.0), np.arange(8) * 0.005,
                            lambda r: r)
    assert win.attempted == 8 and win.completed == 7 and win.failed == 1
    assert len(win.latencies_s) == 8
