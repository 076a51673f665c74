"""Open-loop Poisson load generator for the multi-tenant server — port of
``repro/serve/loadgen.py`` (numpy and threading only).  A copy but for
this docstring and one repair: a burst that :func:`saturation_throughput`
sees shed waits for its oldest pending ticket, not for its first (which,
once done, returns at once and turns the retry into a spin).

Open-loop means arrivals follow a pre-drawn schedule that does NOT react to
completions — the generator submits at the scheduled instant (or
immediately, if it has fallen behind the clock) whether or not earlier
requests finished.  This is the discipline that exposes real tail latency:
a closed-loop generator slows down exactly when the server struggles
(coordinated omission) and reports flattering percentiles.

Two instruments:

* :func:`run_open_loop` — drive one or more tenants concurrently (one
  generator thread each) at fixed offered rates for a duration; report
  per-tenant p50/p99 end-to-end latency, achieved throughput and the
  rejection rate (``Overloaded`` responses are *counted*, not retried —
  shed load is the admission policy working).
* :func:`saturation_throughput` — the server's sustainable ceiling on one
  tenant: enqueue a deep closed burst and measure drain rate (best of
  ``repeats``).  Offered rates for open-loop runs are usually set relative
  to this.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .admission import Overloaded
from .server import Server


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One tenant's open-loop run, measured from the client side."""

    tenant: str
    offered_rps: float              # Poisson arrival rate driven
    duration_s: float               # scheduled generation window
    submitted: int
    accepted: int
    rejected: int                   # typed Overloaded shed responses
    failed: int                     # tickets that raised (dispatch errors)
    completed: int
    p50_s: float                    # end-to-end: submit -> result ready
    p99_s: float
    throughput_rps: float           # completions / wall (incl. drain)
    rejection_rate: float

    def describe(self) -> str:
        return (f"{self.tenant} @ {self.offered_rps:.0f} req/s offered: "
                f"p50={self.p50_s * 1e3:.2f}ms p99={self.p99_s * 1e3:.2f}ms "
                f"served {self.throughput_rps:.0f} req/s, "
                f"rejected {self.rejection_rate:.1%}")


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _drive_one(server: Server, tenant: str, make_input, rate_rps: float,
               duration_s: float, rng: np.random.Generator,
               result_timeout_s: float, out: dict) -> None:
    # pre-draw the whole Poisson schedule: exponential inter-arrivals,
    # absolute offsets — generation cost cannot distort the arrival process
    n_max = max(1, int(rate_rps * duration_s * 1.5 + 10 * rate_rps ** 0.5))
    offsets = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_max))
    offsets = offsets[offsets < duration_s]
    accepted: list[tuple[object, float]] = []   # (ticket, t_submit)
    rejected = 0
    t0 = time.perf_counter()
    for off in offsets:
        now = time.perf_counter() - t0
        if off > now:
            time.sleep(off - now)   # ahead of schedule: wait for the instant
        # behind schedule: submit immediately (open loop — never skip)
        try:
            t_submit = time.perf_counter()
            ticket = server.submit(tenant, make_input())
            accepted.append((ticket, t_submit))
        except Overloaded:
            rejected += 1
    # drain: wait for every accepted ticket.  Latency is submit -> the
    # ticket's own fulfillment stamp, NOT the time this drain loop got to
    # it — draining sequentially after the window must not inflate tails.
    latencies: list[float] = []
    failed = 0
    deadline = time.perf_counter() + result_timeout_s
    for ticket, t_submit in accepted:
        try:
            ticket.result(timeout=max(0.001, deadline - time.perf_counter()))
            latencies.append(ticket.completed_at - t_submit)
        except Exception:   # timeout or rejected ticket: count, keep draining
            failed += 1
    wall = time.perf_counter() - t0
    submitted = len(offsets)
    out[tenant] = LoadReport(
        tenant=tenant, offered_rps=float(rate_rps),
        duration_s=float(duration_s), submitted=submitted,
        accepted=len(accepted), rejected=rejected, failed=failed,
        completed=len(latencies),
        p50_s=_percentile(latencies, 50), p99_s=_percentile(latencies, 99),
        throughput_rps=(len(latencies) / wall if wall > 0 else 0.0),
        rejection_rate=(rejected / submitted if submitted else 0.0))


def run_open_loop(server: Server, rates_rps: dict[str, float],
                  make_input, duration_s: float = 2.0, *, seed: int = 0,
                  result_timeout_s: float = 30.0) -> dict[str, LoadReport]:
    """Drive ``{tenant: offered_rate}`` concurrently (one open-loop Poisson
    generator thread per tenant) against a *running* server.

    ``make_input`` is either a zero-arg callable returning one input sample
    or a ``{tenant: callable}`` mapping.  Returns ``{tenant: LoadReport}``.
    """
    if not server.running:
        raise RuntimeError("server must be started before driving load")
    makers = (make_input if isinstance(make_input, dict)
              else {t: make_input for t in rates_rps})
    out: dict[str, LoadReport] = {}
    threads = []
    for i, (tenant, rate) in enumerate(sorted(rates_rps.items())):
        if rate <= 0:
            raise ValueError(f"offered rate for {tenant!r} must be > 0")
        rng = np.random.default_rng(seed + i)
        th = threading.Thread(
            target=_drive_one,
            args=(server, tenant, makers[tenant], float(rate),
                  float(duration_s), rng, float(result_timeout_s), out),
            name=f"loadgen-{tenant}", daemon=True)
        threads.append(th)
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def saturation_throughput(server: Server, tenant: str, make_input, *,
                          n_requests: int = 128, repeats: int = 3,
                          result_timeout_s: float = 60.0) -> float:
    """Sustainable requests/s ceiling for one tenant: submit a closed burst
    of ``n_requests`` back-to-back (retrying the few the admission gate
    sheds, so exactly ``n_requests`` complete) and measure the drain rate;
    best of ``repeats`` damps warm-up and scheduler noise."""
    best = 0.0
    for _ in range(repeats):
        tickets = []
        head = 0                    # the oldest ticket not yet done
        t0 = time.perf_counter()
        submitted = 0
        while submitted < n_requests:
            try:
                tickets.append(server.submit(tenant, make_input()))
                submitted += 1
            except Overloaded:
                # closed burst: wait for the oldest pending ticket, then
                # keep going (the head ticket, once done, would return at
                # once: a retry loop that spins holds the interpreter lock
                # the scheduler thread launches with)
                while head < len(tickets) and tickets[head].done():
                    head += 1
                if head < len(tickets):
                    tickets[head].result(timeout=result_timeout_s)
                else:
                    time.sleep(0.001)
        for t in tickets:
            t.result(timeout=result_timeout_s)
        wall = time.perf_counter() - t0
        best = max(best, n_requests / wall)
    return best
