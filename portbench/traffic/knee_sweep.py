"""Find the knee of a Poisson cell once: the highest rate the server
sustains.  Not part of any run of the benchmark.

    python3 -m portbench.traffic.knee_sweep --workload <poisson cell> --seed <n>
        [--burst 1024] [--step-seconds 10] [--fractions 0.5 0.6 ...]

Sets the cell up as a run does, measures the drain rate of a closed burst
(a copy of ``saturation_throughput``), then offers open-loop Poisson load
at each fraction of it in turn through the cell's own generator, and
prints one JSON line a step: offered and completed req/s, p50/p95/p99 from
the due time, the p95 of the step's last third against its first (a
backlog that grows shows as a rising ratio), and the generator's lateness.
The knee is the highest step that completes at its offered rate with no
growing backlog; the cell's ``rate`` is four fifths of it.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--burst", type=int, default=1024)
    ap.add_argument("--step-seconds", type=float, default=10.0)
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0, 1.1])
    args = ap.parse_args(argv)
    from ..harness import ROOT, prepare
    sys.path.insert(0, str(ROOT / "src"))
    from . import poisson
    run = prepare(args.workload, args.seed, args.step_seconds, False)
    n_pool = len(run.pool)

    def make(r):
        return run.pool[r % n_pool]

    sat = poisson.saturation_throughput(run.server, make,
                                        n_requests=args.burst)
    print(json.dumps({"saturation_rps": sat, "burst": args.burst}),
          flush=True)
    for f in args.fractions:
        rate = f * sat
        dues = poisson.schedule(rate, args.step_seconds, run.rng)
        win = poisson.open_loop(run.server, dues, make)
        lat = np.asarray(win.latencies_s) * 1e3
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "fraction": f, "offered_rps": rate,
            "completed_rps": win.completed / (win.t_end - win.t_start),
            "failed": win.failed,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "p95_last_over_first_third": float(
                np.percentile(lat[-third:], 95)
                / np.percentile(lat[:third], 95)),
            "lateness": win.notes[-1]}), flush=True)
    run.kind.teardown(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
