"""Elastic heterogeneous cluster demo on the PyTorch port: rating-based
allocation (paper §V) plus the elastic runtime's policy
(``repro_torch.runtime.elastic``) — a worker dies mid-service, a second
straggles, and the cluster re-plans with the full Planner search (mode x
fusion x subset x transport, Eq. 7 overflow redistribution inside) while
keeping every surviving worker inside its memory budget.  The counterpart
of ``examples/heterogeneous_cluster.py``, plus ``--device``: one int8
session serves a probe request on every plan the cluster moves through
(``Session.replan``, one quantization), and the output must stay bit-exact
— split inference is exact whatever the split.  Exits non-zero otherwise.

Run:  PYTHONPATH=src python examples/torch/heterogeneous_cluster.py \
          [--device cpu]
      (--smoke is accepted for one command line across the examples: this
      one always runs the smoke model)
"""
import argparse

import numpy as np

from repro_torch.core import WorkerParams
from repro_torch.models import mobilenet_v2_smoke
from repro_torch.runtime.elastic import ElasticCluster


def show(cluster, tag):
    plan = cluster.plan
    macs = [plan.split.worker_macs(slot) / 1e3
            for slot in range(plan.n_workers)]
    print(f"{tag}: alive={cluster.alive_indices} "
          f"serving={list(cluster.plan_worker_ids)} "
          f"mode={plan.mode}/{plan.transport} "
          f"share(kMACs)={np.round(macs).astype(int).tolist()} "
          f"peakRAM(KB)={np.round(plan.peak_ram / 1024, 1).tolist()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the probe session runs (default CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for a uniform command line; this example "
                         "always runs the smoke model")
    args = ap.parse_args()

    model = mobilenet_v2_smoke()
    workers = [WorkerParams(f_mhz=600, flash_bytes=64 << 10),
               WorkerParams(f_mhz=600, flash_bytes=24 << 10),   # small flash
               WorkerParams(f_mhz=450, flash_bytes=64 << 10),
               WorkerParams(f_mhz=150, flash_bytes=64 << 10)]
    cluster = ElasticCluster(model, workers, heartbeat_timeout=0.5)
    show(cluster, "initial plan   ")
    print("  (worker 1's small flash caps its share; the planner's Eq. 7 "
          "redistribution keeps every shard inside flash)")

    # one int8 session follows the cluster from plan to plan: the probe's
    # output must not move
    session = cluster.plan.compile(precision="int8", seed=0,
                                   device=args.device)
    probe = (np.random.default_rng(0).standard_normal(model.input_shape)
             .astype(np.float32))
    want = session.run(probe)
    print(f"probe served on {session.device}: class "
          f"{int(np.argmax(want.reshape(-1)))}")
    failures = []

    def serve(tag):
        session.replan(cluster.plan)
        if not np.array_equal(session.run(probe), want):
            failures.append(tag)
        print(f"  probe on the {tag} plan: bit-exact = {tag not in failures}")

    # steady state: heartbeats + step times flow in
    for w in cluster.alive_indices:
        cluster.heartbeat(w)
        cluster.report_step_time(w, 1.0)

    # worker 3 starts straggling (thermal throttle, contention, ...)
    for _ in range(3):
        cluster.report_step_time(3, 4.0)
    if cluster.check():
        show(cluster, "post-straggler ")
        print(f"  worker 3 demoted to {cluster.health[3].params.f_mhz:.0f} "
              f"MHz (floored at {cluster.demotion_floor:.0%} of original)")
        serve("post-straggler")

    # worker 2 dies (no heartbeat); the rest keep heartbeating
    cluster.mark_failed(2)
    for w in cluster.alive_indices:
        cluster.heartbeat(w)
    cluster.check()
    show(cluster, "post-failure   ")
    serve("post-failure")

    print(f"re-planned inference latency: "
          f"{cluster.plan.latency_s * 1e3:.1f} ms "
          f"(simulated, transport={cluster.plan.transport})")

    # worker 2 comes back with a fresh process: original rating restored
    cluster.rejoin(2)
    for w in cluster.alive_indices:
        cluster.heartbeat(w)
    cluster.check()
    show(cluster, "post-rejoin    ")
    serve("post-rejoin")
    if failures:
        raise SystemExit("FAIL: the probe's int8 output changed on the "
                         + ", ".join(failures) + " plan(s)")


if __name__ == "__main__":
    main()
