"""Multi-tenant serving example on the PyTorch port: one
``repro_torch.serve.Server`` hosting two split-CNN tenants (the same
MobileNetV2 family at two input resolutions), driven by the open-loop
Poisson load generator.  The counterpart of
``examples/multi_tenant_serve.py``, with the same invariants plus
``--device``: both tenants and the oracle ``Session`` run there (CUDA by
default, where every dispatch runs the hand-written ``qgemm`` and
``dwconv3x3`` kernels; ``cpu`` runs their plain versions).

The serving subsystem stacks three pieces on top of the ``Session`` facade:

* **continuous batching** — a scheduler thread drains the per-tenant queues
  into bucket-padded micro-batches through in-flight dispatch slots; no
  client ever calls ``flush()``;
* **admission control** — per-tenant :class:`~repro_torch.serve.SLO`; overload is
  shed with a typed ``Overloaded`` response instead of queueing requests
  into a tail that cannot meet its target;
* **QoS monitoring** — rolling per-tenant p50/p99/throughput and
  accept/reject counters (``server.stats()``).

The example verifies the serving invariants end to end and exits non-zero if
any fails: bit-exactness vs the plain ``Session`` path, zero dispatch
failures under steady Poisson load, typed shedding under 2x overload with
the accepted population's p99 staying bounded near the SLO target.

Run:  PYTHONPATH=src python examples/torch/multi_tenant_serve.py \
          [--input-hw 56] [--device cpu]
      (--smoke: reduced models + shorter drive)
"""
import argparse

import numpy as np

from repro_torch.api import Session
from repro_torch.core import split_model
from repro_torch.models import mobilenet_v2, mobilenet_v2_smoke
from repro_torch.serve import (SLO, Server, run_open_loop,
                               saturation_throughput)

# 4 simulated MCUs with heterogeneous compute ratings (relative speed)
RATINGS = (3.0, 1.0, 2.0, 0.5)
P99_TARGET_S = 0.25             # tenant B's SLO under the overload phase
P99_BOUND_S = 4 * P99_TARGET_S  # accepted-tail bound the example enforces


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input-hw", type=int, default=56,
                    help="tenant A input resolution (56 keeps CPU latency "
                         "low; the paper uses 112)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="steady-phase Poisson drive duration (s)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced models + shorter drive")
    ap.add_argument("--device", default=None,
                    help="where the tenants run (default CUDA)")
    args = ap.parse_args()
    if args.smoke:
        args.duration = min(args.duration, 1.5)

    rng = np.random.default_rng(0)
    print("== two tenants: one model family, two resolutions ==")
    if args.smoke:
        model_a = mobilenet_v2_smoke()
        model_b = mobilenet_v2(input_hw=(24, 24), width_mult=0.25,
                               num_classes=10,
                               cfg=[(1, 8, 1, 1), (6, 16, 2, 2),
                                    (6, 24, 2, 2)])
    else:
        model_a = mobilenet_v2(input_hw=(args.input_hw, args.input_hw))
        model_b = mobilenet_v2_smoke()
    plan_a = split_model(model_a, np.asarray(RATINGS), mode="neuron")
    plan_b = split_model(model_b, np.asarray(RATINGS), mode="neuron")
    for name, m in (("A", model_a), ("B", model_b)):
        print(f"tenant {name}: input {m.input_shape}, "
              f"{m.total_macs() / 1e6:.0f}M MACs, "
              f"split across {len(RATINGS)} MCUs (neuron mode)")

    # the oracle Session shares tenant A's shard geometry and quantization:
    # warming it first means the tenant warmup below hits the cross-instance
    # constant cache instead of uploading again
    base = Session(plan_a, precision="int8", max_batch=8, device=args.device)
    base.warmup()
    hits0 = Server.cache_stats()["hits"]

    print("\n== host both tenants on one continuous-batching server ==")
    server = Server(max_inflight=2)
    server.add_tenant("a", plan_a, precision="int8", max_batch=8,
                      qmodel=base.qmodel, device=args.device,
                      slo=SLO(p99_target_s=None, queue_cap=1024))
    server.add_tenant("b", plan_b, precision="int8", max_batch=8,
                      device=args.device,
                      slo=SLO(p99_target_s=P99_TARGET_S, queue_cap=1024))
    hits = Server.cache_stats()["hits"] - hits0
    print("tenant A SLO: queue_cap=1024 (no latency target)")
    print(f"tenant B SLO: p99<={P99_TARGET_S * 1e3:.0f}ms, queue_cap=1024")
    print(f"constant-cache hits while warming tenants: {hits} "
          f"(tenant A shares the oracle session's uploaded constants)")

    failures: list[str] = []
    with server:
        print("\n== bit-exactness: server path vs Session.run ==")
        probes = [rng.standard_normal(model_a.input_shape).astype(np.float32)
                  for _ in range(4)]
        bitexact = all(np.array_equal(server.run("a", p, timeout=120.0),
                                      base.run(p)) for p in probes)
        print(f"4 probe requests through the running scheduler: "
              f"bit-exact vs Session.run = {bitexact}")
        if not bitexact:
            failures.append("server output diverged from Session.run")

        print("\n== per-tenant saturation (closed-burst ceiling) ==")
        n_burst = 64 if args.smoke else 96
        sat_a = saturation_throughput(server, "a", lambda: probes[0],
                                      n_requests=n_burst)
        xb = rng.standard_normal(model_b.input_shape).astype(np.float32)
        sat_b = saturation_throughput(server, "b", lambda: xb,
                                      n_requests=n_burst)
        print(f"tenant A: {sat_a:.0f} req/s   tenant B: {sat_b:.0f} req/s")

        print("\n== steady state: open-loop Poisson at 0.4x saturation ==")
        steady = run_open_loop(
            server, {"a": 0.4 * sat_a, "b": 0.4 * sat_b},
            {"a": lambda: probes[0], "b": lambda: xb},
            duration_s=args.duration, seed=1)
        for name in ("a", "b"):
            r = steady[name]
            print(f"  {r.describe()}")
            if r.completed == 0:
                failures.append(f"steady phase: tenant {name} completed "
                                f"nothing")
            if r.failed:
                failures.append(f"steady phase: tenant {name} had "
                                f"{r.failed} failed tickets")

        print("\n== overload: tenant B at 2x saturation, SLO defended ==")
        over = run_open_loop(server, {"b": 2.0 * sat_b}, {"b": lambda: xb},
                             duration_s=args.duration, seed=2)["b"]
        print(f"  offered {over.offered_rps:.0f} req/s: "
              f"shed {over.rejection_rate:.1%} (typed Overloaded), "
              f"accepted p99={over.p99_s * 1e3:.1f}ms "
              f"(target {P99_TARGET_S * 1e3:.0f}ms, "
              f"bound {P99_BOUND_S * 1e3:.0f}ms)")
        if not over.rejection_rate > 0:
            failures.append("overload phase shed nothing — admission "
                            "control did not engage")
        if not over.p99_s <= P99_BOUND_S:
            failures.append(f"accepted p99 {over.p99_s:.3f}s blew through "
                            f"the {P99_BOUND_S}s bound — queueing unbounded")

        print("\n== per-tenant QoS snapshots ==")
        for name, qos in server.stats().items():
            print(f"  {qos.describe()}")

    if failures:
        raise SystemExit("FAIL: " + "; ".join(failures))
    print("\nall serving invariants hold")


if __name__ == "__main__":
    main()
