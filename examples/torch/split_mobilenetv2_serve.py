"""End-to-end serving example (the paper's deployment) on the PyTorch port:
serve int8 MobileNetV2 classification over micro-batched requests across 8
simulated heterogeneous MCUs.  The counterpart of
``examples/split_mobilenetv2_serve.py``, with the same flags plus
``--device``: the session, the float reference and the eager oracle run
there (CUDA by default, where every conv is the hand-written ``qgemm``
kernel and every depthwise layer ``dwconv3x3_bands`` or ``dwconv3x3``;
``cpu`` runs their plain versions).

The coordinator is ``repro_torch.api``: ``Cluster`` holds the measured
workers, ``Planner.plan`` searches partitioning mode x fusion x worker
subsets under the 512 KB RAM budget with the paper's analytic cost models,
and ``plan.compile`` returns a ``Session`` that serves requests through the
``CompiledSplitExecutor`` with bucket-padded micro-batching — each
(precision, bucket) pair uploads its constants once and is amortized over
all traffic.  One eager reference request demonstrates the bit-exact int8
parity between the serving engine and the step-for-step MCU protocol
oracle; the example exits non-zero without it.

Run:  PYTHONPATH=src python examples/torch/split_mobilenetv2_serve.py \
          [--requests 8] [--device cpu]
      (--smoke: reduced model + 4 requests)
"""
import argparse
import time

import numpy as np

from repro_torch.api import SEARCH_MODES, Cluster, Objective, Planner
from repro_torch.core import (SplitExecutor, reference_forward,
                              single_device_peak)
from repro_torch.models import mobilenet_v2, mobilenet_v2_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--input-hw", type=int, default=56,
                    help="input resolution (56 keeps CPU latency low; the "
                         "paper uses 112)")
    ap.add_argument("--mode",
                    choices=("auto", "neuron", "kernel", "spatial", "mixed"),
                    default="auto",
                    help="partitioning mode: 'auto' lets the planner search "
                         "all axes including the DP per-block 'mixed' "
                         "assignment; a named mode pins the search")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced smoke model + 4 requests")
    ap.add_argument("--device", default=None,
                    help="where the session runs (default CUDA)")
    args = ap.parse_args()
    if args.smoke:
        args.requests = min(args.requests, 4)

    rng = np.random.default_rng(0)
    print("== offline preprocessing (Fig. 2) ==")
    if args.smoke:
        model = mobilenet_v2_smoke()
        print(f"MobileNetV2-smoke: {len(model.layers)} layers, "
              f"{model.total_macs() / 1e6:.0f}M MACs")
    else:
        model = mobilenet_v2(input_hw=(args.input_hw, args.input_hw))
        print(f"MobileNetV2@{args.input_hw}: {len(model.layers)} layers, "
              f"{model.total_macs() / 1e6:.0f}M MACs")
    single = single_device_peak(model)
    verdict = ("-> infeasible on one MCU" if single > 512 * 1024
               else "(smoke config fits; the full model does not)")
    print(f"single-MCU peak RAM {single / 1024:.0f} KB "
          f"(budget 512 KB) {verdict}")

    print("\n== resource-aware planning (8 heterogeneous MCUs) ==")
    cluster = Cluster.heterogeneous_demo(8)
    modes = SEARCH_MODES if args.mode == "auto" else (args.mode,)
    t0 = time.perf_counter()
    plan = Planner(model, cluster).plan(
        Objective(minimize="latency", ram_cap_bytes=512 * 1024, modes=modes))
    print(f"plan search took {time.perf_counter() - t0:.2f} s")
    print(plan.report())

    print("\n== compile the plan into a serving session ==")
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(4)]
    session = plan.compile(precision="int8", calibration=calib,
                           max_batch=max(args.requests, 1),
                           device=args.device)
    t0 = time.perf_counter()
    session.warmup(buckets=(1, session.max_batch))
    print(f"warmed int8 buckets (1, {session.max_batch}) on "
          f"{session.device} in {time.perf_counter() - t0:.1f} s "
          f"(constants uploaded once for all traffic)")

    print("\n== split inference serving (micro-batched requests) ==")
    xs = np.stack([rng.standard_normal(model.input_shape).astype(np.float32)
                   for _ in range(args.requests)])
    logits_q = session.submit_many(xs)
    preds_q = np.argmax(logits_q.reshape(args.requests, -1), axis=1)
    agree = 0
    for i in range(args.requests):
        pred_f = int(np.argmax(reference_forward(model, xs[i],
                                                 device=session.device)))
        agree += int(preds_q[i]) == pred_f
        print(f"request {i}: class={int(preds_q[i])} (float model: {pred_f})")
    stats = session.stats()
    print(f"\nint8-split vs float-monolithic top-1 agreement: "
          f"{agree}/{args.requests}")
    print(f"served {stats.requests} requests in {stats.batches} dispatches "
          f"({stats.padded} padded slots): "
          f"{stats.wall_s * 1e3:.0f} ms total, "
          f"{stats.throughput_rps:.1f} req/s, "
          f"{stats.wall_s / stats.requests * 1e3:.1f} ms/request amortized")
    if stats.transport == "pipelined":
        print(f"planned transport: pipelined (per-link async queues; "
              f"predicted overlap saving "
              f"{stats.predicted_overlap_saved_s * 1e3:.1f} ms/inference "
              f"vs the serial coordinator)")
    else:
        print("planned transport: serial (Eq. 5-6 coordinator)")

    # one eager reference request: the serving engine must agree bit-for-bit
    # with the step-for-step MCU protocol oracle
    eager = SplitExecutor(plan.split, session.qmodel, device=session.device)
    t0 = time.perf_counter()
    eager_q = eager.run(xs[0], mode="int8")
    eager_s = time.perf_counter() - t0
    exact = np.array_equal(eager_q, logits_q[0])
    print(f"eager reference request: {eager_s * 1e3:.0f} ms, "
          f"bit-exact vs session: {exact}")
    if not exact:
        raise SystemExit("FAIL: session output diverged from the eager oracle")


if __name__ == "__main__":
    main()
