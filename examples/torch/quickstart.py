"""Quickstart on the PyTorch port: split a CNN's inference across
simulated networked MCUs.  The counterpart of ``examples/quickstart.py``,
plus ``--device``: the session and the monolithic reference run there
(CUDA by default; ``cpu`` runs the kernels' plain versions).

Reproduces the paper's core claim through the coordinator facade in ~5 lines
of API: a model whose per-layer peak RAM exceeds a single MCU becomes
feasible when split at sub-layer granularity, the coordinator picks the
split/placement automatically, and the split execution is numerically
identical to the monolithic reference.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
      (--smoke is accepted for one command line across the examples: this
      one always runs the smoke model)
"""
import argparse

import numpy as np

from repro_torch.api import Cluster, Objective, Planner
from repro_torch.core import (WorkerParams, reference_forward,
                              single_device_peak)
from repro_torch.models import mobilenet_v2_smoke

# split vs monolithic float forward: the same sums in other orders
FLOAT_ATOL = 1e-4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the session runs (default CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for a uniform command line; this example "
                         "always runs the smoke model")
    args = ap.parse_args()

    # the whole coordinator pipeline (rating -> splitting -> allocation ->
    # feasibility -> placement) is these five lines:
    model = mobilenet_v2_smoke()
    cluster = Cluster((WorkerParams(f_mhz=600), WorkerParams(f_mhz=450),
                       WorkerParams(f_mhz=150, d_s_per_kb=0.002)))
    plan = Planner(model, cluster).plan(
        Objective(minimize="latency", ram_cap_bytes=512 * 1024))
    session = plan.compile(precision="float", device=args.device)
    out = session.run(x := np.random.default_rng(0)
                      .standard_normal(model.input_shape).astype(np.float32))

    print(f"model: {len(model.layers)} layers, "
          f"{model.total_macs() / 1e6:.2f}M MACs, "
          f"{model.total_weight_bytes(1) / 1024:.0f} KB int8 weights")
    print(f"device: {session.device}")

    # 1. single-device peak RAM (the bottleneck the paper attacks)
    single = single_device_peak(model)
    print(f"single-MCU peak RAM: {single / 1024:.1f} KB")

    # 2. the plan the coordinator chose (Eq. 5 ratings -> mode/subset search)
    print(f"chosen split: mode={plan.mode}, "
          f"{plan.n_workers}/{cluster.n_workers} workers, "
          f"ratings {np.round(np.asarray(plan.ratings), 2)}")
    print(f"per-worker peak RAM: {np.round(plan.peak_ram / 1024, 1)} KB "
          f"({single / plan.max_peak_ram:.1f}x reduction)")

    # 3. split execution == monolithic reference
    ref = reference_forward(model, x, device=session.device)
    err = float(np.max(np.abs(out - ref)))
    print(f"split vs monolithic max|err|: {err:.2e}")
    if not err <= FLOAT_ATOL:
        raise SystemExit(f"FAIL: split output differs from the monolithic "
                         f"reference by {err:.2e} (> {FLOAT_ATOL})")

    # 4. end-to-end latency through the Eq. 1 timing model; the planner also
    # searched the transport axis (serial coordinator vs per-link pipelining)
    print(f"simulated inference: total={plan.latency_s * 1e3:.1f} ms "
          f"(comp {plan.comp_s * 1e3:.1f} + comm {plan.comm_s * 1e3:.1f})")
    saved = (f", overlap saves {plan.overlap_saved_s * 1e3:.1f} ms vs serial"
             if plan.transport == "pipelined" else "")
    print(f"chosen transport: {plan.transport}{saved}")


if __name__ == "__main__":
    main()
