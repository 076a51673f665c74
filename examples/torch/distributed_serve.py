"""Distributed serving demo on the PyTorch port: the pipelined schedule
running for real, the workers' segments on the card's kernels.  The
counterpart of ``examples/distributed_serve.py``, with the same flags and
checks, plus ``--device``: the coordinator, its workers and the oracle
``Session`` run there (CUDA by default, where each worker's convs are the
hand-written ``qgemm`` and ``dwconv3x3`` kernels; ``cpu`` runs their plain
versions).

Spawns N socket workers (separate Python processes by default), ships each
its shard of the int8 MobileNetV2 weights once, then drives requests through
the asyncio :class:`~repro_torch.runtime.coordinator.Coordinator` — downloads for
one fused block overlap the previous block's compute and uploads, exactly as
the PR-4 transport simulator schedules them.  The run is validated on the
spot: output must be bit-exact against the single-process ``Session`` and
the measured event timeline must realize every dependency edge the
pipelined simulator predicts.  Exits nonzero if either invariant fails.

With ``--churn`` the demo becomes a scripted fault-injection run over the
elastic runtime instead: N workers serve, one is killed mid-stream, a
straggler is demoted, the dead worker rejoins — and after every transition
the output must stay bit-exact vs the single-process ``Session`` on the
surviving topology, with only the delta re-shipped (re-shipped bytes <
full setup bytes), every unchanged shard geometry hitting the warm
compiled cache (rate 1.0), recovery bounded by ``--recovery-budget``, and
zero leaked asyncio tasks after shutdown.  Exits nonzero on any violation
— the CI ``elastic-churn`` job.

Run:  PYTHONPATH=src python examples/torch/distributed_serve.py --workers 4
      (--smoke: reduced model, 2 workers; --device cpu: the CPU)
      PYTHONPATH=src python examples/torch/distributed_serve.py --churn
"""
import argparse
import asyncio
import json
import sys
import time

import numpy as np

from repro_torch.core.splitting import split_model
from repro_torch.models import mobilenet_v2, mobilenet_v2_smoke
from repro_torch.runtime import run_distributed, worker_geometry_summary


def run_churn(args, model, name) -> int:
    """Scripted fault injection over the elastic runtime (CI elastic-churn).

    Phases: steady serve -> kill one worker mid-stream -> demote a
    straggler -> rejoin the dead worker.  Every phase's outputs must be
    bit-exact vs the single-process Session on the surviving topology.
    """
    from repro_torch.api.planner import Objective
    from repro_torch.api.session import Session
    from repro_torch.core.allocation import WorkerParams
    from repro_torch.runtime.elastic import ElasticCluster
    from repro_torch.runtime.replan import ElasticCoordinator

    # spatial objective: band workers replicate layer weights, so replans
    # re-ship specs, not weights — the reship < full-setup invariant.
    # The full 112x112 model needs the PSRAM-class RAM budget once churn
    # skews the band allocation toward the surviving fast workers.
    ram = (512 << 10) if args.smoke else (8 << 20)
    cluster = ElasticCluster(
        model, [WorkerParams(ram_bytes=ram) for _ in range(args.workers)],
        objective=Objective(modes=("spatial",)),
        heartbeat_timeout=1e9)      # churn is injected, not timed out
    sess = Session(cluster.plan.split, precision=args.precision, seed=0,
                   device=args.device)
    qm = sess.qmodel
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(model.input_shape).astype(np.float32)
          for _ in range(max(args.requests, 2))]
    print(f"{name}: churn over {args.workers} {args.spawn} worker(s), "
          f"{args.precision}, serving {len(xs)} request(s)/phase")

    async def drive():
        res = {"phases": {}, "reports": [], "leaked_tasks": None}
        ec = ElasticCoordinator(cluster, qm, precision=args.precision,
                                spawn=args.spawn,
                                log_dir=args.log_dir, device=args.device)
        async with ec:
            res["phases"]["steady"] = [await ec.infer(x) for x in xs]
            # kill the worker serving plan slot 0 while a request is in
            # flight: the retry path must recover it, not drop it
            victim = ec.physical_ids[0]
            t = asyncio.ensure_future(ec.infer(xs[0]))
            await asyncio.sleep(0)
            await ec.inject_failure(0)
            first = await t
            res["phases"]["kill"] = [first] + [await ec.infer(x)
                                               for x in xs[1:]]
            res["victim"] = victim
            res["victim_excluded"] = victim not in cluster.plan_worker_ids
            res["surviving_split"] = ec.split
            # straggler: last slot reports 10x step times, gets demoted
            straggler = max(ec.physical_ids)
            for _ in range(4):
                for slot in ec.physical_ids:
                    ec.report_step_time(
                        slot, 10.0 if slot == straggler else 1.0)
            await ec.rebalance()
            res["phases"]["demote"] = [await ec.infer(x) for x in xs]
            # the dead worker comes back as a fresh process
            await ec.rejoin(victim)
            res["phases"]["rejoin"] = [await ec.infer(x) for x in xs]
            res["reports"] = list(ec.reports)
            # cold-search yardstick for the warm-replan invariant: a fresh
            # Planner (empty CostCache) on the same post-rejoin topology
            from repro_torch.api.cluster import Cluster as ApiCluster
            from repro_torch.api.planner import Planner
            sub = ApiCluster(
                tuple(cluster.health[i].params
                      for i in cluster.alive_indices), name="cold")
            t0 = time.perf_counter()
            Planner(model, sub, cluster.sim_cfg).plan(cluster.objective)
            res["cold_search_wall_s"] = time.perf_counter() - t0
        leaked = [t for t in asyncio.all_tasks()
                  if t is not asyncio.current_task() and not t.done()]
        res["leaked_tasks"] = len(leaked)
        return res

    res = asyncio.run(drive())

    # oracle: single-process Session on the post-kill surviving topology
    # (same qmodel — int8 output is bit-exact across all split geometries)
    oracle = Session(res["surviving_split"], qmodel=qm,
                     precision=args.precision, device=args.device)
    ys_ref = [oracle.run(x) for x in xs]
    failures = []
    for phase, ys in res["phases"].items():
        if len(ys) != len(xs):
            failures.append(f"phase {phase}: {len(ys)}/{len(xs)} requests "
                            "served (silent drop)")
            continue
        bad = [i for i, (y, yr) in enumerate(zip(ys, ys_ref))
               if not np.array_equal(y, yr)]
        if bad:
            failures.append(f"phase {phase}: requests {bad} not bit-exact "
                            "vs single-process Session")
        else:
            print(f"  phase {phase:7s}: {len(ys)} request(s) bit-exact")
    kill_rep = res["reports"][0]
    rejoin_rep = res["reports"][-1]
    for tag, rep in [("kill", kill_rep), ("rejoin", rejoin_rep)]:
        print(f"  {tag}: downtime {rep['downtime_s']:.2f} s, reshipped "
              f"{rep['reshipped_bytes']}/{rep['full_setup_bytes']} B, "
              f"cache {rep['cache_hits']}/{rep['expected_cache_hits']} "
              f"(rate {rep['hit_rate']:.2f})")
    for rep in res["reports"]:
        if rep["reshipped_bytes"] >= rep["full_setup_bytes"]:
            failures.append(f"replan re-shipped {rep['reshipped_bytes']} B "
                            f">= full setup {rep['full_setup_bytes']} B")
        if rep["hit_rate"] != 1.0:
            failures.append(f"warm-cache hit rate {rep['hit_rate']} != 1.0 "
                            f"({rep['cache_hits']}/"
                            f"{rep['expected_cache_hits']})")
        if rep["downtime_s"] > args.recovery_budget:
            failures.append(f"recovery took {rep['downtime_s']:.1f} s > "
                            f"budget {args.recovery_budget} s")
    if rejoin_rep["cache_hits"] == 0:
        failures.append("rejoin produced zero warm-cache hits (vacuous)")
    # warm-replan search invariants: the cluster's persistent CostCache must
    # make every churn replan warm (hit rate > 0) and the rejoin replan
    # strictly faster than a cold search of the same topology
    for tag, rep in [("kill", kill_rep), ("rejoin", rejoin_rep)]:
        print(f"  {tag}: search {rep['replan_candidates_evaluated']} "
              f"candidates, hit rate {rep['replan_cache_hit_rate']:.2f}, "
              f"wall {rep['replan_search_wall_s'] * 1e3:.0f} ms "
              f"(cold {res['cold_search_wall_s'] * 1e3:.0f} ms)")
        if rep["replan_cache_hit_rate"] <= 0.0:
            failures.append(f"{tag} replan searched cold "
                            f"(cache hit rate "
                            f"{rep['replan_cache_hit_rate']})")
    if rejoin_rep["replan_search_wall_s"] >= res["cold_search_wall_s"]:
        failures.append(
            f"warm rejoin search wall {rejoin_rep['replan_search_wall_s']:.3f}"
            f" s >= cold search wall {res['cold_search_wall_s']:.3f} s")
    if not res["victim_excluded"]:
        failures.append("killed worker still in plan_worker_ids")
    if res["leaked_tasks"]:
        failures.append(f"{res['leaked_tasks']} asyncio task(s) leaked "
                        "after close()")
    print(f"  leaked tasks after close: {res['leaked_tasks']}")

    if args.timeline_out:
        doc = {"model": name, "workers": args.workers,
               "precision": args.precision,
               "phases": {k: len(v) for k, v in res["phases"].items()},
               "victim": res["victim"],
               "cold_search_wall_s": res["cold_search_wall_s"],
               "reports": res["reports"],
               "leaked_tasks": res["leaked_tasks"],
               "failures": failures}
        with open(args.timeline_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=str)
        print(f"wrote churn report -> {args.timeline_out}")

    if failures:
        for msg in failures:
            print(f"CHURN VALIDATION FAILED: {msg}", file=sys.stderr)
        return 1
    print("OK")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count (default: 4, or 2/3 under --smoke)")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--mode", choices=("spatial", "neuron", "kernel"),
                    default="spatial")
    ap.add_argument("--precision", choices=("int8", "float"), default="int8")
    ap.add_argument("--spawn", choices=("process", "inprocess"),
                    default="process")
    ap.add_argument("--input-hw", type=int, default=112,
                    help="input resolution for the full model (paper: 112)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model + 2 workers + in-process loop "
                         "(CI distributed-smoke job)")
    ap.add_argument("--churn", action="store_true",
                    help="scripted fault injection over the elastic "
                         "runtime: kill mid-stream, demote, rejoin "
                         "(CI elastic-churn job)")
    ap.add_argument("--recovery-budget", type=float, default=120.0,
                    help="max seconds a single replan transition may take "
                         "(--churn)")
    ap.add_argument("--timeline-out", default=None,
                    help="write the validation report + measured timeline "
                         "as JSON")
    ap.add_argument("--log-dir", default=None,
                    help="directory for per-worker log files (process spawn)")
    ap.add_argument("--device", default=None,
                    help="torch device of the coordinator and its workers "
                         "(default: CUDA)")
    args = ap.parse_args(argv)

    if args.smoke:
        model = mobilenet_v2_smoke()
        name = "MobileNetV2-smoke"
        if args.workers is None:
            args.workers = 3 if args.churn else 2
    else:
        model = mobilenet_v2(input_hw=(args.input_hw, args.input_hw))
        name = f"MobileNetV2@{args.input_hw}"
    if args.workers is None:
        args.workers = 4

    if args.churn:
        return run_churn(args, model, name)
    print(f"{name}: {len(model.layers)} layers, "
          f"{model.total_macs() / 1e6:.0f}M MACs -> {args.workers} "
          f"{args.spawn} worker(s), {args.precision}, mode={args.mode}")

    split = split_model(model, np.ones(args.workers), mode=args.mode)
    for g in worker_geometry_summary(split):
        print(f"  worker {g['worker']}: {g['weight_bytes'] / 1024:.0f} KB "
              f"weights, {len(g['segments'])} segment(s)")

    rep = run_distributed(split, precision=args.precision,
                          n_requests=args.requests, spawn=args.spawn,
                          log_dir=args.log_dir, device=args.device)

    print(f"\nsetup (connect + ship shards + upload + warm-up): "
          f"{rep.setup_s:.2f} s")
    print(f"bit-exact vs single-process Session:  {rep.bitexact} "
          f"(max |diff| = {rep.max_abs_diff:g})")
    print(f"dependency edges measured/predicted:  "
          f"{len(rep.measured_edges)}/{len(rep.predicted_edges)} "
          f"(superset: {rep.edges_superset})")
    print(f"request makespan measured {rep.makespan_s * 1e3:.1f} ms vs "
          f"predicted-on-MCU {rep.predicted_s * 1e3:.1f} ms "
          f"(ratio {rep.calibration_ratio:.3f} — localhost sockets, "
          f"informational)")

    if args.timeline_out:
        doc = rep.row()
        doc["events"] = [
            {"worker": e.worker, "kind": e.kind, "segment": e.segment,
             "layer": e.layer, "start_s": e.start_s, "end_s": e.end_s,
             "nbytes": e.nbytes}
            for e in (rep.timeline.events if rep.timeline else ())]
        with open(args.timeline_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote timeline -> {args.timeline_out}")

    if not (rep.bitexact and rep.edges_superset):
        print("VALIDATION FAILED", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
