"""Readings that the limits of ``correct`` are set from.  Not part of any
run of the benchmark.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> ...

For each seed, in one process: a run of the cell (its own traffic at its
own load, for ``--seconds``) and its numbers compared, then the control,
the reference computed with int4 weights (levels -7..7, the step below the
configuration's int8) in the program's place, on the same images and
judged the same way.  One JSON line a seed, with every reading of the gap
(``portbench.harness.gaps``).  The program's largest ``mean_code_gap``
over the seeds is the lower reading of the limit, the control's smallest
the upper.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np


def control_checks(run):
    """The control's numbers compared, for the requests of ``run``."""
    from .harness import judge
    ctrl = run.ref.Reference(run.cfg["model"], run.weights, run.calibration,
                             run.device, weight_bits=4)
    used = sorted(run.ref_codes)
    codes = dict(zip(used, ctrl(run.pool[used])))
    n_pool = len(run.pool)
    outs = np.stack([codes[int(i) % n_pool] for i in run.ids])
    return judge(run.ids, outs, run.ref_codes, run.window.attempted,
                 dict(run.limits, pool=n_pool))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from .harness import ROOT, run_cell
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    for seed in args.seeds:
        result, run = run_cell(args.workload, seed, args.seconds, False)
        ctrl, ctrl_ok, ctrl_gaps = control_checks(run)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "program": result["checks"], "program_gaps": run.readings,
            "control": ctrl, "control_gaps": ctrl_gaps,
            "control_correct": ctrl_ok}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
