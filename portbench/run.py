"""Run one cell of the benchmark once, on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints notes and, last, each number compared beside its limit on standard
error, and the result as one JSON line, last, on standard output.  Exits
non-zero and prints no result without enough CUDA devices for the cell,
without the program (``src/repro_torch``) beside this folder, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys

from .harness import ROOT, Bench, Refused, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    chips = Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result, run = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    except Refused as e:
        print(e, file=sys.stderr)
        return 3
    for line in run.window.notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
