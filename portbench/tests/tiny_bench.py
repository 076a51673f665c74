"""Helpers of the benchmark's CPU tests: a copy of the benchmark with a tiny
MobileNetV2 configuration and a cell of each traffic kind, and a toy
architecture of its own (``toy_cnn``: its reference, its program side, a
configuration and a cell), added as files and ``BENCHMARK.json`` entries
alone."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

TINY_MODEL = {
    "arch": "mobilenet_v2", "input": [3, 24, 24], "stem_channels": 32,
    "inverted_residual": [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 2, 1]],
    "last_channels": 1280, "num_classes": 10}

TINY_CELLS = {
    "tiny.offline": dict(kind="offline", traffic="offline_b4",
                         params=dict(batch=4, inflight=2, pool=16),
                         trace=dict(skip=1, batches=2)),
    "tiny.poisson": dict(kind="poisson", traffic="poisson_b4",
                         params=dict(rate=40.0, max_batch=4, max_inflight=2,
                                     slo_p99_s=5.0, queue_cap=4096, pool=16),
                         trace=dict(from_end_s=0.3, seconds=0.1)),
    "tiny.single": dict(kind="single", traffic="single",
                        params=dict(pool=8), trace=dict(skip=1, requests=2)),
}
TINY_E2E = {"offline": "req_per_s", "poisson": "latency_p95_ms",
            "single": "request_ms"}

# a second architecture: stem conv, depthwise, pointwise, pool, classifier
TOY_ARCH = "toy_cnn"
TOY_MODEL = {"arch": TOY_ARCH, "input": [3, 20, 20], "width": 16,
             "pointwise": 24, "num_classes": 10}
TOY_CELLS = {"toy.offline": TINY_CELLS["tiny.offline"]}


def _add_config(bench: dict, root: Path, name: str, model: dict) -> None:
    cfg = {"name": name, "source": "test", "model": model,
           "split": {"mode": "spatial", "ratings": [1.0, 0.6, 1.4]},
           "precision": "int8", "calibration_images": 3, "reduced": []}
    (root / f"portbench/configs/{name}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "CPU tests"})


def _add_cell(bench: dict, root: Path, name: str, config: str,
              c: dict) -> None:
    cell = dict(config=config, traffic=c["traffic"], kind=c["kind"],
                params=c["params"], trace=c["trace"],
                limits={"mean_code_gap": 0.5}, chips=1, why="CPU tests")
    (root / f"portbench/workloads/{name}.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": c["traffic"], "chips": 1,
                               "why": "CPU tests"})
    e2e = TINY_E2E[c["kind"]]
    entry = next((m for m in bench["end_to_end"] if m["name"] == e2e), None)
    if entry is None:   # a metric the benchmark lists for no cell yet
        entry = {"name": e2e, "unit": "ms", "better": "lower",
                 "bound": 0.25, "source": "host_clock", "workloads": []}
        bench["end_to_end"].append(entry)
    entry["workloads"].append(name)


def add_tiny(root: Path) -> None:
    """Add the tiny configuration and its cells to the benchmark at
    ``root``, as files and entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    _add_config(bench, root, "tiny", TINY_MODEL)
    for name, c in TINY_CELLS.items():
        _add_cell(bench, root, name, "tiny", c)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def add_toy(root: Path) -> None:
    """Add the toy architecture to the benchmark at ``root``: its
    reference and program files, a configuration naming it and an offline
    cell, as files and entries only."""
    shutil.copy(HERE / "toy_cnn_reference.py",
                root / f"portbench/reference/{TOY_ARCH}.py")
    shutil.copy(HERE / "toy_cnn_program.py",
                root / f"portbench/programs/{TOY_ARCH}.py")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    _add_config(bench, root, "toy", TOY_MODEL)
    for name, c in TOY_CELLS.items():
        _add_cell(bench, root, name, "toy", c)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def copy_bench(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench`` (its tests left out)
    at ``dest``, with the tiny cells and the toy architecture added."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny(dest)
    add_toy(dest)
    return dest
