"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny configuration and a cell of each traffic kind, added as files and
``BENCHMARK.json`` entries alone."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

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


def add_tiny(root: Path, split_mode: str = "spatial") -> None:
    """Add the tiny configuration and its cells to the benchmark at
    ``root``, as files and entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = {"name": "tiny", "source": "test", "model": TINY_MODEL,
           "split": {"mode": split_mode, "ratings": [1.0, 0.6, 1.4]},
           "precision": "int8", "calibration_images": 3, "reduced": []}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for name, c in TINY_CELLS.items():
        cell = dict(config="tiny", traffic=c["traffic"], kind=c["kind"],
                    params=c["params"], trace=c["trace"],
                    limits={"mean_code_gap": 0.5}, chips=1, why="CPU tests")
        (root / f"portbench/workloads/{name}.json").write_text(
            json.dumps(cell))
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": c["traffic"], "chips": 1,
                                   "why": "CPU tests"})
        e2e = TINY_E2E[c["kind"]]
        entry = next((m for m in bench["end_to_end"] if m["name"] == e2e),
                     None)
        if entry is None:   # a metric the benchmark lists for no cell yet
            entry = {"name": e2e, "unit": "ms", "better": "lower",
                     "bound": 0.25, "source": "host_clock", "workloads": []}
            bench["end_to_end"].append(entry)
        entry["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark with the tiny cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny(tmp_path)
    return tmp_path
