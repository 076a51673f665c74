"""A cell of each traffic kind on the card, short, traced: correct, every
per-layer metric read, every share of a roofline or a peak under 100%.
Needs a CUDA device (marker ``cuda``; skips without one)."""
from __future__ import annotations

import json

import pytest

from .tiny_bench import ROOT

from portbench.harness import Bench, run_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_on_the_card(card, cell):
    result, _ = run_cell(cell, 2 ** 31 + 99, 4.0, True)
    assert result["correct"], result["checks"]
    want = {m["name"] for m in Bench(ROOT).per_layer(cell)}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
