"""The harness finds every configuration, cell, traffic kind and metric by
name from its files; a cell added as files alone runs; the work counts."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT, TINY_CELLS, TINY_E2E

from portbench import counts
from portbench.harness import Bench, run_cell
from portbench.reference import mobilenetv2 as ref

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    bench = Bench(ROOT)
    entry = bench.cell(cell)
    wl = bench.data("workloads", cell)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    cfg = bench.data("configs", entry["config"])
    assert cfg["name"] == entry["config"]
    kind = bench.code("traffic", wl["kind"])
    for fn in ("setup", "drive", "teardown"):
        assert callable(getattr(kind, fn))
    e2e = [m["name"] for m in bench.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.per_layer(cell)
    for m in bench.end_to_end(cell):
        assert callable(bench.code("endtoend", m["name"]).read)
    for m in bench.per_layer(cell):
        assert callable(bench.code("metrics", m["name"]).read)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_one_named(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]


@pytest.mark.parametrize("hw,macs", [(112, "82.20"), (224, "300.84")])
def test_counts_macs_of_the_published_shapes(hw, macs):
    from repro_torch.models.mobilenetv2 import mobilenet_v2
    model = json.loads((ROOT / "portbench/configs/mnv2_112_spatial8.json")
                       .read_text())["model"]
    model = dict(model, input=[3, hw, hw])
    lyrs = ref.layers(model)
    assert f"{counts.total_macs(lyrs) / 1e6:.2f}" == macs
    assert counts.total_macs(lyrs) == mobilenet_v2(input_hw=(hw, hw)) \
        .total_macs()


def test_least_time_is_the_longer_of_ops_and_bytes():
    lyr = ref.Layer("x", "conv", 96, 24, (56, 56), (56, 56))
    ops, nbytes = counts.layer_ops(lyr, 8), counts.layer_bytes(lyr, 8)
    assert ops == 2 * 96 * 24 * 56 * 56 * 8
    assert nbytes == 8 * (96 + 24) * 56 * 56 + 96 * 24 + 4 * 24
    assert counts.least_s(lyr, 8) == max(ops / counts.PEAK_INT8_OPS_S,
                                         nbytes / counts.PEAK_BYTES_S)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_cell_added_from_files_alone_runs(tiny_root, cell):
    """A configuration and a cell added as files and BENCHMARK.json
    entries only; run here on the CPU (the command itself refuses a
    machine without the card)."""
    result, run = run_cell(cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                           root=tiny_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    e2e = TINY_E2E[TINY_CELLS[cell]["kind"]]
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["missing"]["value"] == 0
    json.dumps(result)
