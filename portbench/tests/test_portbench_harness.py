"""The harness finds every configuration, cell, traffic kind, metric and
architecture by name from its files; a cell, and an architecture, added as
files alone runs; the work counts."""
from __future__ import annotations

import json
import re

import pytest

from .tiny_bench import ROOT, TINY_CELLS, TINY_E2E, TOY_CELLS

from portbench import counts
from portbench.harness import Bench, run_cell
from portbench.reference import mobilenet_v2 as ref

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


ADDED = {**TINY_CELLS, **TOY_CELLS}


@pytest.mark.parametrize("cell", sorted(ADDED))
def test_cell_added_from_files_alone_runs(tiny_root, cell):
    """A configuration and a cell added as files and BENCHMARK.json
    entries only, the toy architecture's with its reference and program
    files; run here on the CPU (the command itself refuses a machine
    without the card)."""
    result, run = run_cell(cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                           root=tiny_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    e2e = TINY_E2E[ADDED[cell]["kind"]]
    assert set(result["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["missing"]["value"] == 0
    json.dumps(result)


def test_the_toy_architecture_is_found_by_its_arch(tiny_root):
    """The toy cell runs the toy's own reference and program modules, whose
    layer list is not MobileNetV2's."""
    result, run = run_cell("toy.offline", 7, 0.3, False, device="cpu",
                           root=tiny_root)
    assert result["correct"]
    assert run.ref.__file__ == str(tiny_root /
                                   "portbench/reference/toy_cnn.py")
    assert run.program.__file__ == str(tiny_root /
                                       "portbench/programs/toy_cnn.py")
    assert [lyr.name for lyr in run.layers] == ["conv0", "dw1", "pw2",
                                                "pool", "fc"]
    assert counts.total_macs(run.layers) == (
        16 * 10 * 10 * 3 * 9 + 16 * 10 * 10 * 9 + 24 * 10 * 10 * 16
        + 24 * 10 * 10 + 24 * 10)


@pytest.mark.parametrize("missing", ["reference", "programs"])
def test_an_arch_without_its_file_fails_before_set_up(tiny_root, monkeypatch,
                                                      missing):
    """A configuration whose ``arch`` has no reference or no program file
    fails with the missing path named, before any weights are made."""
    from portbench import inputs
    (tiny_root / f"portbench/{missing}/toy_cnn.py").unlink()

    def no_set_up(*a, **k):
        raise AssertionError("set-up began")

    monkeypatch.setattr(inputs, "weights", no_set_up)
    path = tiny_root / f"portbench/{missing}/toy_cnn.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        run_cell("toy.offline", 7, 0.3, False, device="cpu", root=tiny_root)


def test_bytes_count_every_tensor_a_layer_states():
    """A layer's bytes are the activation elements it states it reads and
    writes (a residual's kept output among them), not worked out from its
    kind: a layer that reads two tensors counts both."""
    lyr = ref.Layer("p", "conv", 144, 24, (28, 28), (28, 28),
                    residual_from="b2_in")
    assert (lyr.elems_read, lyr.elems_written) == (
        144 * 28 * 28 + 24 * 28 * 28, 24 * 28 * 28)
    assert counts.layer_bytes(lyr, 4) == 4 * (144 + 2 * 24) * 28 * 28 + (
        144 * 24 + 4 * 24)

    class Gate:     # a per-channel multiply of two tensors, no weights
        kind, cout, weight_shape = "mul", 96, None
        elems_read, elems_written = 2 * 96 * 14 * 14, 96 * 14 * 14

    assert counts.layer_bytes(Gate, 8) == 8 * 3 * 96 * 14 * 14


# the yardstick of both configurations as it read before the reference was
# found by its arch: a change of the harness may not move it
@pytest.mark.parametrize("config,batch,macs,least", [
    ("mnv2_112_spatial8", 8, 82204288,
     (5.668126567164179e-06, 3.6922364179104476e-06)),
    ("mnv2_224_kernel8", 32, 300836992,
     (7.38140847761194e-05, 5.775255880597015e-05))])
def test_counts_of_the_configurations_are_pinned(config, batch, macs, least):
    model = json.loads((ROOT / f"portbench/configs/{config}.json")
                       .read_text())["model"]
    lyrs = ref.layers(model)
    assert counts.total_macs(lyrs) == macs
    assert (counts.least_s_of(lyrs, ("conv", "linear"), batch),
            counts.least_s_of(lyrs, ("dwconv",), batch)) == least
