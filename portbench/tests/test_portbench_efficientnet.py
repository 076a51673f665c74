"""EfficientNet-B0, an architecture added as files alone: a small
configuration of it runs correct through the harness on the CPU and its
int4 control does not; the published configuration's yardstick is pinned;
the readers of its two per-layer metrics read the traced kernels by name."""
from __future__ import annotations

import json
import types

import pytest

from portbench import counts
from portbench.control import control_checks
from portbench.harness import Bench, run_cell

from .tiny_bench import ROOT, TINY_CELLS, _add_cell, _add_config

SMALL = {"arch": "efficientnet_b0", "input": [3, 32, 32], "stem_channels": 16,
         "mbconv": [[1, 3, 8, 1, 1], [6, 5, 16, 2, 2], [6, 3, 24, 1, 2]],
         "se_ratio": 0.25, "last_channels": 64, "num_classes": 10}
CELL = "effsmall.offline"
SEED = 2 ** 31 + 2029


@pytest.fixture
def eff_root(tiny_root):
    """The benchmark copy with a small EfficientNet configuration and an
    offline cell added, as files and ``BENCHMARK.json`` entries alone."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    _add_config(bench, tiny_root, "effsmall", SMALL)
    _add_cell(bench, tiny_root, CELL, "effsmall", TINY_CELLS["tiny.offline"])
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def test_small_efficientnet_runs_correct_and_its_control_fails(eff_root):
    result, run = run_cell(CELL, SEED, 0.5, False, device="cpu",
                           root=eff_root)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert run.ref.__file__ == str(eff_root /
                                   "portbench/reference/efficientnet_b0.py")
    assert sum(lyr.kind == "gate" for lyr in run.layers) == 4
    checks, ok, _ = control_checks(run)
    assert not ok
    assert checks["mean_code_gap"]["value"] > 3 * max(
        1.0, result["checks"]["mean_code_gap"]["value"])


def test_published_configuration_counts_are_pinned():
    """390,490,528 MACs a request (the paper: 0.39 B); the least times of
    the kernels' layers at the cell's batch of 32."""
    bench = Bench(ROOT)
    cfg = bench.data("configs", "effb0_224_spatial8")
    ref = bench.code("reference", cfg["model"]["arch"])
    lyrs = ref.layers(cfg["model"])
    assert counts.total_macs(lyrs) == 390_490_528
    assert sum(lyr.kind == "gate" for lyr in lyrs) == 16
    five = [lyr for lyr in lyrs if lyr.kind == "dwconv" and lyr.kernel == 5]
    assert len(five) == 9
    assert len(ref.se_layers(lyrs)) == 32
    assert cfg["reduced"] == []


class _Trace:
    """A traced window of two dispatches with one kernel of each name."""

    dispatches = 2

    def __init__(self, names):
        self.names = names

    def device_s(self, prefixes):
        return sum(1e-3 for n in self.names if n.startswith(prefixes))


@pytest.mark.parametrize("metric,kernel", [
    ("kernels.dwconv5x5_roofline",
     "void (anonymous namespace)::dwconv5x5_kernel<1, true, true, 1>"),
    ("kernels.dwconv5x5_roofline", "dwconv5x5_kernel<2, true, true, 1>"),
    ("kernels.se_roofline",
     "(anonymous namespace)::se_pool_kernel((anonymous namespace)::"
     "PoolParams)"),
    ("kernels.se_roofline", "se_gate_kernel")])
def test_new_readers_read_their_kernels_by_name(metric, kernel):
    """Each reader reads the least time of its layers over the device time
    of its kernels in both forms of the name, and nothing where the trace
    has no such kernel (the 3x3 kernel is not the 5x5's)."""
    bench = Bench(ROOT)
    cfg = bench.data("configs", "effb0_224_spatial8")
    ref = bench.code("reference", cfg["model"]["arch"])
    lyrs = ref.layers(cfg["model"])
    reader = bench.code("metrics", metric)
    run = types.SimpleNamespace(ref=ref, layers=lyrs, batch=32)
    run.trace = _Trace([kernel, "void (anonymous namespace)::"
                        "dwconv3x3_kernel<1, true, true, 1>"])
    got = reader.read(run)
    want = [lyr for lyr in lyrs
            if (lyr.kind == "dwconv" and lyr.kernel == 5
                if "5x5" in metric else lyr in ref.se_layers(lyrs))]
    assert got == pytest.approx(100 * 2 * sum(counts.least_s(lyr, 32)
                                              for lyr in want) / 1e-3)
    run.trace = _Trace(["void (anonymous namespace)::dwconv3x3_kernel<1>"])
    assert reader.read(run) is None
