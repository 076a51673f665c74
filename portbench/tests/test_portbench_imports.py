"""No module the harness loads is JAX's or the JAX package's, compared by
the whole top-level name (the port's name begins with the JAX package's)."""
from __future__ import annotations

import subprocess
import sys
import types

import pytest

from .tiny_bench import ROOT, copy_bench

from portbench import harness


def test_forbidden_compares_the_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert not [m for m in harness.forbidden_modules()
                if m.startswith("repro_torch")]
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro.core" in harness.forbidden_modules()


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    copy_bench(tmp_path)
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "res, _ = harness.run_cell('tiny.offline', 5, 0.3, False, "
        "device='cpu', root=Path(%r))\n"
        "assert res['correct'], res\n"
        "assert 'repro_torch' in sys.modules\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n" % (str(ROOT), str(ROOT / "src"),
                                  str(tmp_path)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_refused_when_the_jax_package_is_loaded(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.Refused, match="jax"):
        harness.run_cell("tiny.single", 5, 0.2, False, device="cpu",
                         root=tiny_root)


def test_command_prints_no_result_without_the_program(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mnv2_112_spatial8.offline_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_command_prints_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mnv2_112_spatial8.offline_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
