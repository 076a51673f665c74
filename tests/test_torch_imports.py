"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py``, not the port's examples (``examples/torch``), not the
mesh tests' rank programs (``tests/torch_mesh_ranks.py``) and not the
recorder of the engine's kernel calls (``tests/torch_launches.py``), both
of which the card's tests import, import JAX or the reference package
``repro``."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples" / "torch").glob("*.py"))
         + [ROOT / "tests" / "torch_mesh_ranks.py",
            ROOT / "tests" / "torch_launches.py"])
# the LM slice's modules, named so that a missing one fails here
LM_SLICE = ("configs/base.py", "configs/__init__.py", "configs/qwen3_14b.py",
            "nn/layers.py", "nn/attention.py", "models/lm.py",
            "train/serve.py", "kernels/decode_attn/ref.py",
            "kernels/decode_attn/decode_attn.py",
            "kernels/decode_attn/ops.py", "convert.py")
# the planner and runtime slice's modules, likewise
PLANNER_RUNTIME_SLICE = (
    "core/memory.py", "core/simulator.py", "core/mixed.py", "core/search.py",
    "api/cluster.py", "api/plan.py", "api/planner.py", "api/session.py",
    "api/__init__.py", "core/__init__.py", "runtime/__init__.py",
    "runtime/protocol.py", "runtime/shards.py", "runtime/worker.py",
    "runtime/coordinator.py", "runtime/validate.py", "runtime/elastic.py",
    "runtime/replan.py", "serve/admission.py")
# the serving slice's modules, likewise
SERVING_SLICE = ("serve/__init__.py", "serve/admission.py", "serve/qos.py",
                 "serve/scheduler.py", "serve/server.py", "serve/loadgen.py")
# the LM families' modules, likewise
FAMILIES_SLICE = ("nn/moe.py", "nn/recurrent.py")
# the training slice's modules, likewise
TRAIN_SLICE = ("models/lm.py", "nn/attention.py", "train/optimizer.py",
               "train/trainer.py", "data/pipeline.py", "ckpt/checkpoint.py",
               "launch/train.py", "convert.py")
# the mesh slice's modules, likewise
MESH_SLICE = ("launch/mesh.py", "launch/__init__.py", "parallel/__init__.py",
              "parallel/sharding.py", "parallel/collectives.py",
              "nn/layers.py", "models/lm.py", "nn/moe.py",
              "train/optimizer.py", "train/trainer.py", "train/serve.py",
              "ckpt/checkpoint.py", "launch/train.py",
              "kernels/decode_attn/decode_attn.py",
              "kernels/decode_attn/ops.py", "kernels/decode_attn/ref.py")
# the dry-run slice's modules, likewise
DRYRUN_SLICE = ("launch/analysis.py", "launch/dryrun.py")
EXAMPLES = ("train_small_lm.py",)
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and not node.args[0].value.startswith(".")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_the_port_leaves_jax_out():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   cwd=ROOT, timeout=120, capture_output=True)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Without CUDA, or without the repository beside it, the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""), timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("rel", list(dict.fromkeys(
    LM_SLICE + PLANNER_RUNTIME_SLICE + SERVING_SLICE + FAMILIES_SLICE
    + TRAIN_SLICE + MESH_SLICE + DRYRUN_SLICE)))
def test_lm_slice_module_present_and_clean(rel):
    path = PORT / rel
    assert path in FILES
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_present_and_clean(name):
    path = ROOT / "examples" / "torch" / name
    assert path in FILES
    assert not _imported_roots(path) & set(FORBIDDEN)
