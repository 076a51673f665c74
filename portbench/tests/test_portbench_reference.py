"""The plain reference against the port's CPU ``Session`` at a small size,
its independence from the program, and its control."""
from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest

from .tiny_bench import ROOT, TINY_MODEL

from portbench import inputs, system
from portbench.control import control_checks
from portbench.harness import Run, run_cell
from portbench.programs import mobilenet_v2 as program
from portbench.reference import mobilenet_v2 as ref

SEED = 2 ** 31 + 5
RATINGS = [1.0, 0.6, 1.4]


def _tiny(seed=SEED):
    lyrs = ref.layers(TINY_MODEL)
    shape = tuple(TINY_MODEL["input"])
    weights = inputs.weights(lyrs, seed, "cpu")
    cal = inputs.calibration(shape, 3, seed, "cpu")
    xs = inputs.pool(shape, 12, seed, "cpu")
    return weights, cal, xs


@pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron"])
def test_reference_equals_port_session_given_its_scales(mode):
    """With the reference's activation scales handed to the program's
    quantizer, every int8 answer of the split ``Session`` on the CPU equals
    the reference's, code for code: the int8 arithmetic is the same."""
    from repro_torch.api import Session
    from repro_torch.core import quantize_model, split_model
    weights, cal, xs = _tiny()
    net = ref.Reference(TINY_MODEL, weights, cal, "cpu")
    scales = [net.input_scale] + [q.out_scale for q in net.qlayers]
    model = program.program_model(TINY_MODEL, weights,
                                  ref.layers(TINY_MODEL))
    sess = Session(split_model(model, RATINGS, mode=mode), device="cpu",
                   qmodel=quantize_model(model, scales), max_batch=4)
    got = sess.submit_many(xs).reshape(len(xs), -1).astype(np.int16)
    np.testing.assert_array_equal(got, net(xs))


def test_reference_equals_port_session_calibrating_apart():
    """Each side calibrating on its own (the benchmark's comparison): at
    this size the answers agree code for code."""
    weights, cal, xs = _tiny()
    cfg = {"model": TINY_MODEL, "precision": "int8",
           "split": {"mode": "spatial", "ratings": RATINGS}}
    run = Run(cfg=cfg, weights=weights, calibration=cal, device="cpu",
              program=program, layers=ref.layers(TINY_MODEL))
    sess = system.session(run, max_batch=4)
    got = sess.submit_many(xs).reshape(len(xs), -1).astype(np.int16)
    np.testing.assert_array_equal(
        got, ref.Reference(TINY_MODEL, weights, cal, "cpu")(xs))


def test_program_model_is_held_to_the_published_layers():
    weights, _, _ = _tiny()
    wrong = dict(TINY_MODEL, last_channels=640)
    with pytest.raises(RuntimeError, match="differs from the published"):
        program.program_model(wrong, weights, ref.layers(wrong))


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench/reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("numpy", "torch", "dataclasses",
                                           "__future__"), (path, m)
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.reference import mobilenet_v2 as r; "
            "from portbench import inputs; "
            "m = %r; ls = r.layers(m); w = inputs.weights(ls, 3, 'cpu'); "
            "c = inputs.calibration(tuple(m['input']), 2, 3, 'cpu'); "
            "r.Reference(m, w, c, 'cpu')(c); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]; "
            "assert not bad, bad" % (str(ROOT), TINY_MODEL))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


@pytest.mark.parametrize("cell", ["tiny.offline", "toy.offline"])
def test_control_comes_out_not_correct(tiny_root, cell):
    """The control (the run's own reference, of its architecture, with int4
    weights in the program's place) fails the comparison that the program
    passes."""
    result, run = run_cell(cell, SEED, 0.5, False, device="cpu",
                           root=tiny_root)
    assert result["correct"]
    checks, ok, _ = control_checks(run)
    assert not ok
    assert checks["mean_code_gap"]["value"] > 3 * max(
        1.0, result["checks"]["mean_code_gap"]["value"])
