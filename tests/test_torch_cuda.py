"""The port's CUDA kernels and engine on the card (``-m cuda``).

Every test here needs an NVIDIA GPU and skips without one; on a card run
them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports nothing of JAX, so it runs where only torch is installed.  Each CUDA
kernel is held against its plain torch version on the same card tensors
(int8 output bit-exact), and the engine's int8 output on the card against
the CPU's, bit for bit.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.api import Session
from repro_torch.kernels.dwconv.dwconv import dwconv3x3, dwconv3x3_bands
from repro_torch.kernels.dwconv.ref import dwconv3x3_ref
from repro_torch.kernels.qgemm.qgemm import qgemm
from repro_torch.kernels.qgemm.ref import qgemm_ref
from repro_torch.models import mobilenet_v2_smoke

pytestmark = pytest.mark.cuda
ACTS = (None, "relu", "relu6")
RATINGS = [1.0, 0.8, 1.2, 0.6]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gemm_inputs(rng, m, k, n, int_bias, dev):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, n) / (127 * 127 * np.sqrt(k))).astype(
        np.float32)
    b = (rng.integers(-3000, 3000, n).astype(np.int32) if int_bias
         else rng.uniform(-1, 1, n).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in (x, w, s, b)]


def _dw_inputs(rng, c, dev):
    w = rng.integers(-127, 128, (c, 3, 3)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, c) / (127 * 127 * 3)).astype(np.float32)
    b = rng.integers(-3000, 3000, c).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (w, s, b)]


@pytest.mark.parametrize("int_bias", [True, False])
@pytest.mark.parametrize("m,k,n", [(1, 1280, 1000), (37, 27, 32),
                                   (300, 200, 129), (65, 960, 320)])
def test_qgemm_vs_plain(cuda, m, k, n, int_bias):
    args = _gemm_inputs(np.random.default_rng(m), m, k, n, int_bias, cuda)
    for act in ACTS:
        for osc in (None, 0.05):
            before = qgemm.launches
            got = qgemm(*args, activation=act, out_scale=osc)
            assert qgemm.launches == before + 1
            exp = qgemm_ref(*args, activation=act, out_scale=osc)
            torch.cuda.synchronize()
            if osc is not None or int_bias:
                assert torch.equal(got, exp), (act, osc)
            else:
                # the kernel's rounded multiply then add, as the plain one
                torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


def test_qgemm_column_slices(cuda):
    """Column slices of a (K, N) weight pass their row stride."""
    x, w, s, b = _gemm_inputs(np.random.default_rng(1), 50, 64, 96, True,
                              cuda)
    got = qgemm(x, w[:, 10:43], s[10:43], b[10:43], out_scale=0.05)
    assert torch.equal(got, qgemm_ref(x, w[:, 10:43], s[10:43], b[10:43],
                                      out_scale=0.05))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("nb,c,rows,wp", [(64, 96, 11, 58), (32, 960, 3, 6),
                                          (7, 19, 9, 14)])
def test_dwconv_bands_vs_plain(cuda, nb, c, rows, wp, stride):
    rng = np.random.default_rng(nb + c)
    x = torch.from_numpy(rng.integers(-127, 128, (nb, c, rows, wp))
                         .astype(np.int8)).to(cuda)
    w, s, b = _dw_inputs(rng, c, cuda)
    before = dwconv3x3_bands.launches
    got = dwconv3x3_bands(x, w, s, b, stride=stride, activation="relu6",
                          out_scale=0.05)
    assert dwconv3x3_bands.launches == before + 1
    assert torch.equal(got, dwconv3x3_ref(x, w, s, b, stride=stride,
                                          activation="relu6", out_scale=0.05))


def test_dwconv_sample_vs_plain(cuda):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, (96, 58, 58))
                         .astype(np.int8)).to(cuda)
    w, s, b = _dw_inputs(rng, 96, cuda)
    before = dwconv3x3.launches
    got = dwconv3x3(x, w, s, b, stride=2, activation="relu6", out_scale=0.05)
    assert dwconv3x3.launches == before + 1
    assert torch.equal(got, dwconv3x3_ref(x, w, s, b, stride=2,
                                          activation="relu6", out_scale=0.05))


@pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron", "mixed"])
def test_session_on_card_equals_cpu(cuda, mode):
    """The engine launches the kernels on the card, and its int8 output is
    bit-identical to the CPU's plain versions."""
    model = mobilenet_v2_smoke()
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((5, *model.input_shape)).astype(np.float32)
    if mode == "mixed":
        n = len(T.group_blocks(model))
        plan = T.split_model_mixed(
            model, RATINGS, ("spatial",) * (n // 2) + ("kernel",) * (n - n // 2))
    else:
        plan = T.split_model(model, RATINGS, mode=mode)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    before = qgemm.launches
    gpu = Session(plan, qmodel=cpu.qmodel, device=cuda, max_batch=4)
    np.testing.assert_array_equal(gpu.submit_many(xs), cpu.submit_many(xs))
    assert qgemm.launches > before
