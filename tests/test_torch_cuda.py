"""The port's CUDA kernels and engine on the card (``-m cuda``).

Every test here needs an NVIDIA GPU and skips without one; on a card run
them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports nothing of JAX, so it runs where only torch is installed.  Each CUDA
kernel is held against its plain torch version on the same card tensors
(int8 output bit-exact), and the engine's int8 output on the card against
the CPU's, bit for bit.  The flash-decode kernel is held against its
plain version at 1e-5 in float32 and, with a bf16 operand, at rtol 2e-2 and
an atol of 2e-2 x the plain output's largest magnitude: its outputs average
v over hundreds of slots and are small, so a fixed atol as large as them
would pass a wrong answer.  The LM's decode on the card, which attends
through it, is held against the CPU's.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn.decode_attn import (chunk_is_empty,
                                                        decode_attn,
                                                        decode_schedule)
from repro_torch.kernels.decode_attn.ops import flash_decode, flash_decode_ref
from repro_torch.kernels.dwconv.dwconv import dwconv3x3, dwconv3x3_bands
from repro_torch.kernels.dwconv.ops import (dwconv, dwconv_bands_unpadded,
                                            dwconv_shards, shard_table)
from repro_torch.kernels.dwconv.ref import dwconv3x3_ref, dwconv_shards_ref
from repro_torch.kernels.qgemm.qgemm import qgemm
from repro_torch.kernels.qgemm.ref import qgemm_ref
from repro_torch.models import lm, mobilenet_v2_smoke
from repro_torch.nn.layers import map_defs

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


def _assert_gemm(got, exp, int8_out):
    if int8_out:
        assert torch.equal(got, exp)
    else:
        torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("k", [16, 27, 960, 1280, 1281])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128, 35840])
def test_qgemm_schedules_vs_plain(cuda, m, k, layout):
    """Every tile height and split schedule (``qgemm_schedule``) on a ragged
    N, with the weight K-contiguous as the engine stores it: the whole
    (N, K) upload transposed, or a column slice of it with a row-strided x
    whose rows are not 16-byte aligned (the byte-staged path).  No weight
    is copied."""
    rng = np.random.default_rng(m * 7 + k)
    n = 130
    x = torch.from_numpy(rng.integers(-127, 128, (m, k + 13))
                         .astype(np.int8)).to(cuda)
    w_nk = torch.from_numpy(rng.integers(-127, 128, (n + 70, k))
                            .astype(np.int8)).to(cuda)
    if layout == "contiguous":
        x, w = x[:, :k].contiguous(), w_nk[:n].t()
    else:
        x, w = x[:, 5:5 + k], w_nk.t()[:, 37:37 + n]
    assert w.stride(0) == 1
    s = torch.from_numpy((rng.uniform(0.5, 1.5, n) / (127 * 127 * np.sqrt(k)))
                         .astype(np.float32)).to(cuda)
    bq = torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32)).to(
        cuda)
    bf = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    copies = qgemm.weight_copies
    for bias, act, osc in ((bq, "relu6", 0.05), (bq, None, None),
                           (bf, "relu", None), (bf, None, 0.05)):
        got = qgemm(x, w, s, bias, activation=act, out_scale=osc)
        exp = qgemm_ref(x, w, s, bias, activation=act, out_scale=osc)
        torch.cuda.synchronize()
        # the float bias with int8 output rounds the same products the
        # same way (a multiply, then an add): bit-exact as well
        _assert_gemm(got, exp, osc is not None or bias is bq)
    assert qgemm.weight_copies == copies


def test_qgemm_row_major_weight_is_copied_and_counted(cuda):
    x, w, s, b = _gemm_inputs(np.random.default_rng(3), 8, 1280, 100, True,
                              cuda)
    copies = qgemm.weight_copies
    got = qgemm(x, w, s, b, out_scale=0.05)
    assert qgemm.weight_copies == copies + 1
    assert torch.equal(got, qgemm(x, w.t().contiguous().t(), s, b,
                                  out_scale=0.05))
    assert qgemm.weight_copies == copies + 1


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


def _shards(c, hw, n, whole_channels, rng):
    """``n`` shards of a (c, hw) flat layer in worker order, cut at random
    channel boundaries or at random positions (channels split between
    shards), as (c_lo, c_hi inclusive, start, stop)."""
    total = c * hw
    unit = hw if whole_channels else 1
    cuts = rng.choice(np.arange(1, total // unit), size=min(n, total // unit)
                      - 1, replace=False) * unit if total // unit > 1 else []
    bounds = [0, *sorted(int(b) for b in cuts), total]
    return [(a // hw, (b - 1) // hw, a, b) for a, b in zip(bounds, bounds[1:])]


def _dw_both(rng, c, dev):
    """Taps, scale and an int32 and a float32 bias."""
    w, s, bq = _dw_inputs(rng, c, dev)
    bf = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
    return w, s, bq, bf


def _assert_dw(got, exp, int8_out):
    if int8_out:
        assert torch.equal(got, exp)
    else:
        # the kernel's rounded multiply then add, as the plain one
        torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


# (batch, C, H, W, stride): the flat plans' shapes (b1_dw, b3_dw, b13_dw,
# b14_dw of the paper model) and misaligned planes: widths 3, 6, 14, 29,
# 58, odd channel counts, 36-byte planes
FLAT_SHAPES = [(8, 96, 56, 56, 2), (8, 144, 28, 28, 2), (8, 576, 7, 7, 2),
               (8, 960, 4, 4, 1), (3, 7, 9, 3, 1), (2, 13, 6, 6, 1),
               (5, 11, 14, 14, 2), (2, 19, 29, 29, 1), (1, 5, 58, 58, 2),
               (4, 33, 2, 2, 1), (2, 3, 1, 7, 2)]


@pytest.mark.parametrize("cut", ["one", "kernel", "neuron"])
@pytest.mark.parametrize("b,c,h,w,stride", FLAT_SHAPES)
def test_dwconv_shards_vs_plain(cuda, b, c, h, w, stride, cut):
    """A flat layer over all of its shards in one launch (kernel-mode
    channel spans, or neuron-mode ranges that split channels), int8 output
    bit-exact and float32 output within one rounding of the plain loop."""
    rng = np.random.default_rng(c * h + w + stride)
    x = torch.from_numpy(rng.integers(-127, 128, (b, c, h, w))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, bf = _dw_both(rng, c, cuda)
    hw = ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    n = {"one": 1, "kernel": 8, "neuron": 8}[cut]
    table = shard_table(_shards(c, hw, n, cut == "kernel", rng))
    for bias, act, osc in ((bq, "relu6", 0.05), (bf, "relu", None),
                           (bq, None, None), (bf, None, 0.05)):
        before = dwconv3x3.launches
        got = dwconv_shards(x, table, wt, s, bias, stride=stride,
                            activation=act, out_scale=osc)
        assert dwconv3x3.launches == before + 1
        exp = dwconv_shards_ref(x, table.rows, wt, s, bias, stride=stride,
                                activation=act, out_scale=osc)
        torch.cuda.synchronize()
        assert got.shape == (b, c * hw)
        _assert_dw(got, exp, osc is not None or bias is bq)


# (windows, C, R, W, stride): the spatial plan's band stacks (b1_dw,
# b14_dw) and misaligned ones
BAND_SHAPES = [(64, 96, 11, 56, 2), (32, 960, 3, 4, 1), (48, 576, 4, 7, 1),
               (7, 19, 9, 14, 1), (5, 13, 5, 29, 2), (3, 9, 4, 3, 1),
               (6, 7, 6, 6, 2), (2, 5, 3, 58, 1)]


@pytest.mark.parametrize("nb,c,rows,w,stride", BAND_SHAPES)
def test_dwconv_bands_unpadded_vs_plain(cuda, nb, c, rows, w, stride):
    rng = np.random.default_rng(nb * c + w)
    x = torch.from_numpy(rng.integers(-127, 128, (nb, c, rows, w))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, bf = _dw_both(rng, c, cuda)
    xp = torch.nn.functional.pad(x, (1, 1))
    for bias, act, osc in ((bq, "relu6", 0.05), (bf, "relu", None)):
        before = dwconv3x3_bands.launches
        got = dwconv_bands_unpadded(x, wt, s, bias, stride=stride,
                                    activation=act, out_scale=osc)
        assert dwconv3x3_bands.launches == before + 1
        exp = dwconv3x3_ref(xp, wt, s, bias, stride=stride, activation=act,
                            out_scale=osc)
        torch.cuda.synchronize()
        _assert_dw(got, exp, osc is not None)


@pytest.mark.parametrize("b,c,h,w,stride", FLAT_SHAPES[4:])
def test_dwconv_same_vs_plain(cuda, b, c, h, w, stride):
    """``ops.dwconv`` pads in the kernel; one sample or a batch."""
    rng = np.random.default_rng(b + c + h)
    x = torch.from_numpy(rng.integers(-127, 128, (b, c, h, w))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, _ = _dw_both(rng, c, cuda)
    for xin in (x, x[0]):
        before = dwconv3x3.launches
        got = dwconv(xin, wt, s, bq, stride=stride, activation="relu6",
                     out_scale=0.05)
        assert dwconv3x3.launches == before + 1
        exp = dwconv3x3_ref(torch.nn.functional.pad(xin, (1, 1, 1, 1)), wt,
                            s, bq, stride=stride, activation="relu6",
                            out_scale=0.05)
        assert torch.equal(got, exp)


def test_dwconv_shards_beyond_the_kernel_raise(cuda):
    n = 65
    table = shard_table([(c, c, c * 4, c * 4 + 4) for c in range(n)])
    x = torch.ones((1, n, 2, 2), dtype=torch.int8, device=cuda)
    w, s, b = _dw_inputs(np.random.default_rng(0), n, cuda)
    with pytest.raises(ValueError, match="at most"):
        dwconv_shards(x, table, w, s, b)


def test_dwconv_smem_layout_matches_schedule(cuda):
    """The schedule budgets the shared memory the kernel lays out."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.dwconv.dwconv import smem_bytes
    fn = backend.library("dwconv").dwconv_smem_bytes
    for c_tile, slab in ((1, 16), (7, 640), (32, 3152), (128, 48)):
        assert fn(c_tile, slab) == smem_bytes(c_tile, slab)


@pytest.mark.parametrize("mode", ["kernel", "neuron", "spatial"])
def test_forward_one_depthwise_launch_per_layer(cuda, mode):
    """A forward makes one depthwise launch per depthwise layer: on the
    flat plans one ``dwconv3x3`` launch over all shards, on the spatial
    plan one ``dwconv3x3_bands`` launch over all bands."""
    model = mobilenet_v2_smoke()
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((4, *model.input_shape)).astype(np.float32)
    plan = T.split_model(model, [1.0, 2.7, 0.35, 1.6, 0.5, 1.15], mode=mode)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    eng = T.CompiledSplitExecutor(plan, cpu.qmodel, device=cuda)
    eng.run_batch(xs, mode="int8")
    before = dwconv3x3.launches, dwconv3x3_bands.launches
    got = eng.run_batch(xs, mode="int8")
    n_dw = sum(layer.kind == "dwconv" for layer in model.layers)
    flat = mode != "spatial"
    assert (dwconv3x3.launches - before[0],
            dwconv3x3_bands.launches - before[1]) == (
                (n_dw, 0) if flat else (0, n_dw))
    np.testing.assert_array_equal(
        got, T.CompiledSplitExecutor(plan, cpu.qmodel, device="cpu")
        .run_batch(xs, mode="int8"))


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


def _smoke_plan_and_qmodel(mode):
    model = mobilenet_v2_smoke()
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    if mode == "mixed":
        n = len(T.group_blocks(model))
        plan = T.split_model_mixed(
            model, RATINGS, ("spatial",) * (n // 2) + ("kernel",) * (n - n // 2))
    else:
        plan = T.split_model(model, RATINGS, mode=mode)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    return model, plan, cpu.qmodel


def _launch_counts():
    return (qgemm.launches, dwconv3x3.launches, dwconv3x3_bands.launches)


def _expected_counts(launches):
    return (sum(k == "qgemm" for k, *_ in launches),
            sum(k == "dwconv3x3" for k, *_ in launches), 0)


@pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron", "mixed"])
def test_worker_segments_on_card_equal_cpu(cuda, mode):
    """Every segment of every worker's setup gives on the card what it
    gives on the CPU, bit for bit, and launches exactly the kernels its
    spec lists (``segment_launches``): one kernel per conv, none taking a
    plain version."""
    from repro_torch.runtime.shards import (build_segment_fns,
                                            build_worker_setup,
                                            segment_launches)
    _, plan, qmodel = _smoke_plan_and_qmodel(mode)
    rng = np.random.default_rng(1)
    for w in range(plan.n_workers):
        meta, arrays = build_worker_setup(plan, qmodel, "int8", w)
        gpu = build_segment_fns(meta, arrays, device=cuda)
        cpu = build_segment_fns(meta, arrays, device="cpu")
        for spec in meta["segments"]:
            if spec["kind"] == "skip":
                continue
            seg = gpu[spec["gi"]]
            x = rng.integers(-127, 128, seg.input_shape).astype(np.int8)
            before = _launch_counts()
            y = seg.fn(x).cpu().numpy()
            delta = tuple(a - b for a, b in zip(_launch_counts(), before))
            assert delta == _expected_counts(segment_launches(spec, arrays))
            np.testing.assert_array_equal(y, cpu[spec["gi"]].fn(x).numpy())


@pytest.mark.parametrize("mode", ["spatial", "kernel", "mixed"])
def test_distributed_inprocess_on_card_equals_session(cuda, mode):
    """In-process workers on the card serve bit-exact with the card's
    ``Session``, realize every predicted edge, and over one request make
    exactly the kernel launches the setup payloads list: no worker conv
    reaches the float64 oracle or a plain version."""
    import asyncio

    from repro_torch.core.simulator import dependency_edges
    from repro_torch.runtime import Coordinator, run_distributed
    from repro_torch.runtime.shards import (build_worker_setup,
                                            segment_launches)
    model, plan, qmodel = _smoke_plan_and_qmodel(mode)
    sess = Session(plan, qmodel=qmodel, device=cuda, max_batch=4)
    rep = run_distributed(plan, qmodel, reference=sess, spawn="inprocess",
                          n_requests=2)
    assert rep.bitexact and rep.edges_superset
    launches = []
    for w in range(plan.n_workers):
        meta, arrays = build_worker_setup(plan, qmodel, "int8", w)
        for spec in meta["segments"]:
            launches += segment_launches(spec, arrays)
    x = np.random.default_rng(2).standard_normal(
        model.input_shape).astype(np.float32)

    async def one_request():
        async with Coordinator(plan, qmodel, spawn="inprocess",
                               device=cuda) as coord:
            before = _launch_counts()
            y = await coord.infer(x)
            after = _launch_counts()
            return y, tuple(a - b for a, b in zip(after, before)), \
                coord.measured_edges
    y, delta, edges = asyncio.run(asyncio.wait_for(one_request(), 240))
    assert delta == _expected_counts(launches)
    assert delta[0] > 0 and delta[1] > 0
    np.testing.assert_array_equal(y, sess.run(x))
    assert dependency_edges(plan) <= edges


def _decode_inputs(rng, b, k, g, hd, s, dev, q_dtype, kv_dtype):
    q = torch.from_numpy(rng.standard_normal((b, 1, k, g, hd)).astype(
        np.float32)).to(dev, q_dtype)
    ck, cv = (torch.from_numpy(rng.standard_normal((b, s, k, hd)).astype(
        np.float32)).to(dev, kv_dtype) for _ in range(2))
    lens = torch.from_numpy(rng.integers(s // 2, s + 1, b).astype(
        np.int32)).to(dev)
    return q, ck, cv, lens


def _assert_decode_close(got, exp, q_dt, kv_dt):
    if q_dt == kv_dt == torch.float32:
        rtol = atol = 1e-5
    else:
        rtol, atol = 2e-2, 2e-2 * float(exp.float().abs().max())
    torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                               atol=atol)


DECODE_DTYPES = {"f32": (torch.float32, torch.float32),
                 "bf16": (torch.bfloat16, torch.bfloat16),
                 "f32/bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtypes", list(DECODE_DTYPES))
@pytest.mark.parametrize("b,k,g,hd,s", [
    (2, 4, 5, 64, 1024), (1, 8, 1, 128, 512), (3, 2, 8, 32, 768),
    (2, 1, 16, 64, 640), (8, 8, 5, 128, 2081), (1, 1, 4, 256, 77),
    (2, 2, 2, 16, 45), (3, 1, 7, 8, 300)])
def test_decode_attn_vs_plain(cuda, b, k, g, hd, s, dtypes):
    """The four shapes of the reference's tests, the qwen3-14b live cache
    (ragged S = 2081), the smoke configs' hd 16, and hd 256 and 8, each in
    the three dtype pairs, read in the model's (B, S, K, hd) layout through
    strides."""
    q_dt, kv_dt = DECODE_DTYPES[dtypes]
    args = _decode_inputs(np.random.default_rng(b * s + g), b, k, g, hd, s,
                          cuda, q_dt, kv_dt)
    before = decode_attn.launches
    got = flash_decode(*args)
    assert decode_attn.launches == before + 1
    exp = flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == q_dt and got.shape == exp.shape
    _assert_decode_close(got, exp, q_dt, kv_dt)


@pytest.mark.parametrize("dtypes", ["bf16", "f32/bf16"])
def test_decode_attn_peaked_vs_plain(cuda, dtypes):
    """q scaled by 8: the logits are peaked, so each output lies near one
    slot's v (O(1)) instead of an average of ~0.01 over the whole cache."""
    q_dt, kv_dt = DECODE_DTYPES[dtypes]
    q, ck, cv, lens = _decode_inputs(np.random.default_rng(11), 8, 8, 5,
                                     128, 2081, cuda, q_dt, kv_dt)
    q = (q.float() * 8.0).to(q_dt)
    got = flash_decode(q, ck, cv, lens)
    exp = flash_decode_ref(q, ck, cv, lens)
    assert float(exp.float().abs().max()) > 1.0
    _assert_decode_close(got, exp, q_dt, kv_dt)


def test_decode_attn_masks_past_lengths(cuda):
    rng = np.random.default_rng(5)
    q, ck, cv, _ = _decode_inputs(rng, 2, 2, 2, 32, 256, cuda,
                                  torch.float32, torch.float32)
    lens = torch.tensor([100, 1], dtype=torch.int32, device=cuda)
    out1 = flash_decode(q, ck, cv, lens, block_s=64)
    ck[:, 100:], cv[:, 100:] = 99.0, -99.0
    ck[1, 1:], cv[1, 1:] = 99.0, -99.0
    out2 = flash_decode(q, ck, cv, lens, block_s=64)
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=1e-6)
    # one valid slot: the output is that slot's v
    torch.testing.assert_close(out2[1, 0], cv[1, 0][:, None].expand(2, 2, 32),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtypes", list(DECODE_DTYPES))
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 5, 8, 16])
def test_decode_attn_split_cases(cuda, g, hd, dtypes):
    """The split over S (``decode_schedule``): S = 1333 is no multiple of
    the chunk; row 0 has one valid slot, row 1 all of them, and row 2 100,
    which leaves whole chunks empty; bf16 caches again with peaked q."""
    q_dt, kv_dt = DECODE_DTYPES[dtypes]
    q, ck, cv, _ = _decode_inputs(np.random.default_rng(g * hd), 3, 2, g, hd,
                                  1333, cuda, q_dt, kv_dt)
    lens = torch.tensor([1, 1333, 100], dtype=torch.int32, device=cuda)
    n_split, chunk = decode_schedule(1333, 6)
    assert n_split > 2 and chunk_is_empty(n_split - 1, chunk, 100)
    scales = (1.0, 8.0) if kv_dt == torch.bfloat16 else (1.0,)
    for scale in scales:
        qs = (q.float() * scale).to(q_dt)
        got = flash_decode(qs, ck, cv, lens)
        exp = flash_decode_ref(qs, ck, cv, lens)
        torch.cuda.synchronize()
        assert got.dtype == q_dt
        _assert_decode_close(got, exp, q_dt, kv_dt)
        # one valid slot: that slot's v, to the output's rounding
        torch.testing.assert_close(
            got[0, 0].float(), cv[0, 0].float()[:, None].expand(2, g, hd)
            .to(q_dt).float(), rtol=1e-6, atol=1e-6)


def test_lm_decode_on_card_equals_cpu(cuda):
    """qwen3-14b-smoke in float32: prefill and four greedy decode steps on
    the card (attention against the cache through the kernel, one launch
    per layer and step) against the same model on the CPU."""
    cfg = get_config("qwen3-14b-smoke")
    params = lm.init_model(cfg, 0, device="cpu")
    gpu_params = map_defs(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    caches = {d: lm.init_cache(cfg, 2, 20, device=d) for d in ("cpu", cuda)}
    ps = {"cpu": params, cuda: gpu_params}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {d: lm.forward(ps[d], {"tokens": toks.to(d)}, cfg, "prefill",
                             caches[d])[0] for d in ps}
        before = decode_attn.launches
        for _ in range(4):
            tok = torch.argmax(out["cpu"], -1)[:, None]
            assert torch.equal(torch.argmax(out[cuda], -1).cpu(), tok[:, 0])
            out = {d: lm.forward(ps[d], {"tokens": tok.to(d)}, cfg, "decode",
                                 caches[d])[0] for d in ps}
            torch.testing.assert_close(out[cuda].cpu(), out["cpu"],
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert decode_attn.launches == before + 4 * cfg.n_layers


def test_lm_decode_step_never_waits_on_the_card(cuda):
    """The position counter lives on the host: a decode step issues no
    synchronising call (``set_sync_debug_mode`` raises on one)."""
    cfg = get_config("qwen2.5-32b-smoke")
    params = lm.init_model(cfg, 0, device=cuda)
    cache = lm.init_cache(cfg, 2, 16, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    logits, cache = lm.forward(params, {"tokens": toks}, cfg, "prefill", cache)
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            logits, cache = lm.forward(params, {"tokens": tok}, cfg, "decode",
                                       cache)
            tok = torch.argmax(logits, -1)[:, None]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cache["pos"] == 11 and bool(torch.isfinite(logits).all())
