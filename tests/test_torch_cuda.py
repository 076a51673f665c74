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
    """A flat layer of more shards than one launch's parameters hold runs in
    ``ceil(n / MAX_SHARDS)`` launches, each writing its slice of the one
    output: bit-exact with the plain loop, kernel-mode spans and neuron-mode
    ranges that split channels, uneven either way."""
    from repro_torch.kernels.dwconv.dwconv import MAX_SHARDS
    rng = np.random.default_rng(0)
    for n in (65, 130):
        for cut in ("kernel", "neuron"):
            c, h, w = (n + 7, 6, 6) if cut == "kernel" else (n // 2 + 3, 7, 7)
            hw = h * w
            x = torch.from_numpy(rng.integers(-127, 128, (3, c, h, w))
                                 .astype(np.int8)).to(cuda)
            wt, s, bq, bf = _dw_both(rng, c, cuda)
            table = shard_table(_shards(c, hw, n, cut == "kernel", rng))
            assert len(table.rows) == n
            for bias, act, osc in ((bq, "relu6", 0.05), (bf, "relu", None)):
                before = dwconv3x3.launches
                got = dwconv_shards(x, table, wt, s, bias, activation=act,
                                    out_scale=osc)
                assert dwconv3x3.launches == before + -(-n // MAX_SHARDS)
                exp = dwconv_shards_ref(x, table.rows, wt, s, bias,
                                        activation=act, out_scale=osc)
                torch.cuda.synchronize()
                assert got.shape == (3, c * hw)
                _assert_dw(got, exp, osc is not None)


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


def test_session_over_72_workers_on_card_equals_cpu(cuda):
    """A neuron-mode split of the smoke model over 72 equal workers: each
    of its 5 depthwise layers has 72 non-empty shards (a kernel-mode split
    would give at most 48, the widest depthwise layer), so each takes two
    launches a forward, and the output is bit-exact with the CPU's."""
    from repro_torch.kernels.dwconv.dwconv import MAX_SHARDS
    model = mobilenet_v2_smoke()
    plan = T.split_model(model, np.ones(72), mode="neuron")
    dw = [i for i, layer in enumerate(model.layers) if layer.kind == "dwconv"]
    assert len(dw) == 5
    for i in dw:
        assert sum(sh.n_positions > 0 for sh in plan.splits[i].shards) == 72
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((4, *model.input_shape)).astype(np.float32)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    gpu = Session(plan, qmodel=cpu.qmodel, device=cuda, max_batch=4)
    gpu.warmup()
    before = dwconv3x3.launches
    got = gpu.submit_many(xs)
    assert dwconv3x3.launches - before == len(dw) * -(-72 // MAX_SHARDS)
    np.testing.assert_array_equal(got, cpu.submit_many(xs))


def test_float_threads_and_calibration_equal_single_thread(cuda):
    """Two threads each serve 10 float requests and calibrate an int8
    session at the same time.  The TF32 switch is process-wide, so this is
    right only while every float section holds ``_full_fp32``'s lock:
    outputs equal the single-thread runs within rtol 1e-6 (TF32 would be
    ~1e-3 off) and the calibrated scales are identical."""
    import threading
    model = mobilenet_v2_smoke()
    plan = T.split_model(model, RATINGS, mode="kernel")
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((10, *model.input_shape)).astype(np.float32)
    single = Session(plan, precision="float", device=cuda)
    want = [single.run(x) for x in xs]
    want_q = Session(plan, precision="int8", seed=0, device=cuda).qmodel
    barrier = threading.Barrier(2)
    results, errors = {}, []

    def client(k):
        try:
            sess = Session(plan, precision="float", device=cuda)
            barrier.wait(30)
            outs = []
            if k == 1:
                qm = Session(plan, precision="int8", seed=0,
                             device=cuda).qmodel
            for x in xs:
                outs.append(sess.run(x))
            if k == 0:
                qm = Session(plan, precision="int8", seed=0,
                             device=cuda).qmodel
            results[k] = (outs, qm)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and not any(t.is_alive() for t in threads)
    for outs, qm in results.values():
        for got, exp in zip(outs, want):
            np.testing.assert_allclose(got, exp, rtol=1e-6,
                                       atol=1e-6 * np.abs(exp).max())
        assert qm.input_scale == want_q.input_scale
        for a, b in zip(qm.layers, want_q.layers):
            assert (a.in_scale, a.out_scale) == (b.in_scale, b.out_scale)
            for x, y in ((a.w_scale, b.w_scale), (a.b_q, b.b_q)):
                np.testing.assert_array_equal(x, y)


def test_dispatch_wait_does_not_wait_for_the_next(cuda):
    """``InflightDispatch.wait`` waits for its own batch only: with ~200 ms
    of work enqueued on the stream between two dispatches, the first
    batch's wait returns well before it, and both are bit-exact."""
    model = mobilenet_v2_smoke()
    plan = T.split_model(model, RATINGS, mode="spatial")
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((8, *model.input_shape)).astype(np.float32)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    gpu = Session(plan, qmodel=cpu.qmodel, device=cuda, max_batch=4)
    gpu.warmup()
    # cycles of torch.cuda._sleep that take ~200 ms on this card
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles = int(10 ** 7 * 200.0 / start.elapsed_time(end))
    import time
    first = gpu.dispatch_async(xs[:4])
    torch.cuda._sleep(cycles)
    second = gpu.dispatch_async(xs[4:])
    t0 = time.perf_counter()
    got_first = first.wait()
    waited = time.perf_counter() - t0
    got_second = second.wait()
    assert waited < 0.05, waited
    assert gpu.dispatch_latency_s(bucket=4) < 0.1
    np.testing.assert_array_equal(got_first, cpu.submit_many(xs[:4]))
    np.testing.assert_array_equal(got_second, cpu.submit_many(xs[4:]))


def test_server_on_card(cuda):
    """Two int8 tenants (spatial and neuron splits) and a float one on one
    ``Server`` on the card, requests queued before the scheduler starts so
    they ride batches of several sizes: int8 byte-equal to ``Session.run``
    on the card, float within 1e-5 of it (cuDNN may pick another algorithm
    for another bucket)."""
    from repro_torch.serve import Server
    model = mobilenet_v2_smoke()
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((11, *model.input_shape)).astype(np.float32)
    plans = {"s": T.split_model(model, RATINGS, mode="spatial"),
             "n": T.split_model(model, RATINGS, mode="neuron"),
             "f": T.split_model(model, RATINGS, mode="kernel")}
    oracles = {name: Session(plan, precision="float" if name == "f" else
                             "int8", seed=0, device=cuda, max_batch=4)
               for name, plan in plans.items()}
    srv = Server()
    for name, plan in plans.items():
        srv.add_tenant(name, plan, precision=oracles[name].precision,
                       qmodel=oracles[name].qmodel, max_batch=4,
                       device=cuda)
    srv._running = True             # queue before the scheduler starts
    tickets = {name: [srv.submit(name, x) for x in xs] for name in plans}
    srv._running = False
    before = qgemm.launches, dwconv3x3.launches, dwconv3x3_bands.launches
    with srv:
        outs = {name: [t.result(timeout=120.0) for t in ts]
                for name, ts in tickets.items()}
    assert all(now > was for now, was in zip(
        (qgemm.launches, dwconv3x3.launches, dwconv3x3_bands.launches),
        before))
    for name, ys in outs.items():
        assert srv.session(name).stats().batches < len(xs)
        for x, y in zip(xs, ys):
            want = oracles[name].run(x)
            if name == "f":
                np.testing.assert_allclose(y, want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max())
            else:
                assert y.dtype == want.dtype
                assert y.tobytes() == want.tobytes()


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


# the LM families' decode shapes: (B, K, G, hd, S) of recurrentgemma-9b's
# MQA ring (K 1, G 16, hd 256), dbrx-132b (G 6), whisper-base's cross cache
# (hd 64 over 1500 frames, a ragged last tile) and self cache, deepseek-moe
# (K 16, G 1) and llava-next-mistral-7b (G 4)
FAMILY_DECODE_SHAPES = [(8, 1, 16, 256, 2048), (8, 8, 6, 128, 2057),
                        (8, 8, 1, 64, 1500), (8, 8, 1, 64, 457),
                        (8, 16, 1, 128, 2081), (8, 8, 4, 128, 2049)]


@pytest.mark.parametrize("dtypes", ["bf16", "f32"])
@pytest.mark.parametrize("b,k,g,hd,s", FAMILY_DECODE_SHAPES)
def test_decode_attn_family_shapes_vs_plain(cuda, b, k, g, hd, s, dtypes):
    """Ragged lengths (full, one slot, a few tiles) and, in bf16, peaked q
    as well."""
    q_dt, kv_dt = DECODE_DTYPES[dtypes]
    q, ck, cv, _ = _decode_inputs(np.random.default_rng(s + g), b, k, g, hd,
                                  s, cuda, q_dt, kv_dt)
    lens = torch.tensor([s, 1, 200, s - 1, 64, 65, s // 2, 1000][:b],
                        dtype=torch.int32, device=cuda).clamp(max=s)
    for scale in ((1.0, 8.0) if kv_dt == torch.bfloat16 else (1.0,)):
        qs = (q.float() * scale).to(q_dt)
        got = flash_decode(qs, ck, cv, lens)
        exp = flash_decode_ref(qs, ck, cv, lens)
        torch.cuda.synchronize()
        _assert_decode_close(got, exp, q_dt, kv_dt)


FAMILY_SMOKE = ["deepseek-moe-16b-smoke", "dbrx-132b-smoke",
                "recurrentgemma-9b-smoke", "xlstm-1.3b-smoke",
                "whisper-base-smoke", "llava-next-mistral-7b-smoke"]


def _family_inputs(cfg, b, s, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device=dev)}
    if cfg.family == "audio":
        out["frames"] = torch.randn((b, cfg.n_audio_frames, cfg.d_model),
                                    generator=gen, device=dev)
    if cfg.family == "vlm":
        out["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                     generator=gen, device=dev)
    return out


@pytest.mark.parametrize("arch", FAMILY_SMOKE)
def test_family_decode_step_no_sync_and_kernel_launches(cuda, arch):
    """Prefill, then decode steps (the hybrid's ring wrapping: a prompt of
    20 over its window of 16) on the card: no step makes a synchronising
    call, each launches ``decode_attn`` once per attention against a cache
    (two per whisper decoder layer, none for xlstm), and the logits equal
    the CPU's."""
    cfg = get_config(arch)
    params = lm.init_model(cfg, 0, device="cpu")
    ps = {"cpu": params, cuda: map_defs(lambda t: t.to(cuda), params)}
    inp = _family_inputs(cfg, 2, 20, cuda)
    max_seq = 32
    caches = {d: lm.init_cache(cfg, 2, max_seq, device=d) for d in ps}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    per_step = sum(ng * sum({"attn": 1, "moe": 1, "xattn": 2}.get(k, 0)
                            for k in pattern)
                   for pattern, ng in lm.pattern_stacks(cfg))
    try:
        out = {d: lm.forward(ps[d], {k: v.to(d) for k, v in inp.items()},
                             cfg, "prefill", caches[d])[0] for d in ps}
        torch.cuda.synchronize()
        for _ in range(3):
            tok = torch.argmax(out["cpu"], -1)[:, None]
            tok_card = tok.to(cuda)
            torch.cuda.synchronize()
            before = decode_attn.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                out[cuda] = lm.forward(ps[cuda], {"tokens": tok_card}, cfg,
                                       "decode", caches[cuda])[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert decode_attn.launches == before + per_step
            out["cpu"] = lm.forward(params, {"tokens": tok}, cfg, "decode",
                                    caches["cpu"])[0]
            torch.testing.assert_close(out[cuda].cpu(), out["cpu"],
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert caches[cuda]["pos"] == (cfg.n_patches if cfg.family == "vlm"
                                   else 0) + 23


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_SMOKE = ["qwen3-14b-smoke"] + FAMILY_SMOKE


def _train_batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", TRAIN_SMOKE)
def test_train_grads_and_step_on_card_equal_cpu(cuda, arch):
    """float32 with TF32 off: the card's loss equals the CPU's at 1e-5, and
    every gradient at rtol 1e-5 and an atol of 1e-5 x the leaf's largest
    gradient where that exceeds 1 (an embedding row sums every position's
    contribution, and the card sums in another order); a donated step's
    loss and grad norm at 1e-5; its params at 1e-5 where |g| > 1e-4 (else
    within 2 x lr: Adam's first step flips g / (|g| + eps) where |g| is
    near eps)."""
    from repro_torch.core.executor import _full_fp32
    from repro_torch.nn.layers import leaves
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import (TrainOptions, loss_and_grads,
                                           make_train_step, to_device)
    cfg = get_config(arch)
    params = lm.init_model(cfg, 0, device="cpu")
    batch = _train_batch(cfg, 2, 12)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    with _full_fp32():
        for d in ("cpu", cuda):
            p = map_defs(lambda t: t.to(d, copy=True), params)
            loss, grads = loss_and_grads(p, to_device(batch, d), cfg)
            new, _, m = make_train_step(cfg, ocfg, TrainOptions(), device=d)(
                p, init_opt_state(p), batch)
            assert all(t is u for t, u in zip(leaves(new), leaves(p)))
            out[d] = loss, grads, new, m
    (loss_c, g_c, p_c, m_c), (loss_d, g_d, p_d, m_d) = out["cpu"], out[cuda]
    torch.testing.assert_close(loss_d.cpu(), loss_c, rtol=1e-5, atol=1e-5)
    for g, e in zip(leaves(g_d), leaves(g_c)):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), e, rtol=1e-5, atol=1e-5 * max(
            1.0, float(e.abs().max())))
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m_d[k].cpu(), m_c[k], rtol=1e-5,
                                   atol=1e-5)
    for p, q, g in zip(leaves(p_d), leaves(p_c), leaves(g_c)):
        err = (p.cpu() - q).abs()
        big = g.abs() > 1e-4
        if big.any():
            assert float(err[big].max()) <= 1e-5
        assert float(err.max()) <= 2 * float(m_c["lr"])


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_remat_and_chunked_attention_on_card(cuda, policy):
    """Chunked attention under autograd with each remat policy gives the
    gradients of the unchunked forward without remat (float32, TF32 off),
    and two microbatches give those of one batch."""
    import dataclasses

    from repro_torch.core.executor import _full_fp32
    from repro_torch.nn.layers import leaves
    from repro_torch.train.trainer import loss_and_grads, to_device
    cfg = get_config("qwen3-14b-smoke")
    params = lm.init_model(cfg, 0, device=cuda)
    batch = to_device(_train_batch(cfg, 4, 16), cuda)
    with _full_fp32():
        _, ref = loss_and_grads(params, batch, dataclasses.replace(
            cfg, remat=False, attn_chunk=0))
        c = dataclasses.replace(cfg, remat=policy is not None,
                                remat_policy=policy or "full", attn_chunk=4)
        for micro in (1, 2):
            _, grads = loss_and_grads(params, batch, c, microbatches=micro)
            for g, e in zip(leaves(grads), leaves(ref)):
                torch.testing.assert_close(g.float(), e, rtol=1e-5,
                                           atol=1e-5)


def test_train_loop_on_card_learns_and_resumes(cuda, tmp_path):
    """The reference's system tests on the card: the loss falls, and a run
    killed at step 6 and resumed to 10 ends where an uninterrupted one
    does; the restored state lies on the card."""
    from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch.train import train_loop
    from repro_torch.nn.layers import leaves
    cfg = get_config("qwen3-14b-smoke")
    _, _, losses = train_loop(cfg, steps=40, batch=16, seq=32, ckpt_dir=None,
                              lr=3e-3, log_every=100)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    train_loop(cfg, steps=6, batch=4, seq=16, ckpt_dir=d1, ckpt_every=3,
               log_every=100, schedule_steps=10)
    params, state, resumed = train_loop(cfg, steps=10, batch=4, seq=16,
                                        ckpt_dir=d1, ckpt_every=100,
                                        log_every=100)
    _, _, full = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=d2,
                            ckpt_every=100, log_every=100)
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-4)
    assert latest_step(d1) == 10
    back = restore_checkpoint(d1, 10, {"params": params, "opt": state})
    assert all(t.device.type == "cuda" for t in leaves(back))


def test_bf16_checkpoint_on_card_bit_exact(cuda, tmp_path):
    import dataclasses

    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.nn.layers import leaves
    from repro_torch.train.trainer import init_train_state
    cfg = dataclasses.replace(get_config("qwen3-14b-smoke"),
                              dtype="bfloat16")
    params, state = init_train_state(cfg, 0)
    tree = {"params": params, "opt": state}
    save_checkpoint(str(tmp_path), 1, tree, blocking=False).join(timeout=60)
    back = restore_checkpoint(str(tmp_path), 1, tree)
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and b.device == a.device
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_lm_serving_on_card_records_no_graph(cuda):
    """Prefill and decode on the card keep no autograd graph even with
    params that require grad; the train forward records one."""
    cfg = get_config("qwen3-14b-smoke")
    params = map_defs(lambda t: t.requires_grad_(True),
                      lm.init_model(cfg, 0, device=cuda))
    cache = lm.init_cache(cfg, 2, 16, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    logits, cache = lm.forward(params, {"tokens": tokens}, cfg, "prefill",
                               cache)
    assert not logits.requires_grad
    logits, _ = lm.forward(params, {"tokens": tokens[:, :1]}, cfg, "decode",
                           cache)
    assert not logits.requires_grad and logits.grad_fn is None
    assert lm.forward(params, {"tokens": tokens}, cfg).requires_grad


# -- the mesh (NCCL) and decode_attn's log-sum-exp output ----------------------

@pytest.mark.parametrize("dtypes", ["bf16", "f32"])
@pytest.mark.parametrize("b,k,g,hd,s", [(8, 8, 5, 128, 2081),
                                        (8, 16, 1, 128, 2081),
                                        (8, 2, 2, 16, 24),
                                        (8, 1, 16, 256, 2048),
                                        (8, 8, 1, 64, 457),
                                        (8, 8, 4, 128, 2057)])
def test_decode_attn_lse_vs_plain(cuda, b, k, g, hd, s, dtypes):
    """``return_lse``: float32 output and log-sum-exp against the plain
    version at the LM shapes the mesh phase launches (qwen3-14b,
    deepseek-moe-16b, the -smoke configs' slices; recurrentgemma-9b's ring
    (K1 G16 hd256, 2048 slots), whisper-base's self cache (hd64) and
    llava's), rows of length 0 included (output 0, lse -inf)."""
    q_dt, kv_dt = DECODE_DTYPES[dtypes]
    q, ck, cv, _ = _decode_inputs(np.random.default_rng(s + g), b, k, g, hd,
                                  s, cuda, q_dt, kv_dt)
    lens = torch.from_numpy(np.random.default_rng(3).integers(
        0, s + 1, b).astype(np.int32)).to(cuda)
    lens[0], lens[1] = 0, s
    before = decode_attn.launches
    out, lse = flash_decode(q, ck, cv, lens, return_lse=True)
    assert decode_attn.launches == before + 1
    e_out, e_lse = flash_decode_ref(q, ck, cv, lens, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (b, 1, k, g)
    _assert_decode_close(out, e_out, q_dt, kv_dt)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())
    fin = torch.isfinite(e_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], e_lse[fin], rtol=1e-5, atol=1e-4)


@pytest.fixture
def nccl_world1(cuda):
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "deepseek-moe-16b-smoke"])
def test_mesh_world1_nccl_equals_single_device(nccl_world1, arch):
    """A world-1 NCCL mesh (1,1,1) on the card, float32 with TF32 off: two
    train steps and prefill + 3 decode steps equal the single-device steps
    on the card (the decode through the lse output and its merge)."""
    import torch_mesh_ranks as ranks
    from repro_torch.core.executor import _full_fp32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.layers import leaves
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = get_config(arch)
    init = lm.init_model(cfg, 0, device="cuda")
    with _full_fp32():
        single = ranks._train(cfg, init, 2, device="cuda")
        got = ranks._train(cfg, init, 2, mesh=mesh)
        prompt, dec = ranks.serve_inputs(cfg)
        before = decode_attn.launches
        logits, slots = ranks._serve(cfg, init, prompt, dec, mesh=mesh)
        launched = decode_attn.launches - before
        want, _ = ranks._serve(cfg, init, prompt, dec, device="cuda")
    np.testing.assert_allclose(got[0], single[0], rtol=1e-5)
    for a, b in zip(leaves(ranks._full(got[1])), leaves(single[1])):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)
    assert slots == ranks.SERVE_MAX
    assert launched == ranks.SERVE_N * cfg.n_layers


MESH_FAMILY_SMOKE = ["recurrentgemma-9b-smoke", "xlstm-1.3b-smoke",
                     "whisper-base-smoke", "llava-next-mistral-7b-smoke"]


@pytest.mark.parametrize("arch", MESH_FAMILY_SMOKE)
def test_mesh_family_world1_nccl_equals_single_device(nccl_world1, arch):
    """The hybrid, ssm, audio and vlm families on a world-1 NCCL mesh
    (1,1,1), float32 with TF32 off: two train steps and prefill + 3 decode
    steps equal the single-device steps on the card; decode_attn launches
    once for each attention cache a step (self through the lse output, and
    whisper's cross cache); the hybrid's decode past the wrap of its ring
    (prompt 8, 12 steps) equals one device's at every step."""
    import torch_mesh_ranks as ranks
    from repro_torch.core.executor import _full_fp32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.layers import leaves
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = get_config(arch)
    per_step = sum(ng * {"attn": 1, "xattn": 2}.get(kind, 0)
                   for pattern, ng in lm.pattern_stacks(cfg)
                   for kind in pattern)
    init = lm.init_model(cfg, 0, device="cuda")
    cases = [(ranks.SERVE_S, ranks.SERVE_N)]
    if arch == ranks.RING_ARCH:
        cases.append((ranks.RING_PROMPT, ranks.RING_STEPS))
    with _full_fp32():
        single = ranks._train(cfg, init, 2, device="cuda")
        got = ranks._train(cfg, init, 2, mesh=mesh)
        for s, n in cases:
            prompt, dec = ranks.serve_inputs(cfg, s, n)
            before = decode_attn.launches
            logits, _ = ranks._serve(cfg, init, prompt, dec, mesh=mesh)
            assert decode_attn.launches - before == n * per_step
            want, _ = ranks._serve(cfg, init, prompt, dec, device="cuda")
            torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], single[0], rtol=1e-5)
    for a, b in zip(leaves(ranks._full(got[1])), leaves(single[1])):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_mesh_multi_card(cuda, tmp_path):
    """One NCCL rank a card, mesh (cards // 2, 2): train and serve steps
    against one card's; skips below 2 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more CUDA devices")
    import torch_mesh_ranks as ranks
    from repro_torch.nn.layers import leaves
    out = ranks.spawn(ranks.card_check, n, tmp_path, timeout=600,
                      backend="nccl")
    # Adam moves an element by at most ~lr a step, whatever its gradient's
    # last bits: the params' bound after 2 steps (the losses hold at 1e-5)
    bound = 2 * ranks._ocfg().lr * 2
    for arch in ranks.ARCHS:
        r = out[arch]
        np.testing.assert_allclose(r["losses"], r["single"], rtol=1e-5)
        for a, b in zip(leaves(r["params"]), leaves(r["single_params"])):
            torch.testing.assert_close(a, b, rtol=0, atol=bound)
        torch.testing.assert_close(r["logits"], r["single_logits"], rtol=0,
                                   atol=1e-5)
