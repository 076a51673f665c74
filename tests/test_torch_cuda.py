"""The port's CUDA kernels and engine on the card (``-m cuda``).

Every test here needs an NVIDIA GPU and skips without one; on a card run
them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The file
imports nothing of JAX, so it runs where only torch is installed.  Each CUDA
kernel is held against its plain torch version on the same card tensors
(int8 output bit-exact), every kernel call of a forward of each benchmark
plan against the same wrapper on CPU copies of its arguments (recorded by
``tests/torch_launches.py``), and the engine's int8 output on the card
against the CPU's, bit for bit.  The flash-decode kernel is held against
its plain version at 1e-5 in float32 and, with a bf16 operand, at rtol
2e-2 and an atol of 2e-2 x the plain output's largest magnitude: its
outputs average v over hundreds of slots and are small, so a fixed atol as
large as them would pass a wrong answer.  The LM's decode on the card,
which attends through it, is held against the CPU's.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.api import Session
from repro_torch.configs import get_config
from repro_torch.kernels.bands import band_take, band_windows
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
from torch_launches import census, layout, on_cpu, source

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
    fn_k = backend.library("dwconv").dwconv_smem_bytes_k
    for c_tile, slab in ((1, 16), (7, 640), (32, 3152), (128, 48)):
        assert fn(c_tile, slab) == smem_bytes(c_tile, slab)
        for k in (3, 5):
            assert fn_k(c_tile, slab, k) == smem_bytes(c_tile, slab, k)


@pytest.mark.parametrize("mode", ["kernel", "neuron", "spatial"])
def test_forward_one_depthwise_launch_per_layer(cuda, mode):
    """A forward makes one depthwise launch per depthwise layer: on the
    flat plans one ``dwconv3x3`` launch over all shards, on the spatial
    plan one ``dwconv3x3_bands`` launch over all bands.  The first batch
    walks the plan twice (once eagerly, once into the graph), and a replay
    runs one depthwise kernel a layer."""
    model = mobilenet_v2_smoke()
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((4, *model.input_shape)).astype(np.float32)
    plan = T.split_model(model, [1.0, 2.7, 0.35, 1.6, 0.5, 1.15], mode=mode)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=4)
    eng = T.CompiledSplitExecutor(plan, cpu.qmodel, device=cuda)
    before = dwconv3x3.launches, dwconv3x3_bands.launches
    eng.run_batch(xs, mode="int8")
    n_dw = sum(layer.kind == "dwconv" for layer in model.layers)
    flat = mode != "spatial"
    assert (dwconv3x3.launches - before[0],
            dwconv3x3_bands.launches - before[1]) == (
                (2 * n_dw, 0) if flat else (0, 2 * n_dw))
    got, kernels = _traced_kernels(lambda: eng.run_batch(xs, mode="int8"))
    assert kernels[1] == n_dw
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
    got, kernels = _traced_kernels(lambda: gpu.submit_many(xs))
    assert kernels[1] == len(dw) * -(-72 // MAX_SHARDS)
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
    before = _launch_counts()

    def serve():
        with srv:
            return {name: [t.result(timeout=120.0) for t in ts]
                    for name, ts in tickets.items()}
    # the tenants captured their buckets' graphs when added: every
    # dispatch replays, which no wrapper counts and the trace shows
    outs, kernels = _traced_kernels(serve)
    assert _launch_counts() == before and all(n > 0 for n in kernels)
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
    bit-identical to the CPU's plain versions (and not all zeros); no call
    copies a GEMM weight into the kernel's layout (``weight_copies``)."""
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
    before, copies = qgemm.launches, qgemm.weight_copies
    gpu = Session(plan, qmodel=cpu.qmodel, device=cuda, max_batch=4)
    got = gpu.submit_many(xs)
    np.testing.assert_array_equal(got, cpu.submit_many(xs))
    assert got.any()
    assert qgemm.launches > before
    # every GEMM weight was uploaded in the kernel's layout: none copied
    assert qgemm.weight_copies == copies


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


# torch kernels (none of this repository's) that open and close a trace
# that counts this repository's kernels: traces on the card have dropped
# kernels (one of a replay's 16 ``band_windows_kernel``s in one run)
PAD_KERNELS = 64


def _card_kernel_names(fn):
    """``fn()`` and the names of the kernels that a profiler trace of it
    shows on the card, the trace opened and closed by PAD_KERNELS torch
    kernels."""
    from torch.autograd import DeviceType
    pad = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        for _ in range(PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]


def _traced_kernels(fn):
    """``fn()`` and the ``qgemm`` and ``dwconv3x3`` kernels (both depthwise
    wrappers launch the latter) a profiler trace of it shows on the card:
    a replayed CUDA graph calls no wrapper, so its launches show there."""
    out, names = _card_kernel_names(fn)
    return out, (sum("qgemm_kernel" in n for n in names),
                 sum("dwconv3x3_kernel" in n for n in names))


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


def _graph_engine(mode, dev, qmodel=True):
    """An engine of the smoke model's ``mode`` plan on ``dev`` (int8 with
    ``qmodel``, else float only) and seeded float batches for it."""
    model, plan, qm = _smoke_plan_and_qmodel(mode)
    eng = T.CompiledSplitExecutor(plan, qm if qmodel else None, device=dev)
    rng = np.random.default_rng(7)

    def batch(n):
        return rng.standard_normal((n, *model.input_shape)).astype(np.float32)
    return eng, batch


def _walk(eng, xs, mode):
    """The plan walked launch by launch on the card, as before graphs."""
    from repro_torch.core.executor import _full_fp32
    x = torch.from_numpy(xs).to(eng.device)
    if mode == "float":
        with _full_fp32():
            return eng._forward(x, mode).cpu().numpy()
    return eng._forward(x, mode).cpu().numpy()


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("mode", ["spatial", "kernel"])
def test_graph_replay_equals_eager_walk_int8(cuda, mode, batch):
    """Replays of the captured forward give the eager walk's int8 answers
    bit for bit, on both plans at batch 8 and 32, and the CPU's."""
    eng, make = _graph_engine(mode, cuda)
    xs = [make(batch) for _ in range(3)]
    got = [eng.run_batch(x, mode="int8") for x in xs]
    assert eng.graph_stats() == dict(captures=1, replays=3, eager=1)
    cpu = T.CompiledSplitExecutor(eng.plan, eng.qmodel, device="cpu")
    for x, y in zip(xs, got):
        np.testing.assert_array_equal(y, _walk(eng, x, "int8"))
        np.testing.assert_array_equal(y, cpu.run_batch(x, mode="int8"))


@pytest.mark.parametrize("mode", ["spatial", "kernel"])
def test_graph_replay_float_matches_eager_walk(cuda, mode):
    """Float mode captures and replays in full float32: within 1e-5 of the
    eager walk (cuDNN may pick another algorithm in the capture)."""
    eng, make = _graph_engine(mode, cuda, qmodel=False)
    for x in (make(8), make(8)):
        got = eng.run_batch(x, mode="float")
        want = _walk(eng, x, "float")
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert eng.graph_stats() == dict(captures=1, replays=2, eager=1)


def test_graph_dispatches_in_flight_keep_their_answers(cuda):
    """Two dispatches in flight with different inputs each return their
    own answers, and an output already returned is not changed by the
    dispatches after it (they share the graph's static buffers)."""
    eng, make = _graph_engine("spatial", cuda)
    xs = [make(8) for _ in range(5)]
    want = [_walk(eng, x, "int8") for x in xs]
    eng.run_batch(xs[0], mode="int8")             # captures
    first = eng.run_batch_async(xs[0], mode="int8")
    second = eng.run_batch_async(xs[1], mode="int8")
    np.testing.assert_array_equal(second.cpu().numpy(), want[1])
    later = [eng.run_batch_async(x, mode="int8") for x in xs[2:]]
    torch.cuda.synchronize()
    np.testing.assert_array_equal(first.cpu().numpy(), want[0])
    for y, w in zip(later, want[2:]):
        np.testing.assert_array_equal(y.cpu().numpy(), w)
    sess = Session(eng.plan, qmodel=eng.qmodel, device=cuda, max_batch=8)
    disps = [sess.dispatch_async(x) for x in xs[:2]]
    for d, w in zip(disps, want):
        np.testing.assert_array_equal(d.wait(), w)


def test_graph_threads_share_an_engine(cuda):
    """Twelve threads dispatch their own batches through one engine at
    once, with a short switch interval: the graph's static input is
    shared, so each copy, replay and output copy must be enqueued whole,
    and every thread gets its own answers."""
    import sys
    import threading
    eng, make = _graph_engine("spatial", cuda)
    xs = [make(4) for _ in range(12)]
    want = [_walk(eng, x, "int8") for x in xs]
    eng.run_batch(xs[0], mode="int8")             # captures
    got, errors = {}, []

    def client(k):
        try:
            got[k] = [eng.run_batch(xs[k], mode="int8") for _ in range(5)]
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for k, w in enumerate(want):
        for y in got[k]:
            np.testing.assert_array_equal(y, w)
    assert eng.graph_stats() == dict(captures=1, replays=61, eager=1)


def test_graph_per_batch_size_and_its_stats(cuda):
    """``graph_stats`` counts one capture at a key, then replays; a new
    batch size captures a graph of its own, and each key keeps its own."""
    eng, make = _graph_engine("kernel", cuda)
    eng.run_batch(make(4), mode="int8")
    assert eng.graph_stats() == dict(captures=1, replays=1, eager=1)
    for _ in range(3):
        eng.run_batch(make(4), mode="int8")
    assert eng.graph_stats() == dict(captures=1, replays=4, eager=1)
    x2 = make(2)
    y2 = eng.run_batch(x2, mode="int8")
    assert eng.graph_stats() == dict(captures=2, replays=5, eager=2)
    assert set(eng._graphs) == {("int8", (4, *eng.plan.model.input_shape)),
                                ("int8", (2, *eng.plan.model.input_shape))}
    eng.run_batch(make(4), mode="int8")
    np.testing.assert_array_equal(eng.run_batch(x2, mode="int8"), y2)
    assert eng.graph_stats() == dict(captures=2, replays=7, eager=2)


@pytest.mark.parametrize("mode", ["spatial", "kernel"])
def test_graph_replay_calls_no_wrapper(cuda, mode):
    """The first dispatch at a key walks the plan twice through the
    wrappers (eagerly, then into the capture); a replay calls no wrapper,
    so their ``.launches`` stay, and runs the walk's kernels."""
    eng, make = _graph_engine(mode, cuda)
    x = make(8)
    before = _launch_counts()
    eng.run_batch(x, mode="int8")                 # walk, capture, replay
    first = tuple(a - b for a, b in zip(_launch_counts(), before))
    before = _launch_counts()
    _walk(eng, x, "int8")
    walk = tuple(a - b for a, b in zip(_launch_counts(), before))
    before = _launch_counts()
    _, kernels = _traced_kernels(lambda: eng.run_batch(x, mode="int8"))
    assert walk[0] > 0 and sum(walk[1:]) > 0
    assert first == tuple(2 * n for n in walk)
    assert _launch_counts() == before
    assert kernels == (walk[0], sum(walk[1:]))


def test_graph_kernels_reach_the_profiler(cuda):
    """The kernels of a replay appear one by one in a ``torch.profiler``
    trace, also where the profiler first runs after the capture (as the
    benchmark's tracer warms it): two replays show twice the ``qgemm`` and
    ``dwconv`` kernels that the eager walk launches."""
    eng, make = _graph_engine("spatial", cuda)
    x = make(8)
    eng.run_batch(x, mode="int8")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.cuda.synchronize()
    before = _launch_counts()
    _walk(eng, x, "int8")
    walk = tuple(a - b for a, b in zip(_launch_counts(), before))
    _, kernels = _traced_kernels(
        lambda: [eng.run_batch(x, mode="int8") for _ in range(2)])
    assert kernels == (2 * walk[0], 2 * sum(walk[1:]))


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


# -- EfficientNet: swish and sigmoid epilogues, 5x5 depthwise, the
# squeeze-and-excitation kernels, the engine --------------------------------

EXP_ACTS = ("swish", "sigmoid")
# the plain versions form sigmoid with torch.exp, the kernels with expf;
# torch's exp may differ from expf in the last bit, which moves a
# requantized code by one where it sits at a rounding tie: at most one code,
# on at most this share of the codes.  On the H100 the kernels matched their
# plain versions at every shape here (0 codes off); the same epilogues in
# float16 put 0.04-0.17% of the codes one off, in bfloat16 0.2-0.8%, so a
# kernel that computed them below float32 fails.
EXP_CODE_SHARE = 1e-4
# the whole network on the card against the CPU (torch's CPU exp against
# expf, a one-code difference carried through the later layers)
NET_CODE_SHARE = 1e-3


def _assert_exp_codes(got, exp, limit=EXP_CODE_SHARE):
    """int8 codes within one code, on at most ``limit`` of them."""
    d = (got.to(torch.int32) - exp.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= limit


def test_sigmoid_formula_matches_torch_sigmoid(cuda):
    """The epilogue's ``1 / (1 + exp(-y))`` is torch's sigmoid within two
    float32 ulps, and swish is y times it."""
    from repro_torch.core.fusion import apply_activation
    y = torch.linspace(-30, 30, 100_001, device=cuda)
    torch.testing.assert_close(apply_activation(y, "sigmoid"),
                               torch.sigmoid(y), rtol=2.5e-7, atol=1e-30)
    torch.testing.assert_close(apply_activation(y, "swish"),
                               y * torch.sigmoid(y), rtol=5e-7, atol=1e-30)


@pytest.mark.parametrize("m,k,n", [(32, 96, 4), (32, 4, 96), (37, 27, 32),
                                   (300, 200, 129), (32, 1152, 48)])
def test_qgemm_swish_sigmoid_vs_plain(cuda, m, k, n):
    """qgemm's swish and sigmoid epilogues against the plain version on the
    card: int8 within one code on a stated share, float32 within one
    rounding."""
    for int_bias in (True, False):
        args = _gemm_inputs(np.random.default_rng(m + n), m, k, n, int_bias,
                            cuda)
        # spread the epilogue's real values over sigmoid's curved range
        args[2] = args[2] * 400
        for act in EXP_ACTS:
            for osc in (None, 0.01 if act == "sigmoid" else 0.05):
                got = qgemm(*args, activation=act, out_scale=osc)
                exp = qgemm_ref(*args, activation=act, out_scale=osc)
                torch.cuda.synchronize()
                if osc is None:
                    torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-7)
                else:
                    _assert_exp_codes(got, exp)


def _dw_inputs_k(rng, c, k, dev, gain=1.0):
    w = rng.integers(-127, 128, (c, k, k)).astype(np.int8)
    s = (gain * rng.uniform(0.5, 1.5, c) / (127 * 127 * k)).astype(np.float32)
    bq = rng.integers(-3000, 3000, c).astype(np.int32)
    bf = rng.uniform(-1, 1, c).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (w, s, bq, bf)]


# (batch, C, H, W, stride): EfficientNet-B0's flat 5x5 layers at 224 (b3,
# b6, b11 at batch 2) and misaligned ones
FLAT_SHAPES_5 = [(2, 144, 56, 56, 2), (2, 480, 14, 14, 1),
                 (2, 1152, 7, 7, 1), (3, 7, 9, 3, 1), (2, 13, 6, 6, 2),
                 (5, 11, 14, 14, 2), (2, 19, 29, 29, 1), (4, 33, 2, 2, 1),
                 (2, 3, 1, 7, 2), (1, 5, 58, 58, 2)]
# (windows, C, R, W, stride): band stacks of the spatial plan (b3, b11 at 8
# bands) and misaligned ones
BAND_SHAPES_5 = [(16, 144, 11, 56, 2), (16, 1152, 5, 7, 1),
                 (7, 19, 9, 14, 1), (5, 13, 7, 29, 2), (3, 9, 5, 3, 1),
                 (6, 7, 6, 6, 2), (2, 5, 5, 58, 1)]


@pytest.mark.parametrize("cut", ["one", "kernel", "neuron"])
@pytest.mark.parametrize("b,c,h,w,stride", FLAT_SHAPES_5)
def test_dwconv5x5_shards_vs_plain(cuda, b, c, h, w, stride, cut):
    """The 5x5 kernel over a flat layer's shards in one launch, pad 2: int8
    bit-exact with the plain loop for the clamps, within one code on a
    stated share for swish; float32 within one rounding."""
    from repro_torch.kernels.dwconv.dwconv import dwconv5x5_shards
    rng = np.random.default_rng(c * h + w + stride)
    x = torch.from_numpy(rng.integers(-127, 128, (b, c, h, w))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, bf = _dw_inputs_k(rng, c, 5, cuda)
    hw = ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    n = {"one": 1, "kernel": 8, "neuron": 8}[cut]
    table = shard_table(_shards(c, hw, n, cut == "kernel", rng))
    for bias, act, osc in ((bq, "relu6", 0.05), (bf, "relu", None),
                           (bq, None, None), (bq, "swish", 0.02),
                           (bf, "swish", None)):
        before = dwconv5x5_shards.launches, dwconv3x3.launches
        got = dwconv_shards(x, table, wt, s, bias, stride=stride,
                            activation=act, out_scale=osc)
        assert (dwconv5x5_shards.launches, dwconv3x3.launches) == (
            before[0] + 1, before[1])
        exp = dwconv_shards_ref(x, table.rows, wt, s, bias, stride=stride,
                                activation=act, out_scale=osc)
        torch.cuda.synchronize()
        assert got.shape == (b, c * hw)
        if act == "swish" and osc is not None:
            _assert_exp_codes(got, exp)
        else:
            _assert_dw(got, exp, osc is not None or bias is bq)


@pytest.mark.parametrize("nb,c,rows,w,stride", BAND_SHAPES_5)
def test_dwconv5x5_bands_unpadded_vs_plain(cuda, nb, c, rows, w, stride):
    """The 5x5 kernel over band windows whose width it pads by 2."""
    from repro_torch.kernels.dwconv.dwconv import dwconv5x5_bands_unpadded
    rng = np.random.default_rng(nb * c + w)
    x = torch.from_numpy(rng.integers(-127, 128, (nb, c, rows, w))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, bf = _dw_inputs_k(rng, c, 5, cuda)
    xp = torch.nn.functional.pad(x, (2, 2))
    for bias, act, osc in ((bq, "relu6", 0.05), (bf, "relu", None),
                           (bq, "swish", 0.02)):
        before = dwconv5x5_bands_unpadded.launches
        got = dwconv_bands_unpadded(x, wt, s, bias, stride=stride,
                                    activation=act, out_scale=osc)
        assert dwconv5x5_bands_unpadded.launches == before + 1
        exp = dwconv3x3_ref(xp, wt, s, bias, stride=stride, activation=act,
                            out_scale=osc)
        torch.cuda.synchronize()
        if act == "swish":
            _assert_exp_codes(got, exp)
        else:
            _assert_dw(got, exp, osc is not None)


@pytest.mark.parametrize("act", EXP_ACTS)
@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv3x3_swish_sigmoid_vs_plain(cuda, stride, act):
    """The 3x3 kernel's swish and sigmoid epilogues, band and flat forms."""
    rng = np.random.default_rng(stride)
    x = torch.from_numpy(rng.integers(-127, 128, (16, 96, 9, 56))
                         .astype(np.int8)).to(cuda)
    wt, s, bq, bf = _dw_inputs_k(rng, 96, 3, cuda, gain=300)
    osc = 0.01 if act == "sigmoid" else 0.05
    got = dwconv_bands_unpadded(x, wt, s, bq, stride=stride, activation=act,
                                out_scale=osc)
    exp = dwconv3x3_ref(torch.nn.functional.pad(x, (1, 1)), wt, s, bq,
                        stride=stride, activation=act, out_scale=osc)
    _assert_exp_codes(got, exp)
    hw = ((9 - 1) // stride + 1) * ((56 - 1) // stride + 1)
    table = shard_table(_shards(96, hw, 8, False, rng))
    for bias, o in ((bq, osc), (bf, None)):
        got = dwconv_shards(x, table, wt, s, bias, stride=stride,
                            activation=act, out_scale=o)
        exp = dwconv_shards_ref(x, table.rows, wt, s, bias, stride=stride,
                                activation=act, out_scale=o)
        if o is None:
            torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-7)
        else:
            _assert_exp_codes(got, exp)


# (samples, bands, C, R, W): EfficientNet-B0's band stacks at 224 (b0, b4,
# b15 over 8 bands, one band each = a flat layer) and misaligned planes
SE_SHAPES = [(4, 8, 32, 15, 112), (4, 8, 240, 4, 28), (32, 8, 1152, 1, 7),
             (3, 1, 96, 56, 56), (2, 1, 1152, 7, 7), (5, 3, 7, 5, 3),
             (1, 8, 13, 2, 9), (2, 5, 2049, 3, 5), (7, 2, 3, 1, 1)]


@pytest.mark.parametrize("bsz,bands,c,r,w", SE_SHAPES)
def test_se_pool_vs_plain(cuda, bsz, bands, c, r, w):
    """The pool over every band's own rows: bit-exact with the plain sum,
    for bands that own all, some or none of their rows."""
    from repro_torch.kernels.se import se_pool
    from repro_torch.kernels.se.ref import se_pool_ref
    rng = np.random.default_rng(bsz * c + r)
    x = torch.from_numpy(rng.integers(-127, 128, (bsz * bands, c, r, w))
                         .astype(np.int8)).to(cuda)
    for rows in ((r,) * bands, tuple(int(v) for v in
                                     rng.integers(0, r + 1, bands))):
        before = se_pool.launches
        got = se_pool(x, rows, 0.01)
        assert se_pool.launches == before + 1
        assert torch.equal(got, se_pool_ref(x, rows, 0.01))
    # a stack that starts off a 16-byte boundary
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    off = buf[3:3 + x.numel()].view(x.shape)
    off.copy_(x)
    assert torch.equal(se_pool(off, (r,) * bands, 0.01),
                       se_pool_ref(x, (r,) * bands, 0.01))


@pytest.mark.parametrize("bsz,bands,c,r,w", SE_SHAPES)
def test_se_gate_vs_plain(cuda, bsz, bands, c, r, w):
    """The gate multiply: exact int32 product, one float32 multiply,
    bit-exact with the plain version."""
    from repro_torch.kernels.se import se_gate
    from repro_torch.kernels.se.ref import se_gate_ref
    rng = np.random.default_rng(bsz + bands * c + w)
    x = torch.from_numpy(rng.integers(-127, 128, (bsz * bands, c, r, w))
                         .astype(np.int8)).to(cuda)
    g = torch.from_numpy(rng.integers(0, 128, (bsz, c)).astype(np.int8)).to(
        cuda)
    for factor in (1.0 / 127, 0.013):
        before = se_gate.launches
        got = se_gate(x, g, factor)
        assert se_gate.launches == before + 1
        assert torch.equal(got, se_gate_ref(x, g, factor))


def _effnet_sessions(mode, cuda, batch=8):
    from repro_torch.models import efficientnet_b0_smoke
    model = efficientnet_b0_smoke()
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((batch, *model.input_shape)).astype(np.float32)
    plan = T.split_model(model, RATINGS, mode=mode)
    cpu = Session(plan, calibration=calib, device="cpu", max_batch=batch)
    return model, plan, cpu, xs


def test_effnet_modes_on_card_agree_and_replay(cuda):
    """EfficientNet's int8 answers on the card: the spatial, kernel and
    neuron plans and the unsplit int8 reference (plain torch on the card)
    agree bit for bit, every dispatch replays its graph, no GEMM weight is
    copied into the kernel's layout, and the card is within one code of the
    CPU on a stated share (the CPU's exp against the card's expf)."""
    answers, copies = {}, qgemm.weight_copies
    for mode in ("spatial", "kernel", "neuron"):
        model, plan, cpu, xs = _effnet_sessions(mode, cuda)
        gpu = Session(plan, qmodel=cpu.qmodel, device=cuda, max_batch=8)
        for _ in range(3):
            answers[mode] = gpu.submit_many(xs)
        # the first dispatch captures the graph and replays it, the others
        # replay it
        assert gpu.engine.graph_stats() == dict(captures=1, replays=3,
                                                eager=1)
        _assert_exp_codes(torch.from_numpy(answers[mode]),
                          torch.from_numpy(cpu.submit_many(xs)),
                          NET_CODE_SHARE)
    assert qgemm.weight_copies == copies
    np.testing.assert_array_equal(answers["spatial"], answers["kernel"])
    np.testing.assert_array_equal(answers["spatial"], answers["neuron"])
    ref = np.stack([T.reference_forward(model, x, device=cuda,
                                        qmodel=cpu.qmodel).reshape(-1)
                    for x in xs])
    np.testing.assert_array_equal(answers["spatial"].reshape(len(xs), -1),
                                  ref)


@pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron"])
def test_effnet_graph_replays_the_new_kernels(cuda, mode):
    """A replay of EfficientNet's captured forward runs the 5x5 and the
    squeeze-and-excitation kernels (their names in the profiler's trace),
    one ``se_pool`` a global pool (each block's and the head's), one
    ``se_gate`` a block, one 5x5 launch a 5x5 layer, and gives the eager
    walk's answers."""
    model, plan, cpu, xs = _effnet_sessions(mode, cuda)
    eng = T.CompiledSplitExecutor(plan, cpu.qmodel, device=cuda)
    eng.run_batch(xs, mode="int8")
    got, names = _card_kernel_names(lambda: eng.run_batch(xs, mode="int8"))
    n_se = sum(layer.kind == "gate" for layer in model.layers)
    n_pool = sum(layer.kind == "avgpool" for layer in model.layers)
    n_5 = sum(layer.kind == "dwconv" and layer.kernel == (5, 5)
              for layer in model.layers)
    n_3 = sum(layer.kind == "dwconv" and layer.kernel == (3, 3)
              for layer in model.layers)
    assert n_pool == n_se + 1
    assert sum("se_pool_kernel" in n for n in names) == n_pool
    assert sum("se_gate_kernel" in n for n in names) == n_se
    assert sum("dwconv5x5_kernel<" in n for n in names) == n_5
    assert sum("dwconv3x3_kernel<" in n for n in names) == n_3
    assert eng.graph_stats() == dict(captures=1, replays=2, eager=1)
    np.testing.assert_array_equal(got, _walk(eng, xs, "int8"))


# -- every kernel call of the benchmark's plans; band staging (csrc/bands.cu)

# the benchmark's configurations: model (and its arguments), split over
# BENCH_RATINGS, the cell's batch, and the wrappers an int8 forward calls (a
# float forward calls the staging's alone)
BENCH_RATINGS = [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]
BAND_PLANS = {
    "mnv2_112": ("mobilenet_v2_paper", {}, "spatial", 8,
                 {"qgemm", "dwconv3x3_bands", "se_pool", "band_windows",
                  "band_take"}),
    "mnv2_224": ("mobilenet_v2", {"input_hw": (224, 224)}, "kernel", 32,
                 {"qgemm", "dwconv3x3", "se_pool"}),
    "effb0_224": ("efficientnet_b0", {}, "spatial", 32,
                  {"qgemm", "dwconv3x3_bands", "dwconv5x5_bands_unpadded",
                   "se_pool", "se_gate", "band_windows", "band_take"})}


def _spatial_stages(plan):
    """The staging launches a walk of ``plan`` makes: one a conv or
    depthwise stage of a spatial group, and one a group's exit."""
    groups = [g for g in plan.block_groups
              if plan.splits[g[0]].mode == "spatial"]
    return (sum(plan.model.layers[i].kind in ("conv", "dwconv")
                for g in groups for i in g), len(groups))


@pytest.mark.parametrize("net,mode", [
    ("effb0_224", "float"), ("effb0_224", "int8"), ("mnv2_112", "float"),
    ("mnv2_112", "int8"), ("mnv2_224", "int8")])
def test_band_staging_at_every_launch_of_the_spatial_plan(cuda, net, mode):
    """Every kernel call of a forward of each benchmark configuration's
    plan (MobileNetV2 at 112 spatial, batch 8; at 224 kernel split, batch
    32; EfficientNet-B0 at 224 spatial, batch 32), recorded on the card,
    equals the same wrapper on CPU copies of the engine's own arguments
    (its plain version): bit for bit, int8 and the float walks' staging
    copies; a swish or sigmoid epilogue within one code on EXP_CODE_SHARE
    of the codes, one at the least (the CPU's exp against the card's
    expf).  The forward calls the plan's wrappers; a spatial group makes
    one staging launch a stage and one more at its exit, which read the
    block input and NCHW and NHWC stacks, write NCHW (the stem's pad
    columns too) and NHWC windows, the int8 residual epilogue on and
    off."""
    from repro_torch import models
    name, kwargs, split, batch, wrappers = BAND_PLANS[net]
    model = getattr(models, name)(seed=0, **kwargs)
    plan = T.split_model(model, BENCH_RATINGS, mode=split)
    rng = np.random.default_rng(11)
    qm = T.quantize_model(model, list(rng.uniform(0.02, 0.1,
                                                  len(model.layers) + 1)))
    eng = T.CompiledSplitExecutor(plan, qm if mode == "int8" else None,
                                  device=cuda)
    x = torch.from_numpy(rng.standard_normal(
        (batch, *model.input_shape)).astype(np.float32)).to(cuda)
    calls = census(eng, x, mode)
    names = [c.name for c in calls]
    assert set(names) == (wrappers if mode == "int8"
                          else {"band_windows", "band_take"})
    assert (names.count("band_windows"),
            names.count("band_take")) == _spatial_stages(plan)
    seen = {"windows": set(), "take": set()}
    for c in calls:
        got, want = c.fn(*c.args, **c.kwargs), on_cpu(c)
        if c.kwargs.get("activation") in EXP_ACTS:
            _assert_exp_codes(got.cpu(), want,
                              max(EXP_CODE_SHARE, 1 / want.numel()))
        else:
            assert torch.equal(got.cpu(), want), (c.name, c.block)
        x_in = c.args[0]
        if c.name == "band_windows":
            cl, pw = c.kwargs.get("channels_last"), c.kwargs.get("pw")
            assert got.is_contiguous(memory_format=torch.channels_last if cl
                                     else torch.contiguous_format)
            out = "nhwc" if cl else f"nchw+{pw}" if pw else "nchw"
            seen["windows"].add((source(x_in, c.args[2]), out, x_in.dtype))
        elif c.name == "band_take":
            seen["take"].add((layout(x_in), len(c.args) > 3, x_in.dtype))
    if split != "spatial":
        return
    if mode == "int8":
        i8 = torch.int8
        assert {("input", "nhwc", i8), ("input", "nchw+1", i8),
                ("nhwc", "nchw", i8), ("nchw", "nhwc", i8)} <= seen["windows"]
        assert {("nhwc", True, i8), ("nhwc", False, i8)} <= seen["take"]
    else:
        f = torch.float32
        assert {("input", "nchw", f), ("input", "nchw+1", f),
                ("nchw", "nchw", f)} <= seen["windows"]
        assert seen["take"] == {("nchw", False, f)}


def test_float_session_full_width_on_card_equals_cpu(cuda):
    """The paper's MobileNetV2 at full width (112x112x3, 1000 classes) in
    float on the spatial split of BENCH_RATINGS: a batch of 8 on the card
    equals the CPU's within 1e-4 of the largest logit (cuDNN and the CPU's
    convolutions sum in other orders over 54 layers), every logit
    finite."""
    from repro_torch.models import mobilenet_v2_paper
    model = mobilenet_v2_paper(seed=0)
    plan = T.split_model(model, BENCH_RATINGS, mode="spatial")
    xs = np.random.default_rng(0).standard_normal(
        (8, *model.input_shape)).astype(np.float32)
    got = Session(plan, precision="float", device=cuda,
                  max_batch=8).submit_many(xs)
    want = Session(plan, precision="float", device="cpu",
                   max_batch=8).submit_many(xs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("source", ["input", "nchw", "nhwc"])
@pytest.mark.parametrize("c", [3, 24, 40, 144, 1152])
def test_band_windows_empty_bands_and_widths_vs_plain(cuda, c, source,
                                                      dtype):
    """Random row tables with an empty band (all -1) and rows of zeros,
    every channel width's vector access (3 channels: one byte), both
    output layouts and a pad: equal to the plain version."""
    rng = np.random.default_rng(c)
    bsz, n_bands, r_win, h, w = 3, 4, 6, 9, 7
    first = source == "input"
    shape = (bsz if first else bsz * n_bands, c, h, w)
    x = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
         if dtype == torch.int8 else
         torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    x = x.to(cuda)
    if source == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    t = rng.integers(0, h, (n_bands, r_win)).astype(np.int32)
    t[rng.random(t.shape) < 0.3] = -1
    t[2] = -1
    table = torch.from_numpy(t).to(cuda)
    from repro_torch.kernels.bands.ref import band_windows_ref
    for pw, cl in ((0, False), (2, False), (0, True)):
        got = band_windows(x, table, bsz, pw=pw, channels_last=cl)
        assert torch.equal(got, band_windows_ref(x, table, bsz, pw, cl))
        assert not got.view(bsz, n_bands, *got.shape[1:])[:, 2].any()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c", [5, 24, 96, 320])
def test_band_take_vs_plain(cuda, c, residual):
    """The exit's row take from NCHW and NHWC stacks, with and without the
    int8 residual epilogue (rint of the f32 product, as
    ``_residual_add_int8``), equal to the plain version and the old add."""
    from repro_torch.core.executor import _residual_add_int8
    from repro_torch.core.quantize import f32
    from repro_torch.kernels.bands.ref import band_take_ref
    rng = np.random.default_rng(c + residual)
    bsz, n_bands, r, w = 8, 6, 5, 14
    x = torch.from_numpy(rng.integers(-127, 128, (bsz * n_bands, c, r, w))
                         .astype(np.int8)).to(cuda)
    rows = torch.from_numpy(np.sort(rng.choice(n_bands * r, 14, replace=False))
                            .astype(np.int32)).to(cuda)
    res = torch.from_numpy(rng.integers(-127, 128, (bsz, c, 14, w))
                           .astype(np.int8)).to(cuda)
    args = (res, f32(0.01 / 0.013)) if residual else ()
    for src in (x, x.contiguous(memory_format=torch.channels_last)):
        got = band_take(src, rows, bsz, *args)
        assert torch.equal(got, band_take_ref(src, rows, bsz, *args))
        if residual:
            plain = band_take_ref(src, rows, bsz)
            assert torch.equal(got, _residual_add_int8(plain, 0.013, res,
                                                       0.01))


def test_band_staging_launches_and_graph_replay(cuda):
    """The smoke model's spatial plan: an eager walk makes one
    ``band_windows`` launch a stage and one ``band_take`` a spatial group;
    a replay of the captured forward runs those kernels (their names in
    the profiler's trace), no torch gather, and gives the walk's answers."""
    eng, make = _graph_engine("spatial", cuda)
    stages, groups = _spatial_stages(eng.plan)
    x = make(8)
    before = (band_windows.launches, band_take.launches)
    want = _walk(eng, x, "int8")
    assert (band_windows.launches - before[0],
            band_take.launches - before[1]) == (stages, groups)
    eng.run_batch(x, mode="int8")
    got, names = _card_kernel_names(lambda: eng.run_batch(x, mode="int8"))
    assert sum("band_windows_kernel" in n for n in names) == stages
    assert sum("band_take_kernel" in n for n in names) == groups
    assert not any("_scatter_gather" in n or "indexSelect" in n
                   for n in names)
    np.testing.assert_array_equal(got, want)
