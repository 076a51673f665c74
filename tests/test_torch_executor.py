"""The port's executors against the reference's, on the CPU.

Both packages run the same model, plan geometry and ``QuantizedModel`` (the
reference calibrates; :mod:`repro_torch.convert` carries the result across).
int8 output of the port's eager ``SplitExecutor`` and batch-first
``CompiledSplitExecutor`` must be ``array_equal`` to the reference's, in
every plan mode (residual blocks included), at band counts {1, 2, 4, 7},
across stride-2 and spatial->kernel seams, and ``run_batch`` must equal
stacked ``run`` calls.  Float output is allclose: the port's float
convolutions sum in another order than XLA's (tolerance below).
"""
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro.models import mobilenet_v2_smoke as ref_smoke

import repro_torch.core as T
from repro_torch.convert import convert_model, convert_qmodel
from repro_torch.core import executor as port_executor

BAND_RATINGS = ([1.0], [1, 1], [1, 1, 1, 1], list(np.ones(7)))
RATINGS = [1.0, 0.8, 1.2, 0.6]
# float32 convolutions summed in a different order (torch vs XLA), through
# up to 18 layers: relative to the largest output
FLOAT_RTOL = 1e-5


def _acts_fn(model, x):
    return R.reference_forward(model, x, collect_activations=True)[1]


def _setup(ref_model, seed=0, n_calib=2):
    """(ref model, port model, ref qmodel, port qmodel, inputs)."""
    rng = np.random.default_rng(seed)
    shape = ref_model.input_shape
    calib = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_calib)]
    rq = R.quantize_model(ref_model, R.calibrate_scales(ref_model, calib,
                                                        _acts_fn))
    tm = convert_model(ref_model)
    xs = rng.standard_normal((3, *shape)).astype(np.float32)
    return ref_model, tm, rq, convert_qmodel(rq, tm), xs


def _block_net(stride=1, hw=12, seed=0):
    """expand -> dwconv -> project inverted residual behind a 3x3 conv that
    stashes the residual: the fused-block shape with interior re-gathers."""
    spec = [
        dict(kind="conv", out_channels=4, kernel=(3, 3), stride=(1, 1),
             padding=(1, 1), activation="relu6", save_as="blk"),
        dict(kind="conv", out_channels=12, kernel=(1, 1), stride=(1, 1),
             padding=(0, 0), activation="relu6"),
        dict(kind="dwconv", kernel=(3, 3), stride=(stride, stride),
             padding=(1, 1), activation="relu6"),
        dict(kind="conv", out_channels=4, kernel=(1, 1), stride=(1, 1),
             padding=(0, 0), residual_from="blk" if stride == 1 else None),
    ]
    return R.trace_sequential(spec, (3, hw, hw),
                              rng=np.random.default_rng(seed))


def _conv_net(kernel, stride, depthwise=False, hw=11, seed=0):
    """A kxk conv (or depthwise conv) then a 1x1 projection."""
    first = dict(kind="dwconv" if depthwise else "conv",
                 kernel=(kernel, kernel), stride=(stride, stride),
                 padding=(kernel // 2, kernel // 2), activation="relu6")
    if not depthwise:
        first["out_channels"] = 5
    spec = [first, dict(kind="conv", out_channels=4, kernel=(1, 1),
                        stride=(1, 1), padding=(0, 0))]
    return R.trace_sequential(spec, (3, hw, hw),
                              rng=np.random.default_rng(seed))


def _small_cnn(seed=0):
    """Every layer kind, a residual and a stride-2 conv (conftest's net)."""
    spec = [
        dict(kind="conv", out_channels=6, kernel=(3, 3), stride=(1, 1),
             padding=(1, 1), activation="relu6", save_as="blk"),
        dict(kind="dwconv", kernel=(3, 3), stride=(1, 1), padding=(1, 1),
             activation="relu6"),
        dict(kind="conv", out_channels=6, kernel=(1, 1), stride=(1, 1),
             padding=(0, 0), residual_from="blk"),
        dict(kind="conv", out_channels=8, kernel=(3, 3), stride=(2, 2),
             padding=(1, 1), activation="relu"),
        dict(kind="avgpool"),
        dict(kind="linear", features=10),
    ]
    return R.trace_sequential(spec, (3, 12, 12),
                              rng=np.random.default_rng(seed))


def _mixed(pkg, model, ratings):
    n = len(pkg.group_blocks(model))
    assignment = tuple("spatial" if i < n // 2 else ("kernel", "neuron")[i % 2]
                       for i in range(n))
    return pkg.split_model_mixed(model, ratings, assignment)


def _plans(mode, rm, tm, ratings):
    if mode == "mixed":
        return _mixed(R, rm, ratings), _mixed(T, tm, ratings)
    return (R.split_model(rm, ratings, mode=mode),
            T.split_model(tm, ratings, mode=mode))


def _check_int8(rp, tp, rq, tq, xs, eager=True):
    ref = R.CompiledSplitExecutor(rp, rq).run_batch(xs, mode="int8")
    got = T.CompiledSplitExecutor(tp, tq, device="cpu").run_batch(
        xs, mode="int8")
    assert got.dtype == np.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if eager:
        # the reference's own tests hold its eager oracle equal to ref
        got_eager = T.SplitExecutor(tp, tq, device="cpu").run(xs[0],
                                                              mode="int8")
        np.testing.assert_array_equal(got_eager, ref[0])


@pytest.fixture(scope="module")
def smoke():
    return _setup(ref_smoke())


class TestInt8Parity:
    @pytest.mark.parametrize("mode", ["neuron", "kernel", "spatial", "mixed"])
    def test_smoke_all_modes(self, smoke, mode):
        rm, tm, rq, tq, xs = smoke
        rp, tp = _plans(mode, rm, tm, RATINGS)
        _check_int8(rp, tp, rq, tq, xs)

    @pytest.mark.parametrize("mode", ["neuron", "kernel", "spatial", "mixed"])
    def test_residual_net_all_modes(self, mode):
        rm, tm, rq, tq, xs = _setup(_small_cnn())
        rp, tp = _plans(mode, rm, tm, [1.0, 2.0, 0.5])
        _check_int8(rp, tp, rq, tq, xs)

    @pytest.mark.parametrize("ratings", BAND_RATINGS,
                             ids=lambda r: f"bands{len(r)}")
    def test_band_counts(self, smoke, ratings):
        rm, tm, rq, tq, xs = smoke
        rp, tp = _plans("spatial", rm, tm, ratings)
        _check_int8(rp, tp, rq, tq, xs, eager=False)

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("ratings", BAND_RATINGS,
                             ids=lambda r: f"bands{len(r)}")
    def test_fused_block_seams(self, stride, ratings):
        """Stride-2 interior stages re-gather band-locally across seams."""
        rm, tm, rq, tq, xs = _setup(_block_net(stride=stride))
        rp, tp = _plans("spatial", rm, tm, ratings)
        _check_int8(rp, tp, rq, tq, xs)

    @pytest.mark.parametrize("kernel,stride,depthwise", [
        (3, 2, False), (5, 1, False), (5, 2, True), (3, 2, True)])
    @pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron"])
    def test_halo_widths(self, kernel, stride, depthwise, mode):
        """Wider halos (5x5), stride 2, and a 5x5 depthwise conv that no
        kernel covers (plain torch on the CPU)."""
        rm, tm, rq, tq, xs = _setup(_conv_net(kernel, stride, depthwise))
        rp, tp = _plans(mode, rm, tm, [1.0, 1.3, 0.6])
        _check_int8(rp, tp, rq, tq, xs)

    def test_spatial_to_kernel_seam(self, smoke):
        rm, tm, rq, tq, xs = smoke
        n = len(R.group_blocks(rm))
        assignment = ("spatial",) * (n // 2) + ("kernel",) * (n - n // 2)
        rp = R.split_model_mixed(rm, RATINGS, assignment)
        tp = T.split_model_mixed(tm, RATINGS, assignment)
        assert "spatial" in tp.group_modes and "kernel" in tp.group_modes
        _check_int8(rp, tp, rq, tq, xs)

    @pytest.mark.parametrize("mode", ["kernel", "neuron"])
    def test_heterogeneous_ratings_uneven_shards(self, smoke, mode):
        """Ratings far apart give uneven shard spans (and, in neuron mode,
        channels split between shards) in every flat depthwise layer."""
        rm, tm, rq, tq, xs = smoke
        ratings = [1.0, 2.7, 0.35, 1.6, 0.5, 1.15]
        rp, tp = _plans(mode, rm, tm, ratings)
        spans = [[g.c_hi - g.c_lo + 1 for g in geoms if g is not None]
                 for geoms, layer in zip(
                     (T.compile_shard_geometry(lyr, sp)
                      for lyr, sp in zip(tm.layers, tp.splits)), tm.layers)
                 if layer.kind == "dwconv"]
        assert any(max(s) >= 2 * min(s) for s in spans)
        _check_int8(rp, tp, rq, tq, xs)

    @pytest.mark.parametrize("mode", ["spatial", "neuron"])
    def test_run_batch_equals_stacked_runs(self, smoke, mode):
        _, tm, _, tq, xs = smoke
        tp = T.split_model(tm, RATINGS, mode=mode)
        eng = T.CompiledSplitExecutor(tp, tq, device="cpu")
        batch = eng.run_batch(xs, mode="int8")
        np.testing.assert_array_equal(
            batch, np.stack([eng.run(x, mode="int8") for x in xs]))


class TestFloat:
    @pytest.mark.parametrize("mode", ["neuron", "kernel", "spatial", "mixed"])
    def test_float_allclose(self, smoke, mode):
        rm, tm, _, _, xs = smoke
        rp, tp = _plans(mode, rm, tm, RATINGS)
        ref = R.CompiledSplitExecutor(rp).run_batch(xs, mode="float")
        got = T.CompiledSplitExecutor(tp, device="cpu").run_batch(
            xs, mode="float")
        atol = FLOAT_RTOL * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=FLOAT_RTOL, atol=atol)
        if mode != "spatial" and mode != "mixed":
            eager = T.SplitExecutor(tp, device="cpu").run(xs[0])
            np.testing.assert_allclose(eager, ref[0], rtol=FLOAT_RTOL,
                                       atol=atol)
        # batched float output equals stacked runs to float32 rounding
        eng = T.CompiledSplitExecutor(tp, device="cpu")
        np.testing.assert_allclose(
            got, np.stack([eng.run(x) for x in xs]), rtol=FLOAT_RTOL,
            atol=atol)

    def test_reference_forward_and_activations(self, smoke):
        rm, tm, _, _, xs = smoke
        ref_out, ref_acts = R.reference_forward(rm, xs[0],
                                                collect_activations=True)
        out, acts = T.reference_forward(tm, xs[0], collect_activations=True,
                                        device="cpu")
        atol = FLOAT_RTOL * np.abs(ref_out).max()
        np.testing.assert_allclose(out, ref_out, rtol=FLOAT_RTOL, atol=atol)
        assert len(acts) == len(ref_acts)
        for a, b in zip(acts, ref_acts):
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL,
                                       atol=FLOAT_RTOL * np.abs(b).max())


class TestEngine:
    def test_no_device_raises_without_cuda(self, smoke, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, tm, _, tq, xs = smoke
        plan = T.split_model(tm, RATINGS, mode="spatial")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.CompiledSplitExecutor(plan, tq)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.SplitExecutor(plan, tq)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.reference_forward(tm, xs[0])

    def test_uncovered_layer_raises_off_cpu(self):
        layer = convert_model(_conv_net(5, 1, depthwise=True)).layers[0]
        assert not port_executor._kernel_eligible_dwconv(layer)
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            port_executor._uncovered(layer, torch.empty(0, device="meta"))
        port_executor._uncovered(layer, torch.empty(0))

    def test_constants_cache(self, smoke):
        _, tm, _, tq, xs = smoke
        T.CompiledSplitExecutor.cache_clear()
        plan = T.split_model(tm, RATINGS, mode="spatial")
        a = T.CompiledSplitExecutor(plan, tq, device="cpu")
        ya = a.run_batch(xs, mode="int8")
        assert T.CompiledSplitExecutor.cache_stats() == dict(
            size=1, hits=0, misses=1)
        # an equal plan built anew shares the uploaded constants
        b = T.CompiledSplitExecutor(T.split_model(tm, RATINGS,
                                                  mode="spatial"), tq,
                                    device="cpu")
        assert b.fingerprint == a.fingerprint
        np.testing.assert_array_equal(b.run_batch(xs, mode="int8"), ya)
        assert T.CompiledSplitExecutor.cache_stats()["hits"] == 1
        assert b._consts is a._consts
        # other geometry misses
        c = T.CompiledSplitExecutor(T.split_model(tm, [1.0, 1.0],
                                                  mode="spatial"), tq,
                                    device="cpu")
        c.run_batch(xs[:1], mode="int8")
        assert c.fingerprint != a.fingerprint
        assert T.CompiledSplitExecutor.cache_stats()["misses"] == 2
        T.CompiledSplitExecutor.cache_clear()
        assert T.CompiledSplitExecutor.cache_stats() == dict(
            size=0, hits=0, misses=0)

    @pytest.mark.parametrize("mode", ["kernel", "neuron", "spatial"])
    def test_one_depthwise_call_per_layer(self, smoke, mode, monkeypatch):
        """A flat depthwise layer is one ``dwconv_shards`` call over all of
        its shards, a spatial depthwise stage one ``dwconv_bands_unpadded``
        call, and neither pads its input first."""
        _, tm, _, tq, xs = smoke
        calls = {"shards": 0, "bands": 0, "pad": 0}

        def counted(name, fn):
            def wrapper(*args, **kw):
                calls[name] += 1
                return fn(*args, **kw)
            return wrapper

        monkeypatch.setattr(port_executor, "dwconv_shards",
                            counted("shards", port_executor.dwconv_shards))
        monkeypatch.setattr(port_executor, "dwconv_bands_unpadded",
                            counted("bands",
                                    port_executor.dwconv_bands_unpadded))
        eng = T.CompiledSplitExecutor(T.split_model(tm, RATINGS, mode=mode),
                                      tq, device="cpu")
        eng.run_batch(xs[:1], mode="int8")      # uploads the constants
        monkeypatch.setattr(port_executor, "_pad_chw",
                            counted("pad", port_executor._pad_chw))
        calls.update(shards=0, bands=0)
        eng.run_batch(xs, mode="int8")
        n_dw = sum(layer.kind == "dwconv" for layer in tm.layers)
        flat = mode != "spatial"
        assert calls["shards"] == (n_dw if flat else 0)
        assert calls["bands"] == (0 if flat else n_dw)
        # the engine pads no depthwise input (flat conv layers use im2col)
        assert calls["pad"] == 0 if flat else calls["pad"] > 0

    def test_bad_mode_and_missing_qmodel(self, smoke):
        _, tm, _, _, xs = smoke
        eng = T.CompiledSplitExecutor(T.split_model(tm, RATINGS),
                                      device="cpu")
        with pytest.raises(ValueError, match="unknown mode"):
            eng.run(xs[0], mode="fp16")
        with pytest.raises(ValueError, match="QuantizedModel"):
            eng.run(xs[0], mode="int8")


class TestFp32Lock:
    """The float path's TF32 switch is process-wide, so ``_full_fp32``
    holds one process-wide lock around the switch and the body."""

    def test_second_thread_waits_for_the_first(self):
        a_inside, a_release, b_ready = (threading.Event() for _ in range(3))
        order, seen = [], {}

        def first():
            with port_executor._full_fp32():
                seen["a_flag"] = torch.backends.cudnn.allow_tf32
                a_inside.set()
                assert a_release.wait(30)
                order.append("a leaves")

        def second():
            # while the first is inside, the lock is not to be had
            seen["b_free"] = port_executor._FP32_LOCK.acquire(blocking=False)
            if seen["b_free"]:
                port_executor._FP32_LOCK.release()
            b_ready.set()
            with port_executor._full_fp32():
                order.append("b enters")
                seen["b_flag"] = torch.backends.cudnn.allow_tf32

        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        ta = threading.Thread(target=first)
        ta.start()
        assert a_inside.wait(30)
        tb = threading.Thread(target=second)
        tb.start()
        assert b_ready.wait(30)
        a_release.set()
        ta.join(30)
        tb.join(30)
        assert not ta.is_alive() and not tb.is_alive()
        assert seen == dict(a_flag=False, b_free=False, b_flag=False)
        assert order == ["a leaves", "b enters"]
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == prev

    def test_reentrant_and_restoring(self):
        """A calibration's reference forward nests inside a float section
        of the same thread: no deadlock, flags back as they were."""
        prev = torch.backends.cudnn.allow_tf32
        with port_executor._full_fp32():
            with port_executor._full_fp32():
                assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32 == prev
        assert port_executor._FP32_LOCK.acquire(blocking=False)
        port_executor._FP32_LOCK.release()

    def test_workers_hold_no_lock_of_their_own(self):
        """The workers' float segments take the same lock through
        ``_full_fp32``; a second lock could order against it and
        deadlock."""
        from repro_torch.runtime import shards
        lock_types = (type(threading.Lock()), type(threading.RLock()))
        assert not [name for name, v in vars(shards).items()
                    if isinstance(v, lock_types)]
