"""The port's distributed runtime against the reference's and its own
``Session``, on the CPU.

* Setup payloads and frames: the port's ``build_worker_setup`` and
  ``encode_frame`` give the reference's specs, arrays and bytes.
* Segment functions: for every segment of every worker's setup (the
  smoke MobileNetV2; spatial, neuron, kernel and one mixed plan at
  N in {1, 2, 4}), the port's ``build_segment_fns(device="cpu")`` equals
  the reference's on the same payload (int8 ``array_equal``, float32
  within 1e-5).
* ``run_distributed(spawn="inprocess")`` is bit-exact with the port's
  ``Session`` and with the reference's ``run_distributed`` in int8 for
  every plan kind at N in {1, 2, 4}, realizing every predicted edge; one
  case runs worker subprocesses with ``--device cpu``.
* Cross-driving: a port coordinator drives reference workers, and a
  reference coordinator drives port workers, bit-exact.
* Faults (``tests/test_runtime.py``'s five cases) surface as descriptive
  errors with no orphaned asyncio task.

Every async body runs under an outer ``asyncio.wait_for``.  Int8 parity
feeds both packages the reference's ``QuantizedModel`` (``convert_qmodel``).
"""
import asyncio

import numpy as np
import pytest

import repro.core as R
from conftest import small_cnn
from repro.api import Session as RefSession
from repro.models import mobilenet_v2_smoke as ref_mnv2_smoke
from repro.runtime import protocol as ref_protocol
from repro.runtime import shards as ref_shards
from repro.runtime.coordinator import Coordinator as RefCoordinator
from repro.runtime.validate import run_distributed as ref_run_distributed
from repro.runtime.worker import run_worker as ref_run_worker

import repro_torch.core as T
from repro_torch.api import Session
from repro_torch.convert import convert_model, convert_qmodel
from repro_torch.core.simulator import dependency_edges
from repro_torch.runtime import protocol, shards
from repro_torch.runtime.coordinator import Coordinator
from repro_torch.runtime.validate import run_distributed
from repro_torch.runtime.worker import run_worker

pytestmark = pytest.mark.xdist_group("runtime")

TIMEOUT = 240
MODES = ("spatial", "neuron", "kernel")
# the distributed float path convolves per band where Session convolves
# per batch; the sums may take another order
FLOAT_TOL = 1e-5


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


def _mixed_assignment(model):
    n_b = len(R.group_blocks(model))
    return [("spatial", "neuron", "kernel")[i % 3] for i in range(n_b)]


def _splits(ref_model, model, mode, n):
    """The same plan in both packages ("mixed": a per-block cycle of the
    three modes)."""
    r = np.ones(n)
    if mode == "mixed":
        a = _mixed_assignment(ref_model)
        return (R.split_model_mixed(ref_model, r, a),
                T.split_model_mixed(model, r, a))
    return R.split_model(ref_model, r, mode=mode), T.split_model(
        model, r, mode=mode)


# ---------------------------------------------------------------------------
# setup payloads, frames and segment functions (smoke MobileNetV2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    ref_model = ref_mnv2_smoke()
    model = convert_model(ref_model)
    ref_q = RefSession(R.split_model(ref_model, np.ones(2)),
                       seed=0).qmodel
    return ref_model, model, ref_q, convert_qmodel(ref_q, model)


def _setups(smoke, mode, n, precision="int8"):
    ref_model, model, ref_q, q = smoke
    rs, ts = _splits(ref_model, model, mode, n)
    int8 = precision == "int8"
    for w in range(n):
        yield (w, ref_shards.build_worker_setup(rs, ref_q if int8 else None,
                                                precision, w),
               shards.build_worker_setup(ts, q if int8 else None, precision,
                                         w))


class TestSetupPayloads:
    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    @pytest.mark.parametrize("precision", ["int8", "float"])
    def test_setup_frames_byte_identical(self, smoke, mode, n, precision):
        for w, (rmeta, rarr), (meta, arr) in _setups(smoke, mode, n,
                                                     precision):
            assert meta == rmeta
            assert list(arr) == list(rarr)
            for k in arr:
                assert arr[k].dtype == rarr[k].dtype
                assert np.array_equal(arr[k], rarr[k])
            wire = protocol.encode_frame("setup", {"plan": meta}, arr)
            assert wire == ref_protocol.encode_frame("setup",
                                                     {"plan": rmeta}, rarr)
            assert shards.setup_array_bytes(arr) == \
                ref_shards.setup_array_bytes(rarr)

    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_coordinator_plan_and_geometry(self, smoke, mode, n):
        ref_model, model, ref_q, q = smoke
        rs, ts = _splits(ref_model, model, mode, n)
        rc = ref_shards.build_coordinator_plan(rs, ref_q, "int8")
        tc = shards.build_coordinator_plan(ts, q, "int8")
        assert repr(tc) == repr(rc)
        assert (shards.worker_geometry_summary(ts)
                == ref_shards.worker_geometry_summary(rs))

    def test_frames_byte_identical(self):
        rng = np.random.default_rng(0)
        arrays = {"x": rng.integers(-127, 128, (3, 5, 7)).astype(np.int8),
                  "y": rng.standard_normal(11).astype(np.float32)}
        for ftype, meta, arr in (("hello", {"worker": 3}, None),
                                 ("infer_input", {"seq": 9, "gi": 2}, arrays),
                                 ("result", {"seq": 1, "gi": 0}, arrays),
                                 ("shutdown", {}, None)):
            wire = protocol.encode_frame(ftype, meta, arr)
            assert wire == ref_protocol.encode_frame(ftype, meta, arr)
            got = protocol.decode_body(wire[4:])
            assert got[0] == ftype and got[1] == meta
        with pytest.raises(protocol.ProtocolError):
            protocol.decode_body(b"\x01\x00")

    def test_delta_setup_equal(self, smoke):
        (_, (rmeta, rarr), (meta, arr)), *_ = _setups(smoke, "spatial", 2)
        held = {fp for spec in meta["segments"]
                for fp in list(spec.get("array_fps", {}).values())[:1]}
        assert (list(shards.delta_setup(meta, arr, held))
                == list(ref_shards.delta_setup(rmeta, rarr, held)))


def _segment_inputs(seg, int8, rng):
    if int8:
        return rng.integers(-127, 128, seg.input_shape).astype(np.int8)
    return rng.standard_normal(seg.input_shape).astype(np.float32)


class TestSegmentFunctions:
    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_int8_segments_equal_reference(self, smoke, mode, n):
        """The reference's payload, lowered by both packages: every segment
        of every worker gives the reference's int8 output."""
        rng = np.random.default_rng(n)
        kinds = set()
        for w, (rmeta, rarr), _ in _setups(smoke, mode, n):
            ref = ref_shards.build_segment_fns(rmeta, rarr)
            got = shards.build_segment_fns(rmeta, rarr, device="cpu")
            assert sorted(got) == sorted(ref)
            for gi, seg in got.items():
                assert seg.input_shape == ref[gi].input_shape
                assert seg.layer_first == ref[gi].layer_first
                x = _segment_inputs(seg, True, rng)
                y = seg.fn(x).cpu().numpy()
                want = np.asarray(ref[gi].fn(x))
                assert y.dtype == np.int8 and y.shape == want.shape
                assert np.array_equal(y, want), (w, gi)
                kinds.add(rmeta["segments"][gi]["kind"])
        assert kinds

    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_float_segments_close_to_reference(self, smoke, mode):
        rng = np.random.default_rng(7)
        for w, (rmeta, rarr), _ in _setups(smoke, mode, 2, "float"):
            ref = ref_shards.build_segment_fns(rmeta, rarr)
            got = shards.build_segment_fns(rmeta, rarr, device="cpu")
            for gi, seg in got.items():
                x = _segment_inputs(seg, False, rng)
                y = seg.fn(x).cpu().numpy()
                np.testing.assert_allclose(y, np.asarray(ref[gi].fn(x)),
                                           rtol=FLOAT_TOL, atol=FLOAT_TOL)

    def test_flat_conv_scale_is_recovered_per_channel(self, smoke):
        """A flat conv shard ships its scale per output position; the
        worker folds it to one value a channel and refuses a payload where
        a channel's positions disagree."""
        (_, (rmeta, rarr), _), *_ = _setups(smoke, "neuron", 2)
        spec = next(s for s in rmeta["segments"] if s["kind"] == "conv")
        gi = spec["gi"]
        bad = dict(rarr)
        s = rarr[f"s{gi}"].copy()
        s[-1] *= 2
        bad[f"s{gi}"] = s
        with pytest.raises(ValueError, match="per local channel"):
            shards.build_segment_fns(
                {"precision": "int8", "segments": [spec]}, bad, device="cpu")

    def test_warm_cache_reuses_uploaded_constants(self, smoke):
        import collections
        (_, _, (meta, arr)), *_ = _setups(smoke, "spatial", 2)
        cache = collections.OrderedDict()
        stats = {}
        first = shards.build_segment_fns(meta, arr, cache=cache,
                                         stats=stats, device="cpu")
        assert stats == {"cache_hits": 0, "cache_misses": len(first)}
        again = shards.build_segment_fns(meta, arr, cache=cache,
                                         stats=stats, device="cpu")
        assert stats == {"cache_hits": len(first), "cache_misses": 0}
        assert all(again[gi].fn is first[gi].fn for gi in first)
        assert shards.warmup_segments(again, "int8") >= 0.0

    def test_no_device_raises_without_cuda(self, smoke, monkeypatch):
        import torch
        (_, _, (meta, arr)), *_ = _setups(smoke, "spatial", 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shards.build_segment_fns(meta, arr)


# ---------------------------------------------------------------------------
# end to end: run_distributed against Session and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    ref_model = small_cnn()
    model = convert_model(ref_model)
    ref_q = RefSession(R.split_model(ref_model, np.ones(2)),
                       seed=0).qmodel
    return ref_model, model, ref_q, convert_qmodel(ref_q, model)


class TestBitExact:
    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_int8_matches_session_and_reference(self, cnn, mode, n):
        ref_model, model, ref_q, q = cnn
        rs, ts = _splits(ref_model, model, mode, n)
        sess = Session(ts, qmodel=q, device="cpu")
        rep = run_distributed(ts, q, reference=sess, spawn="inprocess",
                              n_requests=2, seed=n)
        assert rep.bitexact, f"max |diff| = {rep.max_abs_diff}"
        assert rep.edges_superset and not rep.missing_edges
        assert dependency_edges(ts) <= rep.measured_edges
        ref_sess = RefSession(rs, qmodel=ref_q)
        ref_rep = ref_run_distributed(rs, ref_q, reference=ref_sess,
                                      spawn="inprocess", n_requests=2,
                                      seed=n)
        assert ref_rep.predicted_edges == rep.predicted_edges
        assert ref_rep.predicted_s == rep.predicted_s
        # the same requests through both packages' runtimes
        rng = np.random.default_rng(n)
        xs = [rng.standard_normal(model.layers[0].in_shape,
                                  dtype=np.float32) for _ in range(2)]

        async def both():
            async with Coordinator(ts, q, spawn="inprocess",
                                   device="cpu") as coord:
                got = [await coord.infer(x) for x in xs]
            async with RefCoordinator(rs, ref_q,
                                      spawn="inprocess") as rcoord:
                want = [await rcoord.infer(x) for x in xs]
            return got, want
        got, want = run(both())
        for g, w_ in zip(got, want):
            assert g.dtype == np.int8 and np.array_equal(g, w_)

    def test_float_close_to_session_and_reference(self, cnn):
        ref_model, model, _, _ = cnn
        rs, ts = _splits(ref_model, model, "spatial", 2)
        sess = Session(ts, precision="float", device="cpu")
        rep = run_distributed(ts, precision="float", reference=sess,
                              spawn="inprocess", n_requests=1)
        # not bit-exact even on the CPU: the session's convolutions sum over
        # a batch, the workers' over one band (a last-bit difference)
        assert rep.max_abs_diff <= FLOAT_TOL
        x = np.random.default_rng(0).standard_normal(
            model.input_shape).astype(np.float32)

        async def both():
            async with Coordinator(ts, precision="float", spawn="inprocess",
                                   device="cpu") as coord:
                got = await coord.infer(x)
            async with RefCoordinator(rs, precision="float",
                                      spawn="inprocess") as rcoord:
                want = await rcoord.infer(x)
            return got, want
        got, want = run(both())
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)

    def test_timeline_in_simulator_schema(self, cnn):
        _, model, _, q = cnn
        ts = T.split_model(model, np.ones(2), mode="spatial")
        rep = run_distributed(ts, q, reference=Session(ts, qmodel=q,
                                                       device="cpu"),
                              spawn="inprocess", n_requests=1)
        tl = rep.timeline
        assert tl.n_workers == ts.n_workers
        assert {e.kind for e in tl.events} == {"download", "compute",
                                               "upload"}
        for e in tl.events:
            assert 0 <= e.start_s <= e.end_s <= tl.makespan_s + 1e-6
        assert all(e.nbytes > 0 for e in tl.events if e.kind != "compute")
        assert float(tl.compute_busy_s.sum()) > 0
        assert rep.row()["n_workers"] == 2

    def test_subprocess_workers_on_cpu(self, cnn, tmp_path):
        _, model, _, q = cnn
        ts = T.split_model(model, np.ones(2), mode="neuron")
        rep = run_distributed(ts, q, reference=Session(ts, qmodel=q,
                                                       device="cpu"),
                              spawn="process", n_requests=1,
                              log_dir=str(tmp_path))
        assert rep.bitexact and rep.edges_superset
        log = (tmp_path / "worker0.log").read_text()
        assert "device cpu" in log

    def test_session_distributed_and_plan_geometry(self, cnn):
        _, model, _, q = cnn
        ts = T.split_model(model, np.ones(2), mode="spatial")
        sess = Session(ts, qmodel=q, device="cpu")
        x = np.random.default_rng(3).standard_normal(
            model.input_shape).astype(np.float32)

        async def main():
            async with sess.distributed(spawn="inprocess") as coord:
                return await coord.infer(x), coord.last_timeline
        y, tl = run(main())
        assert np.array_equal(y, sess.run(x))
        assert tl is not None and tl.events

    def test_no_device_raises_without_cuda(self, cnn, monkeypatch):
        import torch
        _, model, _, q = cnn
        ts = T.split_model(model, np.ones(2))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Coordinator(ts, q)


# ---------------------------------------------------------------------------
# cross-driving: one package's coordinator, the other's workers
# ---------------------------------------------------------------------------

async def _external(coord, workers):
    """Start ``coord`` (spawn="external") and attach one worker task per
    expected id once its server is bound."""
    start = asyncio.ensure_future(coord.start())
    while coord._server is None:
        await asyncio.sleep(0.01)
    tasks = [asyncio.ensure_future(workers(coord.port, w))
             for w in coord.expected]
    await start
    return tasks


async def _finish(coord, tasks):
    await coord.close()
    done, pending = await asyncio.wait(tasks, timeout=30)
    for t in pending:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    assert not pending, "workers did not exit on shutdown"


class TestCrossDriving:
    @pytest.mark.parametrize("mode", ["spatial", "neuron"])
    def test_port_coordinator_drives_reference_workers(self, cnn, mode):
        ref_model, model, ref_q, q = cnn
        _, ts = _splits(ref_model, model, mode, 2)
        sess = Session(ts, qmodel=q, device="cpu")
        x = np.random.default_rng(11).standard_normal(
            model.input_shape).astype(np.float32)

        async def main():
            coord = Coordinator(ts, q, spawn="external", device="cpu",
                                setup_timeout=60)
            tasks = await _external(
                coord, lambda port, w: ref_run_worker("127.0.0.1", port, w))
            try:
                return await coord.infer(x), set(coord.measured_edges)
            finally:
                await _finish(coord, tasks)
        y, edges = run(main())
        assert np.array_equal(y, sess.run(x))
        assert dependency_edges(ts) <= edges

    @pytest.mark.parametrize("mode", ["spatial", "kernel"])
    def test_reference_coordinator_drives_port_workers(self, cnn, mode):
        ref_model, model, ref_q, q = cnn
        rs, ts = _splits(ref_model, model, mode, 2)
        sess = Session(ts, qmodel=q, device="cpu")
        x = np.random.default_rng(12).standard_normal(
            model.input_shape).astype(np.float32)

        async def main():
            coord = RefCoordinator(rs, ref_q, spawn="external",
                                   setup_timeout=60)
            tasks = await _external(
                coord, lambda port, w: run_worker("127.0.0.1", port, w,
                                                  device="cpu"))
            try:
                return await coord.infer(x)
            finally:
                await _finish(coord, tasks)
        y = run(main())
        assert np.array_equal(y, sess.run(x))


# ---------------------------------------------------------------------------
# fault injection: descriptive errors, no hangs, no orphaned tasks
# ---------------------------------------------------------------------------

@pytest.fixture()
def fault_env(cnn):
    _, model, _, q = cnn
    return T.split_model(model, np.ones(1), mode="neuron"), q


async def _fake_hello(host, port):
    r, w = await asyncio.open_connection(host, port)
    await protocol.write_frame(w, "hello", {"worker": 0})
    await protocol.read_frame(r)        # setup frame
    return r, w


async def _drive(split, qmodel, fake, expect, *, setup_ok, **coord_kw):
    before = {t for t in asyncio.all_tasks() if not t.done()}
    coord = Coordinator(split, qmodel, spawn="external", setup_timeout=30,
                        device="cpu", **coord_kw)
    fk = None
    try:
        start = asyncio.ensure_future(coord.start())
        while coord._server is None:
            await asyncio.sleep(0.01)
        fk = asyncio.ensure_future(fake(coord.host, coord.port))
        if not setup_ok:
            with pytest.raises(RuntimeError, match=expect):
                await start
            return
        await start
        x = np.zeros(split.model.input_shape, np.float32)
        with pytest.raises(RuntimeError, match=expect):
            await coord.infer(x)
    finally:
        if fk is not None:
            fk.cancel()
            await asyncio.gather(fk, return_exceptions=True)
        await coord.close()
        await asyncio.sleep(0.05)
        leaked = {t for t in asyncio.all_tasks()
                  if not t.done()} - before - {asyncio.current_task()}
        assert not leaked, f"orphaned tasks: {leaked}"


class TestFaultInjection:
    def test_truncated_frame_during_setup(self, fault_env):
        split, qm = fault_env

        async def fake(host, port):
            r, w = await _fake_hello(host, port)
            w.write(b"\x40\x00\x00\x00partial")   # claims 64B, sends 7
            await w.drain()
            w.close()

        run(_drive(split, qm, fake, r"worker 0.*truncated frame",
                   setup_ok=False))

    def test_worker_dies_mid_upload(self, fault_env):
        split, qm = fault_env

        async def fake(host, port):
            r, w = await _fake_hello(host, port)
            await protocol.write_frame(w, "ready",
                                       {"worker": 0, "setup_s": 0.0})
            await protocol.read_frame(r)          # infer_input
            wire = protocol.encode_frame(
                "result", {"seq": 0, "gi": 0, "worker": 0},
                {"y": np.zeros(64, np.int8)})
            w.write(wire[:len(wire) // 2])        # half the frame, then die
            await w.drain()
            w.close()

        run(_drive(split, qm, fake, r"worker 0.*truncated frame",
                   setup_ok=True, request_timeout=20))

    def test_slow_worker_hits_recv_timeout(self, fault_env):
        split, qm = fault_env

        async def fake(host, port):
            r, w = await _fake_hello(host, port)
            await protocol.write_frame(w, "ready",
                                       {"worker": 0, "setup_s": 0.0})
            while True:                           # heartbeat but never answer
                await asyncio.sleep(0.1)
                await protocol.write_frame(w, "heartbeat", {"worker": 0})

        run(_drive(split, qm, fake, r"worker 0 timed out on segment 0",
                   setup_ok=True, request_timeout=0.5, max_retries=1))

    def test_garbage_frame_fails_setup(self, fault_env):
        split, qm = fault_env

        async def fake(host, port):
            r, w = await _fake_hello(host, port)
            w.write(b"\x08\x00\x00\x00NOTJSON!")
            await w.drain()
            await asyncio.sleep(10)

        run(_drive(split, qm, fake, r"worker 0", setup_ok=False))

    def test_unidentified_peer_rejected(self, fault_env):
        split, qm = fault_env

        async def fake(host, port):
            r, w = await asyncio.open_connection(host, port)
            await protocol.write_frame(w, "hello", {"worker": 99})
            await asyncio.sleep(10)

        run(_drive(split, qm, fake, r"unidentified peer|setup failed",
                   setup_ok=False))


class TestSegmentLaunches:
    @pytest.mark.parametrize("mode", MODES + ("mixed",))
    def test_launch_list_matches_the_wrappers(self, smoke, mode,
                                              monkeypatch):
        """``segment_launches`` lists the wrapper calls a segment makes,
        with the shapes they get (recorded here on the CPU, where the same
        wrappers take their plain versions)."""
        import repro_torch.runtime.shards as sh
        calls = []

        def conv_shape(x, w, *_, stride, **__):
            _, rows, width = x.shape
            _, c_in, kh, kw = w.shape
            m = ((rows - kh) // stride[0] + 1) * ((width - kw) // stride[1]
                                                  + 1)
            return m, c_in * kh * kw, w.shape[0]

        def spy(name, fn, shape_of):
            def wrapped(*a, **kw):
                calls.append((name, shape_of(*a, **kw)))
                return fn(*a, **kw)
            return wrapped
        monkeypatch.setattr(sh, "qconv2d", spy("qgemm", sh.qconv2d,
                                               conv_shape))
        monkeypatch.setattr(sh, "qgemm", spy(
            "qgemm", sh.qgemm,
            lambda x, w, *_, **__: (x.shape[0], x.shape[1], w.shape[1])))
        monkeypatch.setattr(sh, "dwconv_window", spy(
            "dwconv3x3", sh.dwconv_window,
            lambda x, *_, stride, **__: (1, *x.shape, stride)))
        rng = np.random.default_rng(3)
        for _, _, (meta, arr) in _setups(smoke, mode, 4):
            segs = shards.build_segment_fns(meta, arr, device="cpu")
            for spec in meta["segments"]:
                if spec["kind"] == "skip":
                    continue
                calls.clear()
                seg = segs[spec["gi"]]
                seg.fn(_segment_inputs(seg, True, rng))
                assert calls == [(k, tuple(shape)) for k, shape, _ in
                                 shards.segment_launches(spec, arr)]
