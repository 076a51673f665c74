"""The port's ``Session`` against its engine and the reference's ``Session``.

Bucket-padded ``submit_many`` must be ``array_equal`` to the port's
``run_batch`` and to the reference ``Session`` serving the same plan
geometry and the same (converted) ``QuantizedModel``.  Tickets, flush,
poisoned dispatches, stats and buckets behave as in the reference.  The
port's own calibration is held to the reference's with allclose: it runs a
float forward pass of its own, whose sums take another order.
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.api import Session as RefSession

import repro_torch.core as T
from repro_torch.api import RollingLatency, Session, Ticket
from repro_torch.convert import convert_model, convert_qmodel

RATINGS = [1.0, 2.0, 0.5]
# activation scales are max-abs over a float forward pass; the two float
# paths differ in summation order only
SCALE_RTOL = 1e-5


def _small_cnn(seed=0):
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


@pytest.fixture(scope="module")
def ref_model():
    return _small_cnn()


@pytest.fixture(scope="module")
def model(ref_model):
    return convert_model(ref_model)


@pytest.fixture(scope="module")
def calib(ref_model):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(ref_model.input_shape).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def ref_qmodel(ref_model, calib):
    scales = R.calibrate_scales(
        ref_model, calib,
        lambda m, x: R.reference_forward(m, x, collect_activations=True)[1])
    return R.quantize_model(ref_model, scales)


@pytest.fixture(scope="module")
def qmodel(ref_qmodel, model):
    return convert_qmodel(ref_qmodel, model)


@pytest.fixture(scope="module")
def plan(model):
    return T.split_model(model, RATINGS, mode="spatial")


@pytest.fixture(scope="module")
def xs(model):
    rng = np.random.default_rng(1)
    return rng.standard_normal((7, *model.input_shape)).astype(np.float32)


def _session(plan, qmodel, **kw):
    return Session(plan, precision="int8", qmodel=qmodel, device="cpu", **kw)


def _engine_ref(plan, qmodel, xs):
    return T.CompiledSplitExecutor(plan, qmodel, device="cpu").run_batch(
        xs, mode="int8")


class TestServing:
    @pytest.mark.parametrize("mode", ["spatial", "kernel", "neuron"])
    def test_submit_many_equals_run_batch_and_reference(
            self, ref_model, model, ref_qmodel, qmodel, xs, mode):
        plan = T.split_model(model, RATINGS, mode=mode)
        session = _session(plan, qmodel, max_batch=4, buckets=(1, 2, 4))
        got = session.submit_many(xs)
        np.testing.assert_array_equal(got, _engine_ref(plan, qmodel, xs))
        ref = RefSession(R.split_model(ref_model, RATINGS, mode=mode),
                         precision="int8", qmodel=ref_qmodel, max_batch=4,
                         buckets=(1, 2, 4)).submit_many(xs)
        assert got.dtype == ref.dtype == np.int8
        np.testing.assert_array_equal(got, ref)

    def test_run_is_bucket_one(self, plan, qmodel, xs):
        session = _session(plan, qmodel)
        np.testing.assert_array_equal(session.run(xs[0]),
                                      _engine_ref(plan, qmodel, xs[:1])[0])
        assert session.stats().per_bucket == {1: 1}

    def test_float_precision_close_to_reference(self, ref_model, plan, xs):
        got = Session(plan, precision="float", device="cpu").submit_many(xs)
        ref = RefSession(R.split_model(ref_model, RATINGS, mode="spatial"),
                         precision="float").submit_many(xs)
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    def test_submit_flush_tickets(self, plan, qmodel, xs):
        session = _session(plan, qmodel, max_batch=4)
        tickets = [session.submit(x) for x in xs[:5]]
        assert session.n_pending == 5
        assert session.flush() == 5
        ref = _engine_ref(plan, qmodel, xs[:5])
        for t, r in zip(tickets, ref):
            assert t.done()
            np.testing.assert_array_equal(t.result(timeout=1.0), r)
        assert session.flush() == 0

    def test_ticket_result_flushes_on_demand(self, plan, qmodel, xs):
        session = _session(plan, qmodel)
        t = session.submit(xs[3])
        np.testing.assert_array_equal(t.result(),
                                      _engine_ref(plan, qmodel, xs[3:4])[0])
        assert t.completed_at > 0 and session.n_pending == 0

    def test_dispatch_async_defers_the_host_copy(self, plan, qmodel, xs):
        session = _session(plan, qmodel, max_batch=4, buckets=(4,))
        inflight = session.dispatch_async(xs[:3])
        assert (inflight.n_requests, inflight.bucket) == (3, 4)
        assert session.stats().batches == 0        # recorded on wait()
        out = inflight.wait()
        assert out.shape[0] == 3 and inflight.wait() is out
        np.testing.assert_array_equal(out, _engine_ref(plan, qmodel, xs[:3]))
        assert session.stats().padded == 1

    def test_replan_keeps_output_and_reuses_constants(self, model, plan,
                                                      qmodel, xs):
        session = _session(plan, qmodel, max_batch=4)
        first = session.submit_many(xs)
        session.replan(T.split_model(model, RATINGS, mode="kernel"))
        np.testing.assert_array_equal(session.submit_many(xs), first)
        hits = T.CompiledSplitExecutor.cache_stats()["hits"]
        session.replan(T.split_model(model, RATINGS, mode="spatial"))
        np.testing.assert_array_equal(session.submit_many(xs), first)
        assert T.CompiledSplitExecutor.cache_stats()["hits"] == hits + 1


class TestTicketsAndFailures:
    def test_detached_ticket_timeout_raises(self):
        t = Ticket()
        with pytest.raises(TimeoutError, match="unfulfilled"):
            t.result(timeout=0.02)
        assert not t.done() and np.isnan(t.completed_at)

    def test_poisoned_dispatch_rejects_all_pending_tickets(
            self, plan, qmodel, xs, monkeypatch):
        session = _session(plan, qmodel, max_batch=4)
        tickets = [session.submit(x) for x in xs[:3]]
        boom = RuntimeError("poisoned input blew up the batch")
        monkeypatch.setattr(session.engine, "run_batch_async",
                            lambda *a, **k: (_ for _ in ()).throw(boom))
        with pytest.raises(RuntimeError, match="poisoned"):
            session.flush()
        for t in tickets:
            assert t.done() and t.exception() is boom
            with pytest.raises(RuntimeError, match="poisoned"):
                t.result(timeout=1.0)
        monkeypatch.undo()
        assert session.n_pending == 0
        good = session.submit(xs[0])
        np.testing.assert_array_equal(good.result(timeout=60.0),
                                      _engine_ref(plan, qmodel, xs[:1])[0])

    def test_submit_during_dispatch_lands_in_next_flush(self, plan, qmodel,
                                                        xs, monkeypatch):
        session = _session(plan, qmodel, max_batch=4)
        first = [session.submit(x) for x in xs[:2]]
        real = session.engine.run_batch_async
        late = []

        def submit_mid_dispatch(batch, mode):
            if not late:
                late.append(session.submit(xs[2]))
            return real(batch, mode=mode)

        monkeypatch.setattr(session.engine, "run_batch_async",
                            submit_mid_dispatch)
        assert session.flush() == 2
        assert not late[0].done() and session.n_pending == 1
        assert session.flush() == 1
        ref = _engine_ref(plan, qmodel, xs[:3])
        for t, r in zip(first + late, ref):
            np.testing.assert_array_equal(t.result(), r)


class TestStatsAndBuckets:
    def test_stats_account_requests_and_padding(self, plan, qmodel, xs):
        session = _session(plan, qmodel, max_batch=4, buckets=(1, 2, 4))
        assert [session.bucket_for(n) for n in (1, 2, 3, 4, 9)] == [
            1, 2, 4, 4, 4]
        s0 = session.stats()
        assert np.isnan(s0.latency_p50_s) and s0.per_bucket_p50_s == {}
        session.submit_many(xs)             # 7 -> buckets 4 + 4 (pad 1)
        s = session.stats()
        assert (s.requests, s.batches, s.padded) == (7, 2, 1)
        assert s.per_bucket == {4: 2} and s.transport == "serial"
        assert s.latency_p99_s >= s.latency_p50_s > 0
        assert session.dispatch_latency_s(bucket=4) == s.per_bucket_p50_s[4]
        assert np.isnan(session.dispatch_latency_s(bucket=2))

    def test_flush_of_more_than_max_bucket_chunks(self, plan, qmodel, xs):
        session = _session(plan, qmodel, max_batch=2, buckets=(1, 2))
        tickets = [session.submit(x) for x in xs[:5]]
        assert session.flush() == 5
        ref = _engine_ref(plan, qmodel, xs[:5])
        for t, r in zip(tickets, ref):
            np.testing.assert_array_equal(t.result(), r)
        s = session.stats()
        assert s.batches == 3 and s.per_bucket == {2: 2, 1: 1}

    def test_rolling_latency_percentiles(self):
        rl = RollingLatency(window=4)
        vals = [0.5, 0.1, 0.4, 0.2, 0.3]
        rl.record_many(vals[:2], key=1)
        rl.record_many(vals[2:], key=2)
        assert len(rl) == 4                          # window keeps the last 4
        assert rl.percentile(50) == float(np.percentile(vals[1:], 50))
        assert rl.percentile(99, key=2) == float(np.percentile(vals[2:], 99))
        assert set(rl.keys()) == {1, 2}
        assert np.isnan(RollingLatency().percentile(50))

    def test_empty_batch_keeps_output_shape_and_dtype(self, plan, qmodel,
                                                      model):
        out = _session(plan, qmodel).submit_many(
            np.zeros((0, *model.input_shape), np.float32))
        assert out.shape == (0, *model.out_shape) and out.dtype == np.int8

    def test_warmup_serves_every_bucket(self, plan, qmodel):
        session = _session(plan, qmodel, max_batch=4, buckets=(1, 2, 4))
        session.warmup()
        assert session.stats().batches == 0       # warmup is not traffic


class TestValidation:
    def test_rejects_bad_arguments(self, plan, qmodel, xs):
        with pytest.raises(ValueError, match="precision"):
            Session(plan, precision="fp16", device="cpu")
        session = _session(plan, qmodel)
        with pytest.raises(ValueError, match="shape"):
            session.submit(xs[0][:, :5])
        with pytest.raises(ValueError, match="batch shape"):
            session.submit_many(xs[0])
        with pytest.raises(TypeError, match="SplitPlan"):
            Session(object(), device="cpu")

    def test_planner_plan_and_distributed_wait_for_later_slices(
            self, plan, qmodel):
        class PlannerPlan:          # what a repro.api.Plan looks like
            split = plan
        with pytest.raises(NotImplementedError, match="planner slice"):
            Session(PlannerPlan(), qmodel=qmodel, device="cpu")
        with pytest.raises(NotImplementedError, match="runtime slice"):
            _session(plan, qmodel).distributed()

    def test_no_device_raises_without_cuda(self, plan, qmodel, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(plan, qmodel=qmodel)


class TestCalibration:
    def test_own_calibration_close_to_reference(self, ref_model, model,
                                                calib):
        ours = Session(T.split_model(model, RATINGS), calibration=calib,
                       device="cpu").qmodel
        ref = RefSession(R.split_model(ref_model, RATINGS),
                         calibration=calib).qmodel
        np.testing.assert_allclose(ours.input_scale, ref.input_scale,
                                   rtol=SCALE_RTOL)
        for a, b in zip(ours.layers, ref.layers):
            np.testing.assert_allclose([a.in_scale, a.out_scale],
                                       [b.in_scale, b.out_scale],
                                       rtol=SCALE_RTOL)
            if b.w_q is not None:
                np.testing.assert_array_equal(a.w_q, b.w_q)
                # b_q = round(bias / (s_in * w_s)): a scale that differs in
                # its last bits can move a rounding by one
                assert np.max(np.abs(a.b_q - b.b_q)) <= 1
