"""The port's multi-tenant serving layer (``repro_torch.serve``) on the CPU.

Every case of the reference's ``tests/test_serve.py`` runs here against the
port with ``device="cpu"`` and the same fixtures and tolerances
(``small_cnn`` converted into the port, a ``[2.0, 1.0]`` split): the
continuous-batching server must be bit-exact vs ``Session.run`` per request
regardless of batch composition, admission control must shed with typed
``Overloaded`` (never by collapsing queues), failures must stay isolated to
the batch that raised, and the QoS monitor / load generator must report what
actually happened.  ``TestAgainstReference`` then holds the port against the
reference package itself: both servers serve one reference
``QuantizedModel`` (carried over by ``convert_qmodel``) byte for byte, and
the scheduler, admission and QoS policies make the same decisions and
report the same numbers over one scripted event sequence with an injected
clock."""
import collections
import dataclasses
import math
import threading
import time

import numpy as np
import pytest

import repro.api.session as ref_session
import repro.core as R
import repro.serve as ref_serve
import repro.serve.scheduler as ref_scheduler
from conftest import small_cnn

import repro_torch.api.session as port_session
import repro_torch.core as T
import repro_torch.serve as port_serve
import repro_torch.serve.scheduler as port_scheduler
from repro_torch.api import Session
from repro_torch.convert import convert_model, convert_qmodel
from repro_torch.serve import (SLO, AdmissionController, EdfBatcher,
                               Overloaded, QosMonitor, Server, run_open_loop,
                               saturation_throughput)
from repro_torch.serve.scheduler import make_request

# threaded server + wall-clock SLO assertions: keep the module on one xdist
# worker (serial group) so parallel cells don't skew its timing
pytestmark = pytest.mark.xdist_group("runtime")
CPU = "cpu"


@pytest.fixture(scope="module")
def ref_model():
    return small_cnn()


@pytest.fixture(scope="module")
def model(ref_model):
    return convert_model(ref_model)


@pytest.fixture(scope="module")
def split(model):
    return T.split_model(model, np.asarray([2.0, 1.0]))


@pytest.fixture(scope="module")
def xs(model):
    rng = np.random.default_rng(3)
    return np.stack([rng.standard_normal(model.input_shape).astype(np.float32)
                     for _ in range(12)])


def _server(split, n_tenants=1, slo=None, **kw):
    srv = Server(**kw)
    for i in range(n_tenants):
        srv.add_tenant(f"t{i}", split, precision="int8", seed=0,
                       max_batch=4, buckets=(1, 2, 4), slo=slo, device=CPU)
    return srv


def _prefill(srv, tenant, xs):
    """Queue requests with the scheduler not yet running (white-box: the
    admitted-but-unscheduled state), returning their tickets."""
    srv._running = True
    tickets = [srv.submit(tenant, x) for x in xs]
    srv._running = False
    return tickets


class TestServerBitexact:
    def test_single_tenant_matches_session_run(self, split, xs):
        ref = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        srv = _server(split)
        with srv:
            for x in xs[:5]:
                assert np.array_equal(srv.run("t0", x, timeout=60.0),
                                      ref.run(x))

    def test_batched_requests_match_per_request_session(self, split, xs):
        """Whatever micro-batch a request rides in, its output is the
        bucket-padded vmapped plan's — identical to a lone Session.run."""
        ref = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        srv = _server(split)
        tickets = _prefill(srv, "t0", xs)      # forces multi-request batches
        with srv:
            outs = [t.result(timeout=60.0) for t in tickets]
        for x, y in zip(xs, outs):
            assert np.array_equal(y, ref.run(x))

    def test_two_tenants_isolated_and_bitexact(self, model, split, xs):
        other = T.split_model(model, np.ones(3), mode="kernel")
        ref_a = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        ref_b = Session(other, precision="int8", seed=0, max_batch=4,
                        device=CPU)
        srv = Server()
        srv.add_tenant("a", split, precision="int8", seed=0, max_batch=4,
                       device=CPU)
        srv.add_tenant("b", other, precision="int8", seed=0, max_batch=4,
                       device=CPU)
        with srv:
            ta = [srv.submit("a", x) for x in xs[:4]]
            tb = [srv.submit("b", x) for x in xs[:4]]
            for x, t in zip(xs, ta):
                assert np.array_equal(t.result(timeout=60.0), ref_a.run(x))
            for x, t in zip(xs, tb):
                assert np.array_equal(t.result(timeout=60.0), ref_b.run(x))


class TestContinuousBatching:
    def test_queued_requests_form_micro_batches(self, split, xs):
        """A backlog drains in bucket-sized dispatches, not one-by-one."""
        srv = _server(split)
        tickets = _prefill(srv, "t0", xs)      # 12 queued, max_batch 4
        with srv:
            for t in tickets:
                t.result(timeout=60.0)
        st = srv.session("t0").stats()
        assert st.requests == len(xs)
        assert st.batches <= math.ceil(len(xs) / 4) + 1
        assert st.batches < len(xs)

    def test_partial_batch_only_when_device_idle(self, split, xs):
        """The bucket-filling rule: while a dispatch is in flight, only a
        full max_batch queue may form the next batch."""
        srv = _server(split)
        sess = srv.session("t0")
        reqs = [make_request(x, "t0", 0.0, SLO()) for x in xs[:2]]
        srv._tenants["t0"].queue.extend(reqs)
        # full_only (something in flight): 2 < max_batch -> no batch
        assert srv._form_batch(full_only=True) is None
        assert len(srv._tenants["t0"].queue) == 2
        # idle device: the partial pair dispatches immediately
        tenant, taken = srv._form_batch(full_only=False)
        assert tenant.session is sess and len(taken) == 2

    def test_responses_fifo_per_tenant(self, split, xs):
        srv = _server(split)
        tickets = _prefill(srv, "t0", xs)
        with srv:
            for t in tickets:
                t.result(timeout=60.0)
        stamps = [t.completed_at for t in tickets]
        assert stamps == sorted(stamps)


class TestAdmissionControl:
    def test_queue_cap_sheds_typed(self, split, xs):
        srv = _server(split, slo=SLO(p99_target_s=None, queue_cap=2))
        srv._running = True
        srv.submit("t0", xs[0])
        srv.submit("t0", xs[1])
        with pytest.raises(Overloaded) as ei:
            srv.submit("t0", xs[2])
        assert ei.value.reason == "queue_cap"
        assert ei.value.tenant == "t0"
        assert ei.value.queue_depth == 2
        # shed, not collapsed: the queued requests are still queued
        assert srv.queue_depth("t0") == 2
        assert srv.stats("t0").rejected == 1

    def test_slo_sheds_on_predicted_delay(self, split, xs):
        srv = _server(split, slo=SLO(p99_target_s=0.05, queue_cap=None))
        sess = srv.session("t0")
        # seed the rolling service-time estimate: 10 s per max_batch bucket
        sess._record_dispatch(4, 4, 10.0)
        srv._running = True
        for i in range(4):        # queue_depth 0..3 -> 0 full batches ahead
            srv.submit("t0", xs[i])
        with pytest.raises(Overloaded) as ei:
            srv.submit("t0", xs[4])   # 4 queued -> 1 batch ahead -> 10 s
        assert ei.value.reason == "slo"
        assert ei.value.predicted_delay_s == pytest.approx(10.0)
        assert ei.value.p99_target_s == pytest.approx(0.05)

    def test_cold_tenant_admits_until_cap(self, split, xs):
        """Before any dispatch is measured the SLO gate cannot predict, so
        only the model-free queue cap holds."""
        srv = _server(split, slo=SLO(p99_target_s=1e-9, queue_cap=3))
        srv._running = True
        for i in range(3):
            srv.submit("t0", xs[i])
        with pytest.raises(Overloaded) as ei:
            srv.submit("t0", xs[3])
        assert ei.value.reason == "queue_cap"

    def test_predicted_delay_math(self):
        class FakeMonitor:
            def service_time_s(self, tenant, bucket=None):
                return 0.5

        ctl = AdmissionController(FakeMonitor())
        assert ctl.predicted_delay_s(
            "t", queue_depth=0, inflight_batches=0, max_batch=8) == 0.0
        assert ctl.predicted_delay_s(
            "t", queue_depth=7, inflight_batches=0, max_batch=8) == 0.0
        assert ctl.predicted_delay_s(
            "t", queue_depth=8, inflight_batches=0, max_batch=8) == 0.5
        assert ctl.predicted_delay_s(
            "t", queue_depth=20, inflight_batches=2, max_batch=8) \
            == pytest.approx((2 + 2) * 0.5)

    def test_service_estimate_cached_within_ttl(self):
        calls = []

        class CountingMonitor:
            def service_time_s(self, tenant, bucket=None):
                calls.append(tenant)
                return 0.25

        now = [0.0]
        ctl = AdmissionController(CountingMonitor(), cache_ttl_s=1.0,
                                  clock=lambda: now[0])
        for _ in range(5):
            ctl.predicted_delay_s("t", queue_depth=16, inflight_batches=0,
                                  max_batch=8)
        assert len(calls) == 1          # cached within the TTL
        now[0] = 2.0
        ctl.predicted_delay_s("t", queue_depth=16, inflight_batches=0,
                              max_batch=8)
        assert len(calls) == 2          # refreshed after expiry

    def test_slo_validation(self):
        with pytest.raises(ValueError):
            SLO(p99_target_s=0.0)
        with pytest.raises(ValueError):
            SLO(queue_cap=0)
        SLO(p99_target_s=None, queue_cap=None)   # both gates off is valid


class TestFailureIsolation:
    def test_poisoned_batch_rejects_only_its_tickets(self, split, xs):
        srv = Server()
        srv.add_tenant("good", split, precision="int8", seed=0, max_batch=4,
                       device=CPU)
        srv.add_tenant("bad", split, precision="int8", seed=0, max_batch=4,
                       device=CPU)
        boom = RuntimeError("poisoned dispatch")

        def raising_dispatch(batch):
            raise boom

        srv.session("bad").dispatch_async = raising_dispatch
        ref = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        with srv:
            tb = [srv.submit("bad", x) for x in xs[:3]]
            tg = [srv.submit("good", x) for x in xs[:3]]
            for t in tb:
                with pytest.raises(RuntimeError, match="poisoned"):
                    t.result(timeout=60.0)
                assert t.exception() is boom
            # the good tenant was never disturbed
            for x, t in zip(xs, tg):
                assert np.array_equal(t.result(timeout=60.0), ref.run(x))
            assert srv.running
        assert srv.stats("bad").failed == 3
        assert srv.stats("good").failed == 0


class TestLifecycle:
    def test_stop_drain_serves_everything_admitted(self, split, xs):
        srv = _server(split)
        tickets = _prefill(srv, "t0", xs[:6])
        srv.start()
        srv.stop(drain=True)
        for t in tickets:
            assert t.done()
            assert t.result(timeout=0.1) is not None

    def test_stop_without_drain_rejects_queued(self, split, xs):
        srv = _server(split)
        tickets = _prefill(srv, "t0", xs[:6])
        srv.start()
        srv.stop(drain=False)
        shed = sum(1 for t in tickets if t.exception() is not None)
        served = sum(1 for t in tickets if t.exception() is None)
        assert shed + served == 6
        assert shed > 0 or served == 6  # a fast scheduler may win the race
        for t in tickets:
            if t.exception() is not None:
                assert isinstance(t.exception(), Overloaded)
                assert t.exception().reason == "shutdown"

    def test_submit_when_not_running_raises(self, split, xs):
        srv = _server(split)
        with pytest.raises(RuntimeError, match="not running"):
            srv.submit("t0", xs[0])

    def test_tenancy_is_static_and_named(self, split):
        srv = _server(split)
        with pytest.raises(ValueError, match="duplicate"):
            srv.add_tenant("t0", split, device=CPU)
        with pytest.raises(KeyError, match="unknown tenant"):
            srv.session("nope")
        with srv:
            with pytest.raises(RuntimeError, match="tenancy is static"):
                srv.add_tenant("late", split, device=CPU)

    def test_start_with_no_tenants_raises(self):
        with pytest.raises(RuntimeError, match="no tenants"):
            Server().start()

    def test_input_validated_before_admission(self, split, xs):
        srv = _server(split, slo=SLO(p99_target_s=None, queue_cap=1))
        with srv:
            with pytest.raises(ValueError, match="shape"):
                srv.submit("t0", xs[0][:, :2, :])
        # the malformed request was never counted against the tenant
        assert srv.stats("t0").submitted == 0


class TestQosMonitor:
    def test_percentiles_and_counters(self):
        now = [0.0]
        mon = QosMonitor(window=64, clock=lambda: now[0])
        lat = [0.01 * (i + 1) for i in range(10)]
        for _ in lat:
            mon.on_submit("t")
            mon.on_admit("t")
        mon.on_complete_batch("t", lat[:6])
        now[0] = 1.0
        for v in lat[6:]:
            mon.on_complete("t", v)
        q = mon.snapshot("t", queue_depth=2, inflight=1)
        assert q.submitted == q.accepted == q.completed == 10
        assert q.latency_p50_s == pytest.approx(np.percentile(lat, 50))
        assert q.latency_p99_s == pytest.approx(np.percentile(lat, 99))
        assert q.queue_depth == 2 and q.inflight == 1
        # 10 completions spanning 1 s of fake clock -> 9 intervals / 1 s
        assert q.throughput_rps == pytest.approx(9.0)
        assert "t" in mon.tenants()
        assert "p50" in q.describe()

    def test_service_time_delegates_to_session(self, split):
        mon = QosMonitor()
        assert math.isnan(mon.service_time_s("t"))
        sess = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        mon.register_session("t", sess)
        assert math.isnan(mon.service_time_s("t"))          # cold
        sess._record_dispatch(4, 4, 0.125)
        assert mon.service_time_s("t", bucket=4) == pytest.approx(0.125)
        # falls back to the all-bucket window for unmeasured buckets
        assert mon.service_time_s("t", bucket=2) == pytest.approx(0.125)

    def test_rejection_rate(self):
        mon = QosMonitor()
        for _ in range(3):
            mon.on_submit("t")
        mon.on_admit("t")
        mon.on_reject("t")
        mon.on_reject("t")
        q = mon.snapshot("t")
        assert q.rejection_rate == pytest.approx(2 / 3)


class TestEdfBatcher:
    def test_earliest_deadline_tenant_wins(self):
        b = EdfBatcher()
        qa = collections.deque([make_request(None, "a", 5.0, SLO(1.0))])
        qb = collections.deque([make_request(None, "b", 1.0, SLO(1.0))])
        assert b.select({"a": qa, "b": qb}) == "b"   # older arrival first
        tight = collections.deque(
            [make_request(None, "c", 5.5, SLO(0.01))])
        assert b.select({"a": qa, "c": tight}) == "c"  # tighter SLO wins
        assert b.select({"a": collections.deque()}) is None

    def test_take_preserves_fifo(self):
        b = EdfBatcher()
        q = collections.deque(
            make_request(i, "a", float(i), SLO(1.0)) for i in range(6))
        taken = b.take(q, 4)
        assert [r.x for r in taken] == [0, 1, 2, 3]
        assert len(q) == 2 and q[0].x == 4

    def test_no_slo_target_means_infinite_deadline(self):
        r = make_request(None, "a", 2.0, SLO(p99_target_s=None))
        assert math.isinf(r.deadline)


class TestLoadgen:
    def test_open_loop_reports(self, split, xs):
        srv = _server(split)
        with srv:
            reports = run_open_loop(srv, {"t0": 50.0}, lambda: xs[0],
                                    duration_s=0.4, seed=0,
                                    result_timeout_s=60.0)
        rep = reports["t0"]
        assert rep.submitted > 0
        assert rep.accepted + rep.rejected == rep.submitted
        assert rep.completed == rep.accepted and rep.failed == 0
        assert rep.p50_s > 0 and rep.p99_s >= rep.p50_s
        assert rep.throughput_rps > 0
        assert "t0" in rep.describe()

    def test_open_loop_requires_running_server(self, split):
        srv = _server(split)
        with pytest.raises(RuntimeError, match="started"):
            run_open_loop(srv, {"t0": 10.0}, lambda: None, duration_s=0.1)

    def test_saturation_throughput_positive(self, split, xs):
        srv = _server(split)
        with srv:
            rate = saturation_throughput(srv, "t0", lambda: xs[0],
                                         n_requests=16, repeats=1)
        assert rate > 0

    def test_overload_sheds_and_bounds_accepted_tail(self, split, xs):
        """End-to-end admission story: a tight SLO under a hopeless offered
        rate sheds most load while every accepted request is still served."""
        srv = _server(split, slo=SLO(p99_target_s=0.02, queue_cap=4))
        with srv:
            reports = run_open_loop(srv, {"t0": 2000.0}, lambda: xs[0],
                                    duration_s=0.5, seed=0,
                                    result_timeout_s=60.0)
        rep = reports["t0"]
        assert rep.rejected > 0
        assert rep.completed == rep.accepted     # shed != dropped-after-admit
        assert rep.failed == 0


class TestSharedCache:
    def test_tenants_share_executable_cache(self, split):
        before = Server.cache_stats()["hits"]
        srv = Server()
        srv.add_tenant("a", split, precision="int8", seed=0, max_batch=4,
                       buckets=(1, 4), device=CPU)
        srv.add_tenant("b", split, precision="int8", seed=0, max_batch=4,
                       buckets=(1, 4), device=CPU)
        assert Server.cache_stats()["hits"] > before


class TestConcurrentClients:
    def test_many_threads_submit_concurrently(self, split, xs):
        srv = _server(split)
        ref = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        expected = [ref.run(x) for x in xs[:4]]
        errors = []

        def client(i):
            try:
                for _ in range(3):
                    y = srv.run("t0", xs[i % 4], timeout=60.0)
                    assert np.array_equal(y, expected[i % 4])
            except Exception as e:  # noqa: BLE001 — re-raised on the main thread
                errors.append(e)

        with srv:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert not errors
        st = srv.stats("t0")
        assert st.completed == 24
        assert st.latency_p50_s > 0

    def test_run_convenience_roundtrip(self, split, xs):
        srv = _server(split)
        ref = Session(split, precision="int8", seed=0, max_batch=4,
                      device=CPU)
        with srv:
            assert np.array_equal(srv.run("t0", xs[0], timeout=60.0),
                                  ref.run(xs[0]))


class TestTicketTimeout:
    def test_detached_ticket_times_out(self):
        from repro_torch.api import Ticket
        t = Ticket()
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
        assert time.perf_counter() - t0 < 5.0
        assert not t.done()


def _policy_script(serve, scheduler, session_mod, seed: int) -> list:
    """Drive one package's ``EdfBatcher``, ``AdmissionController`` and
    ``QosMonitor`` through the scripted event sequence of ``seed`` with an
    injected clock; return every decision and number they gave."""
    now = [0.0]

    def clock():
        return now[0]

    class _Session:
        """Stand-in session: dispatch latencies through the package's own
        ``RollingLatency``, keyed by bucket."""

        def __init__(self):
            self.rolling = session_mod.RollingLatency(8)

        def dispatch_latency_s(self, bucket=None, q=50.0):
            return self.rolling.percentile(q, key=bucket)

    tenants = ("a", "b", "c")
    slos = {"a": serve.SLO(p99_target_s=0.05, queue_cap=6),
            "b": serve.SLO(p99_target_s=None, queue_cap=3),
            "c": serve.SLO(p99_target_s=0.02, queue_cap=None)}
    mon = serve.QosMonitor(window=16, clock=clock)
    ctl = serve.AdmissionController(mon, cache_ttl_s=0.01, clock=clock)
    sessions = {t: _Session() for t in tenants}
    for t in tenants:
        mon.register_session(t, sessions[t])
    batcher = serve.EdfBatcher()
    queues = {t: collections.deque() for t in tenants}
    pending = collections.deque()
    inflight = 0
    log = []
    rng = np.random.default_rng(seed)
    for step in range(300):
        now[0] += float(rng.exponential(0.003))
        event = int(rng.integers(0, 5))
        if event <= 1:
            t = tenants[int(rng.integers(0, 3))]
            try:
                ctl.admit(t, slos[t], queue_depth=len(queues[t]),
                          inflight_batches=inflight, max_batch=4)
                queues[t].append(scheduler.make_request(step, t, now[0],
                                                        slos[t]))
                log.append(("admit", t, step))
            except serve.Overloaded as e:
                log.append(("shed", t, e.reason, e.queue_depth,
                            e.predicted_delay_s, e.p99_target_s, str(e)))
        elif event == 2:
            name = batcher.select(queues)
            if name is not None:
                reqs = batcher.take(queues[name], 4)
                inflight += 1
                pending.append((name, reqs, now[0]))
                log.append(("take", name, [r.x for r in reqs],
                            [r.deadline for r in reqs]))
        elif event == 3 and pending:
            name, reqs, t_disp = pending.popleft()
            inflight -= 1
            if rng.random() < 0.1:
                mon.on_failure(name, len(reqs))
            else:
                bucket = min(b for b in (1, 2, 4) if b >= len(reqs))
                sessions[name].rolling.record(now[0] - t_disp, key=bucket)
                mon.on_complete_batch(name, [now[0] - r.t_arrival
                                             for r in reqs])
        else:
            t = tenants[int(rng.integers(0, 3))]
            log.append(("snapshot", dataclasses.astuple(mon.snapshot(
                t, queue_depth=len(queues[t]), inflight=inflight)),
                mon.service_time_s(t, bucket=4)))
    log.append(tuple(dataclasses.astuple(mon.snapshot(t)) for t in tenants))
    return log


class TestAgainstReference:
    @pytest.mark.parametrize("mode", ["neuron", "kernel", "spatial"])
    def test_server_outputs_equal_reference_server(self, ref_model, model,
                                                   xs, mode):
        """One reference ``QuantizedModel`` served by both packages' servers
        (the port's carried over by ``convert_qmodel``): byte for byte."""
        ratings = np.asarray([2.0, 1.0])
        ref_split = R.split_model(ref_model, ratings, mode=mode)
        ref_q = ref_session.Session(ref_split, precision="int8",
                                    seed=0).qmodel
        qmodel = convert_qmodel(ref_q, model)
        outs = []
        for srv, split, qm, kw in (
                (ref_serve.Server(), ref_split, ref_q, {}),
                (Server(), T.split_model(model, ratings, mode=mode), qmodel,
                 dict(device=CPU))):
            srv.add_tenant("t", split, precision="int8", qmodel=qm,
                           max_batch=4, buckets=(1, 2, 4), **kw)
            with srv:
                tickets = [srv.submit("t", x) for x in xs]
                outs.append([np.asarray(t.result(timeout=60.0))
                             for t in tickets])
        for want, got in zip(*outs):
            assert (got.dtype, got.shape) == (want.dtype, want.shape)
            assert got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_policies_decide_as_the_reference(self, seed):
        """EDF selection and batch formation, admission decisions (with the
        Overloaded's reason, state and message) and QoS snapshots are the
        same, number for number, over one scripted event sequence."""
        want = _policy_script(ref_serve, ref_scheduler, ref_session, seed)
        got = _policy_script(port_serve, port_scheduler, port_session, seed)
        assert len(got) == len(want)
        kinds = collections.Counter(e[0] for e in want[:-1])
        assert kinds["take"] and kinds["snapshot"]
        assert {e[2] for e in want[:-1] if e[0] == "shed"} == {"queue_cap",
                                                             "slo"}
        np.testing.assert_equal(got, want)

    def test_one_overloaded_class(self):
        """The elastic runtime and the server shed with the same class."""
        import repro_torch.runtime.replan  # noqa: F401  (its lazy imports)
        from repro_torch.serve.admission import Overloaded as from_admission
        assert Overloaded is from_admission is port_serve.Overloaded
        assert sorted(port_serve.__all__) == sorted(ref_serve.__all__)


class TestPortDevice:
    def test_tenant_without_device_needs_cuda(self, split, monkeypatch):
        """A tenant runs on CUDA unless it is given ``device="cpu"``; with
        no card it raises instead of drifting to the CPU."""
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        srv = Server()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            srv.add_tenant("t0", split, precision="int8", seed=0)
        with pytest.raises(KeyError):
            srv.session("t0")

    def test_float_tenant_within_tolerance(self, split, xs):
        """Float tenants are held at 1e-5 against ``Session.run``: another
        bucket may sum a convolution in another order."""
        ref = Session(split, precision="float", max_batch=4, device=CPU)
        srv = Server()
        srv.add_tenant("f", split, precision="float", max_batch=4,
                       buckets=(1, 2, 4), device=CPU)
        tickets = _prefill(srv, "f", xs)
        with srv:
            outs = [t.result(timeout=60.0) for t in tickets]
        assert srv.session("f").stats().batches < len(xs)
        for x, y in zip(xs, outs):
            want = ref.run(x)
            np.testing.assert_allclose(y, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
