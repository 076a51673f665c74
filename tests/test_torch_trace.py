"""The port's span recorder (``repro_torch.trace``) on the CPU: it records
only while a ``torch.profiler`` runs, in every thread; a ``Session``
dispatch leaves one span of each of its layers, keyed by the dispatch's
id and nested by their intervals; a ``Server`` request leaves its queue
span keyed by its own id; the cap turns spans away into ``dropped``.  The
recorder has no counterpart in the JAX package, so nothing here is held
to it."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.api import Session
from repro_torch.core import split_model
from repro_torch.models import mobilenet_v2_smoke
from repro_torch.serve import Server

RATINGS = np.asarray([1.0, 0.6, 1.4])
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_recorder():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def model():
    return mobilenet_v2_smoke()


@pytest.fixture(scope="module")
def xs(model):
    rng = np.random.default_rng(5)
    return rng.standard_normal((3, *model.input_shape)).astype(np.float32)


@pytest.fixture(scope="module", params=["spatial", "kernel"])
def session(request, model):
    plan = split_model(model, RATINGS, mode=request.param)
    return Session(plan, device="cpu", max_batch=4, buckets=(1, 2, 4))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_gate_reads_the_profiler_in_every_thread():
    """``clock`` is None with no profiler, and a clock reading under one,
    also in a thread started before the profiler."""
    assert trace.clock() is None
    seen = []
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(10)
        seen.append(trace.clock())
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with torch.profiler.profile(activities=CPU_ONLY):
        on = trace.clock()
        go.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    assert isinstance(on, int) and isinstance(seen[0], int)
    assert trace.clock() is None


def test_no_profiler_records_nothing_and_reads_no_clock(session, xs,
                                                        monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read for tracing")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    disp = session.dispatch_async(xs)
    disp.wait()
    monkeypatch.undo()
    assert trace.spans() == [] and trace.dropped() == 0
    assert isinstance(disp.dispatch_id, int)


def test_dispatch_spans_under_the_profiler(session, xs):
    plan = session.split
    want = session.dispatch_async(xs).wait()
    with torch.profiler.profile(activities=CPU_ONLY):
        disp = session.dispatch_async(xs)
        got = disp.wait()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()

    spans = trace.spans()
    names = _by_name(spans)
    assert {n: len(v) for n, v in names.items()} == {
        "session.dispatch": 1, "executor.input": 1, "executor.forward": 1,
        "session.wait": 1, "executor.block": len(plan.block_groups)}
    assert {s[1] for s in spans} == {disp.dispatch_id}

    (_, _, d0, d1, d_attrs), = names["session.dispatch"]
    assert d_attrs == {"n": len(xs), "bucket": 4}
    (_, _, f0, f1, _), = names["executor.forward"]
    (_, _, i0, i1, _), = names["executor.input"]
    assert d0 <= i0 <= i1 <= f0 <= f1 <= d1
    layers = plan.model.layers
    blocks = names["executor.block"]
    for (_, _, b0, b1, attrs), g in zip(blocks, plan.block_groups):
        assert f0 <= b0 <= b1 <= f1
        assert attrs == {
            "first": layers[g[0]].name, "last": layers[g[-1]].name,
            "mode": ("spatial" if plan.splits[g[0]].mode == "spatial"
                     else "flat"),
            "kind": "+".join(layers[i].kind for i in g)}
    assert all(a[3] <= b[2] for a, b in zip(blocks, blocks[1:]))
    (_, _, w0, w1, w_attrs), = names["session.wait"]
    assert d1 <= w0 <= w1 and w_attrs["device_s"] > 0


def test_forward_span_says_the_cpu_walks_the_plan(session, xs):
    """On the CPU the ``executor.forward`` span carries ``graph="eager"``,
    every block group still has its span, no graph is captured or
    replayed, and the traced answer is the untraced one."""
    want = session.dispatch_async(xs).wait()
    before = session.engine.graph_stats()
    with torch.profiler.profile(activities=CPU_ONLY):
        got = session.dispatch_async(xs).wait()
    assert got.tobytes() == want.tobytes()
    names = _by_name(trace.spans())
    (_, _, _, _, attrs), = names["executor.forward"]
    assert attrs == {"graph": "eager"}
    assert len(names["executor.block"]) == len(session.split.block_groups)
    stats = session.engine.graph_stats()
    assert stats["captures"] == stats["replays"] == 0
    assert stats["eager"] == before["eager"] + 1


def test_dispatch_ids_count_up_per_session(session, xs):
    with torch.profiler.profile(activities=CPU_ONLY):
        ids = [session.dispatch_async(xs[:1]) for _ in range(3)]
        for d in ids:
            d.wait()
    ids = [d.dispatch_id for d in ids]
    assert ids == list(range(ids[0], ids[0] + 3))
    keys = [s[1] for s in trace.spans() if s[0] == "session.dispatch"]
    assert keys == ids


def test_server_queue_spans_cross_the_scheduler_thread(model, xs):
    """The server starts before the profiler: its scheduler thread must
    record every request's queue span, keyed by the request's id, with the
    id of the dispatch it rode in."""
    srv = Server(max_inflight=2)
    srv.add_tenant("t", split_model(model, RATINGS, mode="spatial"),
                   device="cpu", max_batch=4, buckets=(1, 2, 4))
    srv.start()
    n = 6
    try:
        with torch.profiler.profile(activities=CPU_ONLY):
            tickets = [srv.submit("t", xs[i % len(xs)]) for i in range(n)]
            for t in tickets:
                t.result(timeout=60)
            srv.stop(drain=True, timeout=60)
    finally:
        srv.stop(drain=False, timeout=60)
    names = _by_name(trace.spans())
    queue = sorted(names["serve.queue"], key=lambda s: s[1])
    assert [s[1] for s in queue] == list(range(n))
    assert all(a[2] <= b[2] for a, b in zip(queue, queue[1:]))
    dispatched = {s[1]: s[4]["n"] for s in names["session.dispatch"]}
    riders = {}
    for _, _, t0, t1, attrs in queue:
        assert t0 <= t1 and attrs["tenant"] == "t"
        riders[attrs["dispatch"]] = riders.get(attrs["dispatch"], 0) + 1
    assert riders == dispatched
    assert {s[1] for s in names["serve.fulfill"]} == set(dispatched)


def test_cap_turns_spans_away():
    rec = trace.Recorder(cap=3)
    for k in range(5):
        rec.record("s", k, 10 * k, 10 * k + 5)
    assert [s[1] for s in rec.spans()] == [0, 1, 2] and rec.dropped == 2
    assert [s[1] for s in rec.spans(10, 25)] == [1, 2]
    assert [s[1] for s in rec.spans(t1_ns=14)] == [0]
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0
    assert trace.RECORDER.cap == trace.CAP == 1_000_000


def test_module_recorder_counts_dropped(monkeypatch):
    monkeypatch.setattr(trace.RECORDER, "cap", 1)
    trace.record("a", 0, 0, 1)
    trace.record("b", 0, 1, 2, {"x": 1})
    assert trace.spans() == [("a", 0, 0, 1, None)] and trace.dropped() == 1
