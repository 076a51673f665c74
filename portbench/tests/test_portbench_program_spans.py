"""The readers of the program's spans (``metrics/_program.py`` and the metrics
built on it), on synthetic spans and device events: the medians, the idle
shares against a brute-force sum over a fine grid, the device events put on
the line fitted to the input copies (or through them piece by piece), the
clock check's lag on the output copies, and None where the clock check
fails, the trace is not aligned, more than a tenth of the input copies are
lost, or the program records no spans."""
from __future__ import annotations

import sys

import numpy as np
import pytest

from repro_torch import trace as program_trace

from portbench.harness import Bench, Run
from portbench.metrics._program import traced
from portbench.trace import Tracer
from portbench.window import Window

from .tiny_bench import ROOT

T0 = 10.0
MS = 1e-3
GAP = 25 * MS           # between the dispatches' starts
BENCH = Bench(ROOT)
NEW = ("engine.forward_ms.offline", "engine.staging_ms.offline",
       "engine.host_us_per_kernel.offline",
       "device.idle_in_forward_share.offline",
       "device.idle_outside_program_share.offline")


def read(name, run):
    return BENCH.code("metrics", name).read(run)


@pytest.fixture(autouse=True)
def _empty_recorder():
    program_trace.clear()
    yield
    program_trace.clear()


def _span(name, key, t0, t1, attrs=None):
    program_trace.record(name, key, round(t0 * 1e9), round(t1 * 1e9), attrs)


def _dispatch(did, t):
    """Dispatch ``did`` enqueued from ``t``: input 2 ms, forward 16 ms in
    two blocks, output 1 ms, then its wait until t + 21.1 ms."""
    _span("session.dispatch", did, t, t + 20 * MS, {"n": 8, "bucket": 8})
    _span("executor.input", did, t, t + 2 * MS)
    _span("executor.forward", did, t + 2 * MS, t + 18 * MS)
    _span("executor.block", did, t + 2 * MS, t + 12 * MS,
          dict(first="stem", last="b1_dw", mode="spatial", kind="conv+dwconv"))
    _span("executor.block", did, t + 12 * MS, t + 18 * MS,
          dict(first="classifier", last="classifier", mode="flat",
               kind="linear"))
    _span("session.output", did, t + 18 * MS, t + 19 * MS)
    _span("session.wait", did, t + 20 * MS, t + 21.1 * MS, {"device_s": 1})


def _events(t):
    """The device events of a dispatch enqueued from ``t``: its input copy
    (enqueued at the end of its input span, starting 20 us before the
    span's end), two kernels inside its forward, its output copy."""
    return [("Memcpy HtoD (Pinned -> Device)", t + 1.98 * MS, t + 2.3 * MS),
            ("qgemm_kernel<64>", t + 10 * MS, t + 11 * MS),
            ("dwconv3x3_kernel<1>", t + 11 * MS, t + 12 * MS),
            ("Memcpy DtoH (Device -> Pinned)", t + 18.5 * MS, t + 18.9 * MS)]


def _starts(n):
    return [T0 + 10 * MS + k * GAP for k in range(n)]


def _run(n=2, drift=0.0, aligned=True, extra_events=(), events=None):
    """``n`` dispatches, ``GAP`` apart from 10 ms into the window; the
    device clock's mapping runs ``drift`` (a share) slow from the window's
    start."""
    starts = _starts(n)
    for did, t in enumerate(starts):
        _dispatch(did, t)
    tracer = Tracer(True, "cpu")
    tracer.t0, tracer.t1 = T0, starts[-1] + 30 * MS
    tracer.done, tracer.aligned = True, aligned
    evs = events if events is not None else [e for t in starts
                                             for e in _events(t)]
    tracer._events = [(n, s - drift * (s - T0), e - drift * (e - T0))
                      for n, s, e in evs] + list(extra_events)
    tracer.dispatches = n
    return Run(trace=tracer, window=Window(t_start=T0))


def _brute_idle_shares(run, events, grid=1e-6):
    """(idle in a forward span, idle in no program span) in % of idle, by
    counting the points of a 1 us grid over the window."""
    ts = np.arange(T0, run.trace.t1, grid) + grid / 2
    busy = np.zeros(len(ts), bool)
    for _, s, e in events:
        busy |= (ts >= s) & (ts < e)
    fwd = np.zeros(len(ts), bool)
    prog = np.zeros(len(ts), bool)
    for n, _, s, e, _ in program_trace.spans():
        inside = (ts >= s / 1e9) & (ts < e / 1e9)
        prog |= inside
        if n == "executor.forward":
            fwd |= inside
    idle = ~busy
    return (100 * (idle & fwd).sum() / idle.sum(),
            100 * (idle & ~prog).sum() / idle.sum())


def test_medians_and_shares_on_an_aligned_trace():
    run = _run()
    assert read("engine.forward_ms.offline", run) == pytest.approx(16.0)
    assert read("engine.staging_ms.offline", run) == pytest.approx(3.0)
    # 16 ms of forward over 2 kernels a dispatch
    assert read("engine.host_us_per_kernel.offline", run) == pytest.approx(
        8000.0)
    p = run._program_traced
    # the events move 20 us later: each input copy onto its span's end
    shifted = [(n, s + 0.02 * MS, e + 0.02 * MS) for n, s, e in
               sorted(run.trace.events, key=lambda ev: ev[1])]
    assert len(p.events) == len(shifted) and all(
        a[0] == b[0] and a[1:] == pytest.approx(b[1:])
        for a, b in zip(p.events, shifted))
    in_fwd, outside = _brute_idle_shares(run, shifted)
    assert read("device.idle_in_forward_share.offline", run) == \
        pytest.approx(in_fwd, abs=0.01)
    assert read("device.idle_outside_program_share.offline", run) == \
        pytest.approx(outside, abs=0.01)
    assert p.lag_s == 0.0 and p.raw_lag_s == 0.0
    assert p.rate == pytest.approx(0.0, abs=1e-9)
    notes = "\n".join(run.window.notes)
    assert "2 dispatches, 2 HtoD and 2 DtoH" in notes
    assert "clock lag 0.0 s" in notes
    assert '["stem", "b1_dw", "spatial", "conv+dwconv", 10000.0]' in notes


def test_a_drifting_device_clock_is_put_back_by_the_fitted_line():
    """A mapping 2% slow puts the eighth dispatch's output copy 3.57 ms
    before its output span starts (the trace's own lag); on the line fitted
    to the input copies, the check holds and the idle shares read as
    without drift."""
    still = _run(n=8)
    want = [read(n, still) for n in NEW[3:]]
    program_trace.clear()
    run = _run(n=8, drift=0.02)
    p = traced(run)
    last = _starts(8)[-1] - T0
    assert p.raw_lag_s == pytest.approx(0.02 * (last + 18.5 * MS) - 0.5 * MS)
    assert p.rate == pytest.approx(0.02 / 0.98)
    assert p.lag_s == pytest.approx(0.0, abs=1e-9) and len(p.matched) == 8
    assert [read(n, run) for n in NEW[3:]] == pytest.approx(want, abs=0.01)


def test_the_line_starts_no_input_copy_after_its_span():
    """Input copies that start 60, 20, 20 and 60 us before their spans'
    ends: the least-squares line would put two of them 20 us after their
    spans; lowered, it puts those two at their spans' ends."""
    starts = _starts(4)
    evs = []
    for k, t in enumerate(starts):
        lead = (20 if k in (1, 2) else 60) * 1e-6
        evs += [(n, s + (0.02 * MS - lead if n.startswith("Memcpy HtoD")
                         else 0), e) for n, s, e in _events(t)]
    run = _run(n=4, events=evs)
    p = traced(run)
    htod = [ev[1] for ev in p.events if ev[0].startswith("Memcpy HtoD")]
    ends = [t + 2 * MS for t in starts]
    assert [h - e for h, e in zip(htod, ends)] == pytest.approx(
        [-40e-6, 0, 0, -40e-6], abs=1e-7)
    assert p.lag_s == 0.0 and p.clock_ok


@pytest.mark.parametrize("spike", [None, 1])
def test_a_kink_of_the_device_clock_is_followed_piece_by_piece(spike):
    """From the fifth of eight input copies on, the device clock runs 8%
    fast: no one line fits, the line through the input copies piece by
    piece puts every event back where it was before the kink (each input
    copy at its span's end) and the idle shares are read; with ``spike``,
    that dispatch's input copy starts 0.3 ms further before its span's end
    than the others, and the piecewise line passes it over."""
    early = 0.3 * MS
    base = [(n, s - early, e - early) if k == spike and n.startswith(
        "Memcpy HtoD") else (n, s, e)
            for k, t in enumerate(_starts(8)) for n, s, e in _events(t)]
    kink = _starts(8)[4] + 1.98 * MS

    def late(t):
        return t + 0.08 * max(0.0, t - kink)

    run = _run(n=8, events=[(n, late(s), late(e)) for n, s, e in base])
    p = traced(run)
    assert p.mapping == "piecewise" and len(p.matched) == 8
    assert p.lag_s == pytest.approx(0.0, abs=1e-9)
    back = sorted((n, s + 0.02 * MS, e + 0.02 * MS) for n, s, e in base)
    assert [ev[0] for ev in sorted(p.events)] == [ev[0] for ev in back]
    assert [x for ev in sorted(p.events) for x in ev[1:]] == pytest.approx(
        [x for ev in back for x in ev[1:]])
    assert None not in [read(n, run) for n in NEW[3:]]


def test_a_step_of_the_device_clock_fails_the_check():
    """The device clock jumps 2 ms early between the fourth and fifth of
    eight input copies: neither one line nor the line through the input
    copies piece by piece puts the fourth output copy inside its span, and
    the idle shares read nothing."""
    step = _starts(8)[4] - MS

    def early(t):
        return t - (2 * MS if t > step else 0)

    evs = [(n, early(s), early(e)) for t in _starts(8)
           for n, s, e in _events(t)]
    run = _run(n=8, events=evs)
    p = traced(run)
    # on the trace's own mapping: output copies 1.5 ms before their spans
    assert p.raw_lag_s == pytest.approx(1.5 * MS)
    assert len(p.matched) == 8 and p.lag_s > 1e-4
    assert [read(n, run) for n in NEW[3:]] == [None, None]
    assert read("engine.forward_ms.offline", run) == pytest.approx(16.0)


def test_clock_check_fails_where_an_output_ends_after_its_wait():
    """An output copy that ends 0.2 ms after its wait, once the events are
    shifted: the idle shares read nothing; the spans' medians still do."""
    evs = [e for t in _starts(2) for e in _events(t)]
    evs = [(n, s, e + (2.38 * MS if n.startswith("Memcpy DtoH") else 0))
           for n, s, e in evs]
    run = _run(events=evs)
    assert read("engine.forward_ms.offline", run) == pytest.approx(16.0)
    assert run._program_traced.lag_s == pytest.approx(0.2 * MS)
    assert [read(n, run) for n in NEW[3:]] == [None, None]


def test_a_copy_queued_behind_device_work_is_left_out_of_the_fit():
    """The second input copy starts right after a kernel still running:
    it may have waited in the stream, so the line is fitted to the first
    copy alone and moves the second as it moves the first."""
    t0, t1 = _starts(2)
    evs = _events(t0) + [
        ("qgemm_kernel<64>", t1 + 1.5 * MS, t1 + 2.29 * MS),
        ("Memcpy HtoD (Pinned -> Device)", t1 + 2.3 * MS, t1 + 2.6 * MS)
    ] + _events(t1)[1:]
    run = _run(events=evs)
    p = traced(run)
    htod = [ev for ev in p.events if ev[0].startswith("Memcpy HtoD")]
    assert htod[1][1] == pytest.approx(t1 + 2.32 * MS)
    assert p.rate == 0.0 and len(p.matched) == 2 and p.lag_s == 0.0


def test_idle_shares_need_an_aligned_trace():
    run = _run(aligned=False)
    assert read("engine.forward_ms.offline", run) == pytest.approx(16.0)
    assert [read(n, run) for n in NEW[3:]] == [None, None]


def test_an_extra_copy_is_passed_over():
    run = _run(extra_events=[("Memcpy HtoD (Pageable -> Device)",
                              T0 + 3 * MS, T0 + 4 * MS)])
    p = traced(run)
    assert len(p.matched) == 2 and p.lag_s == 0.0
    assert None not in [read(n, run) for n in NEW]


@pytest.mark.parametrize("lost,reads", [((5,), True), ((3, 6), False)])
def test_lost_copies(lost, reads):
    """Input copies the profiler lost: their dispatches take the shift of
    the dispatch before; with more than a tenth of them lost the idle
    shares read nothing."""
    starts = _starts(10)
    evs = [e for k, t in enumerate(starts) for e in _events(t)
           if not (k in lost and e[0].startswith("Memcpy HtoD"))]
    run = _run(n=10, events=evs)
    p = traced(run)
    assert len(p.matched) == 10 - len(lost) and p.lag_s == 0.0
    idle = [read(n, run) for n in NEW[3:]]
    assert (None not in idle) if reads else idle == [None, None]
    assert read("engine.forward_ms.offline", run) == pytest.approx(16.0)


def test_none_without_trace_spans_or_program(monkeypatch):
    untraced = Run(trace=None, window=Window(t_start=T0))
    assert [read(n, untraced) for n in NEW] == [None] * len(NEW)
    empty = _run()
    program_trace.clear()
    assert [read(n, empty) for n in NEW] == [None] * len(NEW)
    # a program without the recorder (the parent commit's)
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace")
    assert [read(n, _run()) for n in NEW] == [None] * len(NEW)


def test_queue_p95_reads_the_servers_queue_spans():
    for rid in range(100):
        _span("serve.queue", rid, T0 + rid * 0.5 * MS,
              T0 + rid * 0.5 * MS + (rid + 1) * 0.01 * MS, {"dispatch": 0})
    run = _run()
    want = np.percentile([(r + 1) * 0.01 for r in range(100)], 95)
    assert read("serve.queue_p95_ms", run) == pytest.approx(want)
    assert read("serve.queue_p95_ms",
                Run(trace=None, window=Window(t_start=T0))) is None


def test_fulfill_and_service_read_the_servers_batches():
    """``serve.fulfill_ms``: the median fulfilment span; ``serve.service_ms``:
    the median ``device_s`` of the batches that carried server requests
    (dispatch 0 and 1 here; a session dispatch of no request is left out)."""
    run = _run()
    for rid in range(4):
        _span("serve.queue", rid, T0, T0 + MS, {"dispatch": rid // 2})
    for did, ms in enumerate((0.2, 0.4, 0.9)):
        _span("serve.fulfill", did, T0 + 40 * MS, T0 + (40 + ms) * MS)
    _span("session.wait", 5, T0 + 50 * MS, T0 + 51 * MS, {"device_s": 9.0})
    assert read("serve.fulfill_ms", run) == pytest.approx(0.4)
    # the synthetic dispatches 0 and 1 record device_s 1 (second)
    assert read("serve.service_ms", run) == pytest.approx(1000.0)
    untraced = Run(trace=None, window=Window(t_start=T0))
    assert read("serve.fulfill_ms", untraced) is None
    assert read("serve.service_ms", untraced) is None
    program_trace.clear()
    assert read("serve.fulfill_ms", _run()) is None
    assert read("serve.service_ms", _run()) is None


PERIOD = 1.5 * MS       # a batch of the graph case, host and device alike


def _graph_run(n=8, drift=0.0):
    """``n`` dispatches of the graph case, ``PERIOD`` apart: dispatch k's
    upload (its own stream) starts 20 us before its input span ends, while
    dispatch k-1's last kernel still runs; its four kernels follow the
    output copy of k-1, which lands before k's output span starts; its
    output copy starts after its compute and is waited for once k+1 is
    enqueued.  The device clock's mapping runs ``drift`` slow."""
    starts = [T0 + 10 * MS + k * PERIOD for k in range(n)]
    evs = []
    for did, t in enumerate(starts):
        _span("session.dispatch", did, t, t + 0.9 * MS, {"n": 8, "bucket": 8})
        _span("executor.input", did, t, t + 0.3 * MS)
        _span("executor.forward", did, t + 0.3 * MS, t + 0.8 * MS,
              {"graph": "replay"})
        _span("session.output", did, t + 0.8 * MS, t + 0.9 * MS)
        w0 = t + PERIOD + 0.9 * MS
        _span("session.wait", did, w0, w0 + 0.02 * MS, {"device_s": 1})
        evs.append(("Memcpy HtoD (Pinned -> Device)", t + 0.28 * MS,
                    t + 0.33 * MS))
        edges = np.linspace(0.44, 1.9, 5) * MS
        evs += [("qgemm_kernel<64>", t + a, t + b)
                for a, b in zip(edges[:-1], edges[1:])]
        evs.append(("Memcpy DtoH (Device -> Pinned)", t + 1.9 * MS,
                    t + 1.92 * MS))
    tracer = Tracer(True, "cpu")
    tracer.t0, tracer.t1 = T0, starts[-1] + PERIOD + MS
    tracer.done, tracer.aligned = True, True
    tracer._events = [(nm, s - drift * (s - T0), e - drift * (e - T0))
                      for nm, s, e in evs]
    tracer.dispatches = n
    return Run(trace=tracer, window=Window(t_start=T0)), evs, starts


@pytest.mark.parametrize("drift", [0.0, 0.02])
def test_uploads_that_overlap_the_dispatch_before_are_paired_by_order(drift):
    """The graph case: each upload runs beside the previous dispatch's
    compute, and that dispatch's output copy lands between this one's
    upload and its output span.  Each dispatch gets its own upload and
    output copy (the n-th of each), the line is fitted to uploads that ran
    beside other work, the clock check holds and both idle shares read as
    a brute-force count over the events put back on the spans' clock."""
    run, evs, starts = _graph_run(drift=drift)
    p = traced(run)
    assert len(p.matched) == 8 and p.lag_s == pytest.approx(0.0, abs=1e-9)
    for did, t in enumerate(starts):
        htod, dtoh = p.copies[did]
        assert htod[0] == pytest.approx(t + 0.28 * MS - drift * (
            t + 0.28 * MS - T0))
        assert dtoh[0] == pytest.approx(t + 1.9 * MS - drift * (
            t + 1.9 * MS - T0))
    shifted = [(nm, s + 0.02 * MS, e + 0.02 * MS) for nm, s, e in evs]
    in_fwd, outside = _brute_idle_shares(run, shifted)
    assert read("device.idle_in_forward_share.offline", run) == \
        pytest.approx(in_fwd, abs=0.01)
    assert read("device.idle_outside_program_share.offline", run) == \
        pytest.approx(outside, abs=0.01)
