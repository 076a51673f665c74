"""``engine.graph_replay_share.offline`` on synthetic spans: the share of
the traced dispatches whose ``executor.forward`` span says
``graph="replay"``, the dispatches before the traced window left out, and
None where no forward span carries the attribute (a program that records
none) or the run was not traced."""
from __future__ import annotations

import pytest

from repro_torch import trace as program_trace

from portbench.harness import Bench, Run
from portbench.trace import Tracer
from portbench.window import Window

from .tiny_bench import ROOT

T0 = 10.0
MS = 1e-3
NAME = "engine.graph_replay_share.offline"


def read(run):
    return Bench(ROOT).code("metrics", NAME).read(run)


@pytest.fixture(autouse=True)
def _empty_recorder():
    program_trace.clear()
    yield
    program_trace.clear()


def _span(name, key, t0, t1, attrs=None):
    program_trace.record(name, key, round(t0 * 1e9), round(t1 * 1e9), attrs)


def _dispatch(did, t, graph):
    """Dispatch ``did`` from ``t``: its input, forward (``graph`` as its
    attribute, none where None), output and wait spans."""
    _span("session.dispatch", did, t, t + 4 * MS, {"n": 8, "bucket": 8})
    _span("executor.input", did, t, t + MS)
    _span("executor.forward", did, t + MS, t + 3 * MS,
          None if graph is None else {"graph": graph})
    _span("session.output", did, t + 3 * MS, t + 4 * MS)
    _span("session.wait", did, t + 5 * MS, t + 6 * MS, {"device_s": 1e-3})


def _run(graphs):
    """One dispatch a ``graphs`` entry, 10 ms apart from 10 ms into the
    traced window, and no device event."""
    starts = [T0 + 10 * MS + k * 10 * MS for k in range(len(graphs))]
    for did, (t, graph) in enumerate(zip(starts, graphs)):
        _dispatch(did, t, graph)
    tracer = Tracer(True, "cpu")
    tracer.t0, tracer.t1 = T0, starts[-1] + 20 * MS
    tracer.done, tracer.aligned = True, True
    tracer._events = []
    tracer.dispatches = len(graphs)
    return Run(trace=tracer, window=Window(t_start=T0))


@pytest.mark.parametrize("graphs,want", [
    (["replay"] * 4, 100.0),
    (["capture", "replay", "eager", "replay"], 50.0),
    (["eager"] * 3, 0.0),
    ([None] * 4, None),
])
def test_share_of_replayed_forwards(graphs, want):
    got = read(_run(graphs))
    assert got == (None if want is None else pytest.approx(want))


def test_dispatches_before_the_window_are_left_out():
    _dispatch(99, T0 - 50 * MS, "capture")
    assert read(_run(["replay", "replay"])) == pytest.approx(100.0)


def test_none_without_a_trace():
    assert read(Run(trace=None, window=Window(t_start=T0))) is None
