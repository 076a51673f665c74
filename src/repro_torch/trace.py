"""Spans of the port's layers: where a dispatch's host time goes.

The port's one span recorder.  It has no counterpart in ``repro``: the
reference traces under ``jax.jit`` and its host path is one call.

A span is a plain tuple ``(name, key, t0_ns, t1_ns, attrs)``: the times
are ``time.perf_counter_ns()``; ``key`` is the dispatch id of a
:class:`~repro_torch.api.session.Session` dispatch or the request id of a
:class:`~repro_torch.serve.Server` request, which ties a request's spans
together and each span to the one that caused it; ``attrs`` is a small
dict or None.  The spans recorded:

=================  =============  =========================================
name               key            interval (attrs)
=================  =============  =========================================
session.dispatch   dispatch id    all of ``Session.dispatch_async``
                                  (``n`` requests, ``bucket``)
executor.input     dispatch id    the batch's pinned copy, its upload and,
                                  on CUDA, its copy into the graph's input
executor.forward   dispatch id    the plan's forward, enqueued (``graph``:
                                  ``replay``, ``capture`` or ``eager``)
executor.block     dispatch id    one block group of the plan, its residual
                                  add included (``first`` and ``last``
                                  layer, ``mode`` spatial or flat, ``kind``);
                                  only where the plan is walked: on the
                                  CPU, and in the capture of a CUDA graph
session.output     dispatch id    the pinned output buffer, its copy and
                                  the dispatch's closing event (CUDA only)
session.wait       dispatch id    ``InflightDispatch.wait`` (``device_s``)
serve.queue        request id     ``Server.submit`` until the request is
                                  taken into a batch (``dispatch``,
                                  ``tenant``)
serve.fulfill      dispatch id    from ``wait`` returning until the batch's
                                  tickets are fulfilled and the monitor is
                                  updated (``tenant``)
=================  =============  =========================================

Recording is on while a ``torch.profiler`` runs and only then: the gate
is ``torch.autograd.profiler._is_profiler_enabled``, which torch sets on
the profiler's start and clears on its stop, for every thread of the
process (the per-thread ``_profiler_enabled()`` would read False in the
server's scheduler thread).  There is no other switch.  :func:`clock` is
the one read of the gate a call site makes; with no profiler running it
returns None and the call site reads no clock and records nothing.

The spans are kept in memory, at most :data:`CAP` of them; what the cap
turns away is counted in :func:`dropped`.
"""
from __future__ import annotations

import time

import torch.autograd.profiler as _profiler

CAP = 1_000_000


class Recorder:
    """An in-memory list of spans, capped at ``cap``.  No lock: a list's
    ``append`` and ``clear`` are atomic under the interpreter's lock, and
    a lock here cost more than the rest of a span."""

    def __init__(self, cap: int = CAP):
        self.cap = int(cap)
        self.dropped = 0
        self._spans: list[tuple] = []

    def record(self, name: str, key: int, t0_ns: int, t1_ns: int,
               attrs: dict | None = None) -> None:
        if len(self._spans) < self.cap:
            self._spans.append((name, key, t0_ns, t1_ns, attrs))
        else:
            self.dropped += 1

    def spans(self, t0_ns: int | None = None,
              t1_ns: int | None = None) -> list[tuple]:
        """The spans that lie inside ``[t0_ns, t1_ns]`` (either end open
        when None), in the order they were recorded."""
        return [s for s in list(self._spans)
                if (t0_ns is None or s[2] >= t0_ns)
                and (t1_ns is None or s[3] <= t1_ns)]

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0


RECORDER = Recorder()
record = RECORDER.record
spans = RECORDER.spans
clear = RECORDER.clear


def dropped() -> int:
    """Spans the cap turned away since the last :func:`clear`."""
    return RECORDER.dropped


def clock() -> int | None:
    """``time.perf_counter_ns()`` while a ``torch.profiler`` runs, else
    None (and no clock read)."""
    return time.perf_counter_ns() if _profiler._is_profiler_enabled else None
