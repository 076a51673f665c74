"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CUDA
activity only) over a fixed amount of steady work inside the window, and the
benchmark's own host spans beside it.

``Tracer.start`` waits for the device, opens the profiler and launches a
few ``spin_kernel`` pads before the traced work; ``stop`` waits again and
pads after it.  Traces of many short launches have dropped events at their
ends, so the pads take those ends; their name keeps them out of every sum.
Device events are put on the host's ``perf_counter`` clock (the profiler
stamps them on the wall clock); where they do not fall inside the traced
window the run says so and leaves the idle gaps unlabelled.  The trace is
read after the window, so its reading delays no request.
"""
from __future__ import annotations

import time

import torch

PADS = 64
PAD_NAME = "spin_kernel"
TOP = 10


def _pad(device) -> None:
    for _ in range(PADS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize(device)


def _union(intervals):
    """Merged (start, end) intervals of ``intervals``, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Tracer:
    """One traced span of a run.  Counts what the traffic kind reports
    while it is open (``dispatches``, ``requests``) and keeps host spans
    (label, start, end) on the ``perf_counter`` clock."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.done = False
        self.t0 = self.t1 = None
        self.dispatches = 0
        self.requests = 0
        self.spans: list[tuple[str, float, float]] = []
        self._events: list[tuple[str, float, float]] | None = None
        self.aligned = False
        self._prof = None

    def warm(self) -> None:
        """Open and close the profiler once in set-up, so that its first
        start does not fall in the window."""
        if self.enabled:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]):
                _pad(self.device)

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        _pad(self.device)
        self._wall_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.active = False
        self.done = True
        _pad(self.device)
        self._prof.__exit__(None, None, None)

    @property
    def events(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of each device event of the trace, read
        from the profiler on first use, after the window."""
        if self._events is None and self._prof is not None:
            self._read(self._prof)
            self._prof = None
        return self._events or []

    def has_kernels(self) -> bool:
        """Whether the stopped trace holds any kernel but the pads (the
        profiler has lost every kernel of a trace, copies kept, while
        another thread was launching)."""
        from torch.autograd import DeviceType
        if self._prof is None:
            return bool(self.kernels())
        return any(e.device_type() == DeviceType.CUDA
                   and not e.name().startswith(("Memcpy", "Memset"))
                   and PAD_NAME not in e.name()
                   for e in self._prof.profiler.kineto_results.events())

    def reset(self) -> None:
        """Drop a stopped trace, so that ``start`` traces anew."""
        self.__init__(self.enabled, self.device)

    # -- what the traffic kind reports -------------------------------------
    def count(self, dispatches: int = 0, requests: int = 0) -> None:
        if self.active:
            self.dispatches += dispatches
            self.requests += requests

    def span(self, label: str, t0: float, t1: float) -> None:
        if self.active:
            self.spans.append((label, t0, t1))

    # -- reading the trace -----------------------------------------------------
    def _read(self, prof) -> None:
        from torch.autograd import DeviceType
        results = prof.profiler.kineto_results
        start_ns = (results.trace_start_ns() if hasattr(results,
                                                        "trace_start_ns")
                    else results.trace_start_us() * 1000)
        raw = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == DeviceType.CUDA and PAD_NAME not in e.name]
        # the profiler's stamps are wall-clock ns; try that clock, then the
        # monotonic one that perf_counter reads
        for offset_ns in (self._wall_ns, 0):
            ev = [(n, (start_ns + s * 1e3 - offset_ns) / 1e9,
                   (start_ns + e * 1e3 - offset_ns) / 1e9) for n, s, e in raw]
            inside = sum(self.t0 - 0.05 <= s <= self.t1 + 0.05
                         for _, s, _ in ev)
            if raw and inside >= 0.9 * len(raw):
                self._events, self.aligned = ev, True
                return
        self._events = [(n, s / 1e6, e / 1e6) for n, s, e in raw]
        self.aligned = False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        iv = [(s, e) for _, s, e in self.events]
        if self.aligned:
            iv = [(max(s, self.t0), min(e, self.t1)) for s, e in iv]
            iv = [(s, e) for s, e in iv if e > s]
        return _union(iv)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernels(self):
        """(name, seconds) of each kernel event (no copies or fills)."""
        return [(n, e - s) for n, s, e in self.events
                if not n.startswith(("Memcpy", "Memset"))]

    def device_s(self, prefixes) -> float:
        """Device seconds of the kernels whose names start with one of
        ``prefixes``."""
        return sum(d for n, d in self.kernels() if n.startswith(prefixes))

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.events:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        if self.aligned:
            edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
            gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
        else:
            gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self._label(s, e), e - s] for s, e in gaps]}

    def _label(self, s: float, e: float) -> str:
        """What the host was doing in the middle of an idle gap: the
        innermost benchmark span there."""
        if not self.aligned:
            return "unaligned"
        mid = 0.5 * (s + e)
        inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
        if not inner:
            return "host:between spans"
        return "host:" + max(inner, key=lambda sp: sp[1])[0]
