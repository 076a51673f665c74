"""The program's own spans over the traced window, by dispatch, the device
events put on their clock, and the check of that clock.

The port records spans (``repro_torch.trace``) while a ``torch.profiler``
runs, so a ``--trace 1`` run holds them for exactly its traced work; they
are read here after the window, within ``[run.trace.t0, run.trace.t1]``. A
program without ``repro_torch.trace`` has none, and every reader built on
this module then returns None.

A dispatch makes one host-to-device copy (its input) and one device-to-host
copy (its output). Since the program replays CUDA graphs, the input is
uploaded on a stream that holds only uploads, and runs beside the compute
of the dispatch before; the output is copied on the caller's stream once
the dispatch's compute is done. So the two copies of a dispatch are not
found near each other: each kind is paired with the dispatches by its own
stream's order. On the H100 machine a traced run of either offline cell
held exactly one copy of each kind a traced dispatch (6 runs).

Putting the device events on the spans' clock. The trace's own mapping
(``portbench.trace``) can drift against the host's clock within one trace:
on the H100 machine its events have come to lie up to 23.4 ms off by the
end of a traced second, and under 0.05 ms off in most runs. In the runs of
fresh processes the drift went at a steady rate; in traces made one after
another in one process its rate changed within the trace. So the device
events are put on the spans' clock by one straight line, fitted by least
squares to the input copies and lowered to the latest line that starts no
input copy after the end of its ``executor.input`` span: an input copy is
enqueued inside that span, so the copy that started nearest its span's end
sets the line (before the graphs it started 5-110 us before that end in 16
traced runs of both offline cells that did not drift; since, 62-271 us in
4 runs, on the trace's own mapping). Where that line fails the clock check
below, the line through the input copies piece by piece (each copy at its
span's end, but a copy that started further before it than the lines
through its neighbours say) is taken if it passes better: it follows a
changing rate, at the cost of each copy's own lead. A copy that starts
within ``BUSY_GAP_S`` after the device fell idle may have waited behind
that work and is left out of the fit (``_ran_free``); one that starts
while other work runs ran beside it, on the uploads' own stream.

Pairing. The input copies are taken in the order they started, one a
dispatch in the dispatches' order: each within ``MATCH_S``, and within half
the distance to the neighbouring dispatches' span ends, of where the copy
before puts it (the first where the trace's own mapping or the trace's
first copy puts it, whichever finds more). Before the graphs the distance
of a copy to its span moved by at most 0.08 ms from one dispatch to the
next; since, dispatches lie some 1.4 ms apart. So a copy the profiler lost
leaves its dispatch unmatched and an extra copy is passed over. An output
copy starts when the device reaches it, behind the dispatch's compute, so
its time says nothing of its dispatch: the output copies are taken in the
order they started, each the first that starts after its dispatch's
``session.output`` starts (less ``MATCH_S`` for the clock's error).
``MATCHED_MIN`` is chosen, not measured (the profiler has lost events in
traces made one after another in one process).

The clock check, on what the fits do not use. An output copy is enqueued
inside its ``session.output`` span and read back inside ``session.wait``:
it cannot start before ``session.output`` starts, nor end after
``session.wait`` ends, and it starts before ``session.output`` ends unless
it waited behind device work. The worst violation over the matched
dispatches is the clock's lag: on the lowered line, 0-4.6 us in 42 traced
runs in fresh processes before the graphs, 5-63 us in 4 since. In 16
traces made two by two in one process, the line missed by up to 9.0 ms
where the drift's rate changed, the piecewise line by 0-50 us, but in one
trace whose input copies all started some 0.19 ms before their spans' ends,
by 0.15 ms. Readers that intersect program spans with device events read
nothing unless the trace is aligned, the copies of at least
``MATCHED_MIN`` of the dispatches are found and the lag of the mapped
events is at most ``LAG_MAX_S``. The lag of the trace's own mapping, over
both copies, is noted beside it.

The first reader of a run appends one note on the spans (how many, the
copies, the mapping, both lags, the line's rate) and one of the median host
time of each block group.
"""
from __future__ import annotations

import json
import statistics

import numpy as np

from ..trace import _union

LAG_MAX_S = 1e-4       # the limit of the clock check
MATCH_S = 3e-3         # a copy this near where the copy before puts it
MATCHED_MIN = 0.9      # the share of dispatches whose copies must be found
BUSY_GAP_S = 2e-5      # a copy this soon after device work may have waited
DISPATCH_SPANS = ("session.", "executor.")


class Traced:
    """The program's spans of one traced window, on the ``perf_counter``
    clock in seconds: ``spans`` (name, key, t0, t1, attrs), ``by_dispatch``
    (dispatch id -> span name -> [(t0, t1, attrs)]), ``dispatches`` (the
    ids of the traced dispatches, in the order they began), ``matched``
    (those whose input and output copies were found), ``events`` (the
    device events put on the spans' clock), ``mapping`` (``"line"`` or
    ``"piecewise"``, which put them there), ``rate`` (the line's slope:
    the spans' clock gains that many seconds a second of the trace's
    own), ``lag_s`` and ``raw_lag_s`` (the clock check on
    ``events`` and on the trace's own mapping, None where no dispatch is
    matched)."""

    def __init__(self, spans, tracer):
        self.tracer = tracer
        self.spans = spans
        self.by_dispatch: dict = {}
        for name, key, t0, t1, attrs in spans:
            if name.startswith(DISPATCH_SPANS):
                self.by_dispatch.setdefault(key, {}).setdefault(
                    name, []).append((t0, t1, attrs))
        self.dispatches = [k for _, k in sorted(
            (d["session.dispatch"][0][0], k)
            for k, d in self.by_dispatch.items()
            if "session.dispatch" in d and "executor.input" in d)]
        raw = sorted(tracer.events, key=lambda ev: ev[1])
        htod, dtoh = [], []     # (start, end, idle seconds before it)
        busy_until = float("-inf")
        for name, s, e in raw:
            if name.startswith("Memcpy HtoD"):
                htod.append((s, e, s - busy_until))
            elif name.startswith("Memcpy DtoH"):
                dtoh.append((s, e, s - busy_until))
            busy_until = max(busy_until, e)
        self.n_htod, self.n_dtoh = len(htod), len(dtoh)
        # the trace's own mapping is near at its start, or else its first
        # copy is the first dispatch's
        guesses = [0.0]
        if htod and self.dispatches:
            first = self.by_dispatch[self.dispatches[0]]["executor.input"]
            guesses.append(first[0][1] - htod[0][0])
        inputs = max((self._match_inputs(htod, g) for g in guesses), key=len)
        fit = [(c[0], self.by_dispatch[d]["executor.input"][0][1] - c[0])
               for d, c in inputs.items() if _ran_free(c[2])]
        xs = np.array([x for x, _ in fit])
        ys = np.array([y for _, y in fit])
        x0 = xs[0] if fit else 0.0
        rate, offset = 0.0, (ys[0] if fit else 0.0)
        if len(np.unique(xs)) >= 2:
            rate, offset = np.polyfit(xs - x0, ys, 1)
        # down to the latest line that starts no input copy after its span
        offset -= max(offset + rate * (xs - x0) - ys, default=0.0)
        self.rate = float(rate)

        def line(t):
            return offset + self.rate * (t - x0)

        # a copy that started further before its span's end than the lines
        # through its neighbours say, on either side and across, takes the
        # highest of those lines' values there: a lone late span's end
        # leaves the line, a change of the drift's rate stays in it
        ys_pw = ys.copy()
        for k in range(1, len(xs) - 1):
            said = [_at(xs, ys, k - 1, k + 1, k)]
            if k >= 2:
                said.append(_at(xs, ys, k - 2, k - 1, k))
            if k + 2 < len(xs):
                said.append(_at(xs, ys, k + 1, k + 2, k))
            ys_pw[k] = min(ys[k], max(said))

        def through(t):
            k = np.clip(np.searchsorted(xs, t) - 1, 0, len(xs) - 2)
            return ys_pw[k] + (ys_pw[k + 1] - ys_pw[k]) * (t - xs[k]) / (
                xs[k + 1] - xs[k])

        def paired(shift):
            outputs = self._match_outputs(dtoh, shift)
            return {d: (c, outputs[d]) for d, c in inputs.items()
                    if d in outputs}

        shift, self.mapping, self.copies = line, "line", paired(line)
        self.lag_s = self._lag(self.copies, line, inputs=False)
        if len(fit) >= 2 and (self.lag_s is None or self.lag_s > LAG_MAX_S):
            copies = paired(through)
            lag = self._lag(copies, through, inputs=False)
            if lag is not None and (self.lag_s is None or lag < self.lag_s):
                shift, self.mapping, self.lag_s, self.copies = (
                    through, "piecewise", lag, copies)
        s0 = np.array([ev[1] for ev in raw])
        s1 = np.array([ev[2] for ev in raw])
        self.events = list(zip((ev[0] for ev in raw),
                               (s0 + shift(s0)).tolist(),
                               (s1 + shift(s1)).tolist())) if raw else []
        self.raw_lag_s = self._lag(self.copies, lambda t: 0.0, inputs=True)

    @property
    def matched(self) -> list:
        """The traced dispatches whose input and output copies were found,
        in order."""
        return [d for d in self.dispatches if d in self.copies]

    def _match_inputs(self, htod, shift: float) -> dict:
        """dispatch id -> input copy of each traced dispatch whose copy is
        found: the copies in the order they started, one a dispatch in the
        dispatches' order, the first looked for ``shift`` before its
        ``executor.input`` span's end and each later one where the one
        before puts it.  A copy further than ``MATCH_S``, or than half the
        distance to the next or the previous dispatch's span end, from
        where it is looked for is not this dispatch's: one too early is
        passed over, one too late left to the dispatches after."""
        ends = [self.by_dispatch[d]["executor.input"][0][1]
                for d in self.dispatches]
        found = {}
        j = 0
        for n, did in enumerate(self.dispatches):
            apart = [abs(ends[m] - ends[n]) for m in (n - 1, n + 1)
                     if 0 <= m < len(ends)]
            near = min([MATCH_S] + [0.5 * a for a in apart])
            want = ends[n] - shift
            while j < len(htod) and htod[j][0] < want - near:
                j += 1
            if j < len(htod) and htod[j][0] <= want + near:
                found[did] = htod[j]
                if _ran_free(htod[j][2]):
                    shift = ends[n] - htod[j][0]
                j += 1
        return found

    def _match_outputs(self, dtoh, shift) -> dict:
        """dispatch id -> output copy of each traced dispatch that has its
        ``session.output`` span, the device times moved by ``shift(t)``:
        the copies in the order they started, one a dispatch in the
        dispatches' order, each the first that starts after its
        ``session.output`` starts, less ``MATCH_S`` for the clock's error.
        When an output copy starts is the device's to say, behind the
        dispatch's compute, so the order of the one stream pairs them."""
        found = {}
        k = 0
        for did in self.dispatches:
            sp = self.by_dispatch[did]
            if "session.output" not in sp:
                continue
            o0 = sp["session.output"][0][0]
            while k < len(dtoh) and dtoh[k][0] + shift(dtoh[k][0]) < (
                    o0 - MATCH_S):
                k += 1
            if k < len(dtoh):
                found[did] = dtoh[k]
                k += 1
        return found

    def _lag(self, copies: dict, shift, inputs: bool) -> float | None:
        """The worst violation of the bounds of ``copies`` (dispatch id ->
        input and output copy; 0 where none) with the device times moved by
        ``shift(t)``; with ``inputs``, the input copies' bounds too (start
        inside ``executor.input`` unless it waited)."""
        worst = None
        for did, ((cs, _, c_idle), (ds, de, d_idle)) in copies.items():
            sp = self.by_dispatch[did]
            if "session.output" not in sp or "session.wait" not in sp:
                continue
            o0, o1, _ = sp["session.output"][0]
            ds, de = ds + shift(ds), de + shift(de)
            v = [o0 - ds, de - sp["session.wait"][0][1], 0.0]
            if d_idle >= BUSY_GAP_S:
                v.append(ds - o1)
            if inputs:
                i0, i1, _ = sp["executor.input"][0]
                cs += shift(cs)
                v.append(i0 - cs)
                if c_idle >= BUSY_GAP_S:
                    v.append(cs - i1)
            worst = max(v) if worst is None else max(worst, *v)
        return worst

    @property
    def clock_ok(self) -> bool:
        return (self.tracer.aligned and self.lag_s is not None
                and self.lag_s <= LAG_MAX_S
                and len(self.matched) >= MATCHED_MIN * len(self.dispatches))

    def per_dispatch_s(self, *names) -> list[float]:
        """Seconds of the spans named ``names`` in each traced dispatch
        that has the first of them."""
        out = []
        for did in self.dispatches:
            spans = self.by_dispatch[did]
            if names[0] in spans:
                out.append(sum(t1 - t0 for n in names
                               for t0, t1, _ in spans.get(n, ())))
        return out

    def median_s(self, *names) -> float | None:
        per = self.per_dispatch_s(*names)
        return statistics.median(per) if per else None

    def idle_intervals(self):
        """The traced window's intervals with the device idle, from the
        fitted events."""
        t = self.tracer
        busy = _union((max(s, t.t0), min(e, t.t1)) for _, s, e in self.events
                      if min(e, t.t1) > max(s, t.t0))
        edges = [t.t0] + [x for iv in busy for x in iv] + [t.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_share_in(self, names=None) -> float | None:
        """Share (%) of the window's device-idle time that lies inside a
        span named in ``names`` (any program span when None)."""
        if not self.clock_ok:
            return None
        idle = self.idle_intervals()
        total = sum(e - s for s, e in idle)
        if total <= 0:
            return None
        inside = _union((t0, t1) for n, _, t0, t1, _ in self.spans
                        if names is None or n in names)
        return 100.0 * _overlap_s(idle, inside) / total

    def block_table(self) -> list:
        """[first, last, mode, kind, median host us] of each block group,
        in the plan's order, over the traced dispatches."""
        per = [self.by_dispatch[d].get("executor.block", [])
               for d in self.dispatches]
        per = [b for b in per if b and len(b) == len(per[0])]
        if not per:
            return []
        rows = []
        for g, (_, _, a) in enumerate(per[0]):
            us = statistics.median((b[g][1] - b[g][0]) * 1e6 for b in per)
            rows.append([a["first"], a["last"], a["mode"], a["kind"],
                         round(us, 1)])
        return rows


def _ran_free(idle: float) -> bool:
    """Whether a copy with ``idle`` seconds of an idle device before it
    started as it was enqueued rather than queued behind other work: the
    device had been idle ``BUSY_GAP_S`` or more, or other work was still
    running when it started (a copy beside running work is on a stream of
    its own, which held nothing before it: the uploads' stream holds only
    uploads, each done long before the next)."""
    return idle >= BUSY_GAP_S or idle < 0


def _at(xs, ys, i, j, k) -> float:
    """The line through points ``i`` and ``j`` at ``xs[k]``."""
    return ys[i] + (ys[j] - ys[i]) * (xs[k] - xs[i]) / (xs[j] - xs[i])


def _overlap_s(a, b) -> float:
    """Seconds where two sorted lists of disjoint intervals overlap."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def traced(run) -> Traced | None:
    """The program's spans of ``run``'s traced window (read once a run),
    or None where the run was not traced or the program records none."""
    if "_program_traced" in run.__dict__:
        return run._program_traced
    run._program_traced = None
    t = run.trace
    if t is None or not t.done:
        return None
    try:
        from repro_torch import trace as program_trace
    except ImportError:
        return None
    raw = program_trace.spans(int(t.t0 * 1e9), int(t.t1 * 1e9))
    if not raw:
        return None
    p = Traced([(n, k, t0 / 1e9, t1 / 1e9, a) for n, k, t0, t1, a in raw], t)
    run._program_traced = p
    run.window.notes.append(
        f"program spans: {len(raw)} in the traced window "
        f"({program_trace.dropped()} dropped), {len(p.dispatches)} "
        f"dispatches, {p.n_htod} HtoD and {p.n_dtoh} DtoH copies in the "
        f"trace, both found for {len(p.matched)} dispatches (aligned "
        f"{t.aligned}); clock lag {p.lag_s} s on the output copies with "
        f"the events mapped by the {p.mapping} fitted to the input copies "
        f"(the line's rate {p.rate}), {p.raw_lag_s} s on the trace's own "
        f"mapping")
    table = p.block_table()
    if table:
        run.window.notes.append(
            "program block groups [first, last, mode, kind, median host us "
            f"over {len(p.dispatches)} dispatches]: {json.dumps(table)}")
    return p
