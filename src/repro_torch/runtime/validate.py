"""Measured-vs-predicted validation for the distributed runtime — port of
``repro/runtime/validate.py``.

Turns the transport simulator from an unfalsifiable oracle into a
calibrated model: run the same plan through (a) the single-process
:class:`~repro_torch.api.session.Session` (the bit-exactness reference), (b) the
pipelined simulator (the prediction), and (c) the real asyncio runtime
(the measurement), then compare on three axes:

* **bit-exact output** — hard invariant, machine-independent;
* **dependency structure** — the runtime's realized ``(segment, consumer,
  producer)`` edges must be a superset of
  :func:`~repro_torch.core.simulator.dependency_edges`; also hard;
* **makespan calibration** — measured / predicted ratio, reported but never
  hard-gated (localhost sockets are not 11.5 kB/s serial links).
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np

from ..core.allocation import WorkerParams
from ..core.simulator import SimConfig, Timeline, dependency_edges, simulate
from ..core.splitting import SplitPlan
from .coordinator import Coordinator


@dataclasses.dataclass
class ValidationReport:
    """One runtime-vs-reference comparison at a fixed worker count."""

    n_workers: int
    n_requests: int
    bitexact: bool
    max_abs_diff: float
    predicted_edges: set[tuple[int, int, int]]
    measured_edges: set[tuple[int, int, int]]
    edges_superset: bool
    makespan_s: float               # measured, best over requests
    predicted_s: float              # simulator pipelined makespan
    calibration_ratio: float        # measured / predicted
    setup_s: float
    timeline: Timeline | None = None

    @property
    def missing_edges(self) -> set[tuple[int, int, int]]:
        return self.predicted_edges - self.measured_edges

    def row(self) -> dict:
        """JSON-friendly summary (benchmarks / CI artifacts)."""
        return {"n_workers": self.n_workers,
                "n_requests": self.n_requests,
                "bitexact": bool(self.bitexact),
                "max_abs_diff": float(self.max_abs_diff),
                "edges_superset": bool(self.edges_superset),
                "n_predicted_edges": len(self.predicted_edges),
                "n_measured_edges": len(self.measured_edges),
                "missing_edges": sorted(self.missing_edges),
                "makespan_s": float(self.makespan_s),
                "predicted_s": float(self.predicted_s),
                "calibration_ratio": float(self.calibration_ratio),
                "setup_s": float(self.setup_s)}


async def validate_distributed(split: SplitPlan, qmodel=None, *,
                               precision: str = "int8",
                               reference=None,
                               n_requests: int = 2, seed: int = 0,
                               spawn: str = "process",
                               workers: list[WorkerParams] | None = None,
                               log_dir: str | None = None,
                               request_timeout: float = 60.0,
                               device=None) -> ValidationReport:
    """Run ``n_requests`` random inputs through the distributed runtime and
    compare against the single-process Session and the pipelined simulator.

    ``reference`` may carry a prebuilt port
    :class:`~repro_torch.api.session.Session` (sharing its qmodel with the
    coordinator keeps the comparison honest — same calibration, same
    weights).  ``device`` is where the coordinator and its workers compute:
    the reference session's device when one is given, else CUDA unless the
    caller passes another.
    """
    if device is None and reference is not None:
        device = reference.device
    if reference is None:
        from ..api.session import Session
        reference = Session(split, precision=precision, qmodel=qmodel,
                            seed=seed, device=device)
    if qmodel is None:
        qmodel = reference.qmodel
    model = split.model
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(model.layers[0].in_shape,
                              dtype=np.float32) for _ in range(n_requests)]
    want = reference.submit_many(xs)

    params = workers or [WorkerParams() for _ in range(split.n_workers)]
    sim = simulate(model, params, split.ratings,
                   SimConfig(transport="pipelined"), plan=split)
    predicted = dependency_edges(split)

    async with Coordinator(split, qmodel, precision=precision, spawn=spawn,
                           log_dir=log_dir, request_timeout=request_timeout,
                           device=device) as coord:
        got = []
        makespans = []
        for x in xs:
            got.append(await coord.infer(x))
            makespans.append(coord.last_timeline.makespan_s)
        measured = set(coord.measured_edges)
        timeline = coord.last_timeline
        setup_s = coord.setup_s

    diffs = [np.max(np.abs(np.asarray(a, np.float32)
                           - np.asarray(b, np.float32)))
             for a, b in zip(want, got)]
    max_abs_diff = float(max(diffs)) if diffs else 0.0
    bitexact = all(np.array_equal(a, b) for a, b in zip(want, got))
    makespan = float(min(makespans)) if makespans else 0.0
    predicted_s = float(sim.total_time)
    return ValidationReport(
        n_workers=split.n_workers, n_requests=n_requests,
        bitexact=bitexact, max_abs_diff=max_abs_diff,
        predicted_edges=predicted, measured_edges=measured,
        edges_superset=predicted <= measured,
        makespan_s=makespan, predicted_s=predicted_s,
        calibration_ratio=(makespan / predicted_s if predicted_s else 0.0),
        setup_s=setup_s, timeline=timeline)


def run_distributed(split: SplitPlan, qmodel=None, **kwargs,
                    ) -> ValidationReport:
    """Synchronous wrapper around :func:`validate_distributed`."""
    return asyncio.run(validate_distributed(split, qmodel, **kwargs))
