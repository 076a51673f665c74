"""What a traffic kind hands back: the measured window's requests,
their outputs and times."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Window:
    t_start: float                  # perf_counter at the first request
    t_end: float = 0.0              # the last output on the host
    attempted: int = 0
    failed: int = 0
    latencies_s: list[float] = dataclasses.field(default_factory=list)
    enqueue_s: list[tuple[float, bool]] = dataclasses.field(
        default_factory=list)      # (host enqueue s, inside the trace)
    stats_delta: dict | None = None
    notes: list[str] = dataclasses.field(default_factory=list)
    _ids: list[np.ndarray] = dataclasses.field(default_factory=list)
    _outs: list[np.ndarray] = dataclasses.field(default_factory=list)
    _done_at: list[float] = dataclasses.field(default_factory=list)

    def deliver(self, ids, outs, at: float | None = None) -> None:
        """Outputs of the requests ``ids`` (request indices), as the timed
        path returned them, on the host at ``at`` (``perf_counter``)."""
        outs = np.asarray(outs)
        self._ids.append(np.asarray(ids, np.int64).reshape(-1))
        self._outs.append(outs.reshape(len(outs), -1))
        if at is not None:
            self._done_at.extend([at] * len(outs))

    def per_second(self) -> list[int]:
        """Answers on the host in each whole second of the window."""
        if not self._done_at:
            return []
        t = np.asarray(self._done_at) - self.t_start
        return np.bincount(t.astype(np.int64)).tolist()

    @property
    def completed(self) -> int:
        return int(sum(len(i) for i in self._ids))

    def outputs(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._ids:
            return np.zeros(0, np.int64), np.zeros((0, 0), np.int8)
        return np.concatenate(self._ids), np.concatenate(self._outs)
