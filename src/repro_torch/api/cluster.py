"""`Cluster`: a validated set of worker MCUs (the facade's first noun).

The paper's deployment-initialization step measures each worker's clock,
link delay/bandwidth and memory budgets (§III Pipeline); a ``Cluster`` is
that measurement set as one immutable value — validated once at
construction so every later planning/serving step can trust it — plus the
presets the examples and tests deploy against.

Port copy of ``repro/api/cluster.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from ..core.allocation import WorkerParams


class ClusterError(ValueError):
    """Invalid cluster description (bad worker parameters, empty set, ...)."""


def json_source_text(source: str | pathlib.Path) -> str:
    """Resolve a ``from_json`` source: a JSON string is returned as-is, a
    path (``pathlib.Path``, or a string that doesn't start with ``{``) is
    read from disk.  Shared by every facade ``from_json`` entry point."""
    if isinstance(source, pathlib.Path) or (
            isinstance(source, str) and not source.lstrip().startswith("{")):
        return pathlib.Path(source).read_text()
    return source


# Default heterogeneous testbed of the serving example: Teensy-class MCUs at
# mixed clocks, some behind slow links (d > 0).  Cycled for n > 8.
_DEMO_FREQS = (600, 600, 528, 450, 450, 396, 150, 150)
_DEMO_DELAYS = (0.0, 0.001, 0.0, 0.002, 0.0, 0.004, 0.001, 0.0)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """An immutable, validated set of :class:`WorkerParams`.

    Construct directly from measured workers, or via the presets
    (:meth:`homogeneous`, :meth:`heterogeneous_demo`) or :meth:`from_json`.
    """

    workers: tuple[WorkerParams, ...]
    name: str = "cluster"

    def __post_init__(self) -> None:
        if not isinstance(self.workers, tuple):
            object.__setattr__(self, "workers", tuple(self.workers))
        if len(self.workers) == 0:
            raise ClusterError("a cluster needs at least one worker")
        for i, w in enumerate(self.workers):
            if not isinstance(w, WorkerParams):
                raise ClusterError(f"worker {i}: expected WorkerParams, got {type(w).__name__}")
            if w.f_mhz <= 0:
                raise ClusterError(f"worker {i}: f_mhz must be > 0 (got {w.f_mhz})")
            if w.b_kb_s <= 0:
                raise ClusterError(f"worker {i}: b_kb_s must be > 0 (got {w.b_kb_s})")
            if w.d_s_per_kb < 0:
                raise ClusterError(f"worker {i}: d_s_per_kb must be >= 0 (got {w.d_s_per_kb})")
            if w.ram_bytes <= 0:
                raise ClusterError(f"worker {i}: ram_bytes must be > 0 (got {w.ram_bytes})")
            if w.flash_bytes <= 0:
                raise ClusterError(f"worker {i}: flash_bytes must be > 0 (got {w.flash_bytes})")

    # -- container protocol --------------------------------------------------
    def __len__(self) -> int:
        return len(self.workers)

    def __iter__(self):
        return iter(self.workers)

    def __getitem__(self, i: int) -> WorkerParams:
        return self.workers[i]

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    @property
    def max_f_mhz(self) -> float:
        """Fastest clock in the cluster — the K1 reference frequency."""
        return max(w.f_mhz for w in self.workers)

    def subset(self, indices, name: str | None = None) -> "Cluster":
        """A new cluster holding ``workers[i] for i in indices`` (order kept)."""
        idx = tuple(int(i) for i in indices)
        for i in idx:
            if not 0 <= i < len(self.workers):
                raise ClusterError(f"subset index {i} out of range for {len(self.workers)} workers")
        return Cluster(tuple(self.workers[i] for i in idx),
                       name=name or f"{self.name}[{len(idx)}]")

    # -- presets -------------------------------------------------------------
    @classmethod
    def homogeneous(cls, n: int, *, f_mhz: float = 600.0, d_s_per_kb: float = 0.0,
                    b_kb_s: float = 11500.0, ram_bytes: int = 512 * 1024,
                    flash_bytes: int = 8 * 1024 * 1024,
                    name: str | None = None) -> "Cluster":
        """``n`` identical workers (the paper's Fig. 9/12 scaling setup)."""
        w = WorkerParams(f_mhz=f_mhz, d_s_per_kb=d_s_per_kb, b_kb_s=b_kb_s,
                         ram_bytes=ram_bytes, flash_bytes=flash_bytes)
        return cls((w,) * int(n), name=name or f"homogeneous-{n}")

    @classmethod
    def heterogeneous_demo(cls, n: int = 8, *, ram_bytes: int = 512 * 1024,
                           flash_bytes: int = 8 * 1024 * 1024) -> "Cluster":
        """The serving example's mixed-clock/mixed-link testbed (cycled)."""
        workers = tuple(
            WorkerParams(f_mhz=_DEMO_FREQS[i % len(_DEMO_FREQS)],
                         d_s_per_kb=_DEMO_DELAYS[i % len(_DEMO_DELAYS)],
                         ram_bytes=ram_bytes, flash_bytes=flash_bytes)
            for i in range(int(n)))
        return cls(workers, name=f"heterogeneous-demo-{n}")

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {"name": self.name,
                "workers": [dataclasses.asdict(w) for w in self.workers]}

    def to_json(self, path: str | pathlib.Path | None = None) -> str:
        """JSON text (also written to ``path`` when given)."""
        text = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            pathlib.Path(path).write_text(text + "\n")
        return text

    @classmethod
    def from_dict(cls, data: dict) -> "Cluster":
        try:
            workers = tuple(WorkerParams(**w) for w in data["workers"])
        except (KeyError, TypeError) as e:
            raise ClusterError(f"malformed cluster description: {e}") from e
        return cls(workers, name=data.get("name", "cluster"))

    @classmethod
    def from_json(cls, source: str | pathlib.Path) -> "Cluster":
        """Load from a JSON file path or a JSON string."""
        try:
            data = json.loads(json_source_text(source))
        except json.JSONDecodeError as e:
            raise ClusterError(f"invalid cluster JSON: {e}") from e
        return cls.from_dict(data)
