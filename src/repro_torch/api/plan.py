"""`Plan`: a scored, serializable split-inference deployment decision.

A ``Plan`` binds together everything the coordinator decided — which
partitioning mode, which fusion granularity, which worker subset, what
capability ratings — plus the simulated cost profile that justified the
decision.  It is produced by :class:`repro_torch.api.Planner`, can round-trip
through JSON (weights are *not* serialized; deserialization re-derives the
:class:`~repro_torch.core.splitting.SplitPlan` from the model + stored ratings and
cross-checks the deterministic metrics), and compiles into a serving
:class:`repro_torch.api.Session` via :meth:`Plan.compile`.

Port copy of ``repro/api/plan.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from ..core.memory import peak_ram_per_worker
from ..core.reinterpret import ReinterpretedModel
from ..core.splitting import SplitPlan, split_model, split_model_mixed
from .cluster import Cluster, json_source_text

FUSIONS = ("block", "layer")


def build_split_plan(model: ReinterpretedModel, ratings, mode: str,
                     fusion: str = "block",
                     assignment=None, block_workers=None) -> SplitPlan:
    """Build the concrete :class:`SplitPlan` for one (mode, fusion) candidate.

    ``fusion`` selects the execution granularity of spatial plans:
    ``"block"`` fuses whole inverted-residual blocks per band (the default —
    interior activations never materialize at full resolution), ``"layer"``
    bands every conv layer independently (no fused blocks: more boundary
    traffic, no interior-halo recompute).  Neuron/kernel plans have a single
    granularity; ``fusion`` is ignored for them.  Delegates to core
    :func:`split_model` — the splitting semantics live in one place.

    ``mode="mixed"`` builds a heterogeneous plan from ``assignment`` (the
    per-fused-block mode vector, required; always block-fused granularity) —
    core :func:`split_model_mixed`.  ``block_workers`` optionally narrows
    each block to a worker subset (per-block index iterables, ``None``
    entries keep all workers); uniform modes ignore it.
    """
    if fusion not in FUSIONS:
        raise ValueError(f"unknown fusion {fusion!r} (want one of {FUSIONS})")
    if mode == "mixed":
        if assignment is None:
            raise ValueError("mode='mixed' needs a per-block assignment")
        return split_model_mixed(model, ratings, assignment,
                                 block_workers=block_workers)
    return split_model(model, ratings, mode=mode, fused=(fusion == "block"))


def _model_fingerprint(model: ReinterpretedModel) -> dict:
    """Cheap structural identity used to reject deserializing a plan against
    the wrong model (weights themselves are never serialized)."""
    return {"n_layers": len(model.layers),
            "input_shape": list(model.input_shape),
            "total_macs": int(model.total_macs()),
            "total_weight_bytes": int(model.total_weight_bytes(1))}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A feasible, scored deployment: the Planner's output.

    ``worker_indices`` index into ``cluster``; ``ratings``/``peak_ram``/
    ``weight_bytes`` are aligned with that subset.  ``candidates`` keeps the
    full scored search table (feasible and not) for :meth:`report`.
    """

    model: ReinterpretedModel
    cluster: Cluster
    objective: "object"                  # repro_torch.api.Objective
    mode: str
    fusion: str
    worker_indices: tuple[int, ...]
    ratings: np.ndarray
    split: SplitPlan
    latency_s: float
    comp_s: float
    comm_s: float
    comm_bytes: int
    peak_ram: np.ndarray                 # per selected worker, bytes (int8)
    weight_bytes: np.ndarray             # per selected worker, bytes (int8)
    score: float
    # transport policy the winning candidate was costed under ("serial" is
    # the Eq. 5-6 coordinator-serialized model; "pipelined" the per-link
    # async transport) and the seconds pipelining saved vs serial (0 when
    # transport == "serial")
    transport: str = "serial"
    overlap_saved_s: float = 0.0
    # mixed plans only: per-fused-block mode vector (group_blocks
    # granularity) the DP search chose; None for uniform plans
    assignment: tuple[str, ...] | None = None
    # mixed plans with Objective(mixed_subsets=...): per-block worker
    # subsets the DP chose (indices into worker_indices' subset, None
    # entries = all workers); None when every block uses the full subset
    block_workers: tuple | None = None
    # search telemetry from the Planner (core.search.SearchStats.to_dict():
    # candidates evaluated, cache hit rate, search wall); None when the
    # plan was deserialized from a pre-v2-search payload
    search_stats: dict | None = None
    candidates: tuple = ()

    # -- derived views -------------------------------------------------------
    @property
    def workers(self) -> tuple:
        """The selected :class:`WorkerParams`, in plan order."""
        return tuple(self.cluster[i] for i in self.worker_indices)

    @property
    def n_workers(self) -> int:
        return len(self.worker_indices)

    @property
    def max_peak_ram(self) -> int:
        return int(np.max(self.peak_ram))

    @property
    def max_weight_bytes(self) -> int:
        return int(np.max(self.weight_bytes))

    # -- reporting -----------------------------------------------------------
    @staticmethod
    def _rle(assignment) -> str:
        """Run-length-encode a per-block mode vector for display:
        ('spatial',)*5 + ('kernel',)*3 -> 'spatial*5 kernel*3'."""
        runs: list[tuple[str, int]] = []
        for m in assignment:
            if runs and runs[-1][0] == m:
                runs[-1] = (m, runs[-1][1] + 1)
            else:
                runs.append((m, 1))
        return " ".join(m if k == 1 else f"{m}*{k}" for m, k in runs)

    def report(self) -> str:
        """Human-readable summary: the decision, its cost profile, and the
        scored candidate table the search considered."""
        lines = [
            f"Plan: mode={self.mode}"
            + (f"/{self.fusion}" if self.mode == "spatial" else "")
            + f", transport={self.transport}"
            + f", {self.n_workers}/{self.cluster.n_workers} workers "
            f"{list(self.worker_indices)} of {self.cluster.name!r}",
            f"  objective: minimize {getattr(self.objective, 'minimize', '?')}"
            f"  score={self.score:.6g}",
            f"  simulated latency: {self.latency_s * 1e3:.1f} ms "
            f"(comp {self.comp_s * 1e3:.1f} + comm {self.comm_s * 1e3:.1f})"
            + (f", overlap saves {self.overlap_saved_s * 1e3:.1f} ms "
               "vs serial" if self.transport == "pipelined" else ""),
            f"  bytes moved/inference: {self.comm_bytes / 1e6:.2f} MB",
            f"  max per-worker peak RAM: {self.max_peak_ram / 1024:.1f} KB",
            f"  max per-worker weights:  {self.max_weight_bytes / 1024:.1f} KB",
            f"  ratings: {np.round(np.asarray(self.ratings), 2).tolist()}",
        ]
        if self.assignment is not None:
            lines.insert(1, "  per-block modes: " + self._rle(self.assignment))
        if self.block_workers is not None and any(
                s is not None for s in self.block_workers):
            lines.append("  per-block workers: " + " ".join(
                "all" if s is None else str(list(s))
                for s in self.block_workers))
        if self.search_stats:
            s = self.search_stats
            lines.append(
                f"  search: {s.get('candidates_evaluated', 0)} candidates "
                f"({s.get('subsets_explored', 0)} subsets, "
                f"cache hit rate {s.get('cache_hit_rate', 0.0):.0%}) "
                f"in {s.get('search_wall_s', 0.0) * 1e3:.0f} ms")
        if self.candidates:
            lines.append("  search ({} candidates):".format(len(self.candidates)))
            for c in self.candidates:
                tag = f"{c.mode}" + (f"/{c.fusion}" if c.mode == "spatial" else "")
                tag += f"/{getattr(c, 'transport', 'serial')}"
                if c.feasible:
                    lines.append(
                        f"    {tag:24s} workers={len(c.worker_indices)} "
                        f"latency={c.latency_s * 1e3:8.1f}ms "
                        f"peak={c.max_peak_ram / 1024:7.1f}KB "
                        f"score={c.score:.6g}"
                        + ("   <- selected" if self._is_selected(c) else ""))
                else:
                    lines.append(
                        f"    {tag:24s} workers={len(c.worker_indices)} "
                        f"INFEASIBLE ({c.reason})")
        return "\n".join(lines)

    def _is_selected(self, cand) -> bool:
        return (cand.mode == self.mode and cand.fusion == self.fusion
                and cand.transport == self.transport
                and tuple(cand.worker_indices) == tuple(self.worker_indices)
                and getattr(cand, "assignment", None) == self.assignment
                and getattr(cand, "block_workers", None) == self.block_workers)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        # schema v2 adds "assignment" (per-fused-block mode vector of mixed
        # plans; null for uniform).  v1 payloads predate mode mixing and
        # load as uniform-mode plans (from_dict tolerates the missing key).
        # "block_workers" and "search_stats" are additive v2 keys (null when
        # absent): per-block worker subsets and the search telemetry.
        return {
            "version": 2,
            "kind": "repro.api.Plan",
            "model": _model_fingerprint(self.model),
            "cluster": self.cluster.to_dict(),
            "objective": self.objective.to_dict(),
            "mode": self.mode,
            "fusion": self.fusion,
            "transport": self.transport,
            "assignment": (list(self.assignment)
                           if self.assignment is not None else None),
            "block_workers": (
                [list(s) if s is not None else None
                 for s in self.block_workers]
                if self.block_workers is not None else None),
            "search_stats": self.search_stats,
            "worker_indices": list(self.worker_indices),
            "ratings": [float(r) for r in np.asarray(self.ratings)],
            "metrics": {
                "latency_s": float(self.latency_s),
                "comp_s": float(self.comp_s),
                "comm_s": float(self.comm_s),
                "comm_bytes": int(self.comm_bytes),
                "overlap_saved_s": float(self.overlap_saved_s),
                "score": float(self.score),
            },
            "peak_ram": [int(b) for b in np.asarray(self.peak_ram)],
            "weight_bytes": [int(b) for b in np.asarray(self.weight_bytes)],
            "candidates": [c.to_dict() for c in self.candidates],
        }

    def to_json(self, path: str | pathlib.Path | None = None) -> str:
        # allow_nan=False guards the contract: the payload must stay strict
        # RFC-8259 JSON (candidate NaN sentinels are mapped to null upstream)
        text = json.dumps(self.to_dict(), indent=2, allow_nan=False)
        if path is not None:
            pathlib.Path(path).write_text(text + "\n")
        return text

    @classmethod
    def from_dict(cls, data: dict, model: ReinterpretedModel) -> "Plan":
        """Rebuild a plan against ``model``.  The split plan is re-derived
        from the stored ratings/mode (weights are not serialized) and the
        deterministic peak-RAM metric is cross-checked against the stored
        value, so loading a plan against the wrong model fails loudly."""
        from .planner import Objective, PlanCandidate  # circular at import time
        if data.get("kind") != "repro.api.Plan":
            raise ValueError("not a serialized repro.api.Plan")
        fp_stored, fp_model = data["model"], _model_fingerprint(model)
        if fp_stored != fp_model:
            raise ValueError(
                f"plan/model mismatch: plan was built for {fp_stored}, "
                f"got {fp_model}")
        cluster = Cluster.from_dict(data["cluster"])
        ratings = np.asarray(data["ratings"], dtype=np.float64)
        # v1 payloads carry no "assignment": they predate mode mixing and
        # rebuild as uniform-mode plans
        assignment = data.get("assignment")
        if data["mode"] == "mixed" and assignment is None:
            raise ValueError("mixed plan payload lacks its per-block "
                             "assignment")
        block_workers = data.get("block_workers")
        if block_workers is not None:
            block_workers = tuple(
                tuple(int(w) for w in s) if s is not None else None
                for s in block_workers)
        split = build_split_plan(model, ratings, data["mode"], data["fusion"],
                                 assignment=assignment,
                                 block_workers=block_workers)
        peak = peak_ram_per_worker(split)
        stored_peak = np.asarray(data["peak_ram"], dtype=np.int64)
        if not np.array_equal(peak, stored_peak):
            raise ValueError(
                "deserialized plan failed its peak-RAM cross-check: "
                f"recomputed {peak.tolist()} != stored {stored_peak.tolist()}")
        m = data["metrics"]
        return cls(
            model=model, cluster=cluster,
            objective=Objective.from_dict(data["objective"]),
            mode=data["mode"], fusion=data["fusion"],
            transport=data.get("transport", "serial"),
            worker_indices=tuple(int(i) for i in data["worker_indices"]),
            ratings=ratings, split=split,
            latency_s=float(m["latency_s"]), comp_s=float(m["comp_s"]),
            comm_s=float(m["comm_s"]), comm_bytes=int(m["comm_bytes"]),
            peak_ram=stored_peak,
            weight_bytes=np.asarray(data["weight_bytes"], dtype=np.int64),
            score=float(m["score"]),
            overlap_saved_s=float(m.get("overlap_saved_s", 0.0)),
            assignment=(tuple(assignment) if assignment is not None
                        else None),
            block_workers=block_workers,
            search_stats=data.get("search_stats"),
            candidates=tuple(PlanCandidate.from_dict(c)
                             for c in data.get("candidates", ())))

    @classmethod
    def from_json(cls, source: str | pathlib.Path,
                  model: ReinterpretedModel) -> "Plan":
        """Load from a JSON file path or a JSON string (needs the model the
        plan was built for — weights are never serialized)."""
        return cls.from_dict(json.loads(json_source_text(source)), model)

    def worker_geometry(self) -> list[dict]:
        """JSON-serializable per-worker shard geometry: what each worker
        stores and computes, per block group — the payload skeleton the
        distributed runtime ships at setup (``repro_torch.runtime.shards``)."""
        from ..runtime.shards import worker_geometry_summary
        return worker_geometry_summary(self.split)

    # -- serving -------------------------------------------------------------
    def compile(self, precision: str = "int8", **session_kwargs):
        """Compile this plan into a serving :class:`repro_torch.api.Session`
        (micro-batched ``CompiledSplitExecutor`` wrapper).  ``precision`` is
        ``"int8"`` (W8A8, auto-calibrated unless ``calibration=``/``qmodel=``
        given) or ``"float"``.  The session runs on CUDA unless
        ``device=`` (passed through with the other keywords) says
        otherwise."""
        from .session import Session
        return Session(self, precision=precision, **session_kwargs)
