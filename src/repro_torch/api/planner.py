"""`Planner`: the resource-aware coordinator's planning step as one call.

The paper's coordinator measures the cluster, rates every worker (Eq. 5),
splits the model proportionally (Eq. 6/7) and deploys.  ``Planner`` turns
that pipeline — plus the partitioning-mode and fusion axes this repo grew
beyond the paper — into a declarative search::

    plan = Planner(model, cluster).plan(
        Objective(minimize="latency", ram_cap_bytes=512 * 1024))

The search space is mode ∈ {neuron, kernel, spatial} (plus the opt-in
"mixed" axis: a per-fused-block mode assignment found by dynamic
programming over block boundaries, :mod:`repro_torch.core.mixed`) × fusion
granularity (fused blocks vs per-layer bands, spatial only) × worker
subsets × transport ∈ {serial, pipelined} (the Eq. 5-6
coordinator-serialized model vs the event-driven per-link async transport).

Worker subsets come from the capability-rating prefix ladder (top-k by
Eq. 5 rating, k = 1..max_workers) — and, when ``Objective(beam_width=...)``
is set, from a beam search that also explores *non-prefix* subsets (drop a
high-rated worker on a slow link): each round keeps the ``beam_width``
best-scoring subsets and grows them by one worker, under an optional
``search_budget`` cap on candidate evaluations.  ``beam_width=None`` (the
default) reproduces the ladder exactly, and because the ladder prefixes are
always evaluated too, the beam plan's score is never worse than the
ladder's (CI-gated).

Every candidate is costed through the shared memoized cost-model layer
(:mod:`repro_torch.core.search`): split geometry, the
:func:`repro_torch.core.simulator.simulate` decomposition and the per-worker peak
(:func:`repro_torch.core.memory.peak_ram_per_worker`) are computed once per
(worker-parameters, mode, fusion, caps) fingerprint and reused across
candidates, across objectives, and — when callers share a
:class:`~repro_torch.core.search.CostCache`, as ``ElasticCluster`` does — across
successive replans.  Neuron/kernel candidates run the Eq. 7
storage-overflow redistribution first, exactly as the paper's allocation
does.  The best feasible candidate becomes a :class:`repro_torch.api.Plan`
(carrying the search telemetry: candidates evaluated, cache hit rate,
search wall); if nothing fits, :class:`InfeasibleError` reports the
*binding* constraint (the one the closest candidate missed by the smallest
margin) instead of returning a silently bad plan.

Port copy of ``repro/api/planner.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from ..core.allocation import ratings_for
from ..core.reinterpret import ReinterpretedModel
from ..core.search import (CostCache, SearchStats, config_fingerprint,
                           evaluate_candidate)
from ..core.simulator import (TRANSPORTS, SimConfig, measured_kc,
                              simulated_k1)
from ..core.splitting import MODES
from .cluster import Cluster
from .plan import Plan

# the planner's mode axis: the three uniform modes plus "mixed" — a
# per-fused-block assignment searched by dynamic programming over block
# boundaries (core.mixed).  Objective defaults to the uniform modes; opt in
# with Objective(modes=SEARCH_MODES).
SEARCH_MODES = MODES + ("mixed",)


class InfeasibleError(RuntimeError):
    """No candidate satisfied the objective's constraints.

    ``binding_constraint`` names the constraint the *closest* candidate
    violated (``"ram_cap"`` / ``"flash_cap"``); ``details`` carries that
    candidate's numbers (mode, workers, requirement vs cap, overshoot).
    For the ``"mixed"`` axis, ``details["mixed"]`` additionally carries the
    DP's best cap-ignoring assignment and which block's cap bound it.
    """

    def __init__(self, message: str, binding_constraint: str, details: dict):
        super().__init__(message)
        self.binding_constraint = binding_constraint
        self.details = details


@dataclasses.dataclass(frozen=True)
class Objective:
    """What the planner optimizes and what it must respect.

    ``minimize``: ``"latency"`` (simulated end-to-end seconds),
    ``"comm_bytes"`` (bytes moved per inference) or ``"peak_ram"`` (max
    per-worker peak).  ``ram_cap_bytes``/``flash_cap_bytes`` tighten every
    worker's own budget (``None`` keeps the per-worker values from the
    cluster).  ``max_workers`` caps the subset size; ``modes`` restricts the
    partitioning axes searched — the three uniform modes by default; add
    ``"mixed"`` (or pass :data:`SEARCH_MODES`) to also search per-block mode
    assignments via the DP in :mod:`repro_torch.core.mixed`; ``transports``
    restricts the transport policies searched (the tuple order doubles as
    the tie-break preference, so the default prefers serial when pipelining
    buys nothing).

    Search-shape knobs: ``beam_width`` enables beam search over non-prefix
    worker subsets on top of the rating ladder (``None`` = ladder only,
    today's search exactly); ``search_budget`` caps the number of *full*
    cost-model evaluations (cache misses) the search may spend — the ladder
    always completes, and cached candidates are free, so a warm
    :class:`~repro_torch.core.search.CostCache` buys the same budget deeper
    exploration;
    ``mixed_subsets`` lets the mixing DP search up to that many rating-
    prefix worker subsets *per block* in addition to the full set (``None``
    = fixed worker set, the original DP).
    """

    minimize: str = "latency"
    ram_cap_bytes: int | None = None
    flash_cap_bytes: int | None = None
    max_workers: int | None = None
    modes: tuple[str, ...] = MODES
    transports: tuple[str, ...] = TRANSPORTS
    beam_width: int | None = None
    search_budget: int | None = None
    mixed_subsets: int | None = None

    def __post_init__(self) -> None:
        if self.minimize not in ("latency", "comm_bytes", "peak_ram"):
            raise ValueError(
                f"unknown minimize={self.minimize!r} "
                "(want 'latency', 'comm_bytes' or 'peak_ram')")
        if not isinstance(self.modes, tuple):
            object.__setattr__(self, "modes", tuple(self.modes))
        if not self.modes:
            raise ValueError("objective needs at least one mode")
        for m in self.modes:
            if m not in SEARCH_MODES:
                raise ValueError(
                    f"unknown mode {m!r} (want one of {SEARCH_MODES})")
        if not isinstance(self.transports, tuple):
            object.__setattr__(self, "transports", tuple(self.transports))
        if not self.transports:
            raise ValueError("objective needs at least one transport")
        for t in self.transports:
            if t not in TRANSPORTS:
                raise ValueError(
                    f"unknown transport {t!r} (want one of {TRANSPORTS})")
        if self.max_workers is not None and self.max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        for name in ("ram_cap_bytes", "flash_cap_bytes"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("beam_width", "search_budget", "mixed_subsets"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1")

    def score(self, latency_s: float, comm_bytes: int,
              max_peak_ram: int) -> float:
        if self.minimize == "latency":
            return float(latency_s)
        if self.minimize == "comm_bytes":
            return float(comm_bytes)
        return float(max_peak_ram)

    def to_dict(self) -> dict:
        return {"minimize": self.minimize,
                "ram_cap_bytes": self.ram_cap_bytes,
                "flash_cap_bytes": self.flash_cap_bytes,
                "max_workers": self.max_workers,
                "modes": list(self.modes),
                "transports": list(self.transports),
                "beam_width": self.beam_width,
                "search_budget": self.search_budget,
                "mixed_subsets": self.mixed_subsets}

    @classmethod
    def from_dict(cls, data: dict) -> "Objective":
        # plans serialized before the transport axis carry no "transports"
        # key: they were searched under the serial model only; the search-
        # shape knobs default to the ladder when absent
        return cls(minimize=data.get("minimize", "latency"),
                   ram_cap_bytes=data.get("ram_cap_bytes"),
                   flash_cap_bytes=data.get("flash_cap_bytes"),
                   max_workers=data.get("max_workers"),
                   modes=tuple(data.get("modes", MODES)),
                   transports=tuple(data.get("transports", ("serial",))),
                   beam_width=data.get("beam_width"),
                   search_budget=data.get("search_budget"),
                   mixed_subsets=data.get("mixed_subsets"))


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One scored point of the search space (kept on the Plan for reporting
    and for the 'prefers the best feasible candidate' property tests)."""

    mode: str
    fusion: str
    worker_indices: tuple[int, ...]
    feasible: bool
    reason: str | None = None            # why infeasible (None when feasible)
    # "*" on infeasible candidates: RAM/flash feasibility is
    # transport-independent, so one entry covers every transport searched
    transport: str = "serial"
    latency_s: float = float("nan")
    comp_s: float = float("nan")
    comm_s: float = float("nan")
    comm_bytes: int = 0
    max_peak_ram: int = 0
    max_weight_bytes: int = 0
    overlap_saved_s: float = 0.0
    score: float = float("nan")
    # mode == "mixed" only: the per-fused-block mode vector the DP chose
    assignment: tuple[str, ...] | None = None
    # mode == "mixed" with subset search: per-block worker subsets (indices
    # into worker_indices' subset, None entries = all)
    block_workers: tuple | None = None
    # mode == "mixed" infeasible only: binding block / best-assignment info
    detail: dict | None = None

    _NAN_FIELDS = ("latency_s", "comp_s", "comm_s", "score")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["worker_indices"] = list(self.worker_indices)
        d["assignment"] = (list(self.assignment)
                           if self.assignment is not None else None)
        d["block_workers"] = (
            [list(s) if s is not None else None for s in self.block_workers]
            if self.block_workers is not None else None)
        # infeasible candidates carry NaN sentinels; map them to null so the
        # payload stays strict RFC-8259 JSON (json.dumps would emit `NaN`)
        for name in self._NAN_FIELDS:
            if math.isnan(d[name]):
                d[name] = None
        return d

    @classmethod
    def from_dict(cls, data: dict) -> "PlanCandidate":
        data = dict(data)
        data["worker_indices"] = tuple(int(i) for i in data["worker_indices"])
        if data.get("assignment") is not None:
            data["assignment"] = tuple(data["assignment"])
        if data.get("block_workers") is not None:
            data["block_workers"] = tuple(
                tuple(int(w) for w in s) if s is not None else None
                for s in data["block_workers"])
        for name in cls._NAN_FIELDS:
            if data.get(name) is None:
                data[name] = float("nan")
        return cls(**data)


@dataclasses.dataclass(frozen=True)
class _Scored:
    """A feasible candidate plus the heavy artifacts plan() needs."""

    cand: PlanCandidate
    ratings: np.ndarray
    split: object                        # core SplitPlan
    peak: np.ndarray
    weights: np.ndarray


class Planner:
    """Searches split/placement space for a model over a cluster.

    ``sim_cfg`` tunes the analytic timing model (defaults to the calibrated
    :class:`~repro_torch.core.simulator.SimConfig`).  K1 is simulated at the
    cluster's fastest clock (the paper's reference measurement); Kc is
    re-derived per subset size, since the communication coefficient depends
    on how many workers share each layer.

    ``cache`` is the memo for the shared cost-model layer
    (:mod:`repro_torch.core.search`); the default is a fresh private
    :class:`~repro_torch.core.search.CostCache`.  Pass a shared instance to warm-
    start successive searches — ``ElasticCluster`` keeps one across replans
    so losing a worker re-derives only the geometry the old plan didn't
    already cost.
    """

    def __init__(self, model: ReinterpretedModel, cluster: Cluster,
                 sim_cfg: SimConfig | None = None, *,
                 cache: CostCache | None = None):
        self.model = model
        self.cluster = cluster if isinstance(cluster, Cluster) else Cluster(tuple(cluster))
        self.sim_cfg = sim_cfg or SimConfig()
        self.cache = cache if cache is not None else CostCache()
        self._k1 = simulated_k1(model, self.cluster.max_f_mhz, self.sim_cfg)
        self._kc: dict[int, float] = {}
        self.last_stats: SearchStats | None = None

    def _kc_for(self, n: int) -> float:
        if n not in self._kc:
            key = ("kc", (id(self.model), len(self.model.layers)), n,
                   config_fingerprint(self.sim_cfg))
            self._kc[n] = self.cache.get_or(
                key, lambda: measured_kc(self.model, n, self.sim_cfg))
        return self._kc[n]

    def _worker_order(self) -> np.ndarray:
        """Workers ranked by capability rating (desc, index tie-break) — the
        subset ladder: the top-k prefix is the k-worker candidate."""
        r = ratings_for(list(self.cluster.workers), self._k1,
                        self._kc_for(self.cluster.n_workers))
        return np.lexsort((np.arange(len(r)), -r))

    # -- the search ----------------------------------------------------------
    def _evaluate(self, objective: Objective
                  ) -> tuple[list[_Scored | PlanCandidate], SearchStats]:
        """Score every candidate the search shape reaches: the rating-prefix
        ladder always, plus beam-discovered subsets when
        ``objective.beam_width`` is set.  Returns ``_Scored`` for feasible
        candidates, bare ``PlanCandidate`` otherwise, with the search
        telemetry."""
        t0 = time.perf_counter()
        stats = SearchStats(beam_width=objective.beam_width)
        order = [int(i) for i in self._worker_order()]
        n_max = self.cluster.n_workers
        if objective.max_workers is not None:
            n_max = min(n_max, objective.max_workers)
        results: list[_Scored | PlanCandidate] = []
        best_by_subset: dict[tuple[int, ...], float] = {}
        evaluated: set[tuple[int, ...]] = set()

        def eval_subset(idx: tuple[int, ...]) -> None:
            evaluated.add(idx)
            scored = self._score_subset(objective, idx, stats)
            results.extend(scored)
            best = math.inf
            for r in scored:
                if isinstance(r, _Scored):
                    best = min(best, r.cand.score)
            best_by_subset[idx] = best

        # the ladder: top-k rating prefixes, k = 1..n_max — always complete
        # (beam_width=None reproduces this search exactly, and the beam
        # plan below can therefore never score worse than the ladder plan)
        for k in range(1, n_max + 1):
            eval_subset(tuple(sorted(order[:k])))

        if objective.beam_width is not None and n_max > 1:
            self._beam(objective, order, n_max, stats, eval_subset,
                       best_by_subset, evaluated)

        stats.subsets_explored = len(evaluated)
        stats.search_wall_s = time.perf_counter() - t0
        self.last_stats = stats
        return results, stats

    def _beam(self, objective, order, n_max, stats, eval_subset,
              best_by_subset, evaluated) -> None:
        """Beam search over worker subsets: keep the ``beam_width`` best
        subsets of each size, grow each by one worker, re-score.  Ladder
        prefixes participate for free (already evaluated — cache hits cost
        nothing), so the beam explores *around* the ladder rather than
        instead of it.  ``search_budget`` caps the *cache misses* (full
        cost-model runs) the beam phase may spend, spread pro-rata across
        subset sizes so large subsets — where heterogeneous clusters
        actually win — get their share instead of the budget burning out on
        exhaustive small-size growth.  Cached subsets are free, so a warm
        cache widens what the same budget reaches."""
        width = objective.beam_width
        budget = objective.search_budget
        beam_start = stats.cache_misses

        def spent() -> int:
            return stats.cache_misses - beam_start

        frontier: list[tuple[int, ...]] = [(w,) for w in order]
        for size in range(1, n_max + 1):
            # the ladder prefix of this size rides in the frontier for free
            # (already evaluated): expansions branch off the prefixes too,
            # so "prefix k plus a non-prefix worker" — the drop-a-high-
            # rated-worker-on-a-slow-link shape — is one round away instead
            # of `size` rounds of bottom-up growth
            prefix = tuple(sorted(order[:size]))
            if prefix not in frontier:
                frontier.append(prefix)
            size_share = (None if budget is None else
                          spent() + max(0, (budget - spent())
                                        // (n_max - size + 1)))
            scored: list[tuple[float, tuple[int, ...]]] = []
            for sub in frontier:
                if sub not in evaluated:
                    if size_share is not None and spent() >= size_share:
                        continue   # over this size's share; free subsets
                    eval_subset(sub)   # may still score below
                scored.append((best_by_subset.get(sub, math.inf), sub))
            if size == n_max or not scored:
                return
            scored.sort(key=lambda t: (t[0], t[1]))
            seen_next: set[tuple[int, ...]] = set()
            frontier = []
            for _, sub in scored[:width]:
                for w in order:
                    if w in sub:
                        continue
                    ns = tuple(sorted(sub + (w,)))
                    if ns not in seen_next:
                        seen_next.add(ns)
                        frontier.append(ns)

    def _score_subset(self, objective: Objective, idx: tuple[int, ...],
                      stats: SearchStats) -> list[_Scored | PlanCandidate]:
        """Score every (mode, fusion) point of one worker subset through the
        memoized cost-model layer, translating the cached evaluation into
        objective-scored candidates (the cache entry is objective-agnostic:
        both transports' metrics are always present, and uniform-mode
        entries are independent of ``minimize``)."""
        workers = [self.cluster[i] for i in idx]
        k = len(idx)
        base_ratings = ratings_for(workers, self._k1, self._kc_for(k))
        ram_caps = np.array(
            [min(w.ram_bytes, objective.ram_cap_bytes or w.ram_bytes)
             for w in workers], dtype=np.float64)
        flash_caps = np.array(
            [min(w.flash_bytes, objective.flash_cap_bytes or w.flash_bytes)
             for w in workers], dtype=np.float64)
        model_bytes = float(self.model.total_weight_bytes(1))
        out: list[_Scored | PlanCandidate] = []
        for mode in objective.modes:
            for fusion in (("block", "layer") if mode == "spatial"
                           else ("block",)):
                ev = evaluate_candidate(
                    self.model, workers, base_ratings, mode, fusion,
                    ram_caps=ram_caps, flash_caps=flash_caps,
                    model_bytes=model_bytes, cfg=self.sim_cfg,
                    minimize=objective.minimize,
                    mixed_subsets=objective.mixed_subsets,
                    mixed_transport_dp=("pipelined" in objective.transports),
                    cache=self.cache, stats=stats)
                if not ev.feasible:
                    out.append(PlanCandidate(
                        mode=mode, fusion=fusion, worker_indices=idx,
                        feasible=False, transport="*", reason=ev.reason,
                        assignment=ev.assignment,
                        max_peak_ram=ev.max_peak_ram,
                        max_weight_bytes=ev.max_weight_bytes,
                        detail=ev.detail))
                    continue
                for var in ev.variants:
                    for transport in objective.transports:
                        latency_s, comp_s, comm_s, saved_s = \
                            var.metrics[transport]
                        cand = PlanCandidate(
                            mode=mode, fusion=fusion, worker_indices=idx,
                            feasible=True, transport=transport,
                            assignment=var.assignment,
                            block_workers=var.block_workers,
                            latency_s=latency_s, comp_s=comp_s,
                            comm_s=comm_s, comm_bytes=var.total_bytes,
                            max_peak_ram=int(var.peak.max()),
                            max_weight_bytes=int(var.weights.max()),
                            overlap_saved_s=saved_s,
                            score=objective.score(latency_s, var.total_bytes,
                                                  int(var.peak.max())))
                        out.append(_Scored(
                            cand=cand, ratings=var.ratings, split=var.split,
                            peak=var.peak, weights=var.weights))
        return out

    def candidates(self, objective: Objective | None = None) -> list[PlanCandidate]:
        """The full scored candidate table (feasible and infeasible) the
        search considers — what :meth:`plan` picks its winner from."""
        objective = objective or Objective()
        results, _ = self._evaluate(objective)
        return [r.cand if isinstance(r, _Scored) else r for r in results]

    def plan(self, objective: Objective | None = None) -> Plan:
        """Search and return the best feasible :class:`Plan`; raise
        :class:`InfeasibleError` naming the binding constraint if none fits."""
        objective = objective or Objective()
        results, stats = self._evaluate(objective)
        feasible = [r for r in results if isinstance(r, _Scored)]
        if not feasible:
            raise self._infeasible(objective, results)
        # deterministic winner: best score, then fewer workers, then the
        # objective's mode order, then fused before per-layer, then the
        # objective's transport order (serial first by default, so the async
        # transport only wins when it actually lowers the score)
        mode_rank = {m: i for i, m in enumerate(objective.modes)}
        transport_rank = {t: i for i, t in enumerate(objective.transports)}
        best = min(feasible, key=lambda s: (
            s.cand.score, len(s.cand.worker_indices),
            mode_rank[s.cand.mode], s.cand.fusion,
            transport_rank[s.cand.transport]))
        c = best.cand
        return Plan(
            model=self.model, cluster=self.cluster, objective=objective,
            mode=c.mode, fusion=c.fusion, worker_indices=c.worker_indices,
            ratings=best.ratings, split=best.split,
            latency_s=c.latency_s, comp_s=c.comp_s, comm_s=c.comm_s,
            comm_bytes=c.comm_bytes, peak_ram=best.peak,
            weight_bytes=best.weights, score=c.score,
            transport=c.transport, overlap_saved_s=c.overlap_saved_s,
            assignment=c.assignment, block_workers=c.block_workers,
            search_stats=stats.to_dict(),
            candidates=tuple(r.cand if isinstance(r, _Scored) else r
                             for r in results))

    def _infeasible(self, objective: Objective, results) -> InfeasibleError:
        """Build the error naming the constraint the closest candidate missed
        by the smallest relative margin (the binding constraint)."""
        best_cand, best_kind, best_margin = None, "ram_cap", float("inf")
        for r in results:
            cand = r.cand if isinstance(r, _Scored) else r
            if cand.feasible or cand.reason is None:
                continue
            if cand.reason.startswith("split_error"):
                kind = "split_error"
            else:
                kind = ("ram_cap" if cand.reason.startswith("ram_cap")
                        else "flash_cap")
            if kind == "ram_cap" and objective.ram_cap_bytes:
                margin = cand.max_peak_ram / objective.ram_cap_bytes
            elif kind == "flash_cap" and objective.flash_cap_bytes:
                margin = (cand.max_weight_bytes / objective.flash_cap_bytes
                          if cand.max_weight_bytes else float("inf"))
            else:
                margin = float("inf")
            if margin < best_margin:
                best_cand, best_kind, best_margin = cand, kind, margin
        if best_cand is None:
            # no candidate produced numbers (e.g. total flash < model bytes)
            cands = [r.cand if isinstance(r, _Scored) else r for r in results]
            best_cand = cands[0]
            reason = best_cand.reason or ""
            if reason.startswith("flash_cap"):
                best_kind = "flash_cap"
            elif reason.startswith("split_error"):
                best_kind = "split_error"
            else:
                best_kind = "ram_cap"
        details = {"mode": best_cand.mode, "fusion": best_cand.fusion,
                   "worker_indices": list(best_cand.worker_indices),
                   "reason": best_cand.reason,
                   "max_peak_ram": best_cand.max_peak_ram,
                   "max_weight_bytes": best_cand.max_weight_bytes,
                   "ram_cap_bytes": objective.ram_cap_bytes,
                   "flash_cap_bytes": objective.flash_cap_bytes}
        if best_cand.mode == "mixed":
            # the DP's binding-block report: which block's cap bound the
            # search, and the best cap-ignoring assignment it would have
            # chosen — real numbers instead of uniform-mode proxies
            details["assignment"] = (list(best_cand.assignment)
                                     if best_cand.assignment else None)
            if best_cand.detail is not None:
                details["mixed"] = dict(best_cand.detail)
        return InfeasibleError(
            f"no feasible split for the objective; binding constraint "
            f"{best_kind} — closest candidate {best_cand.mode} over "
            f"{len(best_cand.worker_indices)} workers failed with: "
            f"{best_cand.reason}",
            binding_constraint=best_kind, details=details)
