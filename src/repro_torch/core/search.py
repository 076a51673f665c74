"""Shared cost-model layer for the plan search: memoized candidate evaluation.

Every axis of the planner's search space — mode × fusion × worker subset ×
transport, plus the per-block mixing DP — bottoms out in the same analytic
cost model: build the split geometry, run :func:`simulator.simulate` for the
timing decomposition, :func:`memory.peak_ram_per_worker` for the RAM gate.
That evaluation is pure in (model, worker parameters, ratings, mode, fusion,
caps, sim config), so this module hoists it behind a :class:`CostCache`:

* **across candidates** — the beam search revisits subsets the prefix
  ladder already costed; a cache hit skips geometry + simulate entirely;
* **across objectives** — uniform-mode evaluations are independent of
  ``Objective.minimize`` (the score is recomputed from cached metrics), so
  a ``comm_bytes`` search reuses a ``latency`` search's table;
* **across successive replans** — keys fingerprint worker *parameters*,
  not cluster indices, so an :class:`~repro_torch.runtime.elastic.ElasticCluster`
  that loses one worker re-plans over survivor subsets it has already
  costed (the warm-replan path measured by the churn drill and the
  ``search`` bench section).

One :func:`simulate` call covers both transports (a pipelined
:class:`~repro_torch.core.simulator.SimResult` always carries the serial Eq. 5-6
decomposition in its ``layer_*`` arrays), so a cached evaluation serves any
``Objective.transports`` subset byte-identically.

:class:`SearchStats` is the per-search telemetry (candidates evaluated,
cache hit rate, wall) surfaced on :meth:`repro_torch.api.Plan.report`,
``SessionStats`` and the elastic transition reports.

Port copy of ``repro/core/search.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from .allocation import WorkerParams, redistribute_overflow
from .memory import peak_ram_per_worker
from .mixed import MixedInfeasible, search_mixed_assignment
from .simulator import SimConfig, simulate

__all__ = ["CostCache", "SearchStats", "CandidateEval", "EvalVariant",
           "evaluate_candidate", "worker_fingerprint", "subset_fingerprint",
           "config_fingerprint", "prefix_subset_grid"]


def worker_fingerprint(w: WorkerParams) -> tuple:
    """A worker's cost-model identity: its parameters, not its index.
    Two physically distinct workers with equal parameters are
    interchangeable to the analytic model, and replans over survivor
    subsets must hit entries cached under the full cluster."""
    return (float(w.f_mhz), float(w.d_s_per_kb), float(w.b_kb_s),
            int(w.ram_bytes), int(w.flash_bytes))


def subset_fingerprint(workers) -> tuple:
    return tuple(worker_fingerprint(w) for w in workers)


def config_fingerprint(cfg: SimConfig) -> tuple:
    """SimConfig identity *excluding transport*: one evaluation covers both
    transports (see module docstring), so transport must not split keys."""
    return (float(cfg.cycles_per_mac), float(cfg.flash_ns_per_mac),
            int(cfg.itemsize), bool(cfg.overlap),
            float(cfg.coordinator_bw_kb_s))


def _model_token(model) -> tuple:
    # id() is stable for the lifetime of the model object — the unit a
    # cache is scoped to (a Planner or an ElasticCluster holds one model).
    # The structural extras guard against id reuse after collection.
    return (id(model), len(model.layers), int(model.total_macs()))


class CostCache:
    """LRU memo for candidate evaluations (and the mixing DP's block-cost
    tables / per-subset Kc coefficients that feed them).

    Deliberately dumb: a bounded ``OrderedDict`` with cumulative hit/miss
    counters.  Per-search deltas are tracked by the caller
    (:class:`SearchStats`), so one persistent cache can serve many searches
    — the ElasticCluster keeps a single instance across replans.
    """

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._data: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key):
        """The cached value, or None (cached values are never None)."""
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)

    def get_or(self, key, builder):
        value = self.get(key)
        if value is None:
            value = builder()
            self.put(key, value)
        return value

    def clear(self) -> None:
        self._data.clear()


@dataclasses.dataclass
class SearchStats:
    """Telemetry of one plan search (or replan).

    ``candidates_evaluated`` counts (subset × mode × fusion) cost-model
    evaluations *requested*; ``cache_hits`` of those were served from the
    :class:`CostCache` without rebuilding geometry or simulating
    (``cache_misses`` ran the full model).  ``subsets_explored`` counts
    distinct worker subsets (ladder prefixes + beam-discovered).
    """

    candidates_evaluated: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    subsets_explored: int = 0
    beam_width: int | None = None
    search_wall_s: float = 0.0

    @property
    def cache_hit_rate(self) -> float:
        if self.candidates_evaluated == 0:
            return 0.0
        return self.cache_hits / self.candidates_evaluated

    def to_dict(self) -> dict:
        return {"candidates_evaluated": self.candidates_evaluated,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_hit_rate": round(self.cache_hit_rate, 6),
                "subsets_explored": self.subsets_explored,
                "beam_width": self.beam_width,
                "search_wall_s": round(self.search_wall_s, 6)}


@dataclasses.dataclass(frozen=True)
class EvalVariant:
    """One concrete assembled split of a feasible candidate.  Uniform
    candidates have exactly one; a mixed candidate may carry two when the
    serial-surrogate and transport-aware DP disagree on the assignment
    (the planner re-ranks them under the exact simulated metrics)."""

    ratings: np.ndarray             # post-Eq.7 ratings the split was built on
    split: object                   # core SplitPlan
    peak: np.ndarray                # per-worker analytic peak (int8 gate)
    weights: np.ndarray             # per-worker weight bytes
    assignment: tuple | None        # mixed: per-block mode vector
    block_workers: tuple | None     # mixed: per-block worker subsets
    total_bytes: int
    # transport -> (latency_s, comp_s, comm_s, overlap_saved_s); both
    # transports always present (derived from one pipelined simulate)
    metrics: dict


@dataclasses.dataclass(frozen=True)
class CandidateEval:
    """Cached result of one (subset, mode, fusion) evaluation."""

    feasible: bool
    reason: str | None = None
    variants: tuple = ()
    max_peak_ram: int = 0
    max_weight_bytes: int = 0
    # infeasible mixed candidates: the DP's best cap-ignoring assignment and
    # which block's cap bound it (surfaced in InfeasibleError.details)
    assignment: tuple | None = None
    detail: dict | None = None


def prefix_subset_grid(n: int, extra: int | None) -> tuple:
    """Per-block worker-subset choices for the mixing DP: ``None`` (all
    workers) plus up to ``extra`` rating-prefix subsets — the top-1 worker
    first, then geometrically growing prefixes (1, 2, 4, ...).  The DP's
    ratings order the prefix; here the choices are expressed as sizes and
    resolved against the rating order by the DP itself."""
    if not extra or n <= 1:
        return (None,)
    sizes = []
    s = 1
    while s < n and len(sizes) < extra:
        sizes.append(s)
        s *= 2
    return (None,) + tuple(sizes)


def _simulate_metrics(model, workers, ratings, split, cfg: SimConfig):
    """One pipelined simulate; both transports' (latency, comp, comm, saved)
    derived from it — byte-identical to simulating each separately, because
    a pipelined SimResult's layer_* arrays *are* the serial decomposition."""
    pcfg = dataclasses.replace(cfg, transport="pipelined")
    res = simulate(model, workers, ratings, pcfg, plan=split,
                   compute_peak=False)
    serial_total = res.serial_total_time
    serial_comp = float(res.layer_comp.sum())
    metrics = {
        "pipelined": (res.total_time, res.comp_time, res.comm_time,
                      res.overlap_saved_s),
        "serial": (serial_total, serial_comp, serial_total - serial_comp,
                   0.0),
    }
    return metrics, res.total_bytes


def evaluate_candidate(model, workers, base_ratings: np.ndarray, mode: str,
                       fusion: str, *, ram_caps: np.ndarray,
                       flash_caps: np.ndarray, model_bytes: float,
                       cfg: SimConfig, minimize: str = "latency",
                       mixed_subsets: int | None = None,
                       mixed_transport_dp: bool = False,
                       cache: CostCache | None = None,
                       stats: SearchStats | None = None) -> CandidateEval:
    """Evaluate one (subset, mode, fusion) point of the search space.

    This is the planner's former ``_score_one`` cost-model body, hoisted so
    it can be memoized: the result depends only on the arguments (worker
    *parameters*, not identities), never on the Objective's transports or —
    for uniform modes — its ``minimize``.  ``build_split_plan`` is bypassed
    on a cache hit; scoring against a particular objective stays with the
    caller, reading the cached per-transport metrics.
    """
    from ..api.plan import build_split_plan

    if stats is not None:
        stats.candidates_evaluated += 1
    key = None
    if cache is not None:
        key = ("cand", _model_token(model), subset_fingerprint(workers),
               tuple(float(r) for r in np.asarray(base_ratings)),
               mode, fusion,
               tuple(float(c) for c in np.asarray(ram_caps)),
               tuple(float(c) for c in np.asarray(flash_caps)),
               config_fingerprint(cfg),
               (minimize, mixed_subsets, mixed_transport_dp)
               if mode == "mixed" else None)
        hit = cache.get(key)
        if hit is not None:
            if stats is not None:
                stats.cache_hits += 1
            return hit
    if stats is not None:
        stats.cache_misses += 1

    def _done(ev: CandidateEval) -> CandidateEval:
        if cache is not None:
            cache.put(key, ev)
        return ev

    ratings = base_ratings
    if mode in ("neuron", "kernel"):
        # Eq. 7: shift rating mass away from storage-overflowed workers
        # (weights are split in these modes, so shares track ratings)
        if flash_caps.sum() < model_bytes:
            return _done(CandidateEval(
                feasible=False,
                reason=(f"flash_cap: total capacity {flash_caps.sum():.0f} B"
                        f" < model {model_bytes:.0f} B")))
    searches = [(None, None)]            # (assignment, block_workers)
    try:
        if mode in ("neuron", "kernel"):
            ratings = redistribute_overflow(base_ratings, flash_caps,
                                            model_bytes)
        if mode == "mixed":
            # DP over block boundaries (core.mixed), exact for the serial
            # cost model; optionally a second pass under the pipelined-seam
            # surrogate — when the two disagree, both assignments become
            # variants and the caller's exact simulated metrics re-rank.
            grid = prefix_subset_grid(len(workers), mixed_subsets)
            s0 = search_mixed_assignment(
                model, workers, ratings, cfg, minimize=minimize,
                ram_caps=ram_caps, subset_choices=grid, cache=cache)
            searches = [(s0.assignment, s0.block_workers)]
            if mixed_transport_dp:
                s1 = search_mixed_assignment(
                    model, workers, ratings, cfg, minimize=minimize,
                    ram_caps=ram_caps, subset_choices=grid, cache=cache,
                    transport="pipelined")
                if (s1.assignment, s1.block_workers) not in searches:
                    searches.append((s1.assignment, s1.block_workers))
    except MixedInfeasible as e:
        return _done(CandidateEval(
            feasible=False,
            reason=(f"ram_cap: mixed block {e.block} "
                    f"(layers {list(e.block_indices)}) peak {e.peak_bytes} B"
                    f" > cap {e.cap_bytes} B on worker {e.worker}"),
            max_peak_ram=int(e.peak_bytes),
            assignment=e.best_assignment,
            detail={"block": e.block,
                    "block_layers": list(e.block_indices),
                    "worker": e.worker,
                    "peak_bytes": int(e.peak_bytes),
                    "cap_bytes": int(e.cap_bytes),
                    "best_infeasible_assignment":
                        list(e.best_assignment) if e.best_assignment else None}))
    except (ValueError, RuntimeError) as e:
        return _done(CandidateEval(
            feasible=False,
            reason=f"split_error: {type(e).__name__}: {e}"))

    variants = []
    worst_peak, worst_weight, reasons = 0, 0, []
    for assignment, block_workers in searches:
        try:
            split = build_split_plan(model, ratings, mode, fusion,
                                     assignment=assignment,
                                     block_workers=block_workers)
            peak = peak_ram_per_worker(split)
        except (ValueError, RuntimeError) as e:
            # a mode that cannot even build a split for these workers is an
            # explicit infeasible candidate, not a search-aborting crash
            reasons.append(f"split_error: {type(e).__name__}: {e}")
            continue
        weights = np.array([split.worker_weight_bytes(w)
                            for w in range(split.n_workers)], dtype=np.int64)
        worst_peak = max(worst_peak, int(peak.max()))
        worst_weight = max(worst_weight, int(weights.max()))
        over_ram = peak > ram_caps
        over_flash = weights > flash_caps
        if over_ram.any() or over_flash.any():
            terms = []
            if over_ram.any():
                w = int(np.argmax(peak / ram_caps))
                terms.append(f"ram_cap: worker {w} peak {int(peak[w])} B "
                             f"> cap {int(ram_caps[w])} B")
            if over_flash.any():
                w = int(np.argmax(weights / flash_caps))
                terms.append(f"flash_cap: worker {w} weights "
                             f"{int(weights[w])} B > cap "
                             f"{int(flash_caps[w])} B")
            reasons.append("; ".join(terms))
            continue
        metrics, total_bytes = _simulate_metrics(model, workers, ratings,
                                                 split, cfg)
        variants.append(EvalVariant(
            ratings=ratings, split=split, peak=peak, weights=weights,
            assignment=assignment, block_workers=block_workers,
            total_bytes=total_bytes, metrics=metrics))
    if not variants:
        return _done(CandidateEval(
            feasible=False, reason="; ".join(reasons) or "split_error: empty",
            max_peak_ram=worst_peak, max_weight_bytes=worst_weight,
            assignment=searches[0][0]))
    return _done(CandidateEval(feasible=True, variants=tuple(variants)))
