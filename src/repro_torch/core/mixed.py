"""Per-block mode-mixing search: dynamic programming over fused-block
boundaries.

The compare-modes data (``simulator.compare_modes``) shows spatial
partitioning winning the early high-resolution stages while the channel
modes (kernel/neuron) win the late channel-heavy stages — the regime split
MCUNetV2 exploits by running only the initial stage patch-based.  A
heterogeneous :class:`~repro_torch.core.splitting.SplitPlan`
(:func:`~repro_torch.core.splitting.split_model_mixed`) lets every fused block
pick its own mode; this module picks the assignment.

The search is exact for the serial (Eq. 5-6) cost model because that model
decomposes over block boundaries: a layer's download time depends only on
its own block's mode, its compute on its own block's mode, and the upload
it overlaps with only on the *previous* block's mode.  So the optimal
assignment is a shortest path over states ``(block, mode, subset)`` with
transition cost

    boundary(b, s' -> s) = t_down(first layer of b under s)
                           + combine(max_comp(first layer under s),
                                     t_up(last layer of b-1 under s'))
    intra(b, s)          = Σ interior-layer serial totals under s

(``combine`` = max under §V.D eager-upload overlap, sum without), exactly
the per-layer arithmetic of :func:`simulator.simulate` — the DP's predicted
latency equals ``simulate(plan=mixed_plan).serial_total_time`` bit-for-bit
(property-tested).  ``comm_bytes`` and ``peak_ram`` objectives use the same
skeleton with sum/max accumulation; both are separable per block, so the DP
degenerates to a per-block argmin there.

Two optional state extensions (both off by default, keeping the default
call byte-identical to the original serial DP):

* ``subset_choices`` widens each block's states with rating-prefix worker
  subsets: a late channel-heavy block may run on the top-1 or top-2 workers
  only, trading parallel compute for less boundary traffic.  The boundary
  arithmetic stays exactly decomposable because ``comm_volume`` download
  bytes depend only on the consumer split and upload bytes only on the
  producer split (excluded workers hold empty shards — the
  ``split_model_mixed(block_workers=...)`` mechanism).

* ``transport="pipelined"`` swaps the DP objective's coordinator-serialized
  link sums for per-link maxima — a surrogate for the pipelined transport,
  where links drain in parallel (``simulator._pipelined_timeline``).  The
  surrogate ranks assignments for pipelined deployment; it is *not* the
  exact makespan (cross-boundary overlap is global), so callers re-rank the
  returned assignment against the serial DP's under the exact simulator
  (``core.search.evaluate_candidate`` does).  ``predicted_latency_s`` is
  always the exact serial total of the chosen assignment.

Per-worker RAM caps prune the state space: a state whose analytic per-worker
peak exceeds any cap is never entered, so the returned assignment is
peak-feasible by construction (flash feasibility — a *sum* across blocks per
worker — is checked by the caller on the assembled plan).  When some block
has no cap-feasible state at all, :class:`MixedInfeasible` (a ``ValueError``)
reports which block's cap bound the search and the best cap-ignoring
assignment, so the planner's ``InfeasibleError`` can name the binding
constraint with real numbers instead of a bare message.

Port copy of ``repro/core/mixed.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .allocation import WorkerParams
from .fusion import group_blocks
from .mapping import comm_volume
from .memory import split_memory
from .reinterpret import ReinterpretedModel, macs_for_positions
from .simulator import SimConfig, _comp_seconds
from .splitting import (MODES, LayerSplit, split_block_spatial, split_layer)

MINIMIZE_TARGETS = ("latency", "comm_bytes", "peak_ram")
DP_TRANSPORTS = ("serial", "pipelined")


class MixedInfeasible(ValueError):
    """Some fused block has no cap-feasible (mode, subset) state.

    Carries the binding block's identity and numbers plus the DP's best
    *cap-ignoring* assignment, so the planner can report what the search
    would have chosen and which block's cap bound it.
    """

    def __init__(self, message: str, *, block: int,
                 block_indices: tuple[int, ...],
                 best_assignment: tuple[str, ...] | None,
                 peak_bytes: int, cap_bytes: int, worker: int):
        super().__init__(message)
        self.block = block
        self.block_indices = block_indices
        self.best_assignment = best_assignment
        self.peak_bytes = peak_bytes
        self.cap_bytes = cap_bytes
        self.worker = worker


@dataclasses.dataclass(frozen=True)
class _BlockCost:
    """Analytic cost pieces of one (fused block, mode, subset) state.

    ``peak_per_worker`` is counted at itemsize=1 (int8) regardless of
    ``cfg.itemsize`` — the planner's RAM-cap gate
    (:func:`memory.peak_ram_per_worker` with defaults) holds that
    convention, and the DP's pruning must agree with the gate the
    assembled plan will face.

    The ``*_pipe`` fields are the pipelined-surrogate counterparts of the
    serialized link times: per-link maxima instead of coordinator sums
    (links drain in parallel under the async transport)."""

    mode: str                       # requested mode
    down0_s: float                  # serialized download time, first layer
    down0_bytes: int
    comp0_max_s: float              # compute critical path, first layer
    intra_s: float                  # Σ serial totals of interior layers
    intra_bytes: int
    up_out_s: float                 # serialized upload time of the block's
    up_out_bytes: int               # final outputs (paid at the next block)
    peak_per_worker: np.ndarray     # per-worker analytic peak bytes
    weight_per_worker: np.ndarray   # per-worker weight-fragment bytes
    down0_pipe_s: float = 0.0       # per-link max variants (pipelined DP)
    intra_pipe_s: float = 0.0
    up_out_pipe_s: float = 0.0

    @property
    def peak_max(self) -> int:
        return int(self.peak_per_worker.max())


@dataclasses.dataclass(frozen=True)
class MixedSearch:
    """Result of :func:`search_mixed_assignment`: the chosen per-block mode
    vector (plus per-block worker subsets when searched) and the metrics
    predicted for it.  ``predicted_latency_s`` is always the exact Eq. 5-6
    serial total of the chosen assignment; under ``transport="pipelined"``
    ``predicted_score`` is the pipelined-seam surrogate the DP minimized
    (callers obtain exact pipelined makespans by simulating the assembled
    plan).  The peak follows the planner's int8 gate convention —
    itemsize=1, see :class:`_BlockCost`."""

    assignment: tuple[str, ...]
    predicted_score: float
    predicted_latency_s: float
    predicted_comm_bytes: int
    predicted_peak_ram: int
    # per-block worker subsets (original worker indices), None = all — only
    # non-None when subset_choices beyond the full set were searched and won
    block_workers: tuple | None = None
    transport: str = "serial"

    @property
    def n_blocks(self) -> int:
        return len(self.assignment)


def _block_splits(model: ReinterpretedModel, indices: tuple[int, ...],
                  ratings: np.ndarray, mode: str) -> list[LayerSplit]:
    """The block's splits under one requested mode — byte-identical to what
    :func:`splitting.split_model_mixed` assembles for this block, so the DP
    costs exactly the plan the caller will build."""
    layers = [model.layers[i] for i in indices]
    if mode == "spatial" and all(lyr.kind in ("conv", "dwconv")
                                 for lyr in layers):
        return split_block_spatial(layers, ratings)
    eff = mode if mode != "spatial" else "neuron"
    return [split_layer(lyr, ratings, eff) for lyr in layers]


def _block_cost(model: ReinterpretedModel, indices: tuple[int, ...],
                ratings: np.ndarray, mode: str, f_mhz: np.ndarray,
                link_s_per_kb: np.ndarray, cfg: SimConfig) -> _BlockCost:
    splits = _block_splits(model, indices, ratings, mode)
    n = len(ratings)
    comp = []
    for sp in splits:
        macs = np.array([macs_for_positions(sp.layer,
                                            sp.shard_of(w).n_positions)
                         for w in range(n)], dtype=np.float64)
        comp.append(_comp_seconds(macs, f_mhz, cfg))
    vol0 = comm_volume(None, splits[0].layer, splits[0],
                       itemsize=cfg.itemsize)
    down0 = link_s_per_kb * vol0.download_bytes / 1024.0
    down0_s = float(down0.sum())
    intra_s, intra_pipe_s, intra_bytes = 0.0, 0.0, 0
    for j in range(1, len(splits)):
        vol = comm_volume(splits[j - 1], splits[j].layer, splits[j],
                          itemsize=cfg.itemsize)
        per_down = link_s_per_kb * vol.download_bytes / 1024.0
        per_up = link_s_per_kb * vol.upload_bytes / 1024.0
        t_down, t_up = float(per_down.sum()), float(per_up.sum())
        max_comp = float(comp[j].max())
        if cfg.overlap:
            intra_s += t_down + max(max_comp, t_up)
            intra_pipe_s += float(per_down.max()) + max(max_comp,
                                                        float(per_up.max()))
        else:
            intra_s += t_down + max_comp + t_up
            intra_pipe_s += (float(per_down.max()) + max_comp
                             + float(per_up.max()))
        intra_bytes += vol.total_bytes
    last = splits[-1]
    up_out = np.zeros(n, dtype=np.int64)
    if last.block_last:
        for shard in last.shards:
            up_out[shard.worker] += shard.n_positions * cfg.itemsize
    up_out_t = link_s_per_kb * up_out / 1024.0
    # itemsize=1: match the planner's RAM gate (see _BlockCost docstring)
    peak = np.max(np.stack([split_memory(sp).per_worker_peak
                            for sp in splits]), axis=0)
    weights = np.array([sum(sp.shard_of(w).weight_bytes for sp in splits)
                        for w in range(n)], dtype=np.int64)
    return _BlockCost(
        mode=mode, down0_s=down0_s,
        down0_bytes=int(vol0.download_bytes.sum()),
        comp0_max_s=float(comp[0].max()), intra_s=intra_s,
        intra_bytes=intra_bytes,
        up_out_s=float(up_out_t.sum()),
        up_out_bytes=int(up_out.sum()),
        peak_per_worker=peak, weight_per_worker=weights,
        down0_pipe_s=float(down0.max()),
        intra_pipe_s=intra_pipe_s,
        up_out_pipe_s=float(up_out_t.max()))


def _combine_first(down0_s: float, comp0_max_s: float, up_s: float,
                   overlap: bool) -> float:
    """Serial total of a block's first layer given the upstream upload it
    overlaps with — simulate's per-layer arithmetic."""
    if overlap:
        return down0_s + max(comp0_max_s, up_s)
    return down0_s + comp0_max_s + up_s


def _assignment_metrics(table: list[dict], states: list,
                        overlap: bool) -> tuple[float, int, int]:
    """(exact serial latency, comm bytes, max peak) of one state sequence —
    summed from the DP tables with the serial boundary arithmetic (the
    transport surrogate never changes these reported metrics)."""
    latency, nbytes, peak = 0.0, 0, 0
    prev: _BlockCost | None = None
    for b, s in enumerate(states):
        c = table[b][s]
        up_s = prev.up_out_s if prev is not None else 0.0
        up_bytes = prev.up_out_bytes if prev is not None else 0
        latency += _combine_first(c.down0_s, c.comp0_max_s, up_s,
                                  overlap) + c.intra_s
        nbytes += up_bytes + c.down0_bytes + c.intra_bytes
        peak = max(peak, c.peak_max)
        prev = c
    return latency, nbytes, peak


def _resolve_subsets(ratings: np.ndarray, subset_choices) -> list:
    """Turn ``subset_choices`` (None = all workers, or a rating-prefix
    *size*) into concrete worker-index tuples, deduplicated in choice
    order.  A prefix covering every positive-rating worker duplicates the
    full set and is dropped."""
    n_pos = int(np.count_nonzero(np.asarray(ratings) > 0))
    order = np.lexsort((np.arange(len(ratings)), -np.asarray(ratings)))
    out, seen = [], set()
    for choice in subset_choices:
        if choice is None:
            key = None
        else:
            size = int(choice)
            if size < 1:
                raise ValueError(f"subset size must be >= 1, got {choice!r}")
            if size >= n_pos:
                continue                      # duplicate of the full set
            key = tuple(sorted(int(i) for i in order[:size]))
        if key in seen:
            continue
        seen.add(key)
        out.append(key)
    if None not in seen:
        out.insert(0, None)
    return out


def search_mixed_assignment(model: ReinterpretedModel,
                            workers: list[WorkerParams],
                            ratings: np.ndarray | None = None,
                            cfg: SimConfig | None = None,
                            minimize: str = "latency",
                            modes: tuple[str, ...] = MODES,
                            ram_caps: np.ndarray | None = None,
                            transport: str = "serial",
                            subset_choices=(None,),
                            cache=None,
                            ) -> MixedSearch:
    """Pick the per-fused-block (mode, worker subset) assignment minimizing
    ``minimize``.

    ``ratings`` default to uniform; ``ram_caps`` (per-worker bytes) prunes
    states whose analytic peak exceeds any worker's cap.  Raises
    :class:`MixedInfeasible` (a ``ValueError``) when some block has no
    cap-feasible state, or ``ValueError`` when ``minimize``/``modes``/
    ``transport`` are invalid.  ``subset_choices`` widens the per-block
    state space with rating-prefix worker subsets (entries are ``None`` for
    all workers or a prefix *size*); the default searches the full set only
    — today's fixed-worker-set DP, byte-identical.  ``transport`` picks the
    DP objective's link model (see module docstring); ``cache`` (a
    :class:`~repro_torch.core.search.CostCache` or anything with ``get``/``put``)
    memoizes the block-cost tables across calls — the tables are
    cap-independent, so one table serves both transports, every
    ``minimize`` and every RAM-cap objective.
    """
    if minimize not in MINIMIZE_TARGETS:
        raise ValueError(f"unknown minimize {minimize!r} "
                         f"(want one of {MINIMIZE_TARGETS})")
    modes = tuple(modes)
    for m in modes:
        if m not in MODES:
            raise ValueError(f"unknown mode {m!r} (want one of {MODES})")
    if not modes:
        raise ValueError("need at least one mode to assign")
    if transport not in DP_TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} "
                         f"(want one of {DP_TRANSPORTS})")
    cfg = cfg or SimConfig()
    n = len(workers)
    ratings = (np.ones(n) if ratings is None
               else np.asarray(ratings, dtype=np.float64))
    if len(ratings) != n:
        raise ValueError(f"{len(ratings)} ratings for {n} workers")
    f_mhz = np.array([p.f_mhz for p in workers])
    link_s_per_kb = np.array([p.d_s_per_kb + 1.0 / p.b_kb_s for p in workers])
    grouping = group_blocks(model)
    subsets = _resolve_subsets(ratings, subset_choices)

    # cap-independent full state tables: rows keyed (mode, subset), cached
    # across transports/objectives/replans when a cache is supplied
    def build_tables() -> list[dict]:
        tables: list[dict] = []
        for block in grouping:
            row: dict = {}
            conv_only = all(model.layers[i].kind in ("conv", "dwconv")
                            for i in block.indices)
            for sub in subsets:
                r_b = ratings if sub is None else np.where(
                    np.isin(np.arange(n), sub), ratings, 0.0)
                for m in modes:
                    if m == "spatial" and not conv_only and "neuron" in modes:
                        # the spatial state falls back to the flat neuron
                        # split on non-conv blocks (_block_splits) — an
                        # exact duplicate of the neuron state; skip it
                        # rather than cost it twice
                        continue
                    row[(m, sub)] = _block_cost(
                        model, tuple(block.indices), r_b, m,
                        f_mhz, link_s_per_kb, cfg)
            tables.append(row)
        return tables

    if cache is not None:
        key = ("mixed_table",
               (id(model), len(model.layers)),
               tuple((float(p.f_mhz), float(p.d_s_per_kb), float(p.b_kb_s),
                      int(p.ram_bytes), int(p.flash_bytes))
                     for p in workers),
               tuple(float(r) for r in ratings),
               (float(cfg.cycles_per_mac), float(cfg.flash_ns_per_mac),
                int(cfg.itemsize), bool(cfg.overlap)),
               modes, tuple(subsets))
        full_table = cache.get(key)
        if full_table is None:
            full_table = build_tables()
            cache.put(key, full_table)
    else:
        full_table = build_tables()

    caps = None if ram_caps is None else np.asarray(ram_caps)
    table: list[dict] = []
    binding: tuple[int, dict] | None = None
    for b, full_row in enumerate(full_table):
        if caps is None:
            table.append(full_row)
            continue
        row = {s: c for s, c in full_row.items()
               if not (c.peak_per_worker > caps).any()}
        if not row and binding is None:
            binding = (b, full_row)
        table.append(row)

    mode_rank = {m: i for i, m in enumerate(modes)}
    sub_rank = {s: i for i, s in enumerate(subsets)}

    def state_rank(s) -> tuple[int, int]:
        # ties break toward the earlier mode, then the earlier subset
        # choice (the full set first) — deterministic, and preferring
        # uniform full-width plans when mixing/subsetting buys nothing
        return (mode_rank[s[0]], sub_rank[s[1]])

    pipe = transport == "pipelined"

    def first_parts(c: _BlockCost) -> tuple[float, float]:
        return ((c.down0_pipe_s, c.comp0_max_s) if pipe
                else (c.down0_s, c.comp0_max_s))

    def up_of(c: _BlockCost | None) -> float:
        if c is None:
            return 0.0
        return c.up_out_pipe_s if pipe else c.up_out_s

    def block_score(c: _BlockCost, up_s: float) -> float:
        if minimize == "latency":
            down0, comp0 = first_parts(c)
            intra = c.intra_pipe_s if pipe else c.intra_s
            return _combine_first(down0, comp0, up_s, cfg.overlap) + intra
        if minimize == "comm_bytes":
            return float(c.down0_bytes + c.intra_bytes)
        return float(c.peak_max)

    def accumulate(prev_score: float, c: _BlockCost, prev: _BlockCost | None
                   ) -> float:
        if minimize == "peak_ram":
            return max(prev_score, block_score(c, 0.0))
        up_s = up_of(prev)
        extra = (prev.up_out_bytes if prev is not None else 0) \
            if minimize == "comm_bytes" else 0.0
        return prev_score + block_score(c, up_s) + float(extra)

    def run_dp(tbl: list[dict]) -> tuple[float, list]:
        """Shortest path over (block, mode, subset); back-pointers give the
        argmin state sequence.  Ties break by :func:`state_rank` for both
        the current and predecessor state."""
        best: dict = {}
        back: list[dict] = []
        for s, c in tbl[0].items():
            best[s] = accumulate(0.0 if minimize != "peak_ram" else -np.inf,
                                 c, None)
        back.append({s: None for s in tbl[0]})
        for b in range(1, len(tbl)):
            nxt: dict = {}
            ptr: dict = {}
            for s, c in tbl[b].items():
                cand = [(accumulate(best[sp], c, tbl[b - 1][sp]),
                         state_rank(sp), sp) for sp in best]
                score, _, sp = min(cand)
                nxt[s], ptr[s] = score, sp
            best = nxt
            back.append(ptr)
        final_score, _, s_last = min(
            (best[s], state_rank(s), s) for s in best)
        rev = [s_last]
        for b in range(len(tbl) - 1, 0, -1):
            rev.append(back[b][rev[-1]])
        return final_score, list(reversed(rev))

    if binding is not None:
        b, full_row = binding
        # best cap-ignoring assignment: what the DP would have chosen with
        # no RAM caps — real numbers for the planner's binding-constraint
        # report
        _, free_states = run_dp(full_table)
        best_assignment = tuple(s[0] for s in free_states)
        c_min = min(full_row.values(), key=lambda c: c.peak_max)
        if caps is not None:
            worker = int(np.argmax(c_min.peak_per_worker / caps))
        else:                                 # pragma: no cover — caps set
            worker = int(np.argmax(c_min.peak_per_worker))
        raise MixedInfeasible(
            f"no cap-feasible mode for fused block "
            f"{tuple(grouping[b].indices)}"
            f" (every candidate peak exceeds a worker's RAM cap)",
            block=b, block_indices=tuple(grouping[b].indices),
            best_assignment=best_assignment,
            peak_bytes=int(c_min.peak_per_worker[worker]),
            cap_bytes=int(caps[worker]) if caps is not None else 0,
            worker=worker)

    final_score, states = run_dp(table)
    assignment = tuple(s[0] for s in states)
    block_workers = tuple(s[1] for s in states)
    if all(s is None for s in block_workers):
        block_workers = None

    latency, nbytes, peak = _assignment_metrics(table, states, cfg.overlap)
    if minimize == "latency" and not pipe:
        score = latency
    elif minimize == "latency":
        score = final_score                   # pipelined-seam surrogate
    else:
        score = {"comm_bytes": float(nbytes),
                 "peak_ram": float(peak)}[minimize]
    return MixedSearch(assignment=assignment, predicted_score=score,
                       predicted_latency_s=latency,
                       predicted_comm_bytes=nbytes, predicted_peak_ram=peak,
                       block_workers=block_workers, transport=transport)
