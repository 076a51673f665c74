"""Plan diffing + the elastic serving loop: replan under churn, ship deltas.

Two layers:

* :func:`diff_plans` / :class:`PlanDiff` — pure, analytic comparison of two
  :class:`~repro_torch.core.splitting.SplitPlan` setups at shard granularity.
  Every worker-setup segment spec carries a content ``fingerprint``
  (geometry + array contents, independent of group index — see
  ``shards._fingerprint_spec``), so classification is exact:

  - ``unchanged``: the mapped physical worker already holds this exact
    segment (same geometry, same weights) — zero bytes shipped, warm
    compiled cache hit;
  - ``moved``: the segment exists verbatim on some *other* old worker —
    re-shipped, but recognizable (a future peer-transfer optimization);
  - ``resized``: the worker served this group before with different
    geometry — only arrays it doesn't hold are re-shipped;
  - ``new``: the group/worker pair did not exist in the old plan.

  ``reshipped_bytes`` is computed per *worker* over the union of its
  segments (an array shared by two segments ships once), matching exactly
  what :meth:`~repro_torch.runtime.Coordinator.replan_to` puts on the wire.

* :class:`ElasticCoordinator` — the serve-through-churn loop, composing an
  :class:`~repro_torch.runtime.elastic.ElasticCluster` (membership + Planner
  policy) with a live :class:`~repro_torch.runtime.Coordinator` (transition
  mechanics).  ``infer`` retries through worker failure: a dead worker
  fails the in-flight request typed, the cluster re-plans over survivors,
  ``replan_to`` cuts over atomically under the coordinator's request lock
  (queued submissions simply run under the new plan), and the request is
  re-run — bit-exact, never silently dropped.  Past ``queue_cap``
  concurrent requests, submissions shed with typed
  ``Overloaded(reason="rebalancing")``.

Port copy of ``repro/runtime/replan.py`` (host logic only; the coordinator
it drives is the port's): the port cannot import the reference, whose
package pulls in JAX, so it carries this copy and
``tests/test_torch_elastic.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

from ..core.quantize import QuantizedModel
from ..core.splitting import SplitPlan
from .coordinator import Coordinator
from .elastic import ElasticCluster
from .shards import build_worker_setup, delta_setup, setup_array_bytes

__all__ = ["SegmentDiff", "PlanDiff", "diff_plans", "ElasticCoordinator"]


@dataclasses.dataclass(frozen=True)
class SegmentDiff:
    """One (new-plan worker, group) shard, classified against the old plan."""

    worker: int            # new plan worker slot
    gi: int                # block group index
    status: str            # "unchanged" | "moved" | "resized" | "new"
    nbytes: int            # total array bytes of this segment, new plan
    reship_bytes: int      # array bytes the mapped worker must receive


@dataclasses.dataclass(frozen=True)
class PlanDiff:
    """Shard-granular diff between two split plans."""

    entries: tuple[SegmentDiff, ...]
    removed: int                    # old segments with no successor
    full_setup_bytes: int           # shipping the new plan cold
    reshipped_bytes: int            # shipping only what mapped workers lack

    def count(self, status: str) -> int:
        return sum(1 for e in self.entries if e.status == status)

    @property
    def unchanged(self) -> int:
        return self.count("unchanged")

    @property
    def moved(self) -> int:
        return self.count("moved")

    @property
    def resized(self) -> int:
        return self.count("resized")

    @property
    def new(self) -> int:
        return self.count("new")

    def summary(self) -> str:
        return (f"PlanDiff: {self.unchanged} unchanged, {self.moved} moved, "
                f"{self.resized} resized, {self.new} new, "
                f"{self.removed} removed; reship "
                f"{self.reshipped_bytes}/{self.full_setup_bytes} B "
                f"({self.reshipped_bytes / max(self.full_setup_bytes, 1):.0%})")


def _worker_setups(split: SplitPlan, qmodel, precision: str) -> dict:
    out = {}
    for w in range(split.n_workers):
        meta, arrays = build_worker_setup(split, qmodel, precision, w)
        out[w] = (meta, arrays)
    return out


def diff_plans(old_split: SplitPlan, new_split: SplitPlan,
               qmodel: QuantizedModel | None = None,
               precision: str = "int8",
               worker_map: dict[int, int] | None = None) -> PlanDiff:
    """Classify every shard of ``new_split`` against ``old_split``.

    ``worker_map`` maps new worker slots to the old slots whose warm state
    they inherit (identity by default — slot ``w`` keeps slot ``w``'s
    stores).  Unmapped slots are fresh workers: everything they need ships.
    """
    old = _worker_setups(old_split, qmodel, precision)
    new = _worker_setups(new_split, qmodel, precision)
    if worker_map is None:
        worker_map = {w: w for w in new if w in old}

    old_seg_fps: dict[int, dict[str, int]] = {}   # worker -> {seg fp: gi}
    old_arr_fps: dict[int, set[str]] = {}
    all_old_segs: set[str] = set()
    for w, (meta, arrays) in old.items():
        segs, fps = {}, set()
        for spec in meta["segments"]:
            if "fingerprint" in spec:
                segs[spec["fingerprint"]] = spec["gi"]
                all_old_segs.add(spec["fingerprint"])
            fps.update(spec.get("array_fps", {}).values())
        old_seg_fps[w] = segs
        old_arr_fps[w] = fps

    entries: list[SegmentDiff] = []
    matched_old: set[tuple[int, str]] = set()
    full_bytes = 0
    reship_bytes = 0
    for w, (meta, arrays) in new.items():
        full_bytes += setup_array_bytes(arrays)
        old_w = worker_map.get(w)
        held = old_arr_fps.get(old_w, set()) if old_w is not None else set()
        reship_bytes += setup_array_bytes(delta_setup(meta, arrays, held))
        old_segs = old_seg_fps.get(old_w, {}) if old_w is not None else {}
        old_gis = set(old_segs.values())
        for spec in meta["segments"]:
            if spec["kind"] == "skip":
                continue
            fp, gi = spec["fingerprint"], spec["gi"]
            seg_keys = spec.get("array_fps", {})
            nbytes = sum(arrays[k].nbytes for k in seg_keys)
            seg_reship = sum(arrays[k].nbytes
                             for k, afp in seg_keys.items()
                             if afp not in held)
            if fp in old_segs:
                status = "unchanged"
                matched_old.add((old_w, fp))
            elif fp in all_old_segs:
                status = "moved"
            elif gi in old_gis:
                status = "resized"
                matched_old.add((old_w, fp))   # successor exists at this gi
            else:
                status = "new"
            entries.append(SegmentDiff(worker=w, gi=gi, status=status,
                                       nbytes=int(nbytes),
                                       reship_bytes=int(seg_reship)))
    inherited_old = set(worker_map.values())
    new_gis_by_old: dict[int, set[int]] = {}
    for e in entries:
        old_w = worker_map.get(e.worker)
        if old_w is not None:
            new_gis_by_old.setdefault(old_w, set()).add(e.gi)
    removed = 0
    for w, segs in old_seg_fps.items():
        if w not in inherited_old:
            removed += len(segs)
            continue
        removed += sum(1 for fp, gi in segs.items()
                       if (w, fp) not in matched_old
                       and gi not in new_gis_by_old.get(w, set()))
    return PlanDiff(entries=tuple(entries), removed=removed,
                    full_setup_bytes=int(full_bytes),
                    reshipped_bytes=int(reship_bytes))


class ElasticCoordinator:
    """Serve through churn: an ElasticCluster's policy driving a live
    Coordinator's mechanics.

    Async context manager::

        cluster = ElasticCluster(model, workers)
        async with ElasticCoordinator(cluster, qmodel) as ec:
            y = await ec.infer(x)          # survives worker death
            ec.cluster.mark_failed(2)      # or heartbeat staleness
            await ec.rebalance()           # explicit, or lazily on failure

    ``infer`` never silently drops a request: a worker failure triggers
    mark-failed + replan + retry (up to ``max_replans`` transitions per
    request); past ``queue_cap`` concurrent requests it sheds with typed
    ``Overloaded(reason="rebalancing")``.
    """

    def __init__(self, cluster: ElasticCluster,
                 qmodel: QuantizedModel | None = None, *,
                 precision: str = "int8", spawn: str = "process",
                 max_replans: int = 3, queue_cap: int = 16,
                 **coord_kwargs):
        self.cluster = cluster
        self.qmodel = qmodel
        self.precision = precision
        self.spawn = spawn
        self.max_replans = max_replans
        self.queue_cap = queue_cap
        self._coord_kwargs = coord_kwargs
        self.coord = Coordinator(cluster.plan.split, qmodel,
                                 precision=precision, spawn=spawn,
                                 **coord_kwargs)
        # split slot -> original (physical) worker id
        self._physical: dict[int, int] = dict(
            enumerate(cluster.plan_worker_ids))
        self.reports: list[dict] = []
        self._depth = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        await self.coord.start()

    async def close(self) -> None:
        await self.coord.close()

    async def __aenter__(self) -> "ElasticCoordinator":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- views -------------------------------------------------------------
    @property
    def split(self) -> SplitPlan:
        return self.coord.split

    @property
    def plan(self):
        return self.cluster.plan

    @property
    def physical_ids(self) -> dict[int, int]:
        """Live mapping: coordinator worker slot -> physical worker id."""
        return dict(self._physical)

    # -- churn signals -------------------------------------------------------
    def report_step_time(self, slot: int, seconds: float) -> None:
        pid = self._physical.get(slot)
        if pid is not None:
            self.cluster.report_step_time(pid, seconds)

    async def inject_failure(self, slot: int) -> None:
        """Kill the worker serving plan slot ``slot`` (fault injection)."""
        h = self.coord.handles[slot]
        if h.proc is not None:
            h.proc.kill()
        elif h.writer is not None:
            h.writer.close()

    async def rejoin(self, physical_id: int, params=None) -> dict:
        """A physical worker comes back; fold it into the plan."""
        self.cluster.rejoin(physical_id, params)
        return await self.rebalance()

    # -- the transition ------------------------------------------------------
    def _mark_failed_handles(self) -> list[int]:
        """Propagate coordinator-observed worker deaths into the cluster."""
        failed = []
        for slot, h in self.coord.handles.items():
            pid = self._physical.get(slot)
            if pid is None:
                continue
            if h.failed is not None:
                self.cluster.mark_failed(pid)
                failed.append(pid)
            else:
                self.cluster.heartbeat(pid)
        return failed

    async def rebalance(self) -> dict:
        """Re-plan over the cluster's current health and cut the live
        coordinator over, shipping only deltas.  Returns the transition
        report (downtime, reshipped vs full bytes, warm-cache hit rate)."""
        self._mark_failed_handles()
        self.cluster.check()
        new_ids = self.cluster.plan_worker_ids
        by_pid = {pid: slot for slot, pid in self._physical.items()}
        worker_map: dict[int, int] = {}
        for slot, pid in enumerate(new_ids):
            old_slot = by_pid.get(pid)
            if old_slot is None:
                continue
            h = self.coord.handles.get(old_slot)
            if h is not None and h.failed is None:
                worker_map[slot] = old_slot
        report = await self.coord.replan_to(self.cluster.plan.split,
                                            worker_map=worker_map)
        self._physical = dict(enumerate(new_ids))
        report["plan_worker_ids"] = list(new_ids)
        # decompose churn downtime: how much of it was plan *search* (and
        # how warm the cluster's persistent CostCache made that search)
        search = self.cluster.last_search_stats or {}
        report["replan_search_wall_s"] = search.get("search_wall_s", 0.0)
        report["replan_candidates_evaluated"] = search.get(
            "candidates_evaluated", 0)
        report["replan_cache_hits"] = search.get("cache_hits", 0)
        report["replan_cache_hit_rate"] = search.get("cache_hit_rate", 0.0)
        self.reports.append(report)
        return report

    # -- serving -------------------------------------------------------------
    async def infer(self, x) -> "object":
        """One request, served through any number of topology transitions
        (up to ``max_replans``) — bit-exact vs a single-process Session on
        the surviving topology, or a typed error; never a silent drop."""
        if self._depth >= self.queue_cap:
            from ..serve.admission import Overloaded
            raise Overloaded("elastic", "rebalancing",
                             queue_depth=self._depth)
        self._depth += 1
        try:
            for attempt in range(self.max_replans + 1):
                try:
                    return await self.coord.infer(x)
                except RuntimeError as e:
                    from ..serve.admission import Overloaded
                    if isinstance(e, Overloaded):
                        raise
                    dead = [slot for slot, h in self.coord.handles.items()
                            if h.failed is not None]
                    if not dead or attempt == self.max_replans:
                        raise
                    await self.rebalance()
        finally:
            self._depth -= 1

    async def infer_many(self, xs) -> list:
        return [await self.infer(x) for x in xs]
