"""Elastic runtime: failure handling, straggler mitigation, and re-allocation
— the paper's Eq. 7 overflow-redistribution reused as the recovery policy.

Two deployment worlds share this module:

* **MCU cluster** (the paper's): :class:`ElasticCluster` tracks per-worker
  health from heartbeats/observed step times, demotes stragglers by scaling
  their capability rating (the same quantity Eq. 5 defines, floored at a
  fraction of the original rating so repeated demotions cannot collapse a
  worker to zero), drops dead workers, and re-plans over the survivors with
  the full :class:`~repro_torch.api.Planner` search — every axis the planner
  knows (mode x fusion x subset x transport), not just neuron splitting,
  with Eq. 7's overflow redistribution and the RAM/flash caps enforced
  inside the search.

  Worker *identity* is preserved across replans: the produced
  :class:`~repro_torch.api.Plan` indexes an alive-only subset cluster, and
  :attr:`ElasticCluster.plan_worker_ids` maps each plan worker slot back to
  the original worker id — so a coordinator can tell which physical worker
  inherits which shard, and ship only the delta
  (:meth:`~repro_torch.runtime.Coordinator.replan_to`).

* **TPU pod**: checkpoints restore onto a smaller mesh (ckpt/checkpoint.py
  restores with new shardings); `plan_recovery_mesh` picks the largest
  (data, model) mesh that still divides the surviving chip count, and the
  caller rebuilds the train step against it.

Port copy of ``repro/runtime/elastic.py`` (numpy only, no torch): the port
cannot import the reference, whose package pulls in JAX, so it carries
this copy and
``tests/test_torch_elastic.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.allocation import WorkerParams


class ClusterCollapsed(RuntimeError):
    """Every worker is dead — no surviving workers to re-plan over."""


@dataclasses.dataclass
class WorkerHealth:
    params: WorkerParams
    alive: bool = True
    last_heartbeat: float = 0.0
    ema_step_time: float | None = None   # straggler signal


class ElasticCluster:
    """Rating-based elastic membership + re-planning for the MCU world.

    Holds the *policy* only (who is alive, how capable) — the transition
    mechanics (delta shipping, warm recompiles, atomic cutover) live in
    :class:`~repro_torch.runtime.replan.ElasticCoordinator`.

    ``plan`` is a full :class:`repro_torch.api.Plan` over the alive subset;
    ``plan_worker_ids[i]`` is the original worker id serving plan slot
    ``i`` (the planner may choose a strict subset of the living workers).
    """

    def __init__(self, model, workers: list[WorkerParams], *,
                 objective=None, sim_cfg=None,
                 heartbeat_timeout: float = 5.0,
                 straggler_factor: float = 1.5,
                 demotion_floor: float = 0.25,
                 clock=time.monotonic):
        if not 0.0 < demotion_floor <= 1.0:
            raise ValueError(f"demotion_floor must be in (0, 1], "
                             f"got {demotion_floor}")
        self.model = model
        self.objective = objective
        self.sim_cfg = sim_cfg
        self.timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.demotion_floor = demotion_floor
        # injectable clock: timeout policy is testable without sleeping
        self._clock = clock
        self.health = [WorkerHealth(p, last_heartbeat=self._clock())
                       for p in workers]
        self._original = tuple(workers)      # pre-demotion ratings basis
        self._planned_alive: tuple[int, ...] = tuple(range(len(workers)))
        self.plan_worker_ids: tuple[int, ...] = ()
        # one CostCache for the cluster's lifetime: replan keys fingerprint
        # worker *parameters*, so a churn event that drops one worker re-plans
        # over survivor subsets the initial search already costed — the warm
        # path the churn drill asserts on (hit rate > 0, lower search wall)
        from ..core.search import CostCache
        self.search_cache = CostCache()
        self.last_search_stats: dict | None = None
        self.plan = self._replan()

    # -- signals ------------------------------------------------------------
    def heartbeat(self, worker: int, now: float | None = None):
        # `if now is None`, not `now or ...`: t=0.0 is a valid fake-clock
        # timestamp and must not silently fall through to the real clock
        self.health[worker].last_heartbeat = (
            self._clock() if now is None else now)

    def report_step_time(self, worker: int, seconds: float, alpha=0.5):
        h = self.health[worker]
        h.ema_step_time = (seconds if h.ema_step_time is None
                           else alpha * seconds + (1 - alpha) * h.ema_step_time)

    def mark_failed(self, worker: int):
        self.health[worker].alive = False

    def rejoin(self, worker: int, params: WorkerParams | None = None,
               now: float | None = None):
        """A previously dead/demoted worker comes back (fresh process): it
        re-enters at its original (or newly measured) capability with a
        clean straggler history.  Call :meth:`check` to fold it into the
        plan."""
        h = self.health[worker]
        h.alive = True
        h.params = params if params is not None else self._original[worker]
        h.last_heartbeat = self._clock() if now is None else now
        h.ema_step_time = None

    # -- policy ---------------------------------------------------------------
    def check(self, now: float | None = None) -> bool:
        """Apply failure + straggler policy; returns True if the plan changed."""
        now = self._clock() if now is None else now
        changed = tuple(self.alive_indices) != self._planned_alive
        for h in self.health:
            if h.alive and now - h.last_heartbeat > self.timeout:
                h.alive = False
                changed = True
        times = [h.ema_step_time for h in self.health
                 if h.alive and h.ema_step_time]
        if times:
            med = float(np.median(times))
            for i, h in enumerate(self.health):
                if h.alive and h.ema_step_time and \
                        h.ema_step_time > self.straggler_factor * med:
                    # straggler: demote its effective clock so the rating —
                    # and therefore its Alg. 1/2 share — shrinks.  Floored
                    # at demotion_floor x the original clock so repeated
                    # demotions cannot compound a worker to zero.
                    floor = self.demotion_floor * self._original[i].f_mhz
                    h.params = dataclasses.replace(
                        h.params,
                        f_mhz=max(floor,
                                  h.params.f_mhz * med / h.ema_step_time))
                    h.ema_step_time = None
                    changed = True
        if changed:
            self.plan = self._replan()
        return changed

    def _replan(self):
        from ..api.cluster import Cluster
        from ..api.planner import Planner
        self._planned_alive = tuple(self.alive_indices)
        alive_ids = list(self._planned_alive)
        if not alive_ids:
            raise ClusterCollapsed("no surviving workers")
        sub = Cluster(tuple(self.health[i].params for i in alive_ids),
                      name=f"alive[{len(alive_ids)}]")
        planner = Planner(self.model, sub, self.sim_cfg,
                          cache=self.search_cache)
        plan = planner.plan(self.objective)
        self.last_search_stats = plan.search_stats
        # plan.worker_indices index the alive-only subset; map back to the
        # original ids so worker identity survives the replan
        self.plan_worker_ids = tuple(alive_ids[i]
                                     for i in plan.worker_indices)
        return plan

    @property
    def alive_indices(self) -> list[int]:
        return [i for i, h in enumerate(self.health) if h.alive]


def plan_recovery_mesh(n_surviving: int, model_axis: int = 16) -> tuple[int, int]:
    """Largest (data, model) mesh on the surviving chips, keeping the model
    axis intact (TP degree is baked into layer shardings); data shrinks."""
    if n_surviving < model_axis:
        raise ValueError(f"need >= {model_axis} chips, have {n_surviving}")
    return (n_surviving // model_axis, model_axis)
