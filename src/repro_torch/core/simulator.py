"""Networked-MCU simulator (paper §VII.D): one coordinator + N workers with
the same partitioning and communication logic as the testbed, scaled to 120
workers.

Timing model (paper Eq. 1):
    t_w = W_w / f_w + (d_w + 1/B_w) * f(W_w)
with the compute term refined by a frequency-independent flash-access
component that reproduces Table I's observation that K1 *rises* as the clock
drops (memory-bound fraction grows with f):

    cycles(macs, f) = macs * (CPM + FLASH_NS * f_mhz / 1000)

Communication volumes are not modeled with Eq. 2's linear f(W)=K1*Kc*W
approximation — they are *derived exactly* from the cross-layer activation
mapping (RouteM): per layer, each worker downloads its input region bytes
(duplication across overlapping receptive fields included) and uploads its
assigned outputs.  Eq. 2's Kc then falls out of the simulation
(Kc = comm_bytes / out_bytes per unit workload) instead of being assumed.

Transport policies (``SimConfig.transport``):

* ``"serial"`` (default) — the paper's Eq. 5–6 behavior, bit-compatible
  with every committed baseline: all traffic flows through the coordinator,
  which serializes sends and receives per layer boundary.
* ``"pipelined"`` — an event-driven async transport: each
  coordinator<->worker link is an independent full-duplex FIFO queue with
  that worker's ``d``/``B`` from :class:`WorkerParams`, and download ->
  compute -> upload are overlappable stages per worker (a worker computes
  shard *i* while downloading shard *i+1*'s input region and uploading
  shard *i-1*'s output).  Uploads stream eagerly (§V.D): an upload occupies
  the uplink from compute *start* and completes no earlier than both the
  compute and the wire time.  A download of shard *i+1* becomes ready once
  the uploads it depends on have completed — for spatial plans that is only
  the producers whose output rows overlap the consumer's input window
  (band + halo), so disjoint bands pipeline deeply; flat neuron/kernel
  shards consume overlapping regions of every producer and degrade to a
  per-boundary barrier.  The result carries a per-worker :class:`Timeline`
  of events reduced to makespan / link-utilization / idle-time stats.
  With a single worker there is no second link to overlap with and the
  policies coincide by construction (the serial schedule *is* the
  single-link timeline).

Port copy of ``repro/core/simulator.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .allocation import WorkerParams
from .mapping import comm_volume
from .memory import layerwise_peak
from .reinterpret import ReinterpretedModel, macs_for_positions
from .splitting import SpatialShard, SplitPlan, split_model

TRANSPORTS = ("serial", "pipelined")


@dataclasses.dataclass
class SimConfig:
    cycles_per_mac: float = 73.0      # CPM, calibrated vs Table I/II (bench)
    flash_ns_per_mac: float = 118.0   # frequency-independent weight-fetch ns
    itemsize: int = 1                 # int8 activations on the wire
    overlap: bool = True              # §V.D eager partial-result streaming
    coordinator_bw_kb_s: float = 115000.0  # PC side (GbE) — rarely binding
    transport: str = "serial"         # "serial" (Eq. 5-6) | "pipelined"

    def __post_init__(self) -> None:
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(want one of {TRANSPORTS})")


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    """One scheduled stage on one worker's pipeline."""

    worker: int
    kind: str                   # "download" | "compute" | "upload"
    segment: int                # transfer-segment index (fused block / layer)
    layer: int                  # first layer index of the segment
    start_s: float
    end_s: float
    nbytes: int = 0             # transfer events only (0 for compute)

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Per-worker event schedule produced by the pipelined transport.

    ``events`` are globally start-ordered; per worker, events of one kind
    never overlap (each link direction and the core are FIFO resources),
    but an upload may overlap its own compute (§V.D streaming) and a
    download may overlap other workers' stages.
    """

    n_workers: int
    events: tuple[TimelineEvent, ...]
    makespan_s: float

    def worker_events(self, worker: int) -> tuple[TimelineEvent, ...]:
        return tuple(e for e in self.events if e.worker == worker)

    def busy_s(self, kind: str) -> np.ndarray:
        """Per-worker total busy seconds for one stage kind."""
        out = np.zeros(self.n_workers)
        for e in self.events:
            if e.kind == kind:
                out[e.worker] += e.duration_s
        return out

    @property
    def compute_busy_s(self) -> np.ndarray:
        return self.busy_s("compute")

    @property
    def link_busy_s(self) -> np.ndarray:
        """Per-worker seconds the link is occupied (download + upload)."""
        return self.busy_s("download") + self.busy_s("upload")

    @property
    def idle_s(self) -> np.ndarray:
        """Per-worker seconds the core sits idle inside the makespan."""
        return np.maximum(self.makespan_s - self.compute_busy_s, 0.0)

    @property
    def link_utilization(self) -> np.ndarray:
        """Per-worker fraction of the makespan the link is busy."""
        if self.makespan_s <= 0:
            return np.zeros(self.n_workers)
        return self.link_busy_s / self.makespan_s


@dataclasses.dataclass
class SimResult:
    layer_comp: np.ndarray      # (L,) per-layer compute critical path (s)
    layer_comm: np.ndarray      # (L,) per-layer communication critical path (s)
    layer_bytes: np.ndarray     # (L,) total bytes moved at this boundary
    per_worker_comp: np.ndarray  # (L, N) compute seconds
    per_worker_comm: np.ndarray  # (L, N)
    # (L, N) bytes; None when the caller passed compute_peak=False (the
    # planner gates RAM via memory.peak_ram_per_worker on the same split,
    # so the layerwise sweep here would be duplicate work on the search
    # hot path)
    peak_ram: np.ndarray | None
    # transport="pipelined" extras.  The layer_* arrays above always hold the
    # serial (Eq. 5-6) decomposition, so the serial-equivalent latency stays
    # derivable from any result; ``timeline`` carries the event schedule.
    transport: str = "serial"
    timeline: Timeline | None = None

    @property
    def layer_total(self) -> np.ndarray:
        return self.layer_comp + self.layer_comm

    @property
    def serial_total_time(self) -> float:
        """End-to-end seconds under the serial (Eq. 5-6) transport."""
        return float(self.layer_total.sum())

    @property
    def total_time(self) -> float:
        if self.timeline is not None:
            return float(self.timeline.makespan_s)
        return self.serial_total_time

    @property
    def overlap_saved_s(self) -> float:
        """Seconds the pipelined transport saves vs serial (0 when serial)."""
        if self.timeline is None:
            return 0.0
        return self.serial_total_time - float(self.timeline.makespan_s)

    @property
    def comp_time(self) -> float:
        if self.timeline is not None:
            # compute critical path under overlap: the busiest core
            return float(self.timeline.compute_busy_s.max())
        return float(self.layer_comp.sum())

    @property
    def comm_time(self) -> float:
        return self.total_time - self.comp_time

    @property
    def total_bytes(self) -> int:
        return int(self.layer_bytes.sum())


def _comp_seconds(macs: np.ndarray, f_mhz: np.ndarray, cfg: SimConfig) -> np.ndarray:
    cycles = macs * (cfg.cycles_per_mac + cfg.flash_ns_per_mac * f_mhz / 1000.0)
    return cycles / (f_mhz * 1e6)


def simulate(model: ReinterpretedModel, workers: list[WorkerParams],
             ratings: np.ndarray | None = None,
             cfg: SimConfig | None = None,
             plan: SplitPlan | None = None,
             compute_peak: bool = True) -> SimResult:
    """Run one end-to-end inference through the timing model.

    ``ratings`` defaults to uniform; ``plan`` may be passed to reuse a split
    — including heterogeneous ``split_model_mixed`` plans, whose segments
    are timed under both transports (spatial→spatial seams keep the exact
    row-overlap dependencies, mixed seams barrier per boundary).
    ``cfg.transport`` picks the communication model: ``"serial"`` (Eq. 5-6,
    the default) or ``"pipelined"`` (per-link FIFO queues with overlapped
    download/compute/upload; the result carries a :class:`Timeline`).
    ``compute_peak=False`` skips the layerwise peak-RAM sweep (the result's
    ``peak_ram`` is None) — for callers like the plan search that gate RAM
    separately on the same split.
    """
    cfg = cfg or SimConfig()
    n = len(workers)
    for i, p in enumerate(workers):
        if p.b_kb_s <= 0:
            raise ValueError(f"worker {i}: zero-bandwidth link "
                             f"(b_kb_s={p.b_kb_s!r}) cannot move activations")
    if ratings is None:
        ratings = np.ones(n)
    if plan is None:
        plan = split_model(model, ratings)
    f_mhz = np.array([p.f_mhz for p in workers])
    d = np.array([p.d_s_per_kb for p in workers])
    inv_b = np.array([1.0 / p.b_kb_s for p in workers])

    L = len(model.layers)
    comp = np.zeros((L, n))
    comm = np.zeros((L, n))
    nbytes = np.zeros(L)
    down_s = np.zeros((L, n))    # per-layer per-worker download wire time
    up_s = np.zeros((L, n))      # upload wire time of layer li-1's producers
    down_b = np.zeros((L, n), dtype=np.int64)
    up_b = np.zeros((L, n), dtype=np.int64)
    per_layer_total = np.zeros(L)
    layer_comp_arr = np.zeros(L)
    prev_split = None
    for li, split in enumerate(plan.splits):
        layer = split.layer
        macs = np.array([macs_for_positions(layer, split.shard_of(w).n_positions)
                         for w in range(n)], dtype=np.float64)
        comp[li] = _comp_seconds(macs, f_mhz, cfg)
        vol = comm_volume(prev_split, layer, split, itemsize=cfg.itemsize)
        down_kb = vol.download_bytes / 1024.0
        up_kb = vol.upload_bytes / 1024.0
        # per-worker link time (Eq. 1's communication term, exact bytes)
        t_down = (d + inv_b) * down_kb
        t_up = (d + inv_b) * up_kb
        comm[li] = t_down + t_up
        nbytes[li] = vol.total_bytes
        down_s[li], up_s[li] = t_down, t_up
        down_b[li], up_b[li] = vol.download_bytes, vol.upload_bytes
        prev_split = split
        # all traffic flows through the coordinator (§VI.B), which serializes
        # sends/receives — the reason communication grows with N (Fig. 9/10)
        t_down_serial = t_down.sum()
        t_up_serial = t_up.sum()
        max_comp = comp[li].max()
        if cfg.overlap:
            # eager partial results (§V.D): uploads stream while other
            # workers still compute
            totals = t_down_serial + np.maximum(max_comp, t_up_serial)
        else:
            totals = t_down_serial + max_comp + t_up_serial
        per_layer_total[li] = totals
        layer_comp_arr[li] = max_comp

    layer_comp = layer_comp_arr
    layer_comm = per_layer_total - layer_comp
    timeline = None
    if cfg.transport == "pipelined":
        if n == 1:
            timeline = _single_link_timeline(per_layer_total, comp, down_s,
                                             up_s, down_b, up_b, cfg.overlap)
        else:
            timeline = _pipelined_timeline(plan, comp, down_s, up_s,
                                           down_b, up_b)
    return SimResult(layer_comp=layer_comp, layer_comm=layer_comm,
                     layer_bytes=nbytes, per_worker_comp=comp,
                     per_worker_comm=comm,
                     peak_ram=(layerwise_peak(plan, itemsize=cfg.itemsize)
                               if compute_peak else None),
                     transport=cfg.transport, timeline=timeline)


def _single_link_timeline(per_layer_total: np.ndarray, comp: np.ndarray,
                          down_s: np.ndarray, up_s: np.ndarray,
                          down_b: np.ndarray, up_b: np.ndarray,
                          overlap: bool) -> Timeline:
    """With one worker there is no second link to overlap with: the pipelined
    transport degenerates to the serial schedule (makespan == Eq. 5-6 total),
    rendered as that worker's timeline."""
    events: list[TimelineEvent] = []
    t = 0.0
    for li in range(comp.shape[0]):
        if down_b[li, 0]:
            events.append(TimelineEvent(0, "download", li, li, t,
                                        t + down_s[li, 0],
                                        int(down_b[li, 0])))
        c0 = t + down_s[li, 0]
        if comp[li, 0] > 0:
            events.append(TimelineEvent(0, "compute", li, li, c0,
                                        c0 + comp[li, 0]))
        if up_b[li, 0]:
            # layer li's bucket carries the *previous* boundary's upload —
            # streamed alongside this layer's compute exactly as Eq. 5-6's
            # overlap term does, or after it when overlap is off
            u0 = c0 if overlap else c0 + comp[li, 0]
            events.append(TimelineEvent(0, "upload", li, max(li - 1, 0), u0,
                                        u0 + up_s[li, 0], int(up_b[li, 0])))
        t += per_layer_total[li]
    return Timeline(n_workers=1, events=tuple(events),
                    makespan_s=float(per_layer_total.sum()))


def _segments(plan: SplitPlan) -> list[tuple[int, ...]]:
    """Transfer segments: maximal runs of layers that exchange no traffic
    internally (fused spatial blocks; singleton for every flat layer)."""
    segs: list[list[int]] = []
    for li, split in enumerate(plan.splits):
        if split.block_first or not segs:
            segs.append([li])
        else:
            segs[-1].append(li)
    return [tuple(s) for s in segs]


def _boundary_deps(prev_split, split, up_bytes: np.ndarray) -> list[list[int]]:
    """For each consumer worker of ``split``, the producer workers of
    ``prev_split`` whose uploads its download waits on.

    When both sides are spatial bands the dependency is exact: only the
    producers whose output rows intersect the consumer's input window
    (band + halo).  Flat shards consume overlapping regions of essentially
    every producer, so they (and mixed boundaries) wait on every producer
    that uploads anything — the per-boundary barrier the serial model also
    implies.
    """
    n = len(split.shards)
    # producers are enumerated over the *producer* split's width (up_bytes
    # is producer-indexed — see CommVolume), consumers over this split's
    uploading = [p for p in range(len(prev_split.shards))
                 if p < len(up_bytes) and up_bytes[p] > 0]
    spatial = (all(isinstance(s, SpatialShard) for s in split.shards)
               and all(isinstance(s, SpatialShard) for s in prev_split.shards))
    if not spatial:
        return [list(uploading) for _ in range(n)]
    deps: list[list[int]] = []
    for w in range(n):
        cs = split.shards[w]
        if cs.n_positions == 0:
            deps.append([])
            continue
        deps.append([p for p in uploading
                     if prev_split.shards[p].row_lo < cs.in_hi
                     and prev_split.shards[p].row_hi > cs.in_lo])
    return deps


def pipelined_dependencies(plan: SplitPlan,
                           itemsize: int = 1) -> list[list[list[int]]]:
    """Per segment boundary, per consumer worker: the producer workers whose
    uploads the consumer's download waits on under the pipelined transport.

    ``result[b][w]`` lists the producers of segment ``b`` (the boundary
    between segments ``b`` and ``b+1``) that consumer worker ``w`` of segment
    ``b+1`` depends on — :func:`_boundary_deps` evaluated with the exact
    upload volumes of the boundary.  This is the public form shared by
    :func:`_pipelined_timeline` and the real distributed runtime
    (``repro_torch.runtime.coordinator``), so the simulated and the executed
    schedule derive their dependency edges from one definition.
    """
    segs = _segments(plan)
    deps: list[list[list[int]]] = []
    for si in range(1, len(segs)):
        first = segs[si][0]
        prev_split = plan.splits[segs[si - 1][-1]]
        split = plan.splits[first]
        vol = comm_volume(prev_split, split.layer, split, itemsize=itemsize)
        deps.append(_boundary_deps(prev_split, split, vol.upload_bytes))
    return deps


def dependency_edges(plan: SplitPlan) -> set[tuple[int, int, int]]:
    """The pipelined schedule's dependency-edge set, as
    ``(consumer_segment, consumer_worker, producer_worker)`` triples.

    A download for segment ``s`` on worker ``w`` may not start before
    producer ``p``'s segment ``s-1`` upload completed.  The measured runtime
    Timeline must realize a *superset* of these edges (a barrier waits on
    more producers, never fewer) — the structural half of the
    measured-vs-predicted validation in ``runtime/validate.py``.
    """
    return {(si + 1, w, p)
            for si, boundary in enumerate(pipelined_dependencies(plan))
            for w, producers in enumerate(boundary)
            for p in producers}


def _pipelined_timeline(plan: SplitPlan, comp: np.ndarray,
                        down_s: np.ndarray, up_s: np.ndarray,
                        down_b: np.ndarray, up_b: np.ndarray) -> Timeline:
    """Event-driven schedule over per-worker full-duplex FIFO links.

    Per segment ``s`` and worker ``w`` three stages are scheduled:

    * download: starts once the downlink is free *and* the uploads it
      depends on (:func:`_boundary_deps`) completed;
    * compute: starts once the download landed and the core is free;
    * upload (eager §V.D streaming): occupies the uplink from compute start,
      completes no earlier than the compute and the wire time.

    Earliest-start scheduling over fixed FIFO orders is deterministic and,
    with ``cfg.overlap=False`` serial as the reference, never slower — the
    serial schedule satisfies every constraint here, plus the coordinator
    serialization this transport removes.
    """
    n = comp.shape[1]
    segs = _segments(plan)
    dl_free = np.zeros(n)
    up_free = np.zeros(n)
    core_free = np.zeros(n)
    up_end = np.zeros(n)          # upload completion of the previous segment
    events: list[TimelineEvent] = []
    for si, seg in enumerate(segs):
        first = seg[0]
        seg_comp = comp[list(seg)].sum(axis=0)
        if si == 0:
            deps = [[] for _ in range(n)]
        else:
            deps = _boundary_deps(plan.splits[segs[si - 1][-1]],
                                  plan.splits[first], up_b[first])
        prev_up_end = up_end.copy()
        new_up_end = np.zeros(n)
        for w in range(n):
            ready = max((prev_up_end[p] for p in deps[w]), default=0.0)
            dl_start = max(ready, dl_free[w])
            dl_end = dl_start + down_s[first, w]
            if down_b[first, w]:
                events.append(TimelineEvent(w, "download", si, first,
                                            dl_start, dl_end,
                                            int(down_b[first, w])))
            dl_free[w] = dl_end
            c_start = max(dl_end, core_free[w])
            c_end = c_start + seg_comp[w]
            if seg_comp[w] > 0:
                events.append(TimelineEvent(w, "compute", si, first,
                                            c_start, c_end))
            core_free[w] = c_end
            # the upload of this segment's output is accounted at the next
            # segment's first layer (comm_volume's prev-split convention)
            if si + 1 < len(segs):
                nxt = segs[si + 1][0]
                if up_b[nxt, w]:
                    u_start = max(c_start, up_free[w])
                    u_end = max(c_end, u_start + up_s[nxt, w])
                    events.append(TimelineEvent(w, "upload", si, first,
                                                u_start, u_end,
                                                int(up_b[nxt, w])))
                    up_free[w] = u_end
                    new_up_end[w] = u_end
                else:
                    new_up_end[w] = c_end
            else:
                new_up_end[w] = c_end
        up_end = new_up_end
    makespan = 0.0
    if events:
        makespan = max(e.end_s for e in events)
    events.sort(key=lambda e: (e.start_s, e.worker, e.kind))
    return Timeline(n_workers=n, events=tuple(events), makespan_s=makespan)


@dataclasses.dataclass(frozen=True)
class ModeReport:
    """One partitioning mode's simulated cost profile (compare_modes).

    ``feasible=False`` marks a mode whose split could not be built for the
    given workers/ratings (``reason`` says why); its metrics are NaN/0 and
    must not be compared.  The transport stats are meaningful for
    ``transport="pipelined"`` (zero under serial, which has no timeline).
    """

    mode: str
    total_time_s: float
    comp_time_s: float
    comm_time_s: float
    total_bytes: int
    max_peak_ram: int        # max over layers x workers (Fig. 12's metric)
    max_weight_bytes: int    # largest per-worker weight footprint
    transport: str = "serial"
    overlap_saved_s: float = 0.0     # serial-equivalent minus makespan
    mean_link_utilization: float = 0.0
    max_idle_s: float = 0.0          # worst per-worker core idle time
    feasible: bool = True
    reason: str | None = None


def compare_modes(model: ReinterpretedModel, workers: list[WorkerParams],
                  ratings: np.ndarray | None = None,
                  cfg: SimConfig | None = None,
                  modes: tuple[str, ...] = ("neuron", "kernel", "spatial"),
                  ) -> dict[str, ModeReport]:
    """Simulate the same deployment under each partitioning mode — the
    comm/peak-RAM tradeoff report: spatial trades weight replication + halo
    recompute for a smaller activation working set and less routed traffic in
    the early high-resolution stages; the channel/neuron modes split weights
    but route overlapping input regions to every worker.

    A mode whose split cannot be built for these workers yields an explicit
    infeasible entry (``feasible=False`` plus the reason) instead of being
    silently dropped or aborting the surviving modes.
    """
    out: dict[str, ModeReport] = {}
    for mode in modes:
        try:
            plan = split_model(model, ratings if ratings is not None
                               else np.ones(len(workers)), mode=mode)
            res = simulate(model, workers, ratings, cfg, plan=plan)
        except (ValueError, RuntimeError) as e:
            out[mode] = ModeReport(
                mode=mode, total_time_s=float("nan"),
                comp_time_s=float("nan"), comm_time_s=float("nan"),
                total_bytes=0, max_peak_ram=0, max_weight_bytes=0,
                transport=(cfg or SimConfig()).transport,
                feasible=False, reason=f"{type(e).__name__}: {e}")
            continue
        tl = res.timeline
        out[mode] = ModeReport(
            mode=mode,
            total_time_s=res.total_time,
            comp_time_s=res.comp_time,
            comm_time_s=res.comm_time,
            total_bytes=res.total_bytes,
            max_peak_ram=int(res.peak_ram.max()),
            max_weight_bytes=max(plan.worker_weight_bytes(w)
                                 for w in range(plan.n_workers)),
            transport=res.transport,
            overlap_saved_s=res.overlap_saved_s,
            mean_link_utilization=(float(tl.link_utilization.mean())
                                   if tl is not None else 0.0),
            max_idle_s=float(tl.idle_s.max()) if tl is not None else 0.0)
    return out


def measured_kc(model: ReinterpretedModel, n_workers: int,
                cfg: SimConfig | None = None) -> float:
    """Estimate Eq. 2's communication coefficient Kc by 'profiling or
    simulation' (§V.B): bytes exchanged per byte of output produced."""
    cfg = cfg or SimConfig()
    plan = split_model(model, np.ones(n_workers))
    total_out = sum(lyr.n_out for lyr in model.layers) * cfg.itemsize
    total_comm = 0
    prev = None
    for split in plan.splits:
        total_comm += comm_volume(prev, split.layer, split, cfg.itemsize).total_bytes
        prev = split
    return total_comm / max(total_out, 1)


def simulated_k1(model: ReinterpretedModel, f_mhz: float,
                 cfg: SimConfig | None = None) -> float:
    """Table I's K1 (KB of output per Mcycle) at a given clock, single MCU,
    no transfers (the paper's dummy-input measurement)."""
    cfg = cfg or SimConfig()
    macs = model.total_macs()
    out_kb = sum(lyr.n_out for lyr in model.layers) * cfg.itemsize / 1024.0
    mcycles = macs * (cfg.cycles_per_mac + cfg.flash_ns_per_mac * f_mhz / 1000.0) / 1e6
    return out_kb / mcycles
