"""Cross-layer activation mapping (paper §IV.C, Algorithm 3).

Two implementations, tested against each other:

* :func:`assignm_bruteforce` / :func:`routem_bruteforce` — the *literal*
  Algorithm 3: iterate every output position of layer ``i+1``, trace its
  receptive field with ``get_input()``, OR worker bits into ``AssignM``;
  then walk layer ``i``'s producer shards and emit ``RouteM`` entries.
  O(total MACs) — used for small layers and as the test oracle.

* :func:`worker_input_regions` — the scalable closed form.  Because shards
  are contiguous flat ranges (Alg. 1), the union of receptive fields of a
  shard decomposes into, per touched channel-group, per output row, one input
  column interval.  This gives identical point sets to brute force (property
  tested) at O(rows) cost instead of O(neurons·k²·Cin).

Byte accounting derived from these mappings drives both the simulator's
communication model (Eq. 1's f(W)) and the peak-RAM model (paper Fig. 8).

Port copy of ``repro/core/mapping.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .reinterpret import LayerSpec
from .splitting import LayerSplit, ShardGeometry, SpatialShard


# ---------------------------------------------------------------------------
# Literal Algorithm 3 (test oracle; small layers)
# ---------------------------------------------------------------------------

def assignm_bruteforce(layer: LayerSpec, split: LayerSplit) -> np.ndarray:
    """Stage 1 of Alg. 3: bitmask over *input* positions of ``layer`` marking
    which workers (computing ``layer``'s outputs) need each input activation."""
    if split.mode == "spatial":
        raise ValueError("assignm_bruteforce operates on flat-range shards; "
                         "spatial bands are covered by worker_input_regions")
    ci, hi, wi = layer.in_shape
    assign_m = np.zeros((ci, hi, wi), dtype=np.int64)
    c_out, h_out, w_out = layer.out_shape
    hw = h_out * w_out
    for shard in split.shards:
        bit = np.int64(1) << np.int64(shard.worker)
        for j in range(shard.start, shard.stop):
            c = j // hw
            h = (j % hw) // w_out
            w = j % w_out
            for (cc, hh, ww) in layer.get_input(c, h, w):
                assign_m[cc, hh, ww] |= bit
    return assign_m


def routem_bruteforce(prev_split: LayerSplit, assign_m: np.ndarray) -> list[tuple[int, int]]:
    """Stage 2 of Alg. 3: for each producer worker of the previous layer, the
    (producer, consumer-bitmask) pairs for every activation it produced."""
    flat = assign_m.reshape(-1)
    route_m: list[tuple[int, int]] = []
    for shard in prev_split.shards:
        for j in range(shard.start, shard.stop):
            route_m.append((shard.worker, int(flat[j])))
    return route_m


# ---------------------------------------------------------------------------
# Scalable region form
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputRegion:
    """Input activations a worker needs: per channel-interval, per input row,
    a list of disjoint column intervals.  Channels half-open [c_lo, c_hi)."""

    c_lo: int
    c_hi: int
    # row -> list of (col_lo, col_hi) disjoint, sorted, half-open intervals
    row_intervals: dict[int, list[tuple[int, int]]]

    @property
    def n_points(self) -> int:
        per_ch = sum(hi - lo for ivs in self.row_intervals.values()
                     for (lo, hi) in ivs)
        return int((self.c_hi - self.c_lo) * per_ch)

    def bounding_slices(self) -> tuple[slice, slice, slice]:
        """Channel/row/col bounding box (used by the executor to slice the
        activation tensor it is routed — a contiguous buffer, as an MCU would
        receive).

        **Over-approximation contract:** the bbox is the smallest *contiguous*
        window covering the region, not the region itself.  For layers with
        ``stride > kernel`` the receptive rows/cols of a shard have gaps, and
        the bbox silently includes the gap rows — its volume can exceed
        :attr:`n_points`.  Byte accounting (``comm_volume``, ``plan_memory``)
        must therefore always use :attr:`n_points` (exact) and never the bbox
        volume; the bbox is only a slicing convenience for code paths that
        tolerate routing a superset (see ``bbox_points`` and the
        gap-regression tests in ``tests/test_mixed.py``)."""
        rows = sorted(self.row_intervals)
        lo = min(iv[0] for ivs in self.row_intervals.values() for iv in ivs)
        hi = max(iv[1] for ivs in self.row_intervals.values() for iv in ivs)
        return (slice(self.c_lo, self.c_hi),
                slice(rows[0], rows[-1] + 1), slice(lo, hi))

    @property
    def bbox_points(self) -> int:
        """Volume of :meth:`bounding_slices` — ``>= n_points``, with strict
        inequality whenever the region has row/col gaps (stride > kernel).
        Kept distinct from ``n_points`` so no caller can conflate the routed
        superset with the exact byte count."""
        cs, rs, ws = self.bounding_slices()
        return ((cs.stop - cs.start) * (rs.stop - rs.start)
                * (ws.stop - ws.start))

    def point_set(self) -> set[tuple[int, int, int]]:
        pts = set()
        for c in range(self.c_lo, self.c_hi):
            for r, ivs in self.row_intervals.items():
                for (lo, hi) in ivs:
                    for w in range(int(lo), int(hi)):
                        pts.add((c, int(r), w))
        return pts


def _merge_intervals(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    ivs = sorted(ivs)
    out: list[tuple[int, int]] = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _rows_cols_for_flat_range(layer: LayerSpec, start: int, stop: int) -> list[tuple[int, int, int, int]]:
    """Decompose flat output range [start, stop) into per-channel
    (channel, h_lo, h_hi, full_row_mask) pieces, then to (h, w_lo, w_hi)
    output spans.  Returns list of (out_row, out_col_lo, out_col_hi, channel).
    """
    c_out, h_out, w_out = layer.out_shape
    hw = h_out * w_out
    spans: list[tuple[int, int, int, int]] = []
    j = start
    while j < stop:
        c = j // hw
        within = j - c * hw
        row = within // w_out
        col = within % w_out
        # how far can we run within this row?
        row_end_flat = c * hw + (row + 1) * w_out
        run_end = min(stop, row_end_flat)
        spans.append((row, col, col + (run_end - j), c))
        j = run_end
    return spans


def worker_input_regions(layer: LayerSpec, split: LayerSplit) -> list[list[InputRegion]]:
    """For every worker computing ``layer``, the exact input regions required
    (union of receptive fields of its assigned output positions)."""
    ci, hi_in, wi_in = layer.in_shape
    out: list[list[InputRegion]] = []
    for shard in split.shards:
        regions: list[InputRegion] = []
        if layer.kind == "gate":
            out.append(_gate_regions(layer, shard))
            continue
        if isinstance(shard, SpatialShard):
            # spatial band: all input channels x the band's receptive-field
            # row window (band + halo) x full width.  For fused interior
            # layers this window is produced locally rather than routed, but
            # it is resident worker RAM either way — and it is where the halo
            # duplication shows up in the peak-RAM accounting.
            if shard.n_positions > 0 and shard.in_hi > shard.in_lo:
                regions.append(InputRegion(
                    0, ci,
                    {r: [(0, wi_in)]
                     for r in range(shard.in_lo, shard.in_hi)}))
            out.append(regions)
            continue
        if shard.n_positions > 0:
            if layer.kind in ("linear", "avgpool"):
                regions.append(InputRegion(
                    0, ci, {r: [(0, wi_in)] for r in range(hi_in)}))
            else:
                # group output spans: per-channel for dwconv (channel-local
                # receptive field), all-channel for dense conv.
                spans = _rows_cols_for_flat_range(layer, shard.start, shard.stop)
                per_key: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
                for (row, w_lo, w_hi, c) in spans:
                    key = (c, c + 1) if layer.kind == "dwconv" else (0, ci)
                    per_key.setdefault(key, []).append((row, w_lo, w_hi))
                _, sw = layer.stride
                _, kw = layer.kernel
                for (c_lo, c_hi), row_spans in per_key.items():
                    col_map: dict[int, list[tuple[int, int]]] = {}
                    for (row, w_lo, w_hi) in row_spans:
                        r_lo, r_hi = layer.input_rows_for_output_rows(row, row)
                        if sw > kw:
                            # stride gaps: footprints of adjacent output cols
                            # are disjoint — one interval per output column
                            ivs = [layer.input_cols_for_output_cols(j, j)
                                   for j in range(w_lo, w_hi)]
                        else:
                            ivs = [layer.input_cols_for_output_cols(w_lo, w_hi - 1)]
                        for r in range(r_lo, r_hi):
                            col_map.setdefault(r, []).extend(ivs)
                    col_map = {r: _merge_intervals(ivs)
                               for r, ivs in col_map.items()}
                    regions.append(InputRegion(c_lo, c_hi, col_map))
        out.append(regions)
    return out


def _gate_regions(layer: LayerSpec, shard) -> list[InputRegion]:
    """What a gate shard is routed: the factors of the channels it touches
    and, for a flat shard, its own positions of the gated activation (a
    spatial shard scales the depthwise band its worker kept, which is
    resident, not routed: ``memory.plan_memory`` counts it)."""
    if shard.n_positions == 0:
        return []
    c_out, _, w_out = layer.out_shape
    if isinstance(shard, SpatialShard):
        return [InputRegion(0, c_out, {0: [(0, 1)]})]
    spans = _rows_cols_for_flat_range(layer, shard.start, shard.stop)
    chans = sorted({c for *_, c in spans})
    regions = [InputRegion(chans[0], chans[-1] + 1, {0: [(0, 1)]})]
    per_ch: dict[int, dict[int, list[tuple[int, int]]]] = {}
    for row, w_lo, w_hi, c in spans:
        per_ch.setdefault(c, {}).setdefault(row, []).append((w_lo, w_hi))
    regions += [InputRegion(c, c + 1, rows) for c, rows in per_ch.items()]
    return regions


def compile_shard_geometry(layer: LayerSpec,
                           split: LayerSplit) -> list[ShardGeometry | None]:
    """Precompute each conv/dwconv shard's static geometry (paper Alg. 3
    made static): channel span, output-row interval, routed padded-input row
    window, and the flat map from the global output range into the shard's
    bounding box.  Entries are ``None`` for empty shards and for layer kinds
    whose shards carry no spatial geometry (linear / avgpool).

    This is the host-side half of the compiled executor: everything here is
    data-independent, so the traced function consumes only the resulting
    Python ints (static slices) and constant index arrays.

    Spatial-mode splits carry banded geometry instead — see
    :func:`splitting.spatial_band_geometry`; entries here are ``None``.
    """
    if layer.kind not in ("conv", "dwconv") or split.mode == "spatial":
        return [None] * len(split.shards)
    c_out, h_out, w_out = layer.out_shape
    hw = h_out * w_out
    sh, _ = layer.stride
    kh, _ = layer.kernel
    out: list[ShardGeometry | None] = []
    for shard in split.shards:
        if shard.n_positions == 0:
            out.append(None)
            continue
        s, e = shard.start, shard.stop
        c_lo, c_hi = s // hw, (e - 1) // hw
        if c_hi > c_lo:
            # union bbox over partial first/last channels spans all rows
            row_lo, row_hi = 0, h_out - 1
        else:
            row_lo = (s - c_lo * hw) // w_out
            row_hi = (e - 1 - c_lo * hw) // w_out
        in_r0 = row_lo * sh
        in_r1 = row_hi * sh + kh
        idx = np.arange(s, e)
        c = idx // hw
        rem = idx % hw
        r = rem // w_out
        col = rem % w_out
        n_rows = row_hi - row_lo + 1
        bbox_index = (c - c_lo) * (n_rows * w_out) + (r - row_lo) * w_out + col
        # shards are contiguous ascending ranges, so the bbox map is a
        # contiguous run (ShardGeometry.bbox_start relies on this)
        assert np.array_equal(bbox_index,
                              np.arange(len(bbox_index)) + bbox_index[0])
        out.append(ShardGeometry(shard.worker, s, e, int(c_lo), int(c_hi),
                                 int(row_lo), int(row_hi), int(in_r0),
                                 int(in_r1), bbox_index))
    return out


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Bytes moved between layers (through the coordinator, §VI.B).

    ``upload_bytes`` is indexed by *producer* worker id (length = the
    previous split's worker count); ``download_bytes`` by *consumer* worker
    id (length = this split's worker count).  The two arrays may differ in
    length when adjacent splits cover different worker sets — mixed plans
    with per-block subsets are the common case."""

    upload_bytes: np.ndarray       # per producer worker: outputs sent up
    download_bytes: np.ndarray     # per consumer worker: inputs sent down
    duplication: float             # Σ download / unique activation bytes

    @property
    def total_bytes(self) -> int:
        return int(self.upload_bytes.sum() + self.download_bytes.sum())


def comm_volume(prev_split: LayerSplit | None, layer: LayerSpec,
                split: LayerSplit, itemsize: int = 1) -> CommVolume:
    """Coordinator-routed traffic for one layer boundary.

    * upload: each producer sends each of its outputs once to the coordinator
      (layer ``i`` outputs). For the first layer (prev_split None) upload=0.
    * download: each consumer receives exactly its input region (AssignM-
      driven); overlap across consumers is duplicated traffic — the effect
      that makes communication dominate at higher worker counts (Fig. 9/10).

    Fused spatial blocks only exchange at block boundaries: a layer that is
    not ``block_first`` downloads nothing (its input band is produced
    locally by the previous fused stage) and a producer that is not
    ``block_last`` uploads nothing (its output never leaves the worker).

    ``upload_bytes`` is sized by the *producer* split's worker count and
    ``download_bytes`` by the *consumer* split's — adjacent splits may cover
    worker sets of different sizes (per-block subsets in mixed plans), and
    sizing the upload array by the consumer would index producer worker ids
    out of (or silently into the wrong slot of) a consumer-sized array.
    """
    # no producer for the first layer: keep consumer width so the all-zero
    # upload row still broadcasts into per-worker accumulators
    up = np.zeros(len(prev_split.shards) if prev_split is not None
                  else len(split.shards), dtype=np.int64)
    if prev_split is not None and prev_split.block_last:
        for shard in prev_split.shards:
            up[shard.worker] += shard.n_positions * itemsize
    elif (prev_split is not None and layer.kind == "avgpool"
          and prev_split.mode == "spatial"):
        # a squeeze-and-excitation pool cutting a spatial block: each band
        # sends up its channels' int32 partial sums, which the coordinator
        # reduces
        for shard in prev_split.shards:
            if shard.n_positions:
                up[shard.worker] += layer.in_shape[0] * 4
    down = np.zeros(len(split.shards), dtype=np.int64)
    if split.block_first:
        regions = worker_input_regions(layer, split)
        for wkr, regs in enumerate(regions):
            down[wkr] = sum(r.n_points for r in regs) * itemsize
    unique = layer.n_in * itemsize
    dup = float(down.sum()) / unique if unique else 0.0
    return CommVolume(up, down, dup)
