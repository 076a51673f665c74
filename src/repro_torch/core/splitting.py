"""Fine-grained splitting strategy (paper §IV.B, Algorithms 1 and 2) plus the
spatial patch mode (MCUNetV2-style, beyond the paper).

Three partitioning modes:

* ``mode="neuron"`` (default, the paper's Algorithms 1/2): output neurons of
  every layer are partitioned into contiguous flat-index ranges, one per
  worker, proportional to capability ratings.  For conv layers the flat order
  is CHW row-major, so a worker's range touches a channel span ``[c_lo,c_hi]``
  and the worker receives exactly the kernels ``W[c]`` for the channels it
  touches (Alg. 1 lines 6–10: kernel assignment + usage counting).  For
  linear layers each column of the weight matrix is one output neuron
  (Alg. 2), so the worker receives the columns in its range.

* ``mode="kernel"``: conv/dwconv ranges are snapped to whole-channel
  boundaries (the strict kernel-wise reading of Alg. 1 — no kernel is ever
  duplicated, at the cost of coarser load balance).  Linear layers split
  neuron-wise as in Alg. 2.

* ``mode="spatial"``: conv/dwconv layers are partitioned along the output
  *height* axis — each worker owns a contiguous band of output rows across
  **all** channels, receiving the band's receptive-field input window (band +
  halo rows) and holding the **full** layer weights.  Whole inverted-residual
  blocks (``fusion.group_blocks``) execute fused per band, so intermediate
  activations (e.g. MobileNetV2's 6x expanded hidden) exist only at band
  size.  This trades weight replication + halo recompute for a much smaller
  activation working set — the winning trade in early high-resolution /
  low-channel stages where routed input regions dominate per-worker peak RAM.
  Linear/avgpool layers fall back to their flat splits.

Beyond the three uniform modes, :func:`split_model_mixed` builds a
*heterogeneous* plan: a different mode (and optionally a different worker
subset) per fused block, so the early high-resolution stages can run spatial
while the late channel-heavy stages run kernel/neuron — the regime split
MCUNetV2 exploits.  The per-block assignment is searched by
``search_mixed_assignment`` in the reference's ``core/mixed.py`` (the
planner slice of the port).

Port copy of ``repro/core/splitting.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .allocation import band_bounds
from .fusion import FusedBlock, group_blocks
from .reinterpret import LayerSpec, ReinterpretedModel, macs_for_positions

MODES = ("neuron", "kernel", "spatial")


@dataclasses.dataclass(frozen=True)
class WorkerShard:
    """One worker's share of one layer."""

    worker: int
    start: int                      # first assigned flat output index
    stop: int                       # one past last assigned flat output index
    # conv/dwconv: kernels (output channels) held locally, with usage counts
    # (Alg. 1 "increment usage count") — c -> number of assigned positions.
    kernel_usage: dict[int, int]
    # linear: columns held locally (== range(start, stop)); conv: channel span.
    weight_bytes: int               # fragment size at 1 byte/param (int8)

    @property
    def n_positions(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class SpatialShard(WorkerShard):
    """One worker's output-height band of one conv/dwconv layer
    (``mode="spatial"``).

    The worker computes output rows ``[row_lo, row_hi)`` of **every** channel
    and needs (unpadded) input rows ``[in_lo, in_hi)`` — its band's receptive
    field, i.e. band + halo rows, derived through the layer's row mapping.
    For layers inside a fused block the band includes the halo rows demanded
    by downstream stages, so ``n_positions`` over workers can exceed ``n_out``
    (halo recompute).  ``start``/``stop`` are unused (the band is not a
    contiguous CHW flat range); ``n_positions`` is overridden accordingly.
    """

    row_lo: int = 0                 # half-open output-row band
    row_hi: int = 0
    in_lo: int = 0                  # half-open unpadded input-row window
    in_hi: int = 0                  # (band + halo) routed/held by the worker
    out_channels: int = 0
    out_width: int = 0

    @property
    def n_positions(self) -> int:  # type: ignore[override]
        return (self.row_hi - self.row_lo) * self.out_width * self.out_channels

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo

    @property
    def in_rows(self) -> int:
        """Height of the routed/held input window (band + halo)."""
        return max(self.in_hi - self.in_lo, 0)


@dataclasses.dataclass(frozen=True)
class LayerSplit:
    layer: LayerSpec
    shards: list[WorkerShard]
    mode: str = "neuron"            # "neuron" | "kernel" | "spatial"
    # Fused-block position (spatial mode): only the first layer of a block
    # downloads routed input and only the last uploads aggregated output;
    # interior activations stay worker-local at band size.
    block_first: bool = True
    block_last: bool = True

    def shard_of(self, worker: int) -> WorkerShard:
        return self.shards[worker]


def partition_bounds(total: int, ratings: np.ndarray) -> np.ndarray:
    """Contiguous partition of ``range(total)`` proportional to ratings.

    Returns ``bounds`` of length N+1 with bounds[0]=0, bounds[-1]=total.
    Uses cumulative rounding so the shares are within 1 of the exact
    proportional amount and the partition is exact (no gaps/overlap) — the
    paper's ``while i - s < n`` loop with the remainder landing on the last
    worker, made deterministic.  One rounding rule for every axis:
    delegates to :func:`allocation.band_bounds`, so flat neuron/kernel
    ranges and spatial row bands can never diverge.
    """
    return band_bounds(ratings, total)


def split_conv_layer(layer: LayerSpec, ratings: np.ndarray) -> LayerSplit:
    """Algorithm 1: split a conv/dwconv layer across workers kernel-wise."""
    if layer.kind not in ("conv", "dwconv"):
        raise ValueError(f"not a conv layer: {layer.kind}")
    c, h, w = layer.out_shape
    hw = h * w
    bounds = partition_bounds(c * hw, ratings)
    per_kernel_params = int(np.prod(layer.weight.shape[1:])) if layer.weight is not None else 0
    shards = []
    for r in range(len(ratings)):
        s, e = int(bounds[r]), int(bounds[r + 1])
        usage: dict[int, int] = {}
        if e > s:
            c_lo, c_hi = s // hw, (e - 1) // hw
            for c1 in range(c_lo, c_hi + 1):
                # positions of channel c1 inside [s, e)
                lo = max(s, c1 * hw)
                hi = min(e, (c1 + 1) * hw)
                usage[c1] = hi - lo
        wbytes = len(usage) * per_kernel_params + len(usage)  # + per-channel bias
        shards.append(WorkerShard(r, s, e, usage, wbytes))
    return LayerSplit(layer, shards)


def split_linear_layer(layer: LayerSpec, ratings: np.ndarray) -> LayerSplit:
    """Algorithm 2: split a linear layer across workers column-wise."""
    if layer.kind != "linear":
        raise ValueError(f"not a linear layer: {layer.kind}")
    h_in = layer.in_shape[0]
    w_out = layer.out_shape[0]
    bounds = partition_bounds(w_out, ratings)
    shards = []
    for r in range(len(ratings)):
        s, e = int(bounds[r]), int(bounds[r + 1])
        usage = {j: 1 for j in range(s, e)}  # one column per output neuron
        wbytes = (e - s) * h_in + (e - s)
        shards.append(WorkerShard(r, s, e, usage, wbytes))
    return LayerSplit(layer, shards)


def split_conv_layer_kernel(layer: LayerSpec, ratings: np.ndarray) -> LayerSplit:
    """Strict kernel-wise split: contiguous *whole-channel* spans per worker
    (Alg. 1 without mid-channel boundaries — no kernel duplication)."""
    if layer.kind not in ("conv", "dwconv"):
        raise ValueError(f"not a conv layer: {layer.kind}")
    c, h, w = layer.out_shape
    hw = h * w
    c_bounds = partition_bounds(c, ratings)
    per_kernel_params = int(np.prod(layer.weight.shape[1:])) if layer.weight is not None else 0
    shards = []
    for r in range(len(ratings)):
        c_s, c_e = int(c_bounds[r]), int(c_bounds[r + 1])
        usage = {c1: hw for c1 in range(c_s, c_e)}
        wbytes = len(usage) * per_kernel_params + len(usage)
        shards.append(WorkerShard(r, c_s * hw, c_e * hw, usage, wbytes))
    return LayerSplit(layer, shards, mode="kernel")


def split_layer(layer: LayerSpec, ratings: np.ndarray,
                mode: str = "neuron") -> LayerSplit:
    if layer.kind in ("conv", "dwconv"):
        if mode == "kernel":
            return split_conv_layer_kernel(layer, ratings)
        return split_conv_layer(layer, ratings)
    if layer.kind == "linear":
        return split_linear_layer(layer, ratings)
    # avgpool & friends stay coordinator-side: zero-weight single "shard".
    shards = [WorkerShard(r, 0, 0, {}, 0) for r in range(len(ratings))]
    return LayerSplit(layer, shards)


def split_block_spatial(layers: list[LayerSpec],
                        ratings: np.ndarray) -> list[LayerSplit]:
    """Spatial split of one fused block (or singleton conv layer).

    The *block output* height is banded proportionally to ratings
    (``allocation.band_bounds``); each layer's per-worker band is then derived
    backwards through the block with the receptive-field row mapping
    (``LayerSpec.input_rows_for_output_rows``), so interior stages compute the
    halo rows their consumers need and the block-input window is exactly the
    band's receptive field (band + halo).
    """
    last = layers[-1]
    if any(lyr.kind not in ("conv", "dwconv") for lyr in layers):
        raise ValueError("spatial blocks must contain only conv/dwconv layers")
    n = len(ratings)
    h_out = last.out_shape[1]
    bounds = band_bounds(np.asarray(ratings, dtype=np.float64), h_out)
    # per layer, per worker: (row_lo, row_hi, in_lo, in_hi)
    bands: list[list[tuple[int, int, int, int]]] = [
        [None] * n for _ in layers]  # type: ignore[list-item]
    for w in range(n):
        r_lo, r_hi = int(bounds[w]), int(bounds[w + 1])
        for li in reversed(range(len(layers))):
            lyr = layers[li]
            if r_hi > r_lo:
                in_lo, in_hi = lyr.input_rows_for_output_rows(r_lo, r_hi - 1)
            else:
                in_lo = in_hi = 0
            bands[li][w] = (r_lo, r_hi, in_lo, in_hi)
            # the upstream stage must produce this stage's input window
            r_lo, r_hi = in_lo, in_hi
    splits: list[LayerSplit] = []
    for li, lyr in enumerate(layers):
        c_out, _, w_out = lyr.out_shape
        per_kernel_params = int(np.prod(lyr.weight.shape[1:])) if lyr.weight is not None else 0
        shards: list[WorkerShard] = []
        for w in range(n):
            r_lo, r_hi, in_lo, in_hi = bands[li][w]
            band_pos = (r_hi - r_lo) * w_out
            if band_pos > 0:
                usage = {c1: band_pos for c1 in range(c_out)}
                # full weights + per-channel bias replicated on active workers
                wbytes = c_out * per_kernel_params + c_out
            else:
                usage, wbytes = {}, 0
            shards.append(SpatialShard(w, 0, 0, usage, wbytes,
                                       row_lo=r_lo, row_hi=r_hi,
                                       in_lo=in_lo, in_hi=in_hi,
                                       out_channels=c_out, out_width=w_out))
        splits.append(LayerSplit(lyr, shards, mode="spatial",
                                 block_first=(li == 0),
                                 block_last=(li == len(layers) - 1)))
    return splits


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """Static output/input geometry of one conv/dwconv shard, precomputed
    host-side so a traced executor contains no geometry arithmetic.

    All fields are plain Python ints / numpy arrays fixed at plan-compile
    time (the flat ranges are data-independent): the channel span the worker
    holds kernels for, the output-row interval it produces, the padded-input
    row window the coordinator routes to it, and the flat map from its global
    output range ``[start, stop)`` into its computed bounding box.

    Because shards are contiguous ascending flat ranges and the bbox spans
    full rows whenever the shard crosses a channel boundary, ``bbox_index``
    is always a contiguous run — ``bbox_start`` exposes it as a plain slice
    offset so the hot path is a static slice, not a gather.  The index map is
    kept (and property-tested) because it is the general contract.
    """

    worker: int
    start: int                      # global flat output range [start, stop)
    stop: int
    c_lo: int                       # inclusive channel span of the fragment
    c_hi: int
    row_lo: int                     # inclusive output-row interval computed
    row_hi: int
    in_r0: int                      # padded-input row window routed to the
    in_r1: int                      # worker (half-open)
    bbox_index: np.ndarray          # int64 (n_positions,) map into bbox flat

    @property
    def n_positions(self) -> int:
        return self.stop - self.start

    @property
    def n_channels(self) -> int:
        return self.c_hi - self.c_lo + 1

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo + 1

    @property
    def bbox_start(self) -> int:
        """Offset of ``start`` inside the shard's bbox flat buffer (the
        contiguous-slice fast path; see class docstring)."""
        return int(self.bbox_index[0]) if self.n_positions else 0


@dataclasses.dataclass(frozen=True)
class SpatialBandGeometry:
    """Static band geometry of one spatial shard stage, precomputed host-side
    (the spatial counterpart of :class:`ShardGeometry`): the output-row band,
    the unpadded input-row window routed to / held by the worker (band +
    halo), and the explicit zero-padding rows to apply above/below the window
    so a VALID conv over ``pad(window)`` yields exactly rows
    ``[row_lo, row_hi)``.  Interior bands get halo rows instead of padding;
    bands touching the tensor edge get real zeros — both are plain Python
    ints, so the traced executors contain only static slices.
    """

    worker: int
    row_lo: int                     # half-open output-row band
    row_hi: int
    in_lo: int                      # half-open unpadded input-row window
    in_hi: int
    pad_top: int                    # zero rows above/below the window
    pad_bot: int

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo


def spatial_band_geometry(layer: LayerSpec,
                          split: LayerSplit) -> list[SpatialBandGeometry | None]:
    """Per-worker :class:`SpatialBandGeometry` for one spatial LayerSplit
    (``None`` for empty bands)."""
    kh, _ = layer.kernel
    sh, _ = layer.stride
    ph, _ = layer.padding
    out: list[SpatialBandGeometry | None] = []
    for shard in split.shards:
        if not isinstance(shard, SpatialShard):
            raise ValueError("spatial_band_geometry needs SpatialShards")
        if shard.row_hi <= shard.row_lo:
            out.append(None)
            continue
        # padded-input window of the band: [row_lo*sh, (row_hi-1)*sh + kh)
        win0 = shard.row_lo * sh
        win_len = (shard.row_hi - 1 - shard.row_lo) * sh + kh
        pad_top = max(0, ph - win0)
        pad_bot = win_len - pad_top - (shard.in_hi - shard.in_lo)
        assert pad_bot >= 0, "band window shorter than its padded extent"
        out.append(SpatialBandGeometry(shard.worker, shard.row_lo,
                                       shard.row_hi, shard.in_lo, shard.in_hi,
                                       pad_top, pad_bot))
    return out


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Full-model split: per-layer shards + per-worker totals.

    ``blocks`` holds the fused execution groups (tuples of layer indices) the
    executors iterate over — singletons except for spatial(-assigned) fused
    blocks, which run fused per band.

    ``mode`` is one of the uniform modes, or ``"mixed"`` for a heterogeneous
    plan built by :func:`split_model_mixed`.  Mixed plans additionally carry
    ``assignment`` — the per-fused-block mode vector over
    ``fusion.group_blocks(model)``, the canonical serialized form — and
    ``block_modes``, the effective mode of each entry of ``blocks`` (spatial
    assignments over non-conv blocks fall back to ``"neuron"`` there).
    """

    model: ReinterpretedModel
    splits: list[LayerSplit]
    ratings: np.ndarray
    mode: str = "neuron"
    blocks: tuple[tuple[int, ...], ...] | None = None
    # mixed plans only: per-group_blocks-block requested mode, and the
    # effective mode of each executor group in ``blocks``
    assignment: tuple[str, ...] | None = None
    block_modes: tuple[str, ...] | None = None

    @property
    def n_workers(self) -> int:
        return len(self.ratings)

    @property
    def block_groups(self) -> tuple[tuple[int, ...], ...]:
        if self.blocks is not None:
            return self.blocks
        return tuple((i,) for i in range(len(self.splits)))

    @property
    def group_modes(self) -> tuple[str, ...]:
        """Effective mode of every entry of :attr:`block_groups` (uniform
        plans report their single mode everywhere)."""
        if self.block_modes is not None:
            return self.block_modes
        return tuple(self.splits[g[0]].mode for g in self.block_groups)

    @property
    def is_mixed(self) -> bool:
        return self.mode == "mixed"

    def worker_weight_bytes(self, worker: int) -> int:
        return sum(sp.shard_of(worker).weight_bytes for sp in self.splits)

    def worker_macs(self, worker: int) -> int:
        return sum(
            macs_for_positions(sp.layer, sp.shard_of(worker).n_positions)
            for sp in self.splits)


def split_model(model: ReinterpretedModel, ratings,
                mode: str = "neuron", fused: bool = True) -> SplitPlan:
    """Split every layer with the same ratings vector (paper reuses R across
    layers; per-layer ratings are supported by calling split_layer directly).

    ``mode``: ``"neuron"`` (default, Alg. 1/2 flat ranges), ``"kernel"``
    (whole-channel conv spans), or ``"spatial"`` (output-height bands + fused
    blocks; see module docstring).

    ``fused`` (spatial only): ``True`` bands whole inverted-residual blocks
    (``fusion.group_blocks`` — interior activations stay at band size);
    ``False`` bands every layer independently (singleton blocks: no
    interior-halo recompute, more boundary traffic).  Ignored for the flat
    modes, which have a single granularity.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
    ratings = np.asarray(ratings, dtype=np.float64)
    if mode != "spatial":
        splits = [split_layer(lyr, ratings, mode) for lyr in model.layers]
        return SplitPlan(model=model, splits=splits, ratings=ratings, mode=mode)
    grouping = (group_blocks(model) if fused
                else [FusedBlock((i,)) for i in range(len(model.layers))])
    splits_by_idx: dict[int, LayerSplit] = {}
    blocks: list[tuple[int, ...]] = []
    for block in grouping:
        layers = [model.layers[i] for i in block.indices]
        if all(lyr.kind in ("conv", "dwconv") for lyr in layers):
            for idx, sp in zip(block.indices, split_block_spatial(layers, ratings)):
                splits_by_idx[idx] = sp
            blocks.append(tuple(block.indices))
        else:
            # linear / avgpool: spatial banding does not apply — flat split,
            # one singleton block per layer.
            for idx in block.indices:
                splits_by_idx[idx] = split_layer(model.layers[idx], ratings)
                blocks.append((idx,))
    splits = [splits_by_idx[i] for i in range(len(model.layers))]
    return SplitPlan(model=model, splits=splits, ratings=ratings,
                     mode="spatial", blocks=tuple(blocks))


def _masked_ratings(ratings: np.ndarray,
                    workers: tuple[int, ...] | None) -> np.ndarray:
    """Zero out every rating outside ``workers`` (None keeps all).  The
    excluded workers receive empty shards everywhere in the block — the
    per-block worker-subset mechanism of mixed plans."""
    if workers is None:
        return ratings
    mask = np.zeros_like(ratings)
    for w in workers:
        if not 0 <= int(w) < len(ratings):
            raise ValueError(f"worker index {w} outside cluster of "
                             f"{len(ratings)} workers")
        mask[int(w)] = ratings[int(w)]
    if mask.sum() <= 0:
        raise ValueError("block worker subset has no positive rating")
    return mask


def split_model_mixed(model: ReinterpretedModel, ratings,
                      assignment,
                      block_workers=None) -> SplitPlan:
    """Heterogeneous split: a different partitioning mode per fused block.

    ``assignment`` is a sequence of modes (one of :data:`MODES`), one per
    fused block of ``fusion.group_blocks(model)``.  A block assigned
    ``"spatial"`` runs fused per output-row band (as in
    ``split_model(mode="spatial")``); blocks assigned a flat mode execute
    layer-by-layer like the uniform flat plans.  A ``"spatial"`` assignment
    over a block containing non-conv layers falls back to the flat neuron
    split, exactly like the uniform spatial constructor — the *effective*
    per-group modes are recorded in ``SplitPlan.block_modes``.

    ``block_workers`` (optional) gives each block its own worker subset: a
    sequence aligned with ``assignment`` whose entries are iterables of
    worker indices (or ``None`` for all workers).  Excluded workers receive
    empty shards for the block's layers; every split still spans the full
    cluster width, so cross-boundary accounting (``mapping.comm_volume``,
    ``memory.plan_memory``) indexes consistently even when adjacent blocks
    use different subsets.

    The resulting plan has ``mode="mixed"`` and both executors run it
    directly — each block group dispatches on its own split mode, and int8
    execution stays bit-exact across every mode seam (tested in
    ``tests/test_mixed.py``).
    """
    ratings = np.asarray(ratings, dtype=np.float64)
    grouping = group_blocks(model)
    assignment = tuple(assignment)
    if len(assignment) != len(grouping):
        raise ValueError(
            f"assignment length {len(assignment)} != {len(grouping)} fused "
            f"blocks (group_blocks granularity)")
    for m in assignment:
        if m not in MODES:
            raise ValueError(f"unknown mode {m!r} (want one of {MODES})")
    if block_workers is None:
        block_workers = [None] * len(grouping)
    block_workers = list(block_workers)
    if len(block_workers) != len(grouping):
        raise ValueError(
            f"block_workers length {len(block_workers)} != "
            f"{len(grouping)} fused blocks")
    splits_by_idx: dict[int, LayerSplit] = {}
    blocks: list[tuple[int, ...]] = []
    block_modes: list[str] = []
    for block, mode, subset in zip(grouping, assignment, block_workers):
        sub = None if subset is None else tuple(int(w) for w in subset)
        r_b = _masked_ratings(ratings, sub)
        layers = [model.layers[i] for i in block.indices]
        if (mode == "spatial"
                and all(lyr.kind in ("conv", "dwconv") for lyr in layers)):
            for idx, sp in zip(block.indices,
                               split_block_spatial(layers, r_b)):
                splits_by_idx[idx] = sp
            blocks.append(tuple(block.indices))
            block_modes.append("spatial")
        else:
            eff = mode if mode != "spatial" else "neuron"
            for idx in block.indices:
                splits_by_idx[idx] = split_layer(model.layers[idx], r_b, eff)
                blocks.append((idx,))
                block_modes.append(eff)
    splits = [splits_by_idx[i] for i in range(len(model.layers))]
    return SplitPlan(model=model, splits=splits, ratings=ratings,
                     mode="mixed", blocks=tuple(blocks),
                     assignment=assignment, block_modes=tuple(block_modes))
