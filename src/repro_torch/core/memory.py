"""Peak-RAM accounting (paper §IV.B: peak memory = input activations +
weight parameters + output activations; evaluated per layer per worker).

This is the analytic counterpart of the paper's on-device heap probe
(§VII.A Metrics): per worker per layer we count the routed input bytes
(exact region sizes from the cross-layer mapping), the local weight-fragment
bytes, and the assigned output bytes.  Weight fragments live in flash on the
real system, but during computation the active kernel is staged in RAM, so
the paper's peak includes all three terms.

Spatial mode: a banded shard's input term is its band's receptive-field row
window (band + halo) across all channels — halo rows are therefore counted
once per worker that holds them (halo duplication).  For layers inside a
fused block the window is produced locally rather than routed, but it is
resident worker RAM all the same, and the weight term is the *full* layer
(spatial mode replicates weights instead of splitting them).

Port copy of ``repro/core/memory.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_planner.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mapping import worker_input_regions
from .splitting import LayerSplit, SplitPlan


@dataclasses.dataclass(frozen=True)
class LayerMemory:
    layer_name: str
    per_worker_in: np.ndarray       # routed input activation bytes
    per_worker_weight: np.ndarray   # weight fragment bytes
    per_worker_out: np.ndarray      # assigned output bytes

    @property
    def per_worker_peak(self) -> np.ndarray:
        return self.per_worker_in + self.per_worker_weight + self.per_worker_out


def split_memory(split: LayerSplit, itemsize: int = 1,
                 weight_itemsize: int | None = None) -> LayerMemory:
    """The three per-worker memory terms of one layer's split — the single
    source of the (in + weight + out) accounting, shared by
    :func:`plan_memory` and the mode-mixing DP (``core.mixed``)."""
    weight_itemsize = itemsize if weight_itemsize is None else weight_itemsize
    n = len(split.shards)
    regions = worker_input_regions(split.layer, split)
    m_in = np.array([sum(r.n_points for r in regs) * itemsize
                     for regs in regions], dtype=np.int64)
    m_w = np.array([split.shard_of(w).weight_bytes * weight_itemsize
                    for w in range(n)], dtype=np.int64)
    m_out = np.array([split.shard_of(w).n_positions * itemsize
                      for w in range(n)], dtype=np.int64)
    return LayerMemory(split.layer.name, m_in, m_w, m_out)


def plan_memory(plan: SplitPlan, itemsize: int = 1,
                weight_itemsize: int | None = None) -> list[LayerMemory]:
    """Per-layer, per-worker memory terms (itemsize=1 → int8 activations)."""
    return [split_memory(split, itemsize, weight_itemsize)
            for split in plan.splits]


def peak_ram_per_worker(plan: SplitPlan, itemsize: int = 1,
                        weight_itemsize: int | None = None) -> np.ndarray:
    """max over layers of (in + weight + out) per worker — Fig. 12's metric.

    ``weight_itemsize`` defaults to ``itemsize`` (the ``plan_memory``
    contract), so a float-weights/int8-activations peak query is
    ``peak_ram_per_worker(plan, itemsize=1, weight_itemsize=4)``."""
    mems = plan_memory(plan, itemsize, weight_itemsize)
    return np.max(np.stack([m.per_worker_peak for m in mems]), axis=0)


def layerwise_peak(plan: SplitPlan, itemsize: int = 1,
                   weight_itemsize: int | None = None) -> np.ndarray:
    """(n_layers, n_workers) peak bytes — Fig. 8's metric.  ``weight_itemsize``
    as in :func:`peak_ram_per_worker`."""
    mems = plan_memory(plan, itemsize, weight_itemsize)
    return np.stack([m.per_worker_peak for m in mems])


def single_device_peak(model, itemsize: int = 1) -> int:
    """Monolithic per-layer peak (full in + full weights + full out) — the
    'infeasible on a single MCU' baseline (§VII.B.1)."""
    return max((lyr.n_in + lyr.n_out) * itemsize + lyr.weight_bytes(itemsize)
               for lyr in model.layers)
