"""Resource-aware workload allocation (paper §V, Eq. 1-7).

Capability ratings combine computation speed and communication overhead
(Eq. 5); workload is allocated proportionally (Eq. 6); storage overflow is
redistributed iteratively while preserving the rating sum (Eq. 7).

Units follow the paper: ``f`` in MHz, workload ``W`` in Mcycles, ``d`` in
seconds/KB, ``B`` in KB/s, ``K1`` in KB/Mcycle.

Port copy of ``repro/core/allocation.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkerParams:
    """Measured characteristics of one worker MCU (collected at deployment
    initialization, §III Pipeline)."""

    f_mhz: float = 600.0          # clock frequency
    d_s_per_kb: float = 0.0       # per-KB communication delay
    b_kb_s: float = 11500.0       # bandwidth (KB/s); Teensy 4.1 ~100 Mbps
    ram_bytes: int = 512 * 1024   # usable RAM budget (peak constraint)
    flash_bytes: int = 8 * 1024 * 1024  # weight-fragment storage limit


def execution_time(w_mcycles: float, p: WorkerParams, k1: float, kc: float) -> float:
    """Eq. 1: t = W/f + (d + 1/B) * f(W), with f(W) = K1*Kc*W (Eq. 2)."""
    comm_kb = k1 * kc * w_mcycles
    return w_mcycles / p.f_mhz + (p.d_s_per_kb + 1.0 / p.b_kb_s) * comm_kb


def capability_rating(p: WorkerParams, k1: float, kc: float) -> float:
    """Eq. 5: R = f*K1 / ((d + 1/B) * f * K1 * Kc + 1).

    R is the KB of output data the MCU can produce per second, accounting for
    the communication it must perform to do so.  kc=0 (no communication)
    degenerates to pure compute throughput f*K1.
    """
    fk1 = p.f_mhz * k1
    return fk1 / ((p.d_s_per_kb + 1.0 / p.b_kb_s) * fk1 * kc + 1.0)


def ratings_for(workers: list[WorkerParams], k1: float,
                kc: float | np.ndarray) -> np.ndarray:
    kcs = np.broadcast_to(np.asarray(kc, dtype=np.float64), (len(workers),))
    return np.array([capability_rating(p, k1, float(k)) for p, k in zip(workers, kcs)])


def proportional_allocation(ratings: np.ndarray, total_size: float) -> np.ndarray:
    """Eq. 6: S_i = R_i * S_m / sum(R)."""
    ratings = np.asarray(ratings, dtype=np.float64)
    return ratings * total_size / ratings.sum()


def redistribute_overflow(ratings: np.ndarray, capacities: np.ndarray,
                          total_size: float, max_iter: int = 1000) -> np.ndarray:
    """Eq. 7: iteratively move overflowed rating mass to workers with spare
    storage, preserving sum(R).

    For an over-capacity worker: R_io = (S_i - S_it) * sum(R) / S_m; the
    overflow is redistributed *evenly* among workers with remaining capacity
    (paper: "to avoid excessive load imbalance").  Repeats until all weight
    fragments fit.  Raises if total capacity < total_size (infeasible).
    """
    ratings = np.asarray(ratings, dtype=np.float64).copy()
    capacities = np.asarray(capacities, dtype=np.float64)
    if capacities.sum() < total_size:
        raise ValueError(
            f"infeasible: total capacity {capacities.sum():.0f} B < model {total_size:.0f} B")
    total_r = ratings.sum()
    for _ in range(max_iter):
        sizes = proportional_allocation(ratings, total_size)
        over = sizes > capacities + 1e-9
        if not over.any():
            break
        overflow_r = np.where(over, (sizes - capacities) * total_r / total_size, 0.0)
        ratings -= overflow_r
        # redistribute evenly among workers with remaining storage capacity
        has_room = ~over & (sizes < capacities - 1e-9)
        if not has_room.any():
            # every worker is at/over capacity but the sum fits: pin each
            # over-capacity worker exactly at capacity and give the rest
            # proportionally to the remainder.
            has_room = ~over
            if not has_room.any():
                raise RuntimeError("redistribution failed to converge")
        ratings[has_room] += overflow_r.sum() / has_room.sum()
    else:
        raise RuntimeError("redistribution failed to converge")
    assert abs(ratings.sum() - total_r) < 1e-6 * max(total_r, 1.0), "rating sum not preserved"
    return ratings


def allocate(workers: list[WorkerParams], k1: float, kc: float | np.ndarray,
             model_bytes: float) -> tuple[np.ndarray, np.ndarray]:
    """Full §V pipeline: ratings -> proportional sizes -> overflow fix.

    Returns (adjusted_ratings, per_worker_bytes).
    """
    r = ratings_for(workers, k1, kc)
    caps = np.array([p.flash_bytes for p in workers], dtype=np.float64)
    r = redistribute_overflow(r, caps, model_bytes)
    return r, proportional_allocation(r, model_bytes)


# Spatial (patch) partitioning ------------------------------------------------

def band_bounds(ratings: np.ndarray, n_rows: int) -> np.ndarray:
    """Contiguous output-row bands proportional to capability ratings — Eq. 6
    applied to the spatial axis instead of the neuron axis (the allocation
    half of ``mode="spatial"``; splitting.py turns these bounds into per-layer
    banded shards with halos).

    Returns ``bounds`` of length N+1 with bounds[0]=0, bounds[-1]=n_rows,
    within one unit of the exact proportional share.  This cumulative
    rounding is the single partition rule for every axis —
    ``splitting.partition_bounds`` delegates here for flat neuron/kernel
    ranges too.
    """
    ratings = np.asarray(ratings, dtype=np.float64)
    if np.any(ratings < 0):
        raise ValueError("ratings must be non-negative")
    s = ratings.sum()
    if s <= 0:
        raise ValueError("at least one rating must be positive")
    cum = np.cumsum(ratings) / s
    bounds = np.concatenate([[0], np.round(cum * n_rows).astype(np.int64)])
    bounds[-1] = n_rows
    return np.maximum.accumulate(bounds)


def band_heights(ratings: np.ndarray, n_rows: int) -> np.ndarray:
    """Per-worker band heights (rows) from capability ratings."""
    return np.diff(band_bounds(ratings, n_rows))


# Baselines used in Table II --------------------------------------------------

def ratings_evenly(workers: list[WorkerParams]) -> np.ndarray:
    """'Evenly' baseline: uniform split."""
    return np.ones(len(workers), dtype=np.float64)


def ratings_freq_only(workers: list[WorkerParams]) -> np.ndarray:
    """'Freq.-only' baseline: proportional to clock frequency."""
    return np.array([p.f_mhz for p in workers], dtype=np.float64)
