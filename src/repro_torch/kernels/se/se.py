"""Launchers of the hand-written CUDA squeeze-and-excitation kernels
(``csrc/se.cu``).

* :func:`se_pool` — the global average pool of a stack of spatial band
  windows (or of whole samples), each band's own rows counted once, summed
  in exact int32 and requantized: the reduction across workers that cuts a
  spatial MBConv block.
* :func:`se_gate` — the gate multiply: each element of the stack times its
  sample's and channel's int8 gate code, in exact int32, then one float32
  requantizing multiply.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``se_pool.launches`` and ``se_gate.launches`` count
launches (a launch captured into a CUDA graph counts once, its replays do
not).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from .ref import se_gate_ref, se_pool_ref

THREADS = 256
MAX_BANDS = 64
MAX_C_TILE = 2048
CTAS_PER_SM = 2          # CTAs per SM the pool's channel tiles aim at
GATE_CTAS_PER_SM = 8     # CTAs per SM of the gate's grid-stride loop


@functools.cache
def _entries():
    lib = backend.library("se")
    p, i = ctypes.c_void_p, ctypes.c_int
    pool = lib.se_pool_s8
    pool.argtypes = [p, p, ctypes.POINTER(i), i, i, i, i, i, ctypes.c_float,
                     p]
    pool.restype = ctypes.c_int
    gate = lib.se_gate_s8
    gate.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
    gate.restype = ctypes.c_int
    return pool, gate


def pool_c_tile(bsz: int, c: int, n_sm: int = 132) -> int:
    """Channels a pool CTA takes: few enough that the bsz x channel tiles
    reach ``CTAS_PER_SM`` CTAs an SM where the channels allow."""
    n_ct = max(1, min(c, -(-CTAS_PER_SM * n_sm // max(bsz, 1))))
    return min(MAX_C_TILE, -(-c // n_ct))


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=1024)
def _valid(rows: tuple[int, ...], width: int):
    return (ctypes.c_int * len(rows))(*(r * width for r in rows))


def se_pool(x, rows, factor: float):
    """x: (bsz * bands, C, R, W) int8, band b of each sample owning its
    first ``rows[b]`` rows (``rows``: a tuple, one entry a band; whole
    samples: ``(H,)``).  Returns (bsz, C) int8: clip(round(f32(sum) *
    factor)), the sum over every band's own rows of each channel."""
    rows = tuple(int(r) for r in rows)
    nb, c, r, w = x.shape
    if x.dtype != torch.int8 or not rows or nb % len(rows):
        raise ValueError(f"se_pool of {tuple(x.shape)} {x.dtype} over "
                         f"{len(rows)} bands")
    if max(rows) > r or min(rows) < 0:
        raise ValueError(f"se_pool rows {rows} outside {r}")
    if x.device.type == "cpu":
        return se_pool_ref(x, rows, factor)
    if len(rows) > MAX_BANDS:
        raise ValueError(f"se_pool over {len(rows)} bands")
    bsz = nb // len(rows)
    out = torch.empty((bsz, c), dtype=torch.int8, device=x.device)
    x = _aligned(x)
    c_tile = pool_c_tile(bsz, c, backend.sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entries()[0](x.data_ptr(), out.data_ptr(), _valid(rows, w),
                           bsz, len(rows), c, r * w, c_tile, factor, stream)
    se_pool.launches += 1
    backend.check("se", status, f"se_pool NB={nb} C={c} R={r} W={w}")
    return out


def se_gate(x, g, factor: float):
    """x: (bsz * bands, C, R, W) int8 (bands >= 1); g: (bsz, C) int8 gate
    codes.  Returns x's shape in int8: clip(round(f32(x * g) * factor))."""
    bsz, c = g.shape
    nb = x.shape[0]
    if (x.dtype != torch.int8 or g.dtype != torch.int8 or x.dim() != 4
            or x.shape[1] != c or nb % bsz):
        raise ValueError(f"se_gate of {tuple(x.shape)} by {tuple(g.shape)}")
    if x.device.type == "cpu":
        return se_gate_ref(x, g, factor)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"se_gate of {n} elements")
    x, g = _aligned(x), g.contiguous()
    out = torch.empty_like(x)
    if n == 0:
        return out
    grid = min(-(-n // (16 * THREADS)),
               GATE_CTAS_PER_SM * backend.sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entries()[1](x.data_ptr(), g.data_ptr(), out.data_ptr(), n,
                           x.shape[2] * x.shape[3], c, nb // bsz, factor,
                           grid, stream)
    se_gate.launches += 1
    backend.check("se", status, f"se_gate NB={nb} C={c}")
    return out


se_pool.launches = se_gate.launches = 0
se_pool.kernels_per_launch = se_gate.kernels_per_launch = 1
