"""Launcher of the hand-written CUDA qgemm kernel (``csrc/qgemm.cu``).

Port of the TPU kernel ``qgemm`` in ``repro/kernels/qgemm/qgemm.py``.  The
CUDA kernel masks ragged M, N and K edges itself, so unlike the TPU kernel
it takes any shape: the host pads nothing.  A CPU tensor takes the plain
version (:func:`.ref.qgemm_ref`); a CUDA tensor launches the kernel or
raises.  ``qgemm.launches`` counts kernel launches (one kernel each); a
launch captured into a CUDA graph counts once, its replays do not.

The kernel reads the weight K-contiguous.  The engine uploads each weight
as (N, K) and passes its (K, N) transposed view (``stride(0) == 1``), so
column slices stay row ranges of that storage and nothing is copied; a
row-major (K, N) weight, as the tests and the reference's contract give
it, is copied to that layout first and counted in
``qgemm.weight_copies``.

:func:`qgemm_schedule` picks the tile height and the split over K from the
shape and the SM count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.quantize import f32
from .. import backend
from .ref import qgemm_ref

_ACTIVATIONS = {None: 0, "relu": 1, "relu6": 2, "swish": 3, "sigmoid": 4}
BN = 64                 # output columns of a CTA's tile
BK = 64                 # K bytes of one pipeline step
TILE_M = (16, 64)       # tile heights the kernel is built for
WORKSPACE_MAX = 8 << 20  # bytes of int32 split partials one launch may use
MIN_SPLIT_STEPS = 3     # K steps of the shortest split


def qgemm_schedule(m: int, n: int, k: int, n_sm: int = 132
                   ) -> tuple[int, int, int]:
    """(tile height, splits over K, K bytes per split) of one launch.

    The tile is 16 rows tall for M <= 16, else 64.  Where the tiles of
    M x N fill less than one wave of ``n_sm`` SMs, K is split so that tiles
    x splits come close to one wave without passing it, but no split is
    shorter than ``MIN_SPLIT_STEPS`` steps of ``BK`` (a split's start and
    the round trip of its partial cost more than a shorter K walk saves).
    The splits cover K exactly with none empty, and their int32 partials
    fit ``WORKSPACE_MAX``."""
    bm = TILE_M[0] if m <= TILE_M[0] else TILE_M[1]
    tiles = -(-m // bm) * -(-n // BN)
    steps = max(1, -(-k // BK))
    splits = 1
    if 0 < tiles < n_sm:
        per_split = tiles * bm * BN * 4
        splits = max(1, min(steps // MIN_SPLIT_STEPS, n_sm // tiles,
                            WORKSPACE_MAX // per_split))
    per = -(-steps // splits)
    return bm, -(-steps // per), per * BK


@functools.cache
def _entry():
    fn = backend.library("qgemm").qgemm_s8
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, ll, ll, i, i, i, i, i,
                   i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


_counters: dict[torch.device, torch.Tensor] = {}


def _tile_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``device``, kept
    across launches (every split launch leaves them at 0).  ``n`` is below
    the SM count (a split launch has fewer tiles than SMs), so the first
    256 are never outgrown and a captured CUDA graph may keep their
    address."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = _counters[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                            device=device)
    return c


def _check_args(x_q, w_q, scale, bias, activation):
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"qgemm shapes {tuple(x_q.shape)} x "
                         f"{tuple(w_q.shape)} do not chain")
    n = w_q.shape[1]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("qgemm takes int8 x and w")
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"scale/bias must be ({n},)")
    if scale.dtype != torch.float32 or bias.dtype not in (torch.float32,
                                                          torch.int32):
        raise TypeError("scale must be float32, bias float32 or int32")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    devices = {t.device for t in (x_q, w_q, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"qgemm operands on several devices: {devices}")


def qgemm(x_q, w_q, scale, bias, *, activation: str | None = None,
          out_scale: float | None = None):
    """x_q: (M, K) int8; w_q: (K, N) int8; scale: (N,) f32.

    ``bias``: (N,) float32 (real-domain bias, added in the f32 epilogue)
    **or** int32 (the quantized ``b_q`` at accumulator scale, added in exact
    int32 before dequant — the bit-exact path the executors use).

    Returns (M, N): int8 (requantized at ``out_scale``) or f32.  ``x_q``
    may be a row slice of a larger matrix (unit column stride); ``w_q``
    either K-contiguous (no copy) or row-major (copied, and counted in
    ``qgemm.weight_copies``)."""
    _check_args(x_q, w_q, scale, bias, activation)
    if x_q.device.type == "cpu":
        return qgemm_ref(x_q, w_q, scale, bias, activation=activation,
                         out_scale=out_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"qgemm runs on cuda or cpu, not {x_q.device}")
    if x_q.stride(1) != 1:
        x_q = x_q.contiguous()
    if w_q.stride(0) != 1 and w_q.shape[0] != 1:
        # not K-contiguous: copy to the layout the kernel reads
        w_q = w_q.t().contiguous().t()
        qgemm.weight_copies += 1
    scale, bias = scale.contiguous(), bias.contiguous()
    m, k = x_q.shape
    n = w_q.shape[1]
    out_i8 = out_scale is not None
    out = torch.empty((m, n), dtype=torch.int8 if out_i8 else torch.float32,
                      device=x_q.device)
    if m == 0 or n == 0:
        return out
    ldx = x_q.stride(0) if m > 1 else k
    ldw = w_q.stride(1) if n > 1 else k
    aligned = (x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0
               and ldx % 16 == 0 and ldw % 16 == 0)
    bm, splits, k_chunk = qgemm_schedule(m, n, k,
                                         backend.sm_count(x_q.device))
    ws = counters = None
    if splits > 1:
        tiles = -(-m // bm) * -(-n // BN)
        ws = torch.empty(splits * tiles * bm * BN, dtype=torch.int32,
                         device=x_q.device)
        counters = _tile_counters(x_q.device, tiles)
    inv = f32(1.0 / float(out_scale)) if out_i8 else 1.0
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    status = _entry()(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(),
                      None if ws is None else ws.data_ptr(),
                      None if counters is None else counters.data_ptr(),
                      m, n, k, ldx, ldw, n, bm, splits,
                      k_chunk, int(aligned),
                      int(not bias.dtype.is_floating_point), int(out_i8),
                      _ACTIVATIONS[activation], inv, stream)
    qgemm.launches += 1
    backend.check("qgemm", status, f"qgemm M={m} N={n} K={k}")
    return out


qgemm.launches = 0
qgemm.weight_copies = 0
qgemm.kernels_per_launch = 1
