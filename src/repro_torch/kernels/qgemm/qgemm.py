"""Launcher of the hand-written CUDA qgemm kernel (``csrc/qgemm.cu``).

Port of the TPU kernel ``qgemm`` in ``repro/kernels/qgemm/qgemm.py``.  The
CUDA kernel masks ragged M, N and K edges itself, so unlike the TPU kernel
it takes any shape: the host pads nothing.  A CPU tensor takes the plain
version (:func:`.ref.qgemm_ref`); a CUDA tensor launches the kernel or
raises.  ``qgemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.quantize import f32
from .. import backend
from .ref import qgemm_ref

_ACTIVATIONS = {None: 0, "relu": 1, "relu6": 2}


@functools.cache
def _entry():
    fn = backend.library("qgemm").qgemm_s8
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, ll, ll, ll, i, i, i,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


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

    Returns (M, N): int8 (requantized at ``out_scale``) or f32.  ``x_q`` and
    ``w_q`` may be row slices of larger matrices (unit column stride)."""
    _check_args(x_q, w_q, scale, bias, activation)
    if x_q.device.type == "cpu":
        return qgemm_ref(x_q, w_q, scale, bias, activation=activation,
                         out_scale=out_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"qgemm runs on cuda or cpu, not {x_q.device}")
    if x_q.stride(1) != 1:
        x_q = x_q.contiguous()
    if w_q.stride(1) != 1:
        w_q = w_q.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    m, k = x_q.shape
    n = w_q.shape[1]
    out_i8 = out_scale is not None
    out = torch.empty((m, n), dtype=torch.int8 if out_i8 else torch.float32,
                      device=x_q.device)
    if m == 0 or n == 0:
        return out
    inv = f32(1.0 / float(out_scale)) if out_i8 else 1.0
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    status = _entry()(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), m, n, k,
                      max(x_q.stride(0), 1), max(w_q.stride(0), 1), n,
                      int(not bias.dtype.is_floating_point), int(out_i8),
                      _ACTIVATIONS[activation], inv, stream)
    qgemm.launches += 1
    backend.check("qgemm", status, f"qgemm M={m} N={n} K={k}")
    return out


qgemm.launches = 0
