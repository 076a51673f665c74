"""Launcher of the hand-written CUDA flash-decode kernel
(``csrc/decode_attn.cu``).

Port of the TPU kernel ``decode_attn`` in
``repro/kernels/decode_attn/decode_attn.py``, with its contract: q
(B, K, G, hd); k, v (B, K, S, hd); lengths (B,) int32; output (B, K, G, hd)
in q's dtype.  The kernel reads k and v through their strides, so a
transposed view of the model's (B, S, K, hd) cache needs no copy, and it
masks ragged S itself.  A CPU tensor takes the plain version
(:func:`.ref.decode_attn_ref`); a CUDA tensor launches the kernel or
raises.  ``decode_attn.launches`` counts kernel launches.

Contract on ``lengths``: each in [1, S].  At 0 the reference kernel and its
plain version already disagree (both average v, over padded and unpadded
slots); the CUDA kernel writes zeros there.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from .ref import decode_attn_ref, softmax_scale

# (q dtype, cache dtype) pairs the kernel takes
_DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16)}
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)     # hd / 8 lanes read one row
_MAX_G, _MAX_QELEMS = 16, 2048


@functools.cache
def _entry():
    fn = backend.library("decode_attn").decode_attn_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, i, i,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v, lengths, block_s):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attn takes q (B, K, G, hd) and k, v "
                         f"(B, K, S, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, kh, _, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, kh, hd):
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} "
                         f"disagree on B, K or hd")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32")
    if (q.dtype, k.dtype) not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode_attn takes (q, cache) dtypes "
                        f"(f32, f32), (bf16, bf16) or (f32, bf16), not "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if isinstance(block_s, bool) or not isinstance(block_s, int) \
            or block_s <= 0:
        raise ValueError(f"block_s must be a positive int, not {block_s!r}")
    devices = {t.device for t in (q, k, v, lengths)}
    if len(devices) != 1:
        raise ValueError(f"decode_attn operands on several devices: "
                         f"{devices}")


@functools.cache
def _scale(hd: int) -> float:
    return float(softmax_scale(hd))


def _aligned(t) -> bool:
    """Unit stride over hd, and 16-byte aligned rows (the kernel reads 16
    bytes at a time)."""
    per = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def decode_attn(q, k, v, lengths, *, block_s: int = 512):
    """q: (B, K, G, hd); k, v: (B, K, S, hd); lengths: (B,) int32 valid
    cache lengths.  Returns (B, K, G, hd) in q's dtype.

    ``block_s`` is the reference kernel's cache tile; it is validated for
    the contract, but the CUDA kernel tiles S its own way and S need not be
    a multiple of it."""
    _check_args(q, k, v, lengths, block_s)
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, not {q.device}")
    b, kh, g, hd = q.shape
    if hd not in _HEAD_DIMS or g > _MAX_G or g * hd > _MAX_QELEMS:
        raise ValueError(f"the decode_attn kernel takes hd in {_HEAD_DIMS}, "
                         f"G <= {_MAX_G} and G * hd <= {_MAX_QELEMS}; got "
                         f"G={g}, hd={hd}")
    k = k if _aligned(k) else k.contiguous()
    v = v if _aligned(v) else v.contiguous()
    q, lengths = q.contiguous(), lengths.contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    s = k.shape[2]
    if b * kh == 0 or g == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), b, kh, g, s, hd,
                      k.stride(0), k.stride(2), k.stride(1), v.stride(0),
                      v.stride(2), v.stride(1),
                      int(q.dtype == torch.bfloat16),
                      int(k.dtype == torch.bfloat16),
                      _scale(hd), stream)
    decode_attn.launches += 1
    backend.check("decode_attn", status, f"decode_attn B={b} K={kh} G={g} "
                  f"S={s} hd={hd}")
    return out


decode_attn.launches = 0
