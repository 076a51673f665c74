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

Each call enqueues two kernels (``decode_attn.kernels_per_launch``): one
that splits the cache over CTAs and writes float32 partials to a
workspace, and one that merges them.  :func:`decode_schedule` picks the
split from S, B*K and the SM count, never from ``lengths``, so a call
makes no synchronising query of the card.

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
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # hd % 16 == 0: tensor cores
_MAX_G = 16
TILE_S = 64             # slots of the tensor-core kernel's tile
RESIDENT = 2            # its CTAs that fit one SM (104 KB of shared memory)
MAX_CHUNK_TILES = 32    # longest chunk, in tiles


def decode_schedule(s: int, bk: int, n_sm: int = 132) -> tuple[int, int]:
    """(n_split, chunk) of one call over a cache of ``s`` slots and ``bk``
    (batch row, kv head) pairs: CTA j of a pair owns slots
    [j * chunk, (j + 1) * chunk).  ``chunk`` is a multiple of ``TILE_S``
    and the chunks cover S with none empty.  As many chunks as fill one
    wave of ``RESIDENT`` CTAs on each of ``n_sm`` SMs, unless a chunk would
    then pass ``MAX_CHUNK_TILES`` tiles: then chunks of that length, over
    several waves, which the card balances as CTAs finish."""
    tiles = max(1, -(-s // TILE_S))
    n_split = max(1, RESIDENT * n_sm // max(bk, 1))
    per = min(MAX_CHUNK_TILES, -(-tiles // n_split))
    return -(-tiles // per), per * TILE_S


def chunk_is_empty(j: int, chunk: int, length: int) -> bool:
    """True when chunk ``j`` holds no slot below ``length``: its CTA writes
    an empty partial (l = 0) and reads no cache."""
    return j * chunk >= length


@functools.cache
def _entry():
    fn = backend.library("decode_attn").decode_attn_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                   i, i, ctypes.c_float, i, i, p, p]
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


def decode_attn(q, k, v, lengths, *, block_s: int = 512,
                return_lse: bool = False):
    """q: (B, K, G, hd); k, v: (B, K, S, hd); lengths: (B,) int32 valid
    cache lengths.  Returns (B, K, G, hd) in q's dtype.

    With ``return_lse``: (output (B, K, G, hd) in float32, log-sum-exp of
    each query row's logits (B, K, G) in float32), for a merge with other
    slices of the same cache; a row of length 0 gives output 0 and lse
    -inf.

    ``block_s`` is the reference kernel's cache tile; it is validated for
    the contract, but the CUDA kernel tiles S its own way and S need not be
    a multiple of it."""
    _check_args(q, k, v, lengths, block_s)
    if q.device.type == "cpu":
        if return_lse:
            return decode_attn_ref(q, k, v, lengths, return_lse=True)
        return decode_attn_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, not {q.device}")
    b, kh, g, hd = q.shape
    if hd not in _HEAD_DIMS or g > _MAX_G:
        raise ValueError(f"the decode_attn kernel takes hd in {_HEAD_DIMS} "
                         f"and G <= {_MAX_G}; got G={g}, hd={hd}")
    k = k if _aligned(k) else k.contiguous()
    v = v if _aligned(v) else v.contiguous()
    q, lengths = q.contiguous(), lengths.contiguous()
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else
                      q.dtype, device=q.device)
    lse = torch.empty((b, kh, g), dtype=torch.float32, device=q.device) \
        if return_lse else None
    s = k.shape[2]
    if b * kh == 0 or g == 0:
        return (out, lse) if return_lse else out
    n_split, chunk = decode_schedule(s, b * kh, backend.sm_count(q.device))
    ws = torch.empty(b * kh * n_split * g * (hd + 2), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
                      kh, g, s, hd, k.stride(0), k.stride(2), k.stride(1),
                      v.stride(0), v.stride(2), v.stride(1),
                      int(q.dtype == torch.bfloat16),
                      int(k.dtype == torch.bfloat16),
                      _scale(hd), n_split, chunk,
                      lse.data_ptr() if return_lse else None, stream)
    decode_attn.launches += 1
    backend.check("decode_attn", status, f"decode_attn B={b} K={kh} G={g} "
                  f"S={s} hd={hd}")
    return (out, lse) if return_lse else out


decode_attn.launches = 0
decode_attn.kernels_per_launch = 2
