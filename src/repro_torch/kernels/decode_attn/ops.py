"""Model-layout wrappers for flash-decode, ported from
``repro/kernels/decode_attn/ops.py``: q (B, 1, K, G, hd), cache
(B, S, K, hd), lengths (B,) int32, output (B, 1, K, G, hd).

The reference transposes the cache to (B, K, S, hd) and pads S to a
multiple of ``block_s``, which on the card would copy the whole cache on
every call.  Here the transpose is a view (the kernel reads through
strides) and the kernel masks ragged S itself, so nothing is copied.
"""
from __future__ import annotations

from .decode_attn import decode_attn
from .ref import decode_attn_ref


def flash_decode(q, cache_k, cache_v, lengths, *, block_s: int = 512,
                 return_lse: bool = False):
    """q: (B, 1, K, G, hd); cache_k/v: (B, S, K, hd); lengths: (B,).
    Returns (B, 1, K, G, hd); with ``return_lse``, (that output in float32,
    log-sum-exp (B, 1, K, G) in float32).  Launches the CUDA kernel for
    CUDA tensors and takes the plain version for CPU tensors."""
    out = decode_attn(q[:, 0], cache_k.transpose(1, 2),
                      cache_v.transpose(1, 2), lengths, block_s=block_s,
                      return_lse=return_lse)
    if return_lse:
        return out[0][:, None], out[1][:, None]
    return out[:, None]


def flash_decode_ref(q, cache_k, cache_v, lengths, *,
                     return_lse: bool = False):
    out = decode_attn_ref(q[:, 0], cache_k.transpose(1, 2),
                          cache_v.transpose(1, 2), lengths,
                          return_lse=return_lse)
    if return_lse:
        return out[0][:, None], out[1][:, None]
    return out[:, None]
