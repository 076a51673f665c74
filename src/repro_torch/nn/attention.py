"""Grouped-query attention (full / sliding-window / decode-with-cache), ported
from ``repro/nn/attention.py``, with an optional q-chunked loop so prefill
and training at long contexts do not hold every (Sq, Sk) score at once.

Logits, softmax and both products accumulate in float32 whatever the
activation dtype; the probabilities are cast to ``v``'s dtype before the PV
product, as the reference does.  Shapes: q (B, Sq, K, G, hd); k, v
(B, Sk, K, hd) with H = K * G (GQA groups).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _mask_bias(q_pos, kv_pos, kv_valid, causal: bool, local_window: int):
    """(B, Sq, Sk) additive bias: 0 where attendable, NEG_INF elsewhere."""
    m = kv_valid[:, None, :]
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if local_window > 0:
        m = m & (kv_pos[:, None, :] > q_pos[:, :, None] - local_window)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.where(m, zero, NEG_INF)


def _attend(q, k, v, bias):
    """q: (B,Sq,K,G,hd); k,v: (B,Sk,K,hd); bias: (B,Sq,Sk) -> (B,Sq,K,G,hd)
    in float32.  The reference keeps bf16 operands with float32 accumulation
    (``preferred_element_type``); torch has no such option, so the operands
    are cast to float32, where each bf16 product is exact."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    logits += bias[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    del logits
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(),
                        v.float())


def gqa_attention(q, k, v, *, q_pos, kv_pos, kv_valid=None, causal=True,
                  local_window: int = 0, chunk: int = 0):
    """q: (B, Sq, K, G, hd); k, v: (B, Sk, K, hd).  Returns (B, Sq, K, G, hd)
    in q's dtype.

    q_pos: (B, Sq) absolute positions; kv_pos: (B, Sk); kv_valid: (B, Sk)
    bool (False for unwritten cache slots).  chunk > 0 walks the query
    dimension in chunks (memory O(Sk * chunk) instead of O(Sq * Sk)); where
    autograd records, each chunk is a checkpoint, as in the reference.
    """
    b, sq, kdim, g, hd = q.shape
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)

    if chunk and sq > chunk and sq % chunk == 0:
        def step(qc, qp):
            bias = _mask_bias(qp, kv_pos, kv_valid, causal, local_window)
            return _attend(qc, k, v, bias)

        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            # recompute each chunk's scores and probabilities in the
            # backward pass, as the reference's checkpoint does: else every
            # chunk's float32 (B, K, G, chunk, Sk) tensors stay saved
            step = functools.partial(checkpoint, step, use_reentrant=False)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        for c0 in range(0, sq, chunk):
            out[:, c0:c0 + chunk] = step(q[:, c0:c0 + chunk],
                                         q_pos[:, c0:c0 + chunk])
        return out
    bias = _mask_bias(q_pos, kv_pos, kv_valid, causal, local_window)
    return _attend(q, k, v, bias).to(q.dtype)


def update_cache(cache_k, cache_v, k_new, v_new, pos: int):
    """Write k_new/v_new (B, Sn, K, hd) into the cache at ``pos`` (host int
    position of the first new token), **in place**: the reference returns
    updated copies (``dynamic_update_slice``); the port writes the caller's
    tensors by slice assignment and returns them.  ``pos`` is clamped so
    the update fits, as ``dynamic_update_slice`` clamps its start."""
    sn = k_new.shape[1]
    pos = min(max(int(pos), 0), cache_k.shape[1] - sn)
    cache_k[:, pos:pos + sn] = k_new
    cache_v[:, pos:pos + sn] = v_new
    return cache_k, cache_v
