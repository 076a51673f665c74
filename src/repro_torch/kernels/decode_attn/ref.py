"""Plain torch version of the flash-decode kernel, ported from
``repro/kernels/decode_attn/ref.py``: the whole softmax at once, in
float32.  It runs on CPU and CUDA tensors; the CPU path of the wrapper and
the card's kernel checks both use it."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def softmax_scale(hd: int) -> torch.Tensor:
    """1 / sqrt(hd) in float32 arithmetic, as ``1.0 / jnp.sqrt(float32(hd))``."""
    return torch.tensor(float(hd), dtype=torch.float32).sqrt().reciprocal()


def decode_attn_ref(q, k, v, lengths, *, return_lse: bool = False):
    """q: (B, K, G, hd); k, v: (B, K, S, hd) (any strides); lengths: (B,)
    int32 valid cache lengths.  Returns (B, K, G, hd) in q's dtype; with
    ``return_lse``, (output in float32, log-sum-exp (B, K, G) in float32),
    a row of length 0 giving output 0 and lse -inf."""
    scale = softmax_scale(q.shape[-1])      # a 0-dim CPU scalar
    logits = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) * scale
    s = k.shape[2]
    valid = (torch.arange(s, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    if return_lse:
        logits = torch.where(valid, logits, -torch.inf)
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(logits - m)
        den = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bkgs,bksh->bkgh", p, v.float())
        out = torch.where(den > 0, out / den, 0.0)
        lse = torch.where(den > 0, m + torch.log(den), -torch.inf)
        return out, lse[..., 0]
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    return out.to(q.dtype)
