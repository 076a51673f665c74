"""Plain torch versions of the squeeze-and-excitation kernels
(``csrc/se.cu``): exact int32 sums and products, then one float32
requantizing multiply, on CPU and CUDA tensors alike."""
from __future__ import annotations

import torch


def requant(v, factor: float):
    """int32 ``v`` -> int8: ``clip(round(f32(v) * factor), -127, 127)``."""
    return torch.clamp(torch.round(v.to(torch.float32) * factor),
                       -127, 127).to(torch.int8)


def se_pool_ref(x, rows, factor: float):
    """x: (bsz * bands, C, R, W) int8, band b of each sample owning its
    first ``rows[b]`` rows.  Returns (bsz, C) int8: the sum over every
    band's own rows, requantized by ``factor``."""
    bands = len(rows)
    nb, c, r, w = x.shape
    own = torch.arange(r, device=x.device)[None, :] < torch.as_tensor(
        rows, device=x.device)[:, None]                    # (bands, R)
    xv = x.reshape(nb // bands, bands, c, r, w).to(torch.int32)
    s = torch.where(own[None, :, None, :, None], xv, 0).sum(dim=(1, 3, 4))
    return requant(s, factor)


def se_gate_ref(x, g, factor: float):
    """x: (bsz * bands, C, R, W) int8; g: (bsz, C) int8 gate codes.  Each
    element times its sample's and channel's gate code, requantized by
    ``factor``."""
    bsz, c = g.shape
    shape = x.shape
    xv = x.reshape(bsz, -1, c, shape[-2] * shape[-1]).to(torch.int32)
    prod = xv * g.to(torch.int32)[:, None, :, None]
    return requant(prod, factor).reshape(shape)
