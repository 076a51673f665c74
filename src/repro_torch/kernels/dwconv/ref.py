"""Plain torch version of the int8 3x3 and 5x5 depthwise conv kernels.

Port of ``repro/kernels/dwconv/ref.py``.  CUDA has no int32 convolution, so
the accumulator is the shifted-product int32 sum of the reference's
``_dwconv_bands_int32`` (``repro/core/executor.py``): one elementwise
product per tap, exact on CPU and CUDA alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.quantize import epilogue


def dwconv_acc_int32(x, w, stride):
    """Depthwise VALID conv of a window stack via kh*kw shifted int32
    products.  x: (B, C, R, Wp); w: (C, 1, kh, kw) or (C, kh, kw);
    stride: (sh, sw).  Returns the (B, C, oh, ow) int32 accumulator — the
    same sum as the kernel's, for any kernel size."""
    if w.dim() == 4:
        w = w[:, 0]
    _, _, rows, wp = x.shape
    kh, kw = w.shape[1], w.shape[2]
    sh, sw = stride
    oh = (rows - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    xi = x.to(torch.int32)
    wi = w.to(torch.int32)
    acc = None
    for i in range(kh):
        for j in range(kw):
            win = xi[:, :, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw]
            term = win * wi[:, i, j][None, :, None, None]
            acc = term if acc is None else acc + term
    return acc


def dwconv3x3_ref(x_pad, w, scale, bias, *, stride: int = 1,
                  activation: str | None = None,
                  out_scale: float | None = None):
    """x_pad: (C, H+2p, W+2p) or a stack (NB, C, R, W+2p) int8, pre-padded;
    w: (C, k, k) int8 (k 3 or 5, p = k // 2); bias: (C,) f32 (real-domain)
    or int32 (``b_q``, added to the int32 accumulator)."""
    single = x_pad.dim() == 3
    xb = x_pad[None] if single else x_pad
    acc = dwconv_acc_int32(xb, w, (stride, stride))
    y = epilogue(acc, scale[:, None, None], bias[:, None, None], activation,
                 out_scale)
    return y[0] if single else y


def dwconv_same_ref(x, w, scale, bias, **kw):
    """SAME kxk depthwise conv of an unpadded (C, H, W) or (B, C, H, W)
    input: pad by k // 2, then :func:`dwconv3x3_ref`."""
    p = w.shape[-1] // 2
    return dwconv3x3_ref(F.pad(x, (p, p, p, p)), w, scale, bias, **kw)


def dwconv_bands_unpadded_ref(x_win, w, scale, bias, **kw):
    """Band windows (NB, C, R, W) whose width is not padded: pad the width
    by k // 2, then :func:`dwconv3x3_ref`."""
    p = w.shape[-1] // 2
    return dwconv3x3_ref(F.pad(x_win, (p, p)), w, scale, bias, **kw)


def dwconv_shards_ref(x, shards, w, scale, bias, *, stride: int = 1,
                      activation: str | None = None,
                      out_scale: float | None = None):
    """Plain version of a flat SAME depthwise layer over its worker shards,
    as the reference's ``_layer_int8`` runs it: for each shard (c_lo, c_hi
    exclusive, start, stop, ...) of ``shards``, pad its channel span of the
    unpadded (B, C, H, W) input, convolve, keep its flat range
    [start, stop) of the layer output, and concatenate the shards in order.
    Returns (B, positions)."""
    bsz = x.shape[0]
    parts = []
    for c_lo, c_hi, start, stop, *_ in shards:
        span = slice(c_lo, c_hi)
        y = dwconv_same_ref(x[:, span], w[span], scale[span], bias[span],
                            stride=stride, activation=activation,
                            out_scale=out_scale)
        # the fragment's full rows: the shard's range starts at
        # start - c_lo * hw in the fragment
        off = start - c_lo * y.shape[2] * y.shape[3]
        parts.append(y.reshape(bsz, -1)[:, off:off + stop - start])
    return torch.cat(parts, dim=1)
