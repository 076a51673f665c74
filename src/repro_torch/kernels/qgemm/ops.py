"""Public wrappers around the qgemm kernel: the im2col path that lowers the
paper's quantized conv + folded-BN + ReLU6 onto the GEMM kernel.

Port of ``repro/kernels/qgemm/ops.py``, with the same contracts.  Every
function also takes a leading batch axis where the reference takes one
sample: the port's engine is batch-first where the reference vmaps.
"""
from __future__ import annotations

import torch.nn.functional as F

from .qgemm import qgemm

# The CUDA kernel masks ragged edges itself, so the reference's padding
# wrapper is the kernel's own launcher here.
qgemm_padded = qgemm


def _patches(xp, kernel_hw, stride):
    """(B, C, Hp, Wp) pre-padded -> (B*oh*ow, C*kh*kw) patches in CHW order."""
    bsz, c, h, w = xp.shape
    kh, kw = kernel_hw
    sh, sw = stride
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        # a 1x1 conv is a pure layout change: no patch gather
        return xp.permute(0, 2, 3, 1).reshape(bsz * oh * ow, c), (oh, ow)
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)    # (B, C, oh, ow, kh, kw)
    patches = win.permute(0, 2, 3, 1, 4, 5).reshape(bsz * oh * ow,
                                                    c * kh * kw)
    return patches, (oh, ow)


def im2col(x_q, kernel_hw, stride, padding):
    """x_q: (C, H, W) int8 -> (out_h*out_w, C*kh*kw) patches (CHW order,
    matching core/reinterpret's flat-index convention).  A leading batch
    axis (B, C, H, W) gives (B*out_h*out_w, C*kh*kw), sample-major."""
    single = x_q.dim() == 3
    xb = x_q[None] if single else x_q
    ph, pw = padding
    if ph or pw:
        xb = F.pad(xb, (pw, pw, ph, ph))
    return _patches(xb, kernel_hw, stride)


def im2col_bands(x_q, kernel_hw, stride):
    """Batched-band im2col: (bands, C, R, W) pre-padded windows ->
    (bands*oh*ow, C*kh*kw) patches, band-major.  Folding the band axis into
    the GEMM M dimension makes a fused spatial block's conv stage ONE kernel
    call for every band (and, batch-first, every sample)."""
    return _patches(x_q, kernel_hw, stride)


def _conv_out(y, bsz, oh, ow, single):
    y = y.reshape(bsz, oh, ow, -1).permute(0, 3, 1, 2)
    return y[0] if single else y


def qconv2d(x_q, w_q, scale, bias, *, stride=(1, 1), padding=(0, 0),
            activation=None, out_scale=None):
    """Quantized conv via im2col + qgemm (paper's conv+BN+ReLU6 fused op).

    x_q: (C, H, W) or (B, C, H, W) int8; w_q: (Cout, Cin, kh, kw) int8;
    scale/bias: (Cout,) f32 (BN folded) or int32 bias.  Returns
    (Cout, oh, ow) (or (B, Cout, oh, ow))."""
    cout, cin, kh, kw = w_q.shape
    patches, (oh, ow) = im2col(x_q, (kh, kw), stride, padding)
    w2 = w_q.reshape(cout, cin * kh * kw).t()        # (C*kh*kw, Cout)
    y = qgemm(patches, w2, scale, bias, activation=activation,
              out_scale=out_scale)
    bsz = 1 if x_q.dim() == 3 else x_q.shape[0]
    return _conv_out(y, bsz, oh, ow, x_q.dim() == 3)

