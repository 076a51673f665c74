"""Plain torch versions of the band staging kernels (``csrc/bands.cu``):
the index_select or gather, mask, permute and copy chain that staged a
fused spatial block's windows before the kernels, on CPU and CUDA tensors
alike."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def band_windows_ref(x, table, bsz: int, pw: int = 0,
                     channels_last: bool = False):
    """The stage's window stack.  ``x``: the block's input (bsz, C, H, W),
    ``table`` rows global, or the previous stage's stack (bsz * bands, C,
    H, W), rows band-local; ``table``: (bands, R) int32, the source row of
    each window row or -1 for a row of zeros.  Returns (bsz * bands, C, R,
    W + 2 * pw), ``pw`` zero columns on each side; with ``channels_last``
    in NHWC memory."""
    n_bands, r_win = table.shape
    src = table.clamp(min=0).to(torch.int64)
    mask = (table >= 0)[:, None, :, None]
    c_in, width = x.shape[1], x.shape[3]
    if x.shape[0] == bsz:
        xw = x.index_select(2, src.reshape(-1))
        xw = xw.reshape(bsz, c_in, n_bands, r_win, width)
        xw = xw.permute(0, 2, 1, 3, 4)
    else:
        xv = x.reshape(bsz, n_bands, c_in, x.shape[2], width)
        index = src[None, :, None, :, None].expand(bsz, n_bands, c_in, r_win,
                                                   width)
        xw = torch.gather(xv, 3, index)
    xw = torch.where(mask, xw, 0)
    xw = xw.reshape(bsz * n_bands, c_in, r_win, width)
    if pw:
        xw = F.pad(xw, (pw, pw))
    if channels_last:
        xw = xw.contiguous(memory_format=torch.channels_last)
    return xw


def band_take_ref(x, rows, bsz: int, residual=None, ratio: float = 1.0):
    """The block's output (bsz, C, H_out, W) from its last stack ``x``
    (bsz * bands, C, r, W): output row h is row ``rows[h] % r`` of band
    ``rows[h] // r``.  With an int8 ``residual`` (the output's shape) the
    residual add of the executor's ``_residual_add_int8``: clip(y +
    round(f32(residual) * ratio), -127, 127), ``ratio`` rounded to float32
    by the caller."""
    n_bands = x.shape[0] // bsz
    c_out, r_out, width = x.shape[1], x.shape[2], x.shape[3]
    y = x.reshape(bsz, n_bands, c_out, r_out, width).permute(0, 2, 1, 3, 4)
    y = y.reshape(bsz, c_out, n_bands * r_out, width)
    y = y.index_select(2, rows.to(torch.int64))
    if residual is not None:
        r = torch.round(residual.to(torch.float32) * ratio).to(torch.int32)
        y = torch.clamp(y.to(torch.int32) + r, -127, 127).to(torch.int8)
    return y
