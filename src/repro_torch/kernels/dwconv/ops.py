"""Public wrappers for the depthwise conv kernel: SAME padding for 3x3.

Port of ``repro/kernels/dwconv/ops.py``, with the same contracts; each
function also takes a leading batch axis.  The CUDA kernel masks the
channel tile itself, so nothing pads channels to a block multiple.
"""
from __future__ import annotations

import torch.nn.functional as F

from .dwconv import dwconv3x3, dwconv3x3_bands


def dwconv(x_q, w, scale, bias, *, stride: int = 1, activation=None,
           out_scale=None):
    """x_q: (C, H, W) or (B, C, H, W) int8 (unpadded); SAME 3x3 depthwise
    conv."""
    return dwconv3x3(F.pad(x_q, (1, 1, 1, 1)), w, scale, bias, stride=stride,
                     activation=activation, out_scale=out_scale)


def dwconv_window(x_win, w, scale, bias, *, stride: int = 1, activation=None,
                  out_scale=None):
    """3x3 depthwise conv over an explicitly prepared row window (spatial
    band + halo/zero rows already in place, width padded by 1), VALID over
    the rows as given.  ``x_win``: (C, R, W+2) with
    R = (out_rows-1)*stride + 3."""
    return dwconv3x3(x_win, w, scale, bias, stride=stride,
                     activation=activation, out_scale=out_scale)


def dwconv_bands(x_win, w, scale, bias, *, stride: int = 1, activation=None,
                 out_scale=None):
    """Batched-band 3x3 depthwise conv over pre-gathered band windows:
    ``x_win`` is (bands, C, R, W+2) with every band's halo/zero rows already
    materialized (shorter bands zero-filled to the common R).  All bands
    run in one kernel launch."""
    return dwconv3x3_bands(x_win, w, scale, bias, stride=stride,
                           activation=activation, out_scale=out_scale)

