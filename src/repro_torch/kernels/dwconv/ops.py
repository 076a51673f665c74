"""Public wrappers for the depthwise conv kernel: SAME padding for 3x3.

Port of ``repro/kernels/dwconv/ops.py``, with the same contracts; each
function also takes a leading batch axis.  The CUDA kernel masks the
channel tile and makes the zero border itself, so nothing pads channels to
a block multiple and :func:`dwconv` copies no padded input.  Two entries
serve the port's engine only: :func:`dwconv_bands_unpadded` (band windows
whose width is padded in the kernel) and :func:`dwconv_shards` (a flat
layer over all of its worker shards in one launch).
"""
from __future__ import annotations

from .dwconv import (ShardTable, dwconv3x3, dwconv3x3_bands,
                     dwconv3x3_bands_unpadded, dwconv3x3_same,
                     dwconv3x3_shards, shard_table)

__all__ = ["ShardTable", "dwconv", "dwconv_bands", "dwconv_bands_unpadded",
           "dwconv_shards", "dwconv_window", "shard_table"]


def dwconv(x_q, w, scale, bias, *, stride: int = 1, activation=None,
           out_scale=None):
    """x_q: (C, H, W) or (B, C, H, W) int8 (unpadded); SAME 3x3 depthwise
    conv."""
    return dwconv3x3_same(x_q, w, scale, bias, stride=stride,
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


def dwconv_bands_unpadded(x_win, w, scale, bias, *, stride: int = 1,
                          activation=None, out_scale=None):
    """:func:`dwconv_bands` over windows (bands, C, R, W) whose width is not
    padded yet: the kernel reads a zero column on each side."""
    return dwconv3x3_bands_unpadded(x_win, w, scale, bias, stride=stride,
                                    activation=activation,
                                    out_scale=out_scale)


def dwconv_shards(x, shards: ShardTable, w, scale, bias, *, stride: int = 1,
                  activation=None, out_scale=None):
    """A flat SAME 3x3 depthwise layer over all of its worker shards in one
    launch: ``x`` is the layer's unpadded (B, C, H, W) input, ``shards`` its
    :class:`ShardTable` (:func:`shard_table`).  Returns (B, positions): each
    shard's flat output range, in shard order."""
    return dwconv3x3_shards(x, shards, w, scale, bias, stride=stride,
                            activation=activation, out_scale=out_scale)
