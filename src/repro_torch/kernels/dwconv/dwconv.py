"""Launchers of the hand-written CUDA depthwise kernel (``csrc/dwconv.cu``).

Port of the two TPU kernels in ``repro/kernels/dwconv/dwconv.py``:

* :func:`dwconv3x3` — one pre-padded (C, H+2, W+2) sample, or a batch of
  them (B, C, H+2, W+2): the flat (neuron/kernel-mode) depthwise shards.
* :func:`dwconv3x3_bands` — a stack of spatial band windows
  (bands, C, R, W+2): the depthwise stage of every fused spatial block.

Both launch the same CUDA kernel, whose leading axis is the window stack
(the batch is that axis for :func:`dwconv3x3`).  Each counts its own
launches (``dwconv3x3.launches``, ``dwconv3x3_bands.launches``).  A CPU
tensor takes the plain version (:func:`.ref.dwconv3x3_ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.quantize import f32
from .. import backend
from .ref import dwconv3x3_ref

_ACTIVATIONS = {None: 0, "relu": 1, "relu6": 2}
# staged bytes per CTA and outputs per CTA the tile choice aims at
_SMEM_BUDGET = 16 * 1024
_OUTPUTS_PER_CTA = 1024


@functools.cache
def _entry():
    fn = backend.library("dwconv").dwconv3x3_s8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p] + [i] * 12 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def tiles(c: int, oh: int, ow: int, wp: int, stride: int) -> tuple[int, int]:
    """(rows_tile, c_tile) of one CTA: at most ``_SMEM_BUDGET`` staged bytes
    and about ``_OUTPUTS_PER_CTA`` outputs."""
    rows_tile = max(1, min(oh, _OUTPUTS_PER_CTA // max(ow, 1)))
    while rows_tile > 1 and ((rows_tile - 1) * stride + 3) * wp > _SMEM_BUDGET:
        rows_tile = (rows_tile + 1) // 2
    slab = ((rows_tile - 1) * stride + 3) * wp
    if slab > _SMEM_BUDGET:
        raise ValueError(f"dwconv rows of width {wp} do not fit the kernel")
    want = -(-_OUTPUTS_PER_CTA // (rows_tile * ow))
    c_tile = max(1, min(c, want, _SMEM_BUDGET // slab))
    return rows_tile, c_tile


def _launch(wrapper, x, w, scale, bias, stride, activation, out_scale):
    """x: (NB, C, R, Wp) int8 on CUDA -> (NB, C, oh, ow); counts the launch
    on ``wrapper``."""
    nb, c, rows, wp = x.shape
    oh = (rows - 3) // stride + 1
    ow = (wp - 3) // stride + 1
    out_i8 = out_scale is not None
    out = torch.empty((nb, c, oh, ow),
                      dtype=torch.int8 if out_i8 else torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    rows_tile, c_tile = tiles(c, oh, ow, wp, stride)
    x, w = x.contiguous(), w.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    inv = f32(1.0 / float(out_scale)) if out_i8 else 1.0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), nb, c, rows, wp, oh, ow,
                      stride, rows_tile, c_tile,
                      int(not bias.dtype.is_floating_point), int(out_i8),
                      _ACTIVATIONS[activation], inv, stream)
    wrapper.launches += 1
    backend.check("dwconv", status,
                  f"dwconv3x3 NB={nb} C={c} R={rows} Wp={wp} s={stride}")
    return out


def _check_args(x, w, scale, bias, stride, activation, ndims):
    if x.dim() not in ndims:
        raise ValueError(f"dwconv input of rank {x.dim()} (want {ndims})")
    c = x.shape[-3]
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("dwconv takes int8 x and w")
    if tuple(w.shape) != (c, 3, 3):
        raise ValueError(f"dwconv weight {tuple(w.shape)} != ({c}, 3, 3)")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    if scale.dtype != torch.float32 or bias.dtype not in (torch.float32,
                                                          torch.int32):
        raise TypeError("scale must be float32, bias float32 or int32")
    if stride not in (1, 2) or activation not in _ACTIVATIONS:
        raise ValueError(f"stride {stride} / activation {activation!r}")
    if x.shape[-2] < 3 or x.shape[-1] < 3:
        raise ValueError(f"dwconv window {tuple(x.shape[-2:])} below 3x3")
    devices = {t.device for t in (x, w, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"dwconv operands on several devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dwconv runs on cuda or cpu, not {x.device}")


def dwconv3x3(x_pad, w, scale, bias, *, stride: int = 1,
              activation: str | None = None, out_scale: float | None = None):
    """x_pad: (C, H+2, W+2) int8 (pre-padded by 1), or a batch
    (B, C, H+2, W+2); w: (C, 3, 3) int8; scale: (C,) f32; bias: (C,) f32
    (real-domain, f32 epilogue) or int32 (quantized ``b_q``, added in exact
    int32 — the bit-exact executor path).  Returns (C, oh, ow) (or
    (B, C, oh, ow)), int8 or f32."""
    _check_args(x_pad, w, scale, bias, stride, activation, (3, 4))
    if x_pad.device.type == "cpu":
        return dwconv3x3_ref(x_pad, w, scale, bias, stride=stride,
                             activation=activation, out_scale=out_scale)
    single = x_pad.dim() == 3
    out = _launch(dwconv3x3, x_pad[None] if single else x_pad, w, scale,
                  bias, stride, activation, out_scale)
    return out[0] if single else out


def dwconv3x3_bands(x_win, w, scale, bias, *, stride: int = 1,
                    activation: str | None = None,
                    out_scale: float | None = None):
    """Batched-band 3x3 depthwise conv: ``x_win`` is (bands, C, R, W+2) int8
    — one pre-gathered row window per spatial band (halo/zero rows and the
    width pad already in place, shorter bands zero-filled to the common R).
    Every band runs in one kernel launch; weights/scale/bias are shared
    across bands (spatial mode replicates weights) with the same contract
    as :func:`dwconv3x3`."""
    _check_args(x_win, w, scale, bias, stride, activation, (4,))
    if x_win.device.type == "cpu":
        return dwconv3x3_ref(x_win, w, scale, bias, stride=stride,
                             activation=activation, out_scale=out_scale)
    return _launch(dwconv3x3_bands, x_win, w, scale, bias, stride,
                   activation, out_scale)


dwconv3x3.launches = 0
dwconv3x3_bands.launches = 0
dwconv3x3.kernels_per_launch = dwconv3x3_bands.kernels_per_launch = 1
