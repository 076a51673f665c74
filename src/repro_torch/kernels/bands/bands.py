"""Launchers of the hand-written CUDA band staging kernels
(``csrc/bands.cu``).

* :func:`band_windows` — the window stack one stage of a fused spatial
  block reads, in one pass from the producer's tensor: each window row a
  source row or zeros, by the stage's row table; NCHW (a depthwise or kxk
  stage, its zero columns written in) or NHWC (a 1x1 conv: the GEMM's
  operand as it is).
* :func:`band_take` — the block's output rows from its last stack, with
  the int8 residual add as the epilogue where the block has one.

Both read an NCHW source, or an NHWC one (a ``qgemm`` output viewed as
(N, C, H, W)), as its strides say, and take int8 or float32 elements.  A
CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``band_windows.launches`` and ``band_take.launches``
count launches (a launch captured into a CUDA graph counts once, its
replays do not).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import backend
from .ref import band_take_ref, band_windows_ref

_ELEM = {torch.int8: 1, torch.float32: 4}


@functools.cache
def _entry():
    fn = backend.library("bands").bands_copy
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, ctypes.c_float] + [i] * 13 + [p]
    fn.restype = ctypes.c_int
    return fn


def _nhwc(x) -> bool:
    """Whether ``x`` (N, C, H, W) lies in NHWC memory (and not also in
    NCHW: with one channel or one position the two are the same)."""
    return (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _vec_bytes(c_bytes: int, *ptrs) -> int:
    """Bytes an NHWC side moves at a time: the largest of 16, 8, 4 that
    divides a position's channel bytes and every NHWC pointer, else 1."""
    for vb in (16, 8, 4):
        if c_bytes % vb == 0 and all(q % vb == 0 for q in ptrs):
            return vb
    return 1


def _args(take: bool, x, out, rows, res, ratio, nbo: int, r: int, pw: int,
          nbs: int, band_step: int, src_nhwc: bool, out_nhwc: bool) -> tuple:
    """The arguments of ``bands_copy`` but the stream (see csrc/bands.cu)."""
    c, hs, w = x.shape[1], x.shape[2], x.shape[3]
    es = _ELEM[x.dtype]
    ptrs = ([x.data_ptr()] if src_nhwc else []) + (
        [out.data_ptr()] if out_nhwc else [])
    return (int(take), es, x.data_ptr(), out.data_ptr(), rows.data_ptr(),
            None if res is None else res.data_ptr(), ratio, out.shape[0],
            nbo, r, w + 2 * pw, pw, nbs, band_step, hs, w, c, int(src_nhwc),
            int(out_nhwc), _vec_bytes(c * es, *ptrs))


def _launch(*args):
    stream = torch.cuda.current_stream(args[1].device).cuda_stream
    return _entry()(*_args(*args), stream)


def _source(x):
    """x in one of the two layouts the kernels read, and whether NHWC."""
    if x.dtype not in _ELEM or x.dim() != 4:
        raise ValueError(f"band staging of {tuple(x.shape)} {x.dtype}")
    if x.is_contiguous():
        return x, False
    if _nhwc(x):
        return x, True
    return x.contiguous(), False


def _table(table, device):
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.device != device or not table.is_contiguous()):
        raise ValueError(f"row table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device}: want a contiguous int32 (bands, "
                         f"rows) on {device}")


def band_windows(x, table, bsz: int, *, pw: int = 0,
                 channels_last: bool = False):
    """The window stack of one stage.  ``x``: the block's input (bsz, C,
    H, W), whose rows the table gives globally, or the previous stage's
    stack (bsz * bands, C, H, W), band-local rows; ``table``: (bands, R)
    int32 on x's device, each window row's source row or -1 for zeros.
    Returns (bsz * bands, C, R, W + 2 * pw) with ``pw`` zero columns on
    each side, or, with ``channels_last`` (``pw`` 0), the same in NHWC
    memory."""
    n_bands, r_win = table.shape
    if x.shape[0] not in (bsz, bsz * n_bands) or pw < 0 or (
            channels_last and pw):
        raise ValueError(f"band_windows of {tuple(x.shape)} by "
                         f"{tuple(table.shape)} at batch {bsz}, pw {pw}")
    if x.device.type == "cpu":
        return band_windows_ref(x, table, bsz, pw, channels_last)
    _table(table, x.device)
    x, src_nhwc = _source(x)
    c, w = x.shape[1], x.shape[3]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((bsz * n_bands, c, r_win, w + 2 * pw), dtype=x.dtype,
                      device=x.device, memory_format=fmt)
    if out.numel() == 0:
        return out
    per_band = x.shape[0] != bsz
    status = _launch(False, x, out, table, None, 1.0, n_bands, r_win, pw,
                     n_bands if per_band else 1, int(per_band), src_nhwc,
                     channels_last)
    band_windows.launches += 1
    backend.check("bands", status,
                  f"band_windows {tuple(x.shape)} -> {tuple(out.shape)}"
                  f"{' NHWC' if channels_last else ''}")
    return out


def band_take(x, rows, bsz: int, residual=None, ratio: float = 1.0):
    """The block's output (bsz, C, H_out, W) from its last stack ``x``
    (bsz * bands, C, r, W): output row h is row ``rows[h] % r`` of band
    ``rows[h] // r`` (``rows``: (H_out,) int32 on x's device).  With an
    int8 ``residual`` (bsz, C, H_out, W), each output code plus
    round(f32(residual) * ratio), clipped to +-127 (``ratio`` rounded to
    float32 by the caller): the executor's ``_residual_add_int8``."""
    if x.shape[0] % bsz or rows.dim() != 1:
        raise ValueError(f"band_take of {tuple(x.shape)} by "
                         f"{tuple(rows.shape)} at batch {bsz}")
    c, w = x.shape[1], x.shape[3]
    shape = (bsz, c, rows.shape[0], w)
    if residual is not None and (residual.dtype != torch.int8
                                 or x.dtype != torch.int8
                                 or tuple(residual.shape) != shape):
        raise ValueError(f"residual {tuple(residual.shape)} "
                         f"{residual.dtype} onto {shape} {x.dtype}")
    if x.device.type == "cpu":
        return band_take_ref(x, rows, bsz, residual, ratio)
    _table(rows[None], x.device)
    x, src_nhwc = _source(x)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if residual is not None:
        residual = residual.contiguous()
    n_bands = x.shape[0] // bsz
    status = _launch(True, x, out, rows, residual, ratio, 1, rows.shape[0],
                     0, n_bands, 0, src_nhwc, False)
    band_take.launches += 1
    backend.check("bands", status,
                  f"band_take {tuple(x.shape)} -> {shape}"
                  f"{' + residual' if residual is not None else ''}")
    return out


band_windows.launches = band_take.launches = 0
band_windows.kernels_per_launch = band_take.kernels_per_launch = 1
