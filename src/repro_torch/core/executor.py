"""Split inference execution (paper §IV.D, Algorithm 4) — torch port of
``repro/core/executor.py``.

Layer-by-layer protocol:
  1. the coordinator routes each worker the input activations its assigned
     output neurons need (RouteM / worker_input_regions);
  2. each worker computes its assigned flat output range from its *local*
     weight fragments only;
  3. partial outputs return to the coordinator, are concatenated in flat
     order (shards are contiguous ascending ranges, so concat == aggregate),
     and become the next layer's input.

Spatial plans (``split_model(..., mode="spatial")``) change the unit of
iteration from layers to *fused blocks* (``SplitPlan.block_groups``): each
worker receives its block-input row window (band + halo), runs the whole
expand→dwconv→project chain on the band locally, and only the block output
is aggregated (a static row-axis concat, since bands tile the output rows).
Residual adds and stashes stay coordinator-side at block boundaries.

A squeeze-and-excitation block (EfficientNet's MBConv, ``fusion.se_cut``) is
cut by its global pool: each worker runs the expand and depthwise stages on
its band and keeps the depthwise band; the pool sums every band's own rows
(a reduction across workers, no halo or fill row counted); the two small
FCs run on their flat splits; each worker then scales its kept band by the
gate and runs the project conv on it, and the block output is aggregated
as before.  In the flat modes the gate is a layer of its own, scaling the
stashed depthwise output.

Two executors share those semantics:

* :class:`SplitExecutor` — the **eager** oracle.  One dispatch per layer
  per shard, on one sample, with plain torch ops only (exact int32 sums via
  shifted products, no kernel).  Supports ``collect_activations``.

* :class:`CompiledSplitExecutor` — the **engine**.  Where the reference
  traces the plan under ``jax.jit(jax.vmap(...))``, the port runs it eagerly
  and batch-first: band stacks are (batch * bands, C, R, W), the GEMM's M is
  batch * bands * oh * ow, the classifier's M is the batch.  Its device
  constants (weights, epilogue scales and biases, band row tables) are
  uploaded once per (plan fingerprint, device) into a class-level cache, and
  a forward pass never waits on the device.  It always takes the structure
  of the reference's ``use_pallas=True`` path — im2col + ``qgemm`` for
  convs, one ``qgemm`` over all shards of a linear layer, ``dwconv`` for 3x3
  and 5x5 depthwise, ``se_pool`` for every global pool — with one
  ``band_windows`` pass staging each spatial stage's windows and one
  ``band_take`` pass a spatial block's output rows, and the wrappers
  alone decide, from the tensor's device, between the CUDA kernel and its
  plain version.  So the card and the CPU differ only inside the
  kernels, and int8 output is bit-identical on both and to the reference
  (swish and sigmoid excepted: their exp is the platform's, see
  ``quantize.epilogue_params``).  On CUDA
  the first forward at each (mode, input shape) walks the plan once, then
  is captured as one CUDA graph, which every later forward at that key
  replays: the same kernels in the same order, one launch from the host.

Every entry point (``SplitExecutor``, ``CompiledSplitExecutor``,
``reference_forward``) runs on CUDA unless the caller passes
``device="cpu"``, and raises when no device is given and CUDA is absent.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from ..kernels.bands import band_take, band_windows
from ..kernels.dwconv.ops import (ShardTable, dwconv_bands_unpadded,
                                   dwconv_shards, shard_table)
from ..kernels.dwconv.ref import dwconv_acc_int32 as _dwconv_bands_int32
from ..kernels.qgemm.ops import im2col, im2col_bands, qgemm
from ..kernels.se import se_gate, se_pool
from ..kernels.se.ref import requant, se_gate_ref
from .fusion import SECut, apply_activation, group_blocks, se_cut
from .mapping import compile_shard_geometry
from .quantize import (QuantizedModel, epilogue_params, f32,
                       quantize_activation_t, requantize)
from .reinterpret import LayerSpec
from .splitting import (LayerSplit, ShardGeometry, SpatialBandGeometry,
                        SplitPlan, WorkerShard, spatial_band_geometry)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else CUDA.  Raises
    when no device is given and CUDA is absent — never drifts to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# The TF32 switches are process-wide: one thread restoring them while
# another still enqueues a float forward would run the rest of that forward
# in TF32.  Every float body holds this lock (reentrant: a calibration's
# reference forward may nest in another float section).
_FP32_LOCK = threading.RLock()


@contextlib.contextmanager
def _full_fp32():
    """The float path in full float32: TF32 off for cuDNN convolutions and
    for matmuls (torch enables it for cuDNN by default).  Holds the
    process-wide ``_FP32_LOCK`` around the switch and the body, so float
    sections of several threads run one at a time.  TF32 is read when an
    operation is enqueued, so the lock covers enqueueing only: the body
    does not wait for the device."""
    with _FP32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _pad_chw(x, padding):
    """Zero-pad the last two (H, W) axes."""
    ph, pw = padding
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw, pw, ph, ph))


def _dense_conv_int32(x, w, stride):
    """Dense VALID conv of int8 operands with the exact int32 sum: one
    float64 channel contraction per tap.  CUDA has no int32 convolution;
    float64 is exact here because every partial sum is an integer far
    below 2**53, whatever order the sum takes."""
    _, _, rows, wp = x.shape
    _, _, kh, kw = w.shape
    sh, sw = stride
    oh = (rows - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    xd = x.to(torch.float64)
    wd = w.to(torch.float64)
    acc = None
    for i in range(kh):
        for j in range(kw):
            win = xd[:, :, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw]
            term = torch.einsum("bchw,oc->bohw", win, wd[:, :, i, j])
            acc = term if acc is None else acc + term
    return acc.to(torch.int32)


def _conv_bands(x, w, stride, int8: bool):
    """x: (N, Cin, R, Wp) padded windows; w: (Cout, Cin_g, kh, kw); VALID
    conv with the window stack as the conv batch axis.  int8 operands give
    the exact int32 accumulator; float ones a float32 convolution."""
    depthwise = w.shape[1] != x.shape[1]
    if int8:
        if depthwise:
            return _dwconv_bands_int32(x, w, stride)
        return _dense_conv_int32(x, w, stride)
    return F.conv2d(x.to(torch.float32), w.to(torch.float32), stride=stride,
                    groups=x.shape[1] if depthwise else 1)


def _conv_chw(x, w, stride, int8: bool):
    """x: (Cin, H, W) padded; w: (Cout, Cin_g, kh, kw); VALID conv."""
    return _conv_bands(x[None], w, stride, int8)[0]


def _avgpool_int8(x_q, in_scale: float, out_scale: float):
    """Coordinator-side global average pool over the last two axes,
    requantized.  The spatial sum is exact; the mean + rescale collapse into
    a single f32 multiply by a host-rounded factor (see
    quantize.epilogue_params for the no-float-adds contract)."""
    hw = x_q.shape[-2] * x_q.shape[-1]
    factor = _pool_factor(in_scale, hw, out_scale)
    s = x_q.to(torch.int32).sum(dim=(-2, -1), keepdim=True)
    return torch.clamp(torch.round(s.to(torch.float32) * factor),
                       -127, 127).to(torch.int8)


def _pool_factor(in_scale: float, hw: int, out_scale: float) -> float:
    """The int8 global pool's one multiply: mean and rescale, rounded to
    float32 once on the host."""
    return f32(float(in_scale) / (hw * float(out_scale)))


def _gate_factor(x_scale: float, g_scale: float, out_scale: float) -> float:
    """The int8 gate's one multiply after the exact int32 product of the
    gated code and the gate code, rounded to float32 once on the host."""
    return f32(float(x_scale) * float(g_scale) / float(out_scale))


def _residual_add_int8(cur_q, cur_scale: float, other_q, other_scale: float):
    """Coordinator-side residual add (Alg. 4 line 9): the stashed activation
    is requantized to ``cur_scale`` (one f32 multiply + round), then added in
    exact int32.  Shared by both executors."""
    ratio = f32(float(other_scale) / float(cur_scale))
    r = torch.round(other_q.to(torch.float32) * ratio).to(torch.int32)
    return torch.clamp(cur_q.to(torch.int32) + r, -127, 127).to(torch.int8)


def _spatial_stage_acc(layer: LayerSpec, geom: SpatialBandGeometry, band_in,
                       weight, bias, int8: bool):
    """One spatial-band stage: VALID conv over the explicitly padded input
    window, plus bias.  Returns the raw accumulator (C_out, n_rows, w_out):
    float32, or exact int32 with the int32 bias already added."""
    _, pw = layer.padding
    x = F.pad(band_in, (pw, pw, geom.pad_top, geom.pad_bot))
    acc = _conv_chw(x, weight, layer.stride, int8)
    return acc + bias[:, None, None]


def _worker_compute(layer: LayerSpec, shard: WorkerShard, x_pad,
                    weight, bias, int8: bool):
    """Compute the shard's flat output range using only the fragment weights
    and the routed input slice.  Returns a flat vector of len n_positions
    (raw accumulator: float32, or int32 with the int32 bias ``b_q`` already
    added — exact; activation NOT applied)."""
    dt = torch.int32 if int8 else torch.float32
    if shard.n_positions == 0:
        return torch.zeros((0,), dtype=dt, device=x_pad.device)
    c_out, h_out, w_out = layer.out_shape
    hw = h_out * w_out
    s, e = shard.start, shard.stop

    if layer.kind == "linear":
        frag = weight[:, s:e]
        xv = x_pad.reshape(-1)
        if int8:
            acc = (xv.to(torch.float64) @ frag.to(torch.float64)).to(dt)
        else:
            acc = xv.to(dt) @ frag.to(dt)
        return acc + bias[s:e]

    c_lo, c_hi = s // hw, (e - 1) // hw
    if c_hi > c_lo:
        row_lo, row_hi = 0, h_out - 1
    else:
        row_lo = (s - c_lo * hw) // w_out
        row_hi = (e - 1 - c_lo * hw) // w_out
    sh, sw = layer.stride
    kh, kw = layer.kernel
    x_slice = x_pad[:, row_lo * sh:row_hi * sh + kh, :]
    if layer.kind == "dwconv":
        x_slice = x_slice[c_lo:c_hi + 1]
    out = _conv_chw(x_slice, weight[c_lo:c_hi + 1], layer.stride, int8)
    out = out + bias[c_lo:c_hi + 1][:, None, None]
    flat = out.reshape(-1)
    idx = torch.arange(s, e, device=x_pad.device)
    c = idx // hw
    rem = idx % hw
    r = rem // w_out
    col = rem % w_out
    n_rows = row_hi - row_lo + 1
    bbox_idx = (c - c_lo) * (n_rows * w_out) + (r - row_lo) * w_out + col
    return flat[bbox_idx]


class SplitExecutor:
    """Runs Algorithm 4 over a SplitPlan, eagerly (the oracle).

    ``mode`` of :meth:`run`: "float" (fp32) or "int8" (W8A8, requires a
    QuantizedModel).  Runs on ``device`` (CUDA unless the caller says).
    """

    def __init__(self, plan: SplitPlan, qmodel: QuantizedModel | None = None,
                 *, device=None):
        self.plan = plan
        self.qmodel = qmodel
        self.device = resolve_device(device)
        self._epilogues: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._band_geoms: dict[int, list[SpatialBandGeometry | None]] = {}

    def _t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _epilogue(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        if i not in self._epilogues:
            self._epilogues[i] = epilogue_params(self.qmodel.layers[i])
        return self._epilogues[i]

    def _band_geometry(self, i: int) -> list[SpatialBandGeometry | None]:
        if i not in self._band_geoms:
            sp = self.plan.splits[i]
            self._band_geoms[i] = spatial_band_geometry(sp.layer, sp)
        return self._band_geoms[i]

    def _weight(self, layer: LayerSpec):
        # float32 as in the reference, where JAX runs without 64-bit types
        # (MobileNetV2's classifier weight is float64 in the numpy model)
        return self._t(layer.weight, torch.float32)

    def _bias(self, layer: LayerSpec):
        return self._t(layer.bias if layer.bias is not None
                       else np.zeros(layer.out_shape[0], np.float32),
                       torch.float32)

    # -- fused spatial block (band + halo per worker) ----------------------
    def _run_block_spatial(self, idxs: tuple[int, ...], x, mode: str):
        """Run one fused block: each worker receives its block-input window
        (band + halo), executes every stage on the band locally, and the
        block output bands are concatenated along the row axis."""
        cut = se_cut(self.plan.model, idxs)
        if cut is not None:
            return self._run_se_block(idxs, cut, x, mode)
        bands = self._run_bands(idxs, x, mode)
        return torch.cat([b for b in bands if b is not None], dim=1)

    def _run_se_block(self, idxs: tuple[int, ...], cut: SECut, x, mode: str):
        """A squeeze-and-excitation block cut by its pool: the stages up to
        the depthwise conv on each worker's band, the pool over every
        band's own rows (the depthwise bands hold exactly their rows: the
        gate and the project conv after them are pointwise), the FCs on
        their flat splits, then each worker's gate and project conv on the
        band it kept."""
        model = self.plan.model
        pre = idxs[:idxs.index(cut.dw) + 1]
        bands = self._run_bands(pre, x, mode)
        live = [b for b in bands if b is not None]
        c, h, w = model.layers[cut.dw].out_shape
        if mode == "int8":
            ql = self.qmodel.layers[cut.pool]
            total = sum(b.to(torch.int32).sum(dim=(1, 2)) for b in live)
            g = requant(total, _pool_factor(ql.in_scale, h * w,
                                            ql.out_scale))
        else:
            g = sum(b.sum(dim=(1, 2)) for b in live) / (h * w)
        for i in (cut.fc1, cut.fc2):
            layer, split = model.layers[i], self.plan.splits[i]
            g = g.reshape(layer.in_shape)
            g = (self._run_layer_int8(i, layer, split, g) if mode == "int8"
                 else self._run_layer_float(layer, split, g))
        g = g.reshape(c, 1, 1)
        if mode == "int8":
            factor = _gate_factor(self.qmodel.layers[cut.dw].out_scale,
                                  self.qmodel.layers[cut.gate].in_scale,
                                  self.qmodel.layers[cut.gate].out_scale)
            gated = [None if b is None else
                     se_gate_ref(b[None], g.reshape(1, c), factor)[0]
                     for b in bands]
        else:
            gated = [None if b is None else b * g for b in bands]
        out = self._run_bands((cut.project,), None, mode, gated)
        return torch.cat([b for b in out if b is not None], dim=1)

    def _run_bands(self, idxs: tuple[int, ...], x, mode: str, bands=None):
        """Each worker's band through the stages ``idxs``: its window of
        ``x`` (band + halo), or its entry of ``bands``.  Returns one band a
        worker, None where its last stage has no rows."""
        model = self.plan.model
        geoms = [self._band_geometry(i) for i in idxs]
        consts = []
        for i in idxs:
            layer = model.layers[i]
            if mode == "int8":
                ql = self.qmodel.layers[i]
                scale, b_q = self._epilogue(i)
                consts.append((self._t(ql.w_q), self._t(scale)[:, None, None],
                               self._t(b_q), float(ql.out_scale)))
            else:
                consts.append((self._weight(layer), self._bias(layer)))
        parts = []
        for w in range(self.plan.n_workers):
            if geoms[-1][w] is None:
                parts.append(None)
                continue
            band = None if bands is None else bands[w]
            for li, i in enumerate(idxs):
                layer = model.layers[i]
                g = geoms[li][w]
                if g is None:
                    # degenerate interior stage: downstream rows come entirely
                    # from padding, so this stage's band is empty
                    c_out, _, w_out = layer.out_shape
                    dt = torch.int8 if mode == "int8" else torch.float32
                    band = torch.zeros((c_out, 0, w_out), dtype=dt,
                                       device=self.device)
                    continue
                if li == 0 and bands is None:
                    band = x[:, g.in_lo:g.in_hi, :]
                if mode == "int8":
                    w_q, scale_b, b_t, out_scale = consts[li]
                    acc = _spatial_stage_acc(layer, g, band, w_q, b_t,
                                             int8=True)
                    band = requantize(acc, scale_b, out_scale,
                                      layer.activation)
                else:
                    wt, b = consts[li]
                    acc = _spatial_stage_acc(layer, g, band, wt, b,
                                             int8=False)
                    band = apply_activation(acc, layer.activation)
            parts.append(band)
        return parts

    # -- single-layer worker pass -----------------------------------------
    def _run_layer_float(self, layer: LayerSpec, split: LayerSplit, x):
        if layer.kind == "avgpool":
            return x.mean(dim=(1, 2), keepdim=True)
        x_pad = _pad_chw(x, layer.padding) if layer.kind != "linear" else x
        w = self._weight(layer)
        b = self._bias(layer)
        parts = [_worker_compute(layer, sh, x_pad, w, b, int8=False)
                 for sh in split.shards]
        y = torch.cat(parts).reshape(layer.out_shape)
        return apply_activation(y, layer.activation)

    def _run_layer_int8(self, i: int, layer: LayerSpec, split: LayerSplit,
                        x_q):
        ql = self.qmodel.layers[i]
        if layer.kind == "avgpool":
            return _avgpool_int8(x_q, ql.in_scale, ql.out_scale)
        x_pad = _pad_chw(x_q, layer.padding) if layer.kind != "linear" else x_q
        w = self._t(ql.w_q)
        scale, b_q = self._epilogue(i)
        b = self._t(b_q)
        parts = [_worker_compute(layer, sh, x_pad, w, b, int8=True)
                 for sh in split.shards]
        acc = torch.cat(parts)  # int32 flat, bias included (exact)
        if layer.kind != "linear":
            hw = layer.out_shape[1] * layer.out_shape[2]
            scale = scale[np.arange(layer.n_out) // hw]
        y_q = requantize(acc, self._t(scale), float(ql.out_scale),
                         layer.activation)
        return y_q.reshape(layer.out_shape)

    def _run_gate(self, i: int, layer: LayerSpec, stashed, g, mode: str):
        """A flat gate: the whole stashed activation times the gate, each
        channel by its factor (the shards' flat ranges tile the output in
        order, so their concatenation is the whole product)."""
        c = layer.out_shape[0]
        if mode != "int8":
            return stashed * g.reshape(c, 1, 1)
        x_scale, x_q = stashed
        ql = self.qmodel.layers[i]
        factor = _gate_factor(x_scale, ql.in_scale, ql.out_scale)
        return se_gate_ref(x_q[None], g.reshape(1, c), factor)[0]

    # -- full-model execution ----------------------------------------------
    def run(self, x: np.ndarray, mode: str = "float",
            collect_activations: bool = False):
        """x: (C, H, W) input sample.  Returns the final output as numpy
        (and per-layer activations if requested — used for calibration)."""
        if mode not in ("float", "int8"):
            raise ValueError(f"unknown mode {mode!r} (want 'float' or 'int8')")
        if collect_activations and any(sp.mode == "spatial"
                                       for sp in self.plan.splits):
            raise ValueError(
                "collect_activations is unsupported with spatial(-assigned) "
                "blocks (fused interior activations never materialize); "
                "calibrate with reference_forward or a flat-mode plan")
        if mode == "int8" and self.qmodel is None:
            raise ValueError("int8 mode requires a QuantizedModel")
        with _full_fp32():
            return self._run(x, mode, collect_activations)

    def _run(self, x, mode, collect_activations):
        model = self.plan.model
        stash: dict[str, object] = {}
        acts = []
        xt = self._t(np.asarray(x, np.float32))
        if mode == "int8":
            cur = quantize_activation_t(xt, self.qmodel.input_scale)
        else:
            cur = xt
        for idxs in self.plan.block_groups:
            i = idxs[-1]
            layer = model.layers[i]
            cur = cur.reshape(model.layers[idxs[0]].in_shape)
            if self.plan.splits[idxs[0]].mode == "spatial":
                cur = self._run_block_spatial(idxs, cur, mode)
            elif layer.kind == "gate":
                cur = self._run_gate(i, layer, stash[layer.gate_from], cur,
                                     mode)
            elif mode == "int8":
                cur = self._run_layer_int8(i, layer, self.plan.splits[i], cur)
            else:
                cur = self._run_layer_float(layer, self.plan.splits[i], cur)
            if layer.residual_from is not None:
                other = stash[layer.residual_from]
                if mode == "int8":
                    oth_scale, oth_q = other
                    cur = _residual_add_int8(
                        cur, self.qmodel.layers[i].out_scale, oth_q,
                        oth_scale)
                else:
                    cur = cur + other
            if layer.save_as is not None:
                if mode == "int8":
                    stash[layer.save_as] = (self.qmodel.layers[i].out_scale,
                                            cur)
                else:
                    stash[layer.save_as] = cur
            if collect_activations:
                acts.append(cur.cpu().numpy())
        out = cur.cpu().numpy()
        return (out, acts) if collect_activations else out


# ---------------------------------------------------------------------------
# Compiled engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BandedStage:
    """Static row-gather geometry of one stage of a fused spatial block in
    the batched-band layout (all host-side numpy, computed once per block).

    ``src_rows[b, t]`` is the source row feeding window row ``t`` of band
    ``b`` — a *global* input row for the block's first stage (the one
    gather per block boundary), a band-local row of the previous stage's
    output otherwise.  ``mask`` marks which window rows carry real data:
    everything else (explicit zero padding at the tensor edge, and the fill
    that equalizes heterogeneous band heights to the common window height)
    is a row of zeros (:func:`_row_table`).  Rows a band does not own come
    out of the stage as garbage and are dropped by the next gather (or the
    final output gather), so a single uniform launch covers every band
    height."""

    index: int                      # layer index in the model
    src_rows: np.ndarray            # (bands, R_win) int32, masked-safe
    mask: np.ndarray                # (bands, 1, R_win, 1) bool
    r_out: int                      # conv output rows at the common height


@dataclasses.dataclass(frozen=True)
class _BandedBlock:
    """One fused spatial block compiled to the batched-band schedule: the
    active band order (concat order == ascending worker id), the per-stage
    gather geometry, and the static map from global output rows to
    (band, local row) realizing the final row-axis aggregation as one take."""

    idxs: tuple[int, ...]
    bands: tuple[int, ...]          # active worker ids, band-stack order
    stages: tuple[_BandedStage, ...]
    out_flat: np.ndarray            # (H_out,) int: band * r_out_last + row


def _compile_banded_block(model, idxs: tuple[int, ...],
                          geoms: list[list[SpatialBandGeometry | None]],
                          ) -> _BandedBlock:
    """Lower one fused spatial block's per-band geometry into the static
    batched-band schedule (see :class:`_BandedStage`).  Pure host-side
    numpy, a copy of the reference's."""
    active = [w for w in range(len(geoms[-1])) if geoms[-1][w] is not None]
    n_bands = len(active)
    stages: list[_BandedStage] = []
    for li, i in enumerate(idxs):
        layer = model.layers[i]
        kh, _ = layer.kernel
        sh, _ = layer.stride
        win: list[tuple[int, int, int, int]] = []
        for wk in active:
            g = geoms[li][wk]
            if g is None:
                win.append((0, 0, 0, 0))
            else:
                n_src = g.in_hi - g.in_lo
                win.append((g.pad_top, n_src,
                            g.pad_top + n_src + g.pad_bot, g.in_lo))
        # common window height; >= kh so the batched VALID conv is always
        # well-formed even when every band of an interior stage is empty
        r_win = max(max((t[2] for t in win), default=0), kh)
        src = np.zeros((n_bands, r_win), np.int32)
        mask = np.zeros((n_bands, 1, r_win, 1), bool)
        for b, (pad_top, n_src, _, in_lo) in enumerate(win):
            if n_src <= 0:
                continue
            t = np.arange(pad_top, pad_top + n_src)
            # first stage gathers from the block input (global rows); later
            # stages gather band-local rows of the previous stage's output
            src[b, t] = (in_lo if li == 0 else 0) + np.arange(n_src)
            mask[b, 0, t, 0] = True
        stages.append(_BandedStage(i, src, mask, (r_win - kh) // sh + 1))
    last = model.layers[idxs[-1]]
    h_out = last.out_shape[1]
    out_flat = np.zeros(h_out, np.int32)
    r_out_last = stages[-1].r_out
    for b, wk in enumerate(active):
        g = geoms[-1][wk]
        out_flat[g.row_lo:g.row_hi] = b * r_out_last + np.arange(g.n_rows)
    return _BandedBlock(tuple(idxs), tuple(active), tuple(stages), out_flat)


def _row_table(stage: _BandedStage) -> np.ndarray:
    """The stage's (bands, R_win) int32 row table, as the band staging
    kernels read it: ``src_rows`` where ``mask`` holds, -1 (a row of zeros)
    elsewhere."""
    return np.where(stage.mask[:, 0, :, 0], stage.src_rows,
                    -1).astype(np.int32)


def _plan_fingerprint(plan: SplitPlan, qmodel: QuantizedModel | None) -> str:
    """Content digest of a plan's compiled identity: layer structure, weights
    (plus quantized constants when present), shard geometry per split, and
    the fused-block grouping.  Plans with equal fingerprints compute the
    same function from the same constants, so their device constants are
    shared across executor instances (``CompiledSplitExecutor._fn_cache``)."""
    h = hashlib.sha256()

    def _arr(a) -> None:
        if a is None:
            h.update(b"\x00none")
        else:
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())

    for lyr in plan.model.layers:
        h.update(repr((lyr.kind, lyr.in_shape, lyr.out_shape, lyr.kernel,
                       lyr.stride, lyr.padding, lyr.activation, lyr.save_as,
                       lyr.residual_from)).encode())
        if lyr.gate_from is not None:
            h.update(repr(("gate_from", lyr.gate_from)).encode())
        _arr(lyr.weight)
        _arr(lyr.bias)
    if qmodel is not None:
        h.update(repr(float(qmodel.input_scale)).encode())
        for ql in qmodel.layers:
            _arr(ql.w_q)
            _arr(ql.b_q)
            _arr(ql.w_scale)
            h.update(repr((float(ql.in_scale), float(ql.out_scale))).encode())
    h.update(repr((plan.mode, plan.block_groups, plan.group_modes)).encode())
    for sp in plan.splits:
        if sp.mode == "spatial":
            h.update(repr([(s.row_lo, s.row_hi, s.in_lo, s.in_hi)
                           for s in sp.shards]).encode())
        else:
            h.update(repr([(s.start, s.stop) for s in sp.shards]).encode())
    return h.hexdigest()


def _kernel_eligible_dwconv(layer: LayerSpec) -> bool:
    """The depthwise kernel covers exactly the depthwise convs of MobileNet
    and EfficientNet: 3x3 or 5x5, SAME padding (1 or 2), square stride 1
    or 2."""
    k = layer.kernel[0]
    return (layer.kind == "dwconv" and k in (3, 5)
            and layer.kernel == (k, k) and layer.padding == (k // 2, k // 2)
            and layer.stride[0] == layer.stride[1]
            and layer.stride[0] in (1, 2))


def _uncovered(layer: LayerSpec, t) -> None:
    """A layer no kernel covers runs only in plain torch on the CPU."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"layer {layer.name}: no CUDA kernel covers a {layer.kind} with "
            f"kernel {layer.kernel}, stride {layer.stride}, padding "
            f"{layer.padding}")


@dataclasses.dataclass
class _Int8Layer:
    """Device constants of one int8 layer."""

    w: torch.Tensor                 # int8, the layer's own weight layout
    w_gemm: torch.Tensor | None     # (K, N) int8 GEMM operand, K contiguous
    w_dw: torch.Tensor | None       # (C, kh, kw) int8 (depthwise)
    scale: torch.Tensor             # (C_out,) f32 epilogue multiplier
    b_q: torch.Tensor               # (C_out,) int32
    out_scale: float


class _DeviceConstants:
    """Everything one plan needs on one device, uploaded once: per-layer
    int8 and float constants (filled per mode on first use), every fused
    spatial block's row tables, and the shard table of every flat 3x3 or
    5x5 depthwise layer."""

    def __init__(self):
        self.int8: dict[int, _Int8Layer] = {}
        self.float: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # per spatial block: each stage's row table (:func:`_row_table`),
        # the output rows and, for a squeeze-and-excitation block, each
        # band's own depthwise rows and their mask (the float pool's)
        self.bands: dict[tuple[int, ...], tuple] = {}
        self.shards: dict[int, ShardTable] = {}
        self.modes: set[str] = set()


class _Graph:
    """One captured forward at one (mode, input shape): the graph, its
    static input ``x`` (each batch is copied into it) and its static output
    ``y``."""

    def __init__(self, graph, x, y):
        self.graph, self.x, self.y = graph, x, y

    def replay(self):
        """Enqueue the forward on the current stream; returns a copy of the
        output, which a later replay does not overwrite."""
        self.graph.replay()
        return self.y.clone()


class CompiledSplitExecutor:
    """Runs a whole :class:`SplitPlan` batch-first on one device.

    All shard geometry (channel spans, routed input windows, bbox offsets)
    is precomputed host-side via :func:`mapping.compile_shard_geometry`, and
    the band gathers via :func:`_compile_banded_block`; a forward pass holds
    only slices, index gathers and kernel launches, and never waits on the
    device until the caller reads the output.

    Parameters
    ----------
    plan, qmodel:
        As for :class:`SplitExecutor`.
    device:
        Where it runs: CUDA unless the caller passes another device (the
        tests pass ``"cpu"``, where the kernels' plain versions run).

    ``run``/``run_batch`` accept float inputs in both modes; int8 mode
    quantizes on the device.  ``collect_activations`` is not supported —
    use the eager :class:`SplitExecutor` for calibration.

    On CUDA the forward at each (mode, input shape) is captured once as a
    CUDA graph and replayed from then on (:meth:`run_batch_async`); the
    graphs belong to the instance and hold its device constants.
    """

    def __init__(self, plan: SplitPlan, qmodel: QuantizedModel | None = None,
                 *, device=None):
        self.plan = plan
        self.qmodel = qmodel
        self.device = resolve_device(device)
        self._geometry: list[list[ShardGeometry | None]] = [
            compile_shard_geometry(sp.layer, sp) for sp in plan.splits]
        self._band_geometry: dict[int, list[SpatialBandGeometry | None]] = {
            i: spatial_band_geometry(sp.layer, sp)
            for i, sp in enumerate(plan.splits) if sp.mode == "spatial"}
        self._banded_cache: dict[tuple[int, ...], _BandedBlock] = {}
        self._fingerprint_cache: str | None = None
        self._consts: _DeviceConstants | None = None
        self._graphs: dict[tuple, _Graph] = {}
        # a graph's static input is shared: its copy, replay and output
        # copy are enqueued by one thread at a time
        self._graph_lock = threading.Lock()
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        self._graph_stats = dict(captures=0, replays=0, eager=0)
        self._save_scale: dict[str, float] = {}
        if qmodel is not None:
            for i, layer in enumerate(plan.model.layers):
                if layer.save_as is not None:
                    self._save_scale[layer.save_as] = float(
                        qmodel.layers[i].out_scale)
        # squeeze-and-excitation: the cut of each spatial block that has
        # one, and the span kind of every layer of a block's pool, FCs and
        # gate
        self._se_cuts: dict[tuple[int, ...], SECut] = {}
        self._se_kind: dict[int, str] = {}
        for block in group_blocks(plan.model):
            g = block.indices
            cut = se_cut(plan.model, g)
            if cut is None:
                continue
            if plan.splits[g[0]].mode == "spatial":
                self._se_cuts[g] = cut
            self._se_kind.update({cut.pool: "se_pool", cut.fc1: "se_fc",
                                  cut.fc2: "se_fc", cut.gate: "se_gate"})
        # attrs of each block group's ``executor.block`` spans: one a group,
        # four for a cut one (the bands before the pool, the pool, the FCs,
        # the gate and the rest)
        self._block_attrs = tuple(self._span_attrs(g)
                                  for g in plan.block_groups)

    def _span_attrs(self, g: tuple[int, ...]) -> tuple[dict, ...]:
        layers = self.plan.model.layers
        mode = ("spatial" if self.plan.splits[g[0]].mode == "spatial"
                else "flat")

        def attrs(first, last, kind):
            return {"first": layers[first].name, "last": layers[last].name,
                    "mode": mode, "kind": kind}

        cut = self._se_cuts.get(g)
        if cut is None:
            kind = "+".join(self._se_kind.get(i, layers[i].kind) for i in g)
            return (attrs(g[0], g[-1], kind),)
        pre = g[:g.index(cut.dw) + 1]
        return (attrs(g[0], cut.dw, "+".join(layers[i].kind for i in pre)),
                attrs(cut.pool, cut.pool, "se_pool"),
                attrs(cut.fc1, cut.fc2, "se_fc"),
                attrs(cut.gate, g[-1], "se_gate+conv"))

    # -- device constants ----------------------------------------------------
    # Shared ACROSS executor instances keyed on (plan fingerprint, device):
    # a re-plan (or Session.warmup) with unchanged geometry reuses the
    # uploaded weights and indices — the counterpart of the reference's
    # executable cache, whose traces re-embed every constant.
    _fn_cache: "collections.OrderedDict[tuple, _DeviceConstants]" = \
        collections.OrderedDict()
    _fn_cache_max = 16              # each entry holds a model's weights
    _fn_cache_hits = 0
    _fn_cache_misses = 0

    @property
    def fingerprint(self) -> str:
        """Content digest of everything the forward pass reads: model
        weights (and quantized constants in int8 plans) plus the full
        shard/band geometry of the plan."""
        if self._fingerprint_cache is None:
            self._fingerprint_cache = _plan_fingerprint(self.plan, self.qmodel)
        return self._fingerprint_cache

    @classmethod
    def cache_stats(cls) -> dict[str, int]:
        return dict(size=len(cls._fn_cache), hits=cls._fn_cache_hits,
                    misses=cls._fn_cache_misses)

    @classmethod
    def cache_clear(cls) -> None:
        cls._fn_cache.clear()
        cls._fn_cache_hits = 0
        cls._fn_cache_misses = 0

    def _banded_block(self, idxs: tuple[int, ...]) -> _BandedBlock:
        """The block's band schedule: over its conv stages alone where a
        squeeze-and-excitation cut runs between them (the pool and the FCs
        leave the bands, and the gate scales them in place)."""
        key = tuple(idxs)
        if key not in self._banded_cache:
            cut = self._se_cuts.get(key)
            stages = key if cut is None else tuple(
                i for i in key if i not in (*cut.reduce, cut.gate))
            geoms = [self._band_geometry[i] for i in stages]
            self._banded_cache[key] = _compile_banded_block(
                self.plan.model, stages, geoms)
        return self._banded_cache[key]

    def _constants(self, mode: str) -> _DeviceConstants:
        if self._consts is None:
            cls = CompiledSplitExecutor
            key = (self.fingerprint, str(self.device))
            consts = cls._fn_cache.get(key)
            if consts is None:
                cls._fn_cache_misses += 1
                consts = cls._fn_cache[key] = _DeviceConstants()
                while len(cls._fn_cache) > cls._fn_cache_max:
                    cls._fn_cache.popitem(last=False)
            else:
                cls._fn_cache_hits += 1
                cls._fn_cache.move_to_end(key)
            self._consts = consts
        if mode not in self._consts.modes:
            self._upload(self._consts, mode)
            self._consts.modes.add(mode)
        return self._consts

    def _upload(self, consts: _DeviceConstants, mode: str) -> None:
        dev = self.device

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        for i, layer in enumerate(self.plan.model.layers):
            if layer.weight is None:
                continue
            if mode == "float":
                bias = (layer.bias if layer.bias is not None
                        else np.zeros(layer.out_shape[0], np.float32))
                consts.float[i] = (t(layer.weight, torch.float32),
                                   t(bias, torch.float32))
                continue
            ql = self.qmodel.layers[i]
            scale, b_q = epilogue_params(ql)
            w_nk = w_dw = None
            if layer.kind == "linear":
                w_nk = ql.w_q.T
            elif layer.kind == "conv":
                w_nk = ql.w_q.reshape(layer.out_shape[0], -1)
            else:
                w_dw = ql.w_q[:, 0]
            # the GEMM weight is stored (N, K) and used as its (K, N)
            # transpose: K contiguous, as the qgemm kernel reads it, and a
            # column slice is a row range of the storage (no copy per call)
            consts.int8[i] = _Int8Layer(
                t(ql.w_q), None if w_nk is None else t(w_nk).t(),
                None if w_dw is None else t(w_dw), t(scale), t(b_q),
                float(ql.out_scale))
            geoms = [g for g in self._geometry[i] if g is not None]
            if _kernel_eligible_dwconv(layer) and geoms:
                consts.shards[i] = shard_table(
                    [(g.c_lo, g.c_hi, g.start, g.stop) for g in geoms])
        for idxs in self.plan.block_groups:
            if self.plan.splits[idxs[0]].mode != "spatial" or idxs in consts.bands:
                continue
            bb = self._banded_block(idxs)
            cut = self._se_cuts.get(idxs)
            tables = [_row_table(st) for st in bb.stages]
            rows = own = None
            if cut is not None:
                dw = self._band_geometry[cut.dw]
                rows = tuple(dw[w].n_rows if dw[w] is not None else 0
                             for w in bb.bands)
                # the rows the project stage reads: each band's own
                own = t(tables[bb.idxs.index(cut.dw) + 1] >= 0)[
                    :, None, :, None]
            consts.bands[idxs] = ([t(tb) for tb in tables],
                                  t(bb.out_flat, torch.int32), rows, own)

    # -- per-layer bodies (batch-first) -------------------------------------
    def _layer_float(self, i: int, layer: LayerSpec, split: LayerSplit, cur,
                     consts: _DeviceConstants):
        bsz = cur.shape[0]
        if layer.kind == "avgpool":
            return cur.mean(dim=(2, 3), keepdim=True)
        w, b = consts.float[i]
        if layer.kind == "linear":
            xv = cur.reshape(bsz, -1)
            parts = [xv @ w[:, sh.start:sh.stop] + b[sh.start:sh.stop]
                     for sh in split.shards if sh.n_positions]
            y = torch.cat(parts, dim=1).reshape(bsz, *layer.out_shape)
            return apply_activation(y, layer.activation)
        x_pad = _pad_chw(cur, layer.padding)
        parts = []
        for g in self._geometry[i]:
            if g is None:
                continue
            x_s = x_pad[:, :, g.in_r0:g.in_r1, :]
            if layer.kind == "dwconv":
                x_s = x_s[:, g.c_lo:g.c_hi + 1]
            out = _conv_bands(x_s, w[g.c_lo:g.c_hi + 1], layer.stride,
                              int8=False)
            out = out + b[g.c_lo:g.c_hi + 1][:, None, None]
            flat = out.reshape(bsz, -1)
            parts.append(flat[:, g.bbox_start:g.bbox_start + g.n_positions])
        y = torch.cat(parts, dim=1).reshape(bsz, *layer.out_shape)
        return apply_activation(y, layer.activation)

    def _layer_int8(self, i: int, layer: LayerSpec, cur,
                    consts: _DeviceConstants):
        ql = self.qmodel.layers[i]
        bsz = cur.shape[0]
        if layer.kind == "avgpool":
            # each sample one band of all its rows
            _, h, w = layer.in_shape
            y = se_pool(cur, (h,), _pool_factor(ql.in_scale, h * w,
                                                ql.out_scale))
            return y.reshape(bsz, *layer.out_shape)
        c = consts.int8[i]
        act, out_scale = layer.activation, c.out_scale

        if layer.kind == "linear":
            # the shards' columns tile the layer in worker order (contiguous
            # ``partition_bounds``): one launch over all of them
            y = qgemm(cur.reshape(bsz, -1), c.w_gemm, c.scale, c.b_q,
                      activation=act, out_scale=out_scale)
            return y.reshape(bsz, *layer.out_shape)

        _, h_out, w_out = layer.out_shape
        hw = h_out * w_out
        geoms = [g for g in self._geometry[i] if g is not None]
        parts = []
        if layer.kind == "conv":
            patches, _ = im2col(cur, layer.kernel, layer.stride,
                                layer.padding)
            for g in geoms:
                span = slice(g.c_lo, g.c_hi + 1)
                y = qgemm(patches, c.w_gemm[:, span], c.scale[span],
                          c.b_q[span], activation=act, out_scale=out_scale)
                # (B*hw, nch) -> the fragment's full rows, CHW flat
                flat = y.reshape(bsz, hw, -1).transpose(1, 2).reshape(bsz, -1)
                off = g.start - g.c_lo * hw
                parts.append(flat[:, off:off + g.n_positions])
        elif _kernel_eligible_dwconv(layer):
            # every worker's shard in one launch, straight into the layer's
            # flat output (the shards' ranges tile it in worker order)
            y = dwconv_shards(cur, consts.shards[i], c.w_dw, c.scale, c.b_q,
                              stride=layer.stride[0], activation=act,
                              out_scale=out_scale)
            return y.reshape(bsz, *layer.out_shape)
        else:
            _uncovered(layer, cur)
            x_pad = _pad_chw(cur, layer.padding)
            for g in geoms:
                span = slice(g.c_lo, g.c_hi + 1)
                acc = _dwconv_bands_int32(x_pad[:, span, g.in_r0:g.in_r1],
                                          c.w[span], layer.stride)
                y = requantize(acc + c.b_q[span][:, None, None],
                               c.scale[span][:, None, None], out_scale, act)
                flat = y.reshape(bsz, -1)
                parts.append(flat[:, g.bbox_start:g.bbox_start + g.n_positions])
        return torch.cat(parts, dim=1).reshape(bsz, *layer.out_shape)

    def _banded_stage_int8(self, layer: LayerSpec, x, table, bsz: int,
                           c: _Int8Layer):
        """One batched-band int8 conv stage over the windows that
        ``band_windows`` stages from ``x`` by the stage's row ``table``
        ((batch*bands, C_in, R, W + 2*pw), zero rows in place): one
        ``im2col_bands`` + ``qgemm`` launch, with the bands (and the batch)
        folded into the GEMM's M.  A 1x1 conv's windows are staged in NHWC
        memory, which is the GEMM's operand as it is; its output is left
        NHWC, viewed as (batch*bands, C_out, R, W).  (A 3x3 or 5x5
        depthwise stage is one ``dwconv_bands_unpadded`` launch on the
        unpadded windows, in :meth:`_block_spatial`.)"""
        act, out_scale = layer.activation, c.out_scale
        pw = layer.padding[1]
        if layer.kind == "conv":
            pointwise = (layer.kernel == (1, 1) and layer.stride == (1, 1)
                         and pw == 0)
            xw = band_windows(x, table, bsz, pw=pw, channels_last=pointwise)
            patches, (oh, ow) = im2col_bands(xw, layer.kernel, layer.stride)
            y = qgemm(patches, c.w_gemm, c.scale, c.b_q, activation=act,
                      out_scale=out_scale)
            return y.reshape(xw.shape[0], oh, ow, -1).permute(0, 3, 1, 2)
        xw = band_windows(x, table, bsz, pw=pw)
        _uncovered(layer, xw)
        acc = _conv_bands(xw, c.w, layer.stride, int8=True)
        return requantize(acc + c.b_q[:, None, None],
                          c.scale[:, None, None], out_scale, act)

    def _block_spatial(self, idxs: tuple[int, ...], cur, mode: str,
                       consts: _DeviceConstants, mark, attrs: tuple,
                       residual=None):
        """Fused spatial block, batched over samples and bands: every stage
        executes ALL workers' bands of every sample as one launch on a
        (batch*bands, C, rows, W) stack (heterogeneous band heights
        zero-filled to the common window height).  Before each stage one
        ``band_windows`` pass stages its windows from the producer's tensor
        (the block input for the first stage: the one halo gather per block
        boundary; the previous stage's stack after it), in the layout the
        stage's kernel reads; one ``band_take`` pass aggregates the output
        rows, and adds the int8 ``residual`` ((stashed codes, ratio)) where
        the caller gives one.

        A squeeze-and-excitation block leaves the bands after its depthwise
        stage (:meth:`_squeeze_excite`) and comes back to them for the
        project stage; ``mark(attrs[k])`` ends its k-th span there (the
        last one ends in :meth:`_forward`)."""
        model = self.plan.model
        tables, out_rows, own_rows, own = consts.bands[idxs]
        cut = self._se_cuts.get(idxs)
        stages = self._banded_block(idxs).idxs
        bsz = cur.shape[0]
        x = cur
        for li, idx in enumerate(stages):
            layer = model.layers[idx]
            if mode == "int8" and _kernel_eligible_dwconv(layer):
                # the kernel reads the width's zero columns itself
                c = consts.int8[idx]
                x = dwconv_bands_unpadded(
                    band_windows(x, tables[li], bsz), c.w_dw, c.scale, c.b_q,
                    stride=layer.stride[0], activation=layer.activation,
                    out_scale=c.out_scale)
            elif mode == "int8":
                x = self._banded_stage_int8(layer, x, tables[li], bsz,
                                            consts.int8[idx])
            else:
                wt, b = consts.float[idx]
                xw = band_windows(x, tables[li], bsz, pw=layer.padding[1])
                acc = _conv_bands(xw, wt, layer.stride, int8=False)
                x = apply_activation(acc + b[:, None, None], layer.activation)
            if cut is not None and idx == cut.dw:
                x = self._squeeze_excite(cut, x, bsz, own_rows, own, mode,
                                         consts, mark, attrs)
        return band_take(x, out_rows, bsz, *(residual or ()))

    def _squeeze_excite(self, cut: SECut, x, bsz: int, rows, own, mode: str,
                        consts: _DeviceConstants, mark, attrs):
        """The squeeze-and-excitation of a cut block on the depthwise band
        stack ``x`` ((batch*bands, C, r, W); band b owns its first
        ``rows[b]`` rows, ``own`` marks them): the pool over every band's
        own rows (``se_pool``), the two FCs, each one launch over all of
        its shards' columns, and the gate multiply of the stack
        (``se_gate``).  Returns the gated stack."""
        model = self.plan.model
        c, h, w = model.layers[cut.dw].out_shape
        mark(attrs[0])
        if mode == "int8":
            ql = self.qmodel.layers[cut.pool]
            g = se_pool(x, rows, _pool_factor(ql.in_scale, h * w,
                                              ql.out_scale))
        else:
            xs = x.reshape(bsz, -1, c, x.shape[2], x.shape[3])
            g = torch.where(own, xs, 0).sum(dim=(1, 3, 4)) / (h * w)
        mark(attrs[1])
        for i in (cut.fc1, cut.fc2):
            layer = model.layers[i]
            if mode == "int8":
                fc = consts.int8[i]
                g = qgemm(g, fc.w_gemm, fc.scale, fc.b_q,
                          activation=layer.activation,
                          out_scale=fc.out_scale)
            else:
                wt, b = consts.float[i]
                g = apply_activation(g @ wt + b, layer.activation)
        mark(attrs[2])
        if mode == "int8":
            return se_gate(x, g, _gate_factor(
                self.qmodel.layers[cut.dw].out_scale,
                self.qmodel.layers[cut.gate].in_scale,
                self.qmodel.layers[cut.gate].out_scale))
        xs = x.reshape(bsz, -1, c, x.shape[2], x.shape[3])
        return (xs * g[:, None, :, None, None]).reshape(x.shape)

    def _gate(self, i: int, layer: LayerSpec, stashed, g, mode: str):
        """A flat gate: the stashed activation (batch, C, H, W) times the
        gate (batch, C), each channel by its factor — the shards' flat
        ranges tile the output, so one launch covers them all."""
        bsz, c = g.shape[0], layer.out_shape[0]
        g = g.reshape(bsz, c)
        if mode != "int8":
            return stashed * g[:, :, None, None]
        ql = self.qmodel.layers[i]
        return se_gate(stashed, g, _gate_factor(
            self._save_scale[layer.gate_from], ql.in_scale, ql.out_scale))

    # -- plan execution -------------------------------------------------------
    def _forward(self, x, mode: str, dispatch: int | None = None):
        """The plan over the batch ``x``, enqueued; with a ``dispatch`` id,
        one ``executor.block`` span a block group."""
        if mode not in ("float", "int8"):
            raise ValueError(f"unknown mode {mode!r} (want 'float' or 'int8')")
        if mode == "int8" and self.qmodel is None:
            raise ValueError("int8 mode requires a QuantizedModel")
        consts = self._constants(mode)
        model = self.plan.model
        bsz = x.shape[0]
        if mode == "int8":
            cur = quantize_activation_t(x, self.qmodel.input_scale)
        else:
            cur = x
        stash: dict[str, torch.Tensor] = {}
        # one clock read a span: each block's span starts where the one
        # before it ends
        t_ns = [None if dispatch is None else time.perf_counter_ns()]

        def mark(attrs):
            if t_ns[0] is not None:
                t1_ns = time.perf_counter_ns()
                trace.record("executor.block", dispatch, t_ns[0], t1_ns, attrs)
                t_ns[0] = t1_ns

        for g, idxs in enumerate(self.plan.block_groups):
            i = idxs[-1]
            layer = model.layers[i]
            cur = cur.reshape(bsz, *model.layers[idxs[0]].in_shape)
            spatial = self.plan.splits[idxs[0]].mode == "spatial"
            residual = None
            if spatial and mode == "int8" and layer.residual_from is not None:
                # the block's output pass adds it
                residual = (stash[layer.residual_from], f32(
                    self._save_scale[layer.residual_from]
                    / float(self.qmodel.layers[i].out_scale)))
            if spatial:
                cur = self._block_spatial(idxs, cur, mode, consts, mark,
                                          self._block_attrs[g], residual)
            elif layer.kind == "gate":
                cur = self._gate(i, layer, stash[layer.gate_from], cur, mode)
            elif mode == "int8":
                cur = self._layer_int8(i, layer, cur, consts)
            else:
                cur = self._layer_float(i, layer, self.plan.splits[i], cur,
                                        consts)
            if layer.residual_from is not None and residual is None:
                if mode == "int8":
                    cur = _residual_add_int8(
                        cur, float(self.qmodel.layers[i].out_scale),
                        stash[layer.residual_from],
                        self._save_scale[layer.residual_from])
                else:
                    cur = cur + stash[layer.residual_from]
            if layer.save_as is not None:
                stash[layer.save_as] = cur
            mark(self._block_attrs[g][-1])
        return cur

    def _capture(self, x, mode: str, dispatch: int | None) -> _Graph:
        """The first forward at a (mode, shape) on CUDA: walk the plan once
        on ``x`` (the lazy work must not fall in a capture: the kernels'
        build and entry points, the constants' upload, the SM count, the
        split-K counters), wait for the device, then capture the walk on
        ``x``, which stays the graph's static input."""
        self._forward(x, mode)
        self._graph_stats["eager"] += 1
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        # a capture needs a stream of its own (nothing runs on it), and
        # only this thread's calls must stay capture-safe: a server's
        # scheduler may launch meanwhile
        with torch.cuda.stream(torch.cuda.Stream(self.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                y = self._forward(x, mode, dispatch)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        self._graph_stats["captures"] += 1
        return _Graph(graph, x, y)

    def _input(self, xs):
        """The batch as a float32 tensor: for a CUDA engine pinned on the
        host (a pinned copy keeps the upload asynchronous), else on the
        engine's device."""
        x = torch.as_tensor(np.ascontiguousarray(xs, np.float32))
        if self.device.type == "cuda":
            return x.pin_memory()
        return x.to(self.device)

    # -- public API ---------------------------------------------------------
    def run(self, x: np.ndarray, mode: str = "float") -> np.ndarray:
        """x: (C, H, W) float input sample (int8 mode quantizes on-device)."""
        return self.run_batch(np.asarray(x, np.float32)[None], mode)[0]

    def run_batch(self, xs: np.ndarray, mode: str = "float") -> np.ndarray:
        """xs: (B, C, H, W) float batch; returns (B, *out_shape)."""
        return self.run_batch_async(xs, mode).cpu().numpy()

    def run_batch_async(self, xs: np.ndarray, mode: str = "float",
                        dispatch: int | None = None):
        """Like :meth:`run_batch` but returns the output tensor on the
        device without waiting for it: the work is enqueued on the current
        stream, so the caller can overlap host work (forming the next
        micro-batch) with this batch's compute and read it later.

        On CUDA the batch is uploaded on a stream of the instance's own,
        copied on the current stream into the static input of the graph of
        its (mode, shape), and the graph is replayed on the current
        stream; the first dispatch at a key captures that graph first
        (:meth:`_capture`).  On the CPU the plan is walked as it is.

        ``dispatch``: the caller's dispatch id, given while spans are
        recorded (:mod:`repro_torch.trace`): ``executor.input``,
        ``executor.forward`` (``graph``: ``"replay"``, ``"capture"`` or
        ``"eager"``) and, where the plan is walked, the blocks' spans carry
        it.  None records nothing."""
        t0_ns = None if dispatch is None else time.perf_counter_ns()
        x = self._input(xs)
        fp32 = _full_fp32 if mode == "float" else contextlib.nullcontext
        if self.device.type != "cuda":
            if t0_ns is not None:
                t1_ns = time.perf_counter_ns()
                trace.record("executor.input", dispatch, t0_ns, t1_ns)
            with fp32():
                y = self._forward(x, mode, dispatch)
            with self._graph_lock:
                self._graph_stats["eager"] += 1
            how = "eager"
        else:
            key = (mode, tuple(x.shape))
            stream = torch.cuda.current_stream(self.device)
            # the upload need not wait for the batch still running on the
            # caller's stream: it runs on a stream of its own
            with torch.cuda.stream(self._upload_stream):
                x = x.to(self.device, non_blocking=True)
            stream.wait_stream(self._upload_stream)
            x.record_stream(stream)
            with self._graph_lock:
                graph = self._graphs.get(key)
                if graph is not None:
                    graph.x.copy_(x)
                if t0_ns is not None:
                    t1_ns = time.perf_counter_ns()
                    trace.record("executor.input", dispatch, t0_ns, t1_ns)
                with fp32():
                    how = "replay"
                    if graph is None:
                        graph = self._graphs[key] = self._capture(
                            x, mode, dispatch)
                        how = "capture"
                    y = graph.replay()
                self._graph_stats["replays"] += 1
        if t0_ns is not None:
            trace.record("executor.forward", dispatch, t1_ns,
                         time.perf_counter_ns(), {"graph": how})
        return y

    def graph_stats(self) -> dict[str, int]:
        """This instance's forwards by how they ran: ``captures`` (CUDA
        graphs captured), ``replays`` (graphs replayed, the capturing
        dispatch's included) and ``eager`` (plans walked launch by launch:
        every forward on the CPU, and the one before each capture).  A
        replay calls no kernel wrapper: the wrappers' ``.launches`` count
        the walks alone, the capture's own included."""
        return dict(self._graph_stats)

    def warmup(self, input_shape=None, batch: int | None = None,
               mode: str = "float") -> None:
        """Upload the constants, build the kernels and, on CUDA, capture the
        graph ahead of serving (zeros input)."""
        shape = tuple(input_shape or self.plan.model.input_shape)
        if batch is None:
            self.run(np.zeros(shape, np.float32), mode)
        else:
            self.run_batch(np.zeros((batch, *shape), np.float32), mode)


def reference_forward(model, x: np.ndarray, collect_activations: bool = False,
                      *, device=None, qmodel: QuantizedModel | None = None):
    """Monolithic single-device float forward (the infeasible-on-MCU
    baseline the split execution must match numerically).  With ``qmodel``
    the same unsplit walk in int8, in plain torch with exact int32 sums:
    the int8 answer no split may change."""
    dev = resolve_device(device)
    if qmodel is not None:
        if collect_activations:
            raise ValueError("collect_activations is for the float forward")
        return _reference_int8(qmodel, x, dev)
    stash = {}
    acts = []
    with _full_fp32():
        cur = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        for layer in model.layers:
            cur = cur.reshape(layer.in_shape)
            if layer.kind == "avgpool":
                cur = cur.mean(dim=(1, 2), keepdim=True)
            elif layer.kind == "gate":
                cur = stash[layer.gate_from] * cur
            else:
                w = torch.as_tensor(layer.weight, dtype=torch.float32,
                                    device=dev)
                b = torch.as_tensor(layer.bias, dtype=torch.float32,
                                    device=dev)
                if layer.kind == "linear":
                    cur = (cur.reshape(-1) @ w + b).reshape(layer.out_shape)
                else:
                    x_pad = _pad_chw(cur, layer.padding)
                    cur = _conv_chw(x_pad, w, layer.stride, int8=False)
                    cur = cur + b[:, None, None]
                cur = apply_activation(cur, layer.activation)
            if layer.residual_from is not None:
                cur = cur + stash[layer.residual_from]
            if layer.save_as is not None:
                stash[layer.save_as] = cur
            if collect_activations:
                acts.append(cur.cpu().numpy())
    out = cur.cpu().numpy()
    return (out, acts) if collect_activations else out


def _reference_int8(qmodel: QuantizedModel, x: np.ndarray, dev):
    """:func:`reference_forward` in int8: every layer whole, as one worker
    would run it."""
    stash: dict[str, tuple[float, torch.Tensor]] = {}
    cur = quantize_activation_t(
        torch.as_tensor(np.asarray(x, np.float32), device=dev),
        qmodel.input_scale)
    for layer, ql in zip(qmodel.model.layers, qmodel.layers):
        cur = cur.reshape(layer.in_shape)
        if layer.kind == "avgpool":
            cur = _avgpool_int8(cur, ql.in_scale, ql.out_scale)
        elif layer.kind == "gate":
            x_scale, x_q = stash[layer.gate_from]
            c = layer.out_shape[0]
            cur = se_gate_ref(x_q[None], cur.reshape(1, c), _gate_factor(
                x_scale, ql.in_scale, ql.out_scale))[0]
        else:
            scale, b_q = epilogue_params(ql)
            w = torch.as_tensor(ql.w_q, device=dev)
            b = torch.as_tensor(b_q, device=dev)
            if layer.kind == "linear":
                acc = (cur.reshape(-1).to(torch.float64)
                       @ w.to(torch.float64)).to(torch.int32) + b
                sc = torch.as_tensor(scale, device=dev)
            else:
                acc = _conv_chw(_pad_chw(cur, layer.padding), w,
                                layer.stride, int8=True) + b[:, None, None]
                sc = torch.as_tensor(scale, device=dev)[:, None, None]
            cur = requantize(acc, sc, float(ql.out_scale), layer.activation)
        if layer.residual_from is not None:
            oth_scale, oth_q = stash[layer.residual_from]
            cur = _residual_add_int8(cur, float(ql.out_scale), oth_q,
                                     oth_scale)
        if layer.save_as is not None:
            stash[layer.save_as] = (float(ql.out_scale), cur)
    return cur.reshape(qmodel.model.out_shape).cpu().numpy()
