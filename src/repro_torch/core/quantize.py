"""Post-training int8 quantization (paper §V.D).

Weights: symmetric per-output-channel int8.  Activations: symmetric
per-tensor int8, calibrated from a float forward pass over calibration
inputs (max-abs).  Accumulation in int32, requantization to the next layer's
activation scale — matching an integer-arithmetic-only MCU runtime
(Jacob et al., CVPR'18, the paper's [2]).

Port of ``repro/core/quantize.py``: the numpy half (``quantize_model``,
``calibrate_scales``, ``epilogue_params``) is a copy; ``requantize``,
``quantize_activation_t`` and ``epilogue`` are the torch forms of the
reference's jnp functions and run on CPU and CUDA tensors alike.

Every float constant of the epilogue that the reference forms in Python
float64 (``1 / out_scale`` and the executor's avgpool ``factor`` and residual
``ratio``) is rounded to float32 once on the host by :func:`f32` and used as
that float32 value everywhere, exactly as JAX casts a Python scalar against a
float32 array.  No kernel or torch op forms a reciprocal itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fusion import apply_activation
from .reinterpret import ReinterpretedModel


@dataclasses.dataclass
class QuantizedLayer:
    w_q: np.ndarray | None          # int8, same layout as LayerSpec.weight
    w_scale: np.ndarray | None      # per-output-channel float scale
    b_q: np.ndarray | None          # int32 bias at scale (s_in * s_w)
    in_scale: float                 # activation scale feeding this layer
    out_scale: float                # activation scale of this layer's output


@dataclasses.dataclass
class QuantizedModel:
    model: ReinterpretedModel
    layers: list[QuantizedLayer]
    input_scale: float


def quantize_tensor_per_channel(w: np.ndarray, channel_axis: int) -> tuple[np.ndarray, np.ndarray]:
    mx = np.max(np.abs(w), axis=tuple(i for i in range(w.ndim) if i != channel_axis))
    scale = np.maximum(mx, 1e-12) / 127.0
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale.astype(np.float64)


def quantize_activation(x: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


def dequantize(q: np.ndarray, scale) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scale, dtype=np.float32)


def calibrate_scales(model: ReinterpretedModel, calib_inputs: list[np.ndarray],
                     forward_fn) -> list[float]:
    """Max-abs activation scale per layer boundary.  ``forward_fn(model, x)``
    must return the list of post-activation outputs per layer (float path)."""
    n_layers = len(model.layers)
    maxes = np.zeros(n_layers + 1)
    for x in calib_inputs:
        maxes[0] = max(maxes[0], float(np.max(np.abs(x))))
        acts = forward_fn(model, x)
        for i, a in enumerate(acts):
            maxes[i + 1] = max(maxes[i + 1], float(np.max(np.abs(a))))
    return list(np.maximum(maxes, 1e-12) / 127.0)


def quantize_model(model: ReinterpretedModel, act_scales: list[float]) -> QuantizedModel:
    """act_scales: length n_layers+1 (input scale followed by per-layer output
    scales) from :func:`calibrate_scales`."""
    assert len(act_scales) == len(model.layers) + 1
    qlayers: list[QuantizedLayer] = []
    for i, layer in enumerate(model.layers):
        s_in, s_out = act_scales[i], act_scales[i + 1]
        if layer.weight is None:
            qlayers.append(QuantizedLayer(None, None, None, s_in, s_out))
            continue
        ch_axis = 0 if layer.kind in ("conv", "dwconv") else 1
        w_q, w_s = quantize_tensor_per_channel(layer.weight, ch_axis)
        bias = layer.bias if layer.bias is not None else np.zeros(
            layer.weight.shape[ch_axis], np.float32)
        b_q = np.round(bias / (s_in * w_s)).astype(np.int64)
        qlayers.append(QuantizedLayer(w_q, w_s, b_q, s_in, s_out))
    return QuantizedModel(model, qlayers, act_scales[0])


def epilogue_params(ql: QuantizedLayer) -> tuple[np.ndarray, np.ndarray]:
    """The int8 layer's fused-epilogue constants: the float32 per-channel
    dequant multiplier ``scale = s_in * w_scale`` and the int32 bias ``b_q``
    (already at accumulator scale).

    The epilogue contract — shared bit-for-bit by the eager executor, the
    compiled engine, the plain kernel versions and the CUDA kernels — is

        y_real = f32(acc_i32 + b_q) * scale            # one f32 multiply
        q_out  = clip(round(y_real * (1 / out_scale)))  # one f32 multiply

    The bias is added in exact int32 arithmetic and every float step is a
    *multiply*: a float add next to a multiply may be contracted into an FMA
    by one compiler and not by another, which flips requantization rounding
    at ties.  With multiplies only, every path rounds identically.
    """
    m = (ql.in_scale * ql.w_scale).astype(np.float32)
    return m, ql.b_q.astype(np.int32)


def f32(value: float) -> float:
    """``value`` (formed in Python float64) rounded once to float32 — the
    constant the reference's JAX code multiplies a float32 array by."""
    return float(np.float32(value))


def epilogue(acc, scale, bias, activation: str | None,
             out_scale: float | None):
    """The kernels' fused epilogue in plain torch: ``acc`` int32, ``scale``
    float32 and ``bias`` (int32 ``b_q`` added exactly before the multiply, a
    float32 real-domain bias added after it, or None when ``acc`` already
    holds it) broadcast against ``acc``.
    Returns int8 requantized at ``out_scale``, or float32 when it is None."""
    if bias is None:
        y = acc.to(torch.float32) * scale
    elif bias.dtype.is_floating_point:
        y = acc.to(torch.float32) * scale + bias
    else:
        y = (acc + bias).to(torch.float32) * scale
    y = apply_activation(y, activation)
    if out_scale is None:
        return y
    return torch.clamp(torch.round(y * f32(1.0 / float(out_scale))),
                       -127, 127).to(torch.int8)


def requantize(acc_i32, scale, out_scale: float, activation: str | None):
    """Biased int32 accumulator -> int8 output at ``out_scale`` (torch, on
    the accumulator's device).  ``scale`` is the float32 multiplier from
    :func:`epilogue_params` as a tensor broadcastable against ``acc_i32``.
    See :func:`epilogue_params` for the exactness contract."""
    return epilogue(acc_i32, scale, None, activation, out_scale)


def quantize_activation_t(x, scale: float):
    """Torch counterpart of :func:`quantize_activation` (float32
    multiply-by-reciprocal, as the reference's ``quantize_activation_jnp``)
    — used on the device by both executors so they round identically."""
    x = x.to(torch.float32)
    return torch.clamp(torch.round(x * f32(1.0 / float(scale))),
                       -127, 127).to(torch.int8)
