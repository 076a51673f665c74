"""Carry a reference model and its quantization across into the port.

The reference (``repro``) and the port build the same MobileNetV2 weights
from the same seed, but parity tests and deployments want the port to run
exactly the reference's objects — above all its ``QuantizedModel``, whose
scales come from the reference's float calibration.  These functions take
the reference's ``ReinterpretedModel`` / ``QuantizedModel`` as plain
numpy arrays and per-layer fields and build the port's objects from them.
They duck-type their input and import nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

from .core.quantize import QuantizedLayer, QuantizedModel
from .core.reinterpret import LayerSpec, ReinterpretedModel


def _arr(a):
    return None if a is None else np.array(a, copy=True)


def convert_model(ref_model) -> ReinterpretedModel:
    """A port ``ReinterpretedModel`` with the reference model's layers
    (kind, shapes, kernel, stride, padding, activation, residual
    bookkeeping, weights and biases)."""
    layers = [
        LayerSpec(name=str(lyr.name), kind=str(lyr.kind),
                  in_shape=tuple(int(v) for v in lyr.in_shape),
                  out_shape=tuple(int(v) for v in lyr.out_shape),
                  weight=_arr(lyr.weight), bias=_arr(lyr.bias),
                  stride=tuple(int(v) for v in lyr.stride),
                  padding=tuple(int(v) for v in lyr.padding),
                  kernel=tuple(int(v) for v in lyr.kernel),
                  activation=lyr.activation, save_as=lyr.save_as,
                  residual_from=lyr.residual_from)
        for lyr in ref_model.layers]
    return ReinterpretedModel(layers=layers,
                              input_shape=tuple(int(v) for v in
                                                ref_model.input_shape))


def convert_qmodel(ref_qmodel, model: ReinterpretedModel | None = None
                   ) -> QuantizedModel:
    """A port ``QuantizedModel`` with the reference's int8 weights, weight
    scales, int bias and activation scales.  ``model`` is the port model it
    quantizes (default: :func:`convert_model` of the reference's)."""
    if model is None:
        model = convert_model(ref_qmodel.model)
    if len(model.layers) != len(ref_qmodel.layers):
        raise ValueError(f"{len(ref_qmodel.layers)} quantized layers for a "
                         f"model of {len(model.layers)}")
    layers = [QuantizedLayer(_arr(ql.w_q), _arr(ql.w_scale), _arr(ql.b_q),
                             float(ql.in_scale), float(ql.out_scale))
              for ql in ref_qmodel.layers]
    return QuantizedModel(model, layers, float(ref_qmodel.input_scale))
