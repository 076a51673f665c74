"""Plain int8 reference of a toy architecture (``toy_cnn``) that is not
MobileNetV2: a 3x3 stem conv, a 3x3 depthwise, a 1x1 pointwise conv, the
global average pool and a classifier, with no inverted-residual table.

Copied into a benchmark's ``portbench/reference/toy_cnn.py`` by the CPU
tests, to show that an architecture is added as files alone.  The int8
arithmetic is the one of ``reference/mobilenet_v2.py``, applied to this
layer list."""
from __future__ import annotations

import numpy as np
import torch

from .mobilenet_v2 import Layer, float_maxes, int8_forward, quantize


def layers(model: dict) -> list[Layer]:
    """The layer list of ``model`` (a configuration's ``model`` group:
    ``input``, ``width``, ``pointwise``, ``num_classes``)."""
    c_in, h, w = model["input"]
    width, pw = model["width"], model["pointwise"]
    hw = ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    return [
        Layer("conv0", "conv", c_in, width, (h, w), hw, kernel=3, stride=2,
              padding=1, activation="relu6"),
        Layer("dw1", "dwconv", width, width, hw, hw, kernel=3, padding=1,
              activation="relu6"),
        Layer("pw2", "conv", width, pw, hw, hw, activation="relu6"),
        Layer("pool", "avgpool", pw, pw, hw, (1, 1)),
        Layer("fc", "linear", pw, model["num_classes"], (1, 1), (1, 1)),
    ]


class Reference:
    """The toy network of one configuration and one set of float weights,
    calibrated on ``calibration``; answers images with int16 codes."""

    def __init__(self, model: dict, weights: dict, calibration, device,
                 weight_bits: int = 8):
        self.layers = layers(model)
        self.device = torch.device(device)
        maxes = float_maxes(self.layers, weights, calibration, self.device)
        self.qlayers, self.input_scale = quantize(self.layers, weights, maxes,
                                                  weight_bits)

    def __call__(self, images) -> np.ndarray:
        y = int8_forward(self.layers, self.qlayers, self.input_scale, images,
                         self.device)
        return y.cpu().numpy().astype(np.int16)
