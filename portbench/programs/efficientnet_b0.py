"""The port's EfficientNet-B0 (``repro_torch.models.efficientnet``) of a
configuration, carrying the benchmark's weights.

The program's own ``efficientnet_b0`` builds the layer list; its weights
are then replaced by the benchmark's, after every layer's structure has
been held against the published architecture of
``portbench/reference/efficientnet_b0.py``.
"""
from __future__ import annotations

import itertools


def _structure(lyr) -> tuple:
    """A published layer as the program's ``LayerSpec`` states it."""
    if lyr.kind == "linear":
        in_shape, out_shape = (lyr.cin, 1, 1), (lyr.cout, 1, 1)
    else:
        in_shape = (lyr.cin, *lyr.in_hw)
        out_shape = (lyr.cout, *lyr.out_hw)
    spatial = lyr.kind in ("conv", "dwconv")
    return (lyr.name, lyr.kind, in_shape, out_shape,
            (lyr.stride,) * 2 if spatial else (1, 1),
            (lyr.padding,) * 2 if spatial else (0, 0),
            (lyr.kernel,) * 2 if spatial else (1, 1),
            lyr.activation, lyr.save_as, lyr.residual_from, lyr.gate_from)


def program_model(model_cfg: dict, weights: dict, published: list):
    """The program's ``ReinterpretedModel`` of ``model_cfg`` carrying
    ``weights``.  Raises if any layer differs from ``published``, the
    reference's layer list of ``model_cfg``."""
    from repro_torch.models.efficientnet import efficientnet_b0
    _, h, w = model_cfg["input"]
    model = efficientnet_b0(
        input_hw=(h, w), num_classes=model_cfg["num_classes"],
        cfg=[tuple(r) for r in model_cfg["mbconv"]],
        stem_channels=model_cfg["stem_channels"],
        last_channels=model_cfg["last_channels"],
        se_ratio=model_cfg["se_ratio"])
    got = [(s.name, s.kind, tuple(s.in_shape), tuple(s.out_shape),
            tuple(s.stride), tuple(s.padding), tuple(s.kernel), s.activation,
            s.save_as, s.residual_from, s.gate_from) for s in model.layers]
    want = [_structure(lyr) for lyr in published]
    for i, (a, b) in enumerate(itertools.zip_longest(got, want)):
        if a != b:
            raise RuntimeError(f"the program's EfficientNet-B0 differs from "
                               f"the published one at layer {i}: {a} != {b}")
    for spec in model.layers:
        if spec.weight is not None:
            spec.weight, spec.bias = weights[spec.name]
    return model
