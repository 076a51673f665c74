"""Layer fusion (paper §V.D): fold BatchNorm into conv weights/bias and fuse
the activation in-place, so conv+BN+ReLU becomes one composite operation.

With BN parameters (gamma, beta, mean, var, eps):
    y = gamma * (conv(x, W) + b - mean) / sqrt(var + eps) + beta
      = conv(x, W * s[c]) + (b - mean) * s[c] + beta,   s = gamma / sqrt(var+eps)

Beyond the per-op folding, :func:`group_blocks` groups consecutive layers into
*fused execution blocks* — MobileNetV2's inverted residuals
(expand 1x1 -> dwconv -> project 1x1, or dwconv -> project for t=1) — used by
the spatial partitioning mode (MCUNetV2-style patch inference): a worker runs
a whole block on its output-height band so the expanded hidden activation only
ever exists at band size, never at full resolution.

Port copy of ``repro/core/fusion.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchNormParams:
    gamma: np.ndarray
    beta: np.ndarray
    mean: np.ndarray
    var: np.ndarray
    eps: float = 1e-5


def fold_batchnorm(weight: np.ndarray, bias: np.ndarray | None,
                   bn: BatchNormParams) -> tuple[np.ndarray, np.ndarray]:
    """Fold BN into a conv/dwconv weight (Cout, Cin_g, kh, kw) and bias."""
    s = bn.gamma / np.sqrt(bn.var + bn.eps)
    w = weight * s[:, None, None, None]
    b = np.zeros(weight.shape[0], weight.dtype) if bias is None else bias
    b = (b - bn.mean) * s + bn.beta
    return w.astype(weight.dtype), b.astype(np.float32)


def fold_batchnorm_linear(weight: np.ndarray, bias: np.ndarray | None,
                          bn: BatchNormParams) -> tuple[np.ndarray, np.ndarray]:
    """Same folding for a linear weight (in_features, out_features)."""
    s = bn.gamma / np.sqrt(bn.var + bn.eps)
    w = weight * s[None, :]
    b = np.zeros(weight.shape[1], weight.dtype) if bias is None else bias
    b = (b - bn.mean) * s + bn.beta
    return w.astype(weight.dtype), b.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """Consecutive layer indices executed as one fused unit per spatial band.

    Only the first layer's input is routed from the coordinator and only the
    last layer's output is aggregated; every intermediate activation stays
    worker-local at band size.  Singleton blocks degrade to plain per-layer
    execution.
    """

    indices: tuple[int, ...]

    @property
    def first(self) -> int:
        return self.indices[0]

    @property
    def last(self) -> int:
        return self.indices[-1]

    def __len__(self) -> int:
        return len(self.indices)


def _is_pointwise(layer) -> bool:
    return (layer.kind == "conv" and layer.kernel == (1, 1)
            and layer.stride == (1, 1) and layer.padding == (0, 0))


def _fusable_interior(layer) -> bool:
    """A layer may sit before the end of a fused block only if nothing else
    needs its full output materialized: no residual stash, no residual add."""
    return layer.save_as is None and layer.residual_from is None


def group_blocks(model) -> list[FusedBlock]:
    """Group a reinterpreted model into fused execution blocks.

    Recognized patterns (MobileNetV2 inverted residuals, §V.D):

    * ``conv1x1(s=1) -> dwconv -> conv1x1(s=1)``  (expand / dw / project)
    * ``dwconv -> conv1x1(s=1)``                  (t=1 block, no expansion)

    Interior layers must carry no ``save_as``/``residual_from`` bookkeeping
    (those are coordinator-side and require the full tensor).  ``save_as`` /
    ``residual_from`` on the *last* layer of a block is fine — the block
    output is aggregated exactly like an unfused layer's.  Everything else
    (stem conv, head conv, avgpool, linear) becomes a singleton block.
    """
    layers = model.layers
    blocks: list[FusedBlock] = []
    i = 0
    while i < len(layers):
        if (i + 2 < len(layers)
                and _is_pointwise(layers[i])
                and layers[i + 1].kind == "dwconv"
                and _is_pointwise(layers[i + 2])
                and _fusable_interior(layers[i])
                and _fusable_interior(layers[i + 1])
                and layers[i].out_shape == layers[i + 1].in_shape
                and layers[i + 1].out_shape == layers[i + 2].in_shape):
            blocks.append(FusedBlock((i, i + 1, i + 2)))
            i += 3
            continue
        if (i + 1 < len(layers)
                and layers[i].kind == "dwconv"
                and _is_pointwise(layers[i + 1])
                and _fusable_interior(layers[i])
                and layers[i].out_shape == layers[i + 1].in_shape):
            blocks.append(FusedBlock((i, i + 1)))
            i += 2
            continue
        blocks.append(FusedBlock((i,)))
        i += 1
    return blocks


def apply_activation(x, activation: str | None):
    """In-place-style fused activation (works for numpy arrays and torch
    tensors).  The ``x * (x > 0)`` form is kept from the reference so int8
    requantization rounds bit for bit as there."""
    if activation is None:
        return x
    if activation == "relu":
        return x * (x > 0)
    if activation == "relu6":
        return (x * (x > 0)).clip(max=6.0)
    raise ValueError(f"unknown activation {activation!r}")
