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

An MBConv block with squeeze-and-excitation (EfficientNet) is grouped too:
``[expand] -> dwconv -> avgpool -> linear -> linear -> gate -> project``.
Its global pool cuts the block (:class:`SECut`): the expand and depthwise
stages run on bands, the pool sums every band's own rows across workers, the
two small FCs run flat, and the gate multiply and the project conv run on
the bands again, against the depthwise band each worker kept.

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


@dataclasses.dataclass(frozen=True)
class SECut:
    """Where a squeeze-and-excitation block's global pool cuts it: the
    layer indices of the depthwise conv whose output is stashed and gated,
    the pool, the two FCs, the gate and the project conv."""

    dw: int
    pool: int
    fc1: int
    fc2: int
    gate: int
    project: int

    @property
    def reduce(self) -> tuple[int, int, int]:
        """The layers between the bands: the pool and the two FCs."""
        return (self.pool, self.fc1, self.fc2)


def se_cut(model, indices) -> SECut | None:
    """The :class:`SECut` of the block ``indices`` (a tuple of layer
    indices), or None when the block has no squeeze-and-excitation."""
    layers = model.layers
    kinds = tuple(layers[i].kind for i in indices)
    tail = ("dwconv", "avgpool", "linear", "linear", "gate", "conv")
    if kinds[-len(tail):] != tail or len(kinds) > len(tail) + 1:
        return None
    return SECut(*indices[-len(tail):])


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

    * ``[conv1x1(s=1)] -> dwconv -> avgpool -> linear -> linear -> gate ->
      conv1x1(s=1)``                          (squeeze-and-excitation MBConv,
      cut by its pool: :func:`se_cut`)

    Interior layers must carry no ``save_as``/``residual_from`` bookkeeping
    (those are coordinator-side and require the full tensor), except the
    depthwise output a block's own gate scales.  ``save_as`` /
    ``residual_from`` on the *last* layer of a block is fine — the block
    output is aggregated exactly like an unfused layer's.  Everything else
    (stem conv, head conv, avgpool, linear) becomes a singleton block.
    """
    layers = model.layers
    blocks: list[FusedBlock] = []
    i = 0
    while i < len(layers):
        se = _se_block_at(layers, i)
        if se:
            blocks.append(FusedBlock(tuple(range(i, i + se))))
            i += se
            continue
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


def _se_block_at(layers, i: int) -> int:
    """The length of the squeeze-and-excitation MBConv block starting at
    layer ``i``, or 0 where none starts there."""
    start = i
    if (i < len(layers) and _is_pointwise(layers[i])
            and _fusable_interior(layers[i])):
        i += 1                                   # the expand conv
    if i + 5 >= len(layers):
        return 0
    dw, pool, fc1, fc2, gate, proj = layers[i:i + 6]
    chain = (dw.kind, pool.kind, fc1.kind, fc2.kind, gate.kind)
    if (chain != ("dwconv", "avgpool", "linear", "linear", "gate")
            or not _is_pointwise(proj)
            or dw.save_as is None or dw.residual_from is not None
            or gate.gate_from != dw.save_as
            or not all(_fusable_interior(lyr) for lyr in (pool, fc1, fc2, gate))
            or gate.out_shape != proj.in_shape
            or (i > start and layers[start].out_shape != dw.in_shape)):
        return 0
    return i + 6 - start


def sigmoid(x):
    """``1 / (1 + exp(-x))`` in the input's precision, for numpy arrays and
    torch tensors: an add, a division and the platform's accurate exp (the
    CUDA kernels' ``expf``, never a fast-math intrinsic)."""
    if isinstance(x, np.ndarray):
        return 1.0 / (1.0 + np.exp(-x))
    return 1.0 / (1.0 + (-x).exp())


def apply_activation(x, activation: str | None):
    """In-place-style fused activation (works for numpy arrays and torch
    tensors).  The ``x * (x > 0)`` form is kept from the reference so int8
    requantization rounds bit for bit as there.  ``swish`` is
    ``x * sigmoid(x)`` (one multiply after :func:`sigmoid`)."""
    if activation is None:
        return x
    if activation == "relu":
        return x * (x > 0)
    if activation == "relu6":
        return (x * (x > 0)).clip(max=6.0)
    if activation == "swish":
        return x * sigmoid(x)
    if activation == "sigmoid":
        return sigmoid(x)
    raise ValueError(f"unknown activation {activation!r}")
