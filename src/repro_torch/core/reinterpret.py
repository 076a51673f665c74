"""Model reinterpretation (paper §IV.A).

Standard DL frameworks expose models at *layer* granularity; the paper's
fine-grained splitting needs *neuron-level* dependencies.  This module defines
the internal representation a pre-trained model is "reinterpreted" into:

  * :class:`LayerSpec` — one entry per fused computation (conv/dwconv/linear/
    pool) carrying tensor dimensions, kernel parameters and the weight tensors
    themselves (the paper serializes the same metadata from its Rust tracer).
  * receptive-field queries — for any output neuron ``(c, h, w)`` of a layer,
    the exact set of input activations required to compute it (paper Fig. 3,
    ``get_input()`` in Alg. 3).

All shapes are CHW (channel, height, width); linear layers are represented as
``(features, 1, 1)`` so that the same flat-index arithmetic (Alg. 1/3's
``i // (h*w)`` decomposition) applies uniformly.

Port copy of ``repro/core/reinterpret.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

Shape3 = tuple[int, int, int]


@dataclasses.dataclass
class LayerSpec:
    """One reinterpreted layer: structural metadata + parameters.

    ``kind``:
      * ``conv``    — dense 2-D convolution, weight ``(Cout, Cin, kh, kw)``
      * ``dwconv``  — depthwise convolution (groups == Cin == Cout), weight
                      ``(C, 1, kh, kw)``
      * ``linear``  — fully connected, weight ``(in_features, out_features)``
                      (column ``j`` == output neuron ``j``, paper Alg. 2)
      * ``avgpool`` — global average pool (no weights; coordinator-side)
    """

    name: str
    kind: str
    in_shape: Shape3
    out_shape: Shape3
    weight: np.ndarray | None = None
    bias: np.ndarray | None = None
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int] = (0, 0)
    kernel: tuple[int, int] = (1, 1)
    activation: str | None = None      # None | "relu" | "relu6" (fused, §V.D)
    # Residual bookkeeping: coordinator-side (the coordinator "prepares the
    # input activations for the next layer", Alg. 4 line 9 — adds happen there).
    save_as: str | None = None         # stash this layer's output under a key
    residual_from: str | None = None   # add stashed activation to this output

    def __post_init__(self) -> None:
        if self.kind in ("conv", "dwconv") and self.weight is not None:
            self.kernel = tuple(self.weight.shape[-2:])

    # -- size helpers ------------------------------------------------------
    @property
    def n_out(self) -> int:
        c, h, w = self.out_shape
        return c * h * w

    @property
    def n_in(self) -> int:
        c, h, w = self.in_shape
        return c * h * w

    def weight_bytes(self, itemsize: int = 1) -> int:
        if self.weight is None:
            return 0
        return int(np.prod(self.weight.shape)) * itemsize

    # -- neuron-level dependency queries (paper Fig. 3) ---------------------
    def receptive_field(self, c: int, h: int, w: int) -> tuple[range, range, range]:
        """Input region (channels, rows, cols) feeding output neuron (c,h,w).

        Returns half-open ranges clipped to the input bounds.  ``get_input``
        in Alg. 3 is the point-set materialization of this query.
        """
        ci, hi, wi = self.in_shape
        if self.kind == "linear":
            return range(ci), range(1), range(1)
        if self.kind == "avgpool":
            return range(c, c + 1), range(hi), range(wi)
        kh, kw = self.kernel
        sh, sw = self.stride
        ph, pw = self.padding
        h0, w0 = h * sh - ph, w * sw - pw
        rows = range(max(h0, 0), min(h0 + kh, hi))
        cols = range(max(w0, 0), min(w0 + kw, wi))
        if self.kind == "dwconv":
            return range(c, c + 1), rows, cols
        return range(ci), rows, cols  # dense conv reads every input channel

    def get_input(self, c: int, h: int, w: int) -> Iterator[tuple[int, int, int]]:
        """Materialized receptive field — literal Alg. 3 ``get_input()``."""
        chs, rows, cols = self.receptive_field(c, h, w)
        for cc in chs:
            for hh in rows:
                for ww in cols:
                    yield (cc, hh, ww)

    def input_rows_for_output_rows(self, h_lo: int, h_hi: int) -> tuple[int, int]:
        """Input row interval (inclusive lo, exclusive hi) needed for output
        rows [h_lo, h_hi] (inclusive).  Vectorized form of receptive_field
        used by the scalable mapping path."""
        _, hi, _ = self.in_shape
        if self.kind in ("linear", "avgpool"):
            return 0, hi
        kh, _ = self.kernel
        sh, _ = self.stride
        ph, _ = self.padding
        lo = max(h_lo * sh - ph, 0)
        hi_ = min(h_hi * sh - ph + kh, hi)
        return lo, hi_

    def input_cols_for_output_cols(self, w_lo: int, w_hi: int) -> tuple[int, int]:
        _, _, wi = self.in_shape
        if self.kind in ("linear", "avgpool"):
            return 0, wi
        _, kw = self.kernel
        _, sw = self.stride
        _, pw = self.padding
        lo = max(w_lo * sw - pw, 0)
        hi_ = min(w_hi * sw - pw + kw, wi)
        return lo, hi_


def conv_out_hw(in_hw: tuple[int, int], kernel: tuple[int, int],
                stride: tuple[int, int], padding: tuple[int, int]) -> tuple[int, int]:
    h = (in_hw[0] + 2 * padding[0] - kernel[0]) // stride[0] + 1
    w = (in_hw[1] + 2 * padding[1] - kernel[1]) // stride[1] + 1
    return h, w


@dataclasses.dataclass
class ReinterpretedModel:
    """Ordered layer list + consistency checks (the serialized representation
    the paper deploys; ours stays in memory / npz)."""

    layers: list[LayerSpec]
    input_shape: Shape3

    def __post_init__(self) -> None:
        prev = self.input_shape
        for lyr in self.layers:
            # Element count must chain; exact shape may differ by a flatten
            # (CHW row-major flat order is preserved, so indices still line up).
            if int(np.prod(lyr.in_shape)) != int(np.prod(prev)):
                raise ValueError(
                    f"layer {lyr.name}: in_shape {lyr.in_shape} != upstream {prev}")
            prev = lyr.out_shape

    @property
    def out_shape(self) -> Shape3:
        return self.layers[-1].out_shape

    def total_weight_bytes(self, itemsize: int = 1) -> int:
        return sum(lyr.weight_bytes(itemsize) for lyr in self.layers)

    def total_macs(self) -> int:
        return sum(layer_macs(lyr) for lyr in self.layers)


def layer_macs(layer: LayerSpec) -> int:
    """Multiply-accumulates for the full layer (workload unit W, §V.A)."""
    c, h, w = layer.out_shape
    if layer.kind == "linear":
        return layer.in_shape[0] * c
    if layer.kind == "avgpool":
        return layer.n_in
    kh, kw = layer.kernel
    cin = 1 if layer.kind == "dwconv" else layer.in_shape[0]
    return c * h * w * kh * kw * cin


def macs_for_positions(layer: LayerSpec, n_positions: int) -> int:
    """MACs for ``n_positions`` output neurons (uniform per-position cost)."""
    if layer.n_out == 0:
        return 0
    return int(round(layer_macs(layer) * n_positions / layer.n_out))


# ---------------------------------------------------------------------------
# Tracing helpers: build LayerSpecs from a functional layer description.
# ---------------------------------------------------------------------------

def trace_sequential(spec: Sequence[dict], input_shape: Shape3,
                     rng: np.random.Generator | None = None) -> ReinterpretedModel:
    """Build a ReinterpretedModel from a declarative op list.

    Each dict: {kind, out_channels?, kernel?, stride?, padding?, features?,
    activation?, save_as?, residual_from?}.  Weights are taken from 'weight'/
    'bias' keys if present, else randomly initialized (He) via ``rng`` —
    mirrors the paper's offline trace of a pre-trained network.
    """
    rng = rng or np.random.default_rng(0)
    layers: list[LayerSpec] = []
    cur = tuple(input_shape)
    for i, op in enumerate(spec):
        kind = op["kind"]
        name = op.get("name", f"L{i}_{kind}")
        if kind == "conv":
            cout = op["out_channels"]
            k = tuple(op.get("kernel", (3, 3)))
            s = tuple(op.get("stride", (1, 1)))
            p = tuple(op.get("padding", (k[0] // 2, k[1] // 2)))
            oh, ow = conv_out_hw(cur[1:], k, s, p)
            w = op.get("weight")
            if w is None:
                fan_in = cur[0] * k[0] * k[1]
                w = rng.standard_normal((cout, cur[0], *k)).astype(np.float32)
                w *= np.sqrt(2.0 / fan_in)
            b = op.get("bias")
            if b is None:
                b = np.zeros((cout,), np.float32)
            layers.append(LayerSpec(name, "conv", cur, (cout, oh, ow), w, b,
                                    stride=s, padding=p,
                                    activation=op.get("activation"),
                                    save_as=op.get("save_as"),
                                    residual_from=op.get("residual_from")))
            cur = (cout, oh, ow)
        elif kind == "dwconv":
            c = cur[0]
            k = tuple(op.get("kernel", (3, 3)))
            s = tuple(op.get("stride", (1, 1)))
            p = tuple(op.get("padding", (k[0] // 2, k[1] // 2)))
            oh, ow = conv_out_hw(cur[1:], k, s, p)
            w = op.get("weight")
            if w is None:
                w = rng.standard_normal((c, 1, *k)).astype(np.float32)
                w *= np.sqrt(2.0 / (k[0] * k[1]))
            b = op.get("bias")
            if b is None:
                b = np.zeros((c,), np.float32)
            layers.append(LayerSpec(name, "dwconv", cur, (c, oh, ow), w, b,
                                    stride=s, padding=p,
                                    activation=op.get("activation"),
                                    save_as=op.get("save_as"),
                                    residual_from=op.get("residual_from")))
            cur = (c, oh, ow)
        elif kind == "linear":
            fin = cur[0] * cur[1] * cur[2]
            fout = op["features"]
            w = op.get("weight")
            if w is None:
                w = rng.standard_normal((fin, fout)).astype(np.float32)
                w *= np.sqrt(2.0 / fin)
            b = op.get("bias")
            if b is None:
                b = np.zeros((fout,), np.float32)
            layers.append(LayerSpec(name, "linear", (fin, 1, 1), (fout, 1, 1),
                                    w, b, activation=op.get("activation")))
            cur = (fout, 1, 1)
        elif kind == "avgpool":
            layers.append(LayerSpec(name, "avgpool", cur, (cur[0], 1, 1)))
            cur = (cur[0], 1, 1)
        elif kind == "flatten":
            # Flatten is implicit: CHW row-major flat order is preserved, so a
            # downstream linear simply declares in_shape (C*H*W, 1, 1).
            cur = (cur[0] * cur[1] * cur[2], 1, 1)
        else:
            raise ValueError(f"unknown op kind {kind!r}")
    return ReinterpretedModel(layers=list(layers), input_shape=tuple(input_shape))
