"""EfficientNet-B0 (Tan & Le, arXiv 1905.11946, Table 1) as a reinterpreted
layer list, conv+BN folded (paper §V.D), swish fused into each conv.

Every MBConv block is ``[expand 1x1] -> kxk depthwise -> squeeze-and-
excitation -> project 1x1 [+ residual]``.  The squeeze-and-excitation is
four layers: a global average pool, an FC down to ``int(se_ratio x block
input channels)`` with swish, an FC back up with sigmoid, and a ``gate``
that scales the stashed depthwise output by the FC's per-channel factors.
Padding is symmetric ``k // 2`` (torchvision's ``efficientnet_b0``; the TF
original pads SAME); dropout and drop-connect are training-only and left
out.  Weights are random (the splitting, routing and quantization are
weight-agnostic).
"""
from __future__ import annotations

import numpy as np

from ..core.reinterpret import ReinterpretedModel, trace_sequential
from .mobilenetv2 import _fused_conv_weight

# (expansion e, kernel k, out channels c, repeats n, stride s) — Table 1
_MBCONV_CFG = [
    (1, 3, 16, 1, 1),
    (6, 3, 24, 2, 2),
    (6, 5, 40, 2, 2),
    (6, 3, 80, 3, 2),
    (6, 5, 112, 3, 1),
    (6, 5, 192, 4, 2),
    (6, 3, 320, 1, 1),
]


def _fc(rng, fin: int, fout: int):
    w = rng.standard_normal((fin, fout)).astype(np.float32) * np.sqrt(1.0 / fin)
    b = rng.uniform(-0.1, 0.1, fout).astype(np.float32)
    return w, b


def efficientnet_b0(input_hw: tuple[int, int] = (224, 224),
                    num_classes: int = 1000, seed: int = 0, cfg=None, *,
                    stem_channels: int = 32, last_channels: int = 1280,
                    se_ratio: float = 0.25) -> ReinterpretedModel:
    """EfficientNet-B0 at ``input_hw``; ``cfg`` holds the MBConv rows
    (e, k, c, n, s), Table 1's by default."""
    rng = np.random.default_rng(seed)
    cfg = cfg or _MBCONV_CFG
    ops: list[dict] = []
    in_ch = stem_channels
    w, b = _fused_conv_weight(rng, in_ch, 3, 3)
    ops.append(dict(kind="conv", name="stem", out_channels=in_ch,
                    kernel=(3, 3), stride=(2, 2), padding=(1, 1), weight=w,
                    bias=b, activation="swish"))
    block = 0
    for e, k, c, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = in_ch * e
            squeeze = max(1, int(in_ch * se_ratio))
            use_res = stride == 1 and in_ch == c
            tag = f"b{block}"
            if use_res:
                # the block input is the output of the op before the block
                ops[-1]["save_as"] = f"{tag}_in"
            if e != 1:
                w, b = _fused_conv_weight(rng, hidden, in_ch, 1)
                ops.append(dict(kind="conv", name=f"{tag}_expand",
                                out_channels=hidden, kernel=(1, 1),
                                stride=(1, 1), padding=(0, 0), weight=w,
                                bias=b, activation="swish"))
            w, b = _fused_conv_weight(rng, hidden, 1, k)
            ops.append(dict(kind="dwconv", name=f"{tag}_dw", kernel=(k, k),
                            stride=(stride, stride), padding=(k // 2, k // 2),
                            weight=w, bias=b, activation="swish",
                            save_as=f"{tag}_dw"))
            ops.append(dict(kind="avgpool", name=f"{tag}_se_pool"))
            w, b = _fc(rng, hidden, squeeze)
            ops.append(dict(kind="linear", name=f"{tag}_se_fc1",
                            features=squeeze, weight=w, bias=b,
                            activation="swish"))
            w, b = _fc(rng, squeeze, hidden)
            ops.append(dict(kind="linear", name=f"{tag}_se_fc2",
                            features=hidden, weight=w, bias=b,
                            activation="sigmoid"))
            ops.append(dict(kind="gate", name=f"{tag}_se_gate",
                            gate_from=f"{tag}_dw"))
            w, b = _fused_conv_weight(rng, c, hidden, 1)
            ops.append(dict(kind="conv", name=f"{tag}_project", out_channels=c,
                            kernel=(1, 1), stride=(1, 1), padding=(0, 0),
                            weight=w, bias=b, activation=None,
                            residual_from=f"{tag}_in" if use_res else None))
            in_ch = c
            block += 1
    w, b = _fused_conv_weight(rng, last_channels, in_ch, 1)
    ops.append(dict(kind="conv", name="head_conv", out_channels=last_channels,
                    kernel=(1, 1), stride=(1, 1), padding=(0, 0), weight=w,
                    bias=b, activation="swish"))
    ops.append(dict(kind="avgpool", name="gap"))
    wl = rng.standard_normal((last_channels, num_classes)).astype(np.float32)
    wl *= np.sqrt(1.0 / last_channels)
    ops.append(dict(kind="linear", name="classifier", features=num_classes,
                    weight=wl, bias=np.zeros(num_classes, np.float32)))
    return trace_sequential(ops, (3, *input_hw), rng=rng)


# a 3x3 block without expansion, a stride-2 5x5 block, a residual 5x5
# block and a stride-2 3x3 block at 32x32
SMOKE_CFG = [(1, 3, 8, 1, 1), (6, 5, 16, 2, 2), (6, 3, 24, 1, 2)]


def efficientnet_b0_smoke(seed: int = 0) -> ReinterpretedModel:
    """Reduced configuration (same block kinds) for CPU smoke tests."""
    return efficientnet_b0(input_hw=(32, 32), num_classes=10, seed=seed,
                           cfg=SMOKE_CFG, stem_channels=16, last_channels=64)
