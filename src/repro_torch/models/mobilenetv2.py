"""MobileNetV2 (Sandler et al., CVPR'18 — the paper's evaluation model) as a
reinterpreted layer list, with conv+BN+ReLU6 pre-fused (paper §V.D: BN folded
into conv weights/bias).

The paper evaluates at input resolution 112x112x3; ``width_mult`` and
``input_hw`` allow the reduced smoke configs.  Weights are randomly
initialized (the paper's pipeline starts from a pre-trained checkpoint; the
splitting/routing/allocation machinery is weight-agnostic).

Port copy of ``repro/models/mobilenetv2.py`` (numpy only, no torch): the port cannot import
the reference, whose package pulls in JAX, so it carries this copy and
``tests/test_torch_host.py`` pins it to the reference's outputs.
"""
from __future__ import annotations

import numpy as np

from ..core.fusion import BatchNormParams, fold_batchnorm
from ..core.reinterpret import ReinterpretedModel, trace_sequential

# (expansion t, out channels c, repeats n, stride s) — Table 2 of MobileNetV2
_INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _fused_conv_weight(rng, cout, cin, k):
    """Random conv weight with a random BN folded in — exercises fusion.py on
    every layer exactly as the offline preprocessing does."""
    fan_in = cin * k * k
    w = rng.standard_normal((cout, cin, k, k)).astype(np.float32) * np.sqrt(2.0 / fan_in)
    bn = BatchNormParams(
        gamma=rng.uniform(0.5, 1.5, cout).astype(np.float32),
        beta=rng.uniform(-0.1, 0.1, cout).astype(np.float32),
        mean=rng.uniform(-0.1, 0.1, cout).astype(np.float32),
        var=rng.uniform(0.5, 1.5, cout).astype(np.float32))
    return fold_batchnorm(w, None, bn)


def mobilenet_v2(input_hw: tuple[int, int] = (112, 112), width_mult: float = 1.0,
                 num_classes: int = 1000, seed: int = 0,
                 cfg=None) -> ReinterpretedModel:
    rng = np.random.default_rng(seed)
    cfg = cfg or _INVERTED_RESIDUAL_CFG
    ops: list[dict] = []
    in_ch = _make_divisible(32 * width_mult)

    w, b = _fused_conv_weight(rng, in_ch, 3, 3)
    ops.append(dict(kind="conv", name="stem", out_channels=in_ch, kernel=(3, 3),
                    stride=(2, 2), padding=(1, 1), weight=w, bias=b,
                    activation="relu6"))
    block = 0
    for (t, c, n, s) in cfg:
        cout = _make_divisible(c * width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = in_ch * t
            use_res = stride == 1 and in_ch == cout
            tag = f"b{block}"
            if t != 1:
                w, b = _fused_conv_weight(rng, hidden, in_ch, 1)
                ops.append(dict(kind="conv", name=f"{tag}_expand",
                                out_channels=hidden, kernel=(1, 1),
                                stride=(1, 1), padding=(0, 0), weight=w, bias=b,
                                activation="relu6",
                                # residual source saved at block input: stash on
                                # the *previous* op; handled below via save_as.
                                ))
            wdw = rng.standard_normal((hidden, 1, 3, 3)).astype(np.float32) * np.sqrt(2.0 / 9)
            bn = BatchNormParams(
                gamma=rng.uniform(0.5, 1.5, hidden).astype(np.float32),
                beta=rng.uniform(-0.1, 0.1, hidden).astype(np.float32),
                mean=rng.uniform(-0.1, 0.1, hidden).astype(np.float32),
                var=rng.uniform(0.5, 1.5, hidden).astype(np.float32))
            wdw, bdw = fold_batchnorm(wdw, None, bn)
            ops.append(dict(kind="dwconv", name=f"{tag}_dw", kernel=(3, 3),
                            stride=(stride, stride), padding=(1, 1),
                            weight=wdw, bias=bdw, activation="relu6"))
            w, b = _fused_conv_weight(rng, cout, hidden, 1)
            ops.append(dict(kind="conv", name=f"{tag}_project",
                            out_channels=cout, kernel=(1, 1), stride=(1, 1),
                            padding=(0, 0), weight=w, bias=b,
                            activation=None,
                            residual_from=f"{tag}_in" if use_res else None))
            if use_res:
                # the block input is produced by the op *preceding* this
                # block's first conv: 4 back with an expand conv, else 3.
                ops[-4 if t != 1 else -3]["save_as"] = f"{tag}_in"
            in_ch = cout
            block += 1

    last_ch = _make_divisible(1280 * max(1.0, width_mult))
    w, b = _fused_conv_weight(rng, last_ch, in_ch, 1)
    ops.append(dict(kind="conv", name="head_conv", out_channels=last_ch,
                    kernel=(1, 1), stride=(1, 1), padding=(0, 0), weight=w,
                    bias=b, activation="relu6"))
    ops.append(dict(kind="avgpool", name="gap"))
    wl = rng.standard_normal((last_ch, num_classes)).astype(np.float32) * np.sqrt(1.0 / last_ch)
    ops.append(dict(kind="linear", name="classifier", features=num_classes,
                    weight=wl, bias=np.zeros(num_classes, np.float32)))
    return trace_sequential(ops, (3, *input_hw), rng=rng)


def mobilenet_v2_smoke(seed: int = 0) -> ReinterpretedModel:
    """Reduced config (same family) for CPU smoke tests."""
    cfg = [(1, 8, 1, 1), (6, 16, 2, 2), (6, 24, 2, 2)]
    return mobilenet_v2(input_hw=(32, 32), width_mult=0.25, num_classes=10,
                        seed=seed, cfg=cfg)


def mobilenet_v2_paper(seed: int = 0) -> ReinterpretedModel:
    """The paper's evaluation configuration: full MobileNetV2 at 112x112x3
    (§VI) — the model the executor benchmark and serving examples target."""
    return mobilenet_v2(input_hw=(112, 112), seed=seed)
