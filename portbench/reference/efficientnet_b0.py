"""Plain int8 EfficientNet-B0: the benchmark's reference.

One unsplit network in plain PyTorch and NumPy, written from the published
architecture (Tan & Le, arXiv 1905.11946, Table 1: a 3x3/2 stem, the
MBConv rows (e, k, c, n, s), a 1x1 head to 1280 channels, global pool,
classifier) and the int8 scheme the configuration states (symmetric
per-output-channel int8 weights, symmetric per-tensor int8 activations
calibrated by max-abs from a float forward, int32 accumulation,
requantization by float32 multiplies, round half to even, clip to +-127).
It imports nothing of the program under test: it derives the layer list,
the activation scales and the quantized weights from the float weights and
calibration images itself.

Departures from the paper:

- padding is symmetric ``k // 2`` (torchvision's ``efficientnet_b0``); the
  TF original pads SAME, which is asymmetric at stride 2;
- dropout and drop-connect (stochastic depth) are left out: they act in
  training only;
- BatchNorm is folded into the convs, and the weights are random (from the
  seed), not the trained checkpoint;
- the int8 scheme at the squeeze-and-excitation gate: the pool's mean is
  requantized like any activation, the FCs are int8 layers whose epilogues
  apply swish and sigmoid in float32 (``y * (1 / (1 + exp(-y)))`` and
  ``1 / (1 + exp(-y))``), and the gate multiplies the kept depthwise codes
  by the sigmoid's codes in exact integers, then requantizes by one float32
  multiply by ``s_dw * s_gate / s_out``.

Integer sums are taken in float64, exact for every sum of int8 products
here (far below 2**53, whatever the order), so the reference runs on the
CPU or the card alike; TF32 is switched off for the float calibration.
``weight_bits=4`` gives the control: the same network with int4 weights
(levels -7..7), the step below int8.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer of the published network, conv+BN folded (CHW).  A
    ``gate`` takes the (C, 1, 1) sigmoid as its input and scales the
    output kept under ``gate_from`` ((C, H, W)) by it."""

    name: str
    kind: str                    # conv | dwconv | avgpool | linear | gate
    cin: int
    cout: int
    in_hw: tuple[int, int]
    out_hw: tuple[int, int]
    kernel: int = 1
    stride: int = 1
    padding: int = 0
    activation: str | None = None       # None | swish | sigmoid
    save_as: str | None = None          # keep this layer's output
    residual_from: str | None = None    # add a kept output to this one
    gate_from: str | None = None        # the kept output a gate scales

    @property
    def weight_shape(self) -> tuple[int, ...] | None:
        if self.kind == "conv":
            return (self.cout, self.cin, self.kernel, self.kernel)
        if self.kind == "dwconv":
            return (self.cout, 1, self.kernel, self.kernel)
        if self.kind == "linear":
            return (self.cin, self.cout)
        return None

    @property
    def fan_in(self) -> int:
        if self.kind == "dwconv":
            return self.kernel * self.kernel
        return self.cin * self.kernel * self.kernel

    @property
    def macs(self) -> int:
        """Multiply-accumulates a sample (the pool counts one add an input
        element, the gate one multiply an output element)."""
        ho, wo = self.out_hw
        if self.kind == "conv":
            return self.cout * ho * wo * self.cin * self.kernel ** 2
        if self.kind == "dwconv":
            return self.cout * ho * wo * self.kernel ** 2
        if self.kind == "linear":
            return self.cin * self.cout
        if self.kind == "gate":
            return self.elems_written
        return self.cin * self.in_hw[0] * self.in_hw[1]

    @property
    def elems_read(self) -> int:
        """Activation elements read a sample: the input, and the kept
        output added to this one (a residual) or scaled by it (a gate)."""
        n_in = self.cin * self.in_hw[0] * self.in_hw[1]
        second = self.residual_from or self.gate_from
        return n_in + (self.elems_written if second else 0)

    @property
    def elems_written(self) -> int:
        """Activation elements written a sample: the output."""
        return self.cout * self.out_hw[0] * self.out_hw[1]


def _conv_hw(hw, k, s, p):
    return tuple((d + 2 * p - k) // s + 1 for d in hw)


def layers(model: dict) -> list[Layer]:
    """The layer list of ``model`` (a configuration's ``model`` group):
    stem 3x3/2, the MBConv rows (e, k, c, n, s) of Table 1 each with its
    squeeze-and-excitation (pool, FC to ``int(se_ratio x block input
    channels)`` with swish, FC back with sigmoid, gate), the 1x1 head,
    global average pool, classifier."""
    c_in, h, w = model["input"]
    out: list[Layer] = []

    def add(**kw):
        lyr = Layer(**kw)
        out.append(lyr)
        return lyr

    stem = model["stem_channels"]
    hw = _conv_hw((h, w), 3, 2, 1)
    add(name="stem", kind="conv", cin=c_in, cout=stem, in_hw=(h, w),
        out_hw=hw, kernel=3, stride=2, padding=1, activation="swish")
    ch = stem
    block = 0
    for e, k, c, n, s in model["mbconv"]:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = ch * e
            squeeze = max(1, int(ch * model["se_ratio"]))
            tag = f"b{block}"
            residual = stride == 1 and ch == c
            if residual:
                # the block's input is the output of the layer before it
                out[-1] = dataclasses.replace(out[-1], save_as=f"{tag}_in")
            if e != 1:
                add(name=f"{tag}_expand", kind="conv", cin=ch, cout=hidden,
                    in_hw=hw, out_hw=hw, activation="swish")
            hw_out = _conv_hw(hw, k, stride, k // 2)
            add(name=f"{tag}_dw", kind="dwconv", cin=hidden, cout=hidden,
                in_hw=hw, out_hw=hw_out, kernel=k, stride=stride,
                padding=k // 2, activation="swish", save_as=f"{tag}_dw")
            add(name=f"{tag}_se_pool", kind="avgpool", cin=hidden,
                cout=hidden, in_hw=hw_out, out_hw=(1, 1))
            add(name=f"{tag}_se_fc1", kind="linear", cin=hidden, cout=squeeze,
                in_hw=(1, 1), out_hw=(1, 1), activation="swish")
            add(name=f"{tag}_se_fc2", kind="linear", cin=squeeze, cout=hidden,
                in_hw=(1, 1), out_hw=(1, 1), activation="sigmoid")
            add(name=f"{tag}_se_gate", kind="gate", cin=hidden, cout=hidden,
                in_hw=(1, 1), out_hw=hw_out, gate_from=f"{tag}_dw")
            add(name=f"{tag}_project", kind="conv", cin=hidden, cout=c,
                in_hw=hw_out, out_hw=hw_out,
                residual_from=f"{tag}_in" if residual else None)
            hw, ch = hw_out, c
            block += 1
    last = model["last_channels"]
    add(name="head_conv", kind="conv", cin=ch, cout=last, in_hw=hw,
        out_hw=hw, activation="swish")
    add(name="gap", kind="avgpool", cin=last, cout=last, in_hw=hw,
        out_hw=(1, 1))
    add(name="classifier", kind="linear", cin=last,
        cout=model["num_classes"], in_hw=(1, 1), out_hw=(1, 1))
    return out


def se_layers(lyrs: list[Layer]) -> list[Layer]:
    """The squeeze-and-excitation pools and gates (the work of the
    program's ``se_`` kernels)."""
    return [lyr for lyr in lyrs
            if lyr.kind == "gate" or lyr.name.endswith("_se_pool")]


# -- float forward and calibration -------------------------------------------

def _dense_conv(x, w, stride, padding):
    """Dense conv as explicit products and sums (no cuDNN algorithm choice):
    one channel contraction per tap."""
    x = torch.nn.functional.pad(x, (padding,) * 4)
    k = w.shape[-1]
    n, _, hp, wp = x.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    acc = None
    for i in range(k):
        for j in range(k):
            win = x[:, :, i:i + (ho - 1) * stride + 1:stride,
                    j:j + (wo - 1) * stride + 1:stride]
            term = torch.einsum("nchw,oc->nohw", win, w[:, :, i, j])
            acc = term if acc is None else acc + term
    return acc


def _depthwise(x, w, stride, padding):
    x = torch.nn.functional.pad(x, (padding,) * 4)
    k = w.shape[-1]
    n, c, hp, wp = x.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    acc = torch.zeros((n, c, ho, wo), dtype=x.dtype, device=x.device)
    for i in range(k):
        for j in range(k):
            win = x[:, :, i:i + (ho - 1) * stride + 1:stride,
                    j:j + (wo - 1) * stride + 1:stride]
            acc += win * w[:, 0, i, j][None, :, None, None]
    return acc


def _linear_map(layer: Layer, x, w):
    """The weighted sum of a conv, depthwise or linear layer (no bias)."""
    if layer.kind == "conv":
        return _dense_conv(x, w, layer.stride, layer.padding)
    if layer.kind == "dwconv":
        return _depthwise(x, w, layer.stride, layer.padding)
    return x.reshape(x.shape[0], -1) @ w


def _act(y, activation):
    """swish and sigmoid as ``y * (1 / (1 + exp(-y)))`` and
    ``1 / (1 + exp(-y))`` in ``y``'s precision."""
    if activation is None:
        return y
    s = 1.0 / (1.0 + torch.exp(-y))
    return y * s if activation == "swish" else s


def _float_walk(lyrs: list[Layer], weights: dict, x, device):
    """Each layer's float64 output (activation, residual and gate applied)
    for the float images ``x`` (N, C, H, W), in order."""
    x = torch.as_tensor(np.asarray(x), device=device).to(torch.float64)
    kept = {}
    for lyr in lyrs:
        if lyr.kind == "avgpool":
            x = x.mean(dim=(2, 3), keepdim=True)
        elif lyr.kind == "gate":
            x = kept[lyr.gate_from] * x.reshape(x.shape[0], -1, 1, 1)
        else:
            w, b = weights[lyr.name]
            w = torch.as_tensor(w, device=device).to(torch.float64)
            b = torch.as_tensor(b, device=device).to(torch.float64)
            y = _linear_map(lyr, x, w)
            x = _act(y + (b[:, None, None] if y.dim() == 4 else b),
                     lyr.activation)
        if lyr.residual_from is not None:
            x = x + kept[lyr.residual_from]
        if lyr.save_as is not None:
            kept[lyr.save_as] = x
        yield x


def float_forward(lyrs: list[Layer], weights: dict, x, device):
    """The float64 classifier output (N, classes) for the float images
    ``x``."""
    for y in _float_walk(lyrs, weights, x, device):
        pass
    return y.reshape(y.shape[0], -1)


def float_maxes(lyrs: list[Layer], weights: dict, images, device,
                block: int = 8) -> np.ndarray:
    """Max |activation| at the input and after every layer (activation,
    residual and gate applied) over ``images``, in float64."""
    maxes = np.zeros(len(lyrs) + 1)
    for lo in range(0, len(images), block):
        x = np.asarray(images[lo:lo + block])
        maxes[0] = max(maxes[0], float(np.abs(x).max()))
        for i, y in enumerate(_float_walk(lyrs, weights, x, device)):
            maxes[i + 1] = max(maxes[i + 1], float(y.abs().max()))
    return maxes


# -- quantization ------------------------------------------------------------

@dataclasses.dataclass
class QLayer:
    w_q: np.ndarray | None       # integer weight levels (float64 holds them)
    mult: np.ndarray | None      # float32 s_in * w_scale, per output channel
    b_q: np.ndarray | None       # int64 bias at accumulator scale
    in_scale: float
    out_scale: float


def _f32(v: float) -> float:
    return float(np.float32(v))


def quantize(lyrs: list[Layer], weights: dict, maxes: np.ndarray,
             weight_bits: int = 8) -> tuple[list[QLayer], float]:
    """Scales max-abs / 127 per activation boundary; weights symmetric per
    output channel at ``2**(weight_bits-1) - 1`` levels, scale and levels
    formed in float32; bias rounded at the accumulator's scale."""
    levels = 2 ** (weight_bits - 1) - 1
    scales = list(np.maximum(maxes, 1e-12) / 127.0)
    out = []
    for i, lyr in enumerate(lyrs):
        s_in, s_out = scales[i], scales[i + 1]
        if lyr.weight_shape is None:
            out.append(QLayer(None, None, None, s_in, s_out))
            continue
        w, b = (np.asarray(a, np.float32) for a in weights[lyr.name])
        axis = 1 if lyr.kind == "linear" else 0
        other = tuple(a for a in range(w.ndim) if a != axis)
        mx = np.max(np.abs(w), axis=other)
        scale = np.maximum(mx, np.float32(1e-12)) / np.float32(levels)
        shape = [1] * w.ndim
        shape[axis] = -1
        w_q = np.clip(np.round(w / scale.reshape(shape)), -levels, levels)
        w_scale = scale.astype(np.float64)
        b_q = np.round(b / (s_in * w_scale)).astype(np.int64)
        mult = (s_in * w_scale).astype(np.float32)
        out.append(QLayer(w_q.astype(np.float64), mult, b_q, s_in, s_out))
    return out, scales[0]


# -- int8 forward ------------------------------------------------------------

def _requant(y32, out_scale: float):
    inv = _f32(1.0 / float(out_scale))
    return torch.clamp(torch.round(y32 * inv), -127, 127)


def int8_forward(lyrs: list[Layer], qlayers: list[QLayer], input_scale: float,
                 x, device):
    """int8 codes of the classifier for the float images ``x`` (N, C, H, W),
    as float64 tensors holding integers."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    cur = _requant(x, input_scale).to(torch.float64)
    kept = {}
    for lyr, q in zip(lyrs, qlayers):
        if lyr.kind == "avgpool":
            hw = lyr.in_hw[0] * lyr.in_hw[1]
            factor = _f32(q.in_scale / (hw * q.out_scale))
            s = cur.sum(dim=(2, 3), keepdim=True).to(torch.float32)
            cur = torch.clamp(torch.round(s * factor), -127,
                              127).to(torch.float64)
        elif lyr.kind == "gate":
            other, other_scale = kept[lyr.gate_from]
            factor = _f32(other_scale * q.in_scale / q.out_scale)
            prod = other * cur.reshape(cur.shape[0], -1, 1, 1)
            cur = torch.clamp(torch.round(prod.to(torch.float32) * factor),
                              -127, 127).to(torch.float64)
        else:
            w = torch.as_tensor(q.w_q, device=device)
            acc = _linear_map(lyr, cur, w)
            bias = torch.as_tensor(q.b_q.astype(np.float64), device=device)
            mult = torch.as_tensor(q.mult, device=device)
            if acc.dim() == 4:
                bias, mult = bias[:, None, None], mult[:, None, None]
            y = _act((acc + bias).to(torch.float32) * mult, lyr.activation)
            cur = _requant(y, q.out_scale).to(torch.float64)
        if lyr.residual_from is not None:
            other, other_scale = kept[lyr.residual_from]
            ratio = _f32(other_scale / q.out_scale)
            r = torch.round(other.to(torch.float32) * ratio).to(torch.float64)
            cur = torch.clamp(cur + r, -127, 127)
        if lyr.save_as is not None:
            kept[lyr.save_as] = (cur, q.out_scale)
    return cur.reshape(cur.shape[0], -1)


class Reference:
    """The reference network of one configuration and one set of float
    weights: calibrates on ``calibration`` itself, then answers any batch
    of images with its int8 classifier codes (int16 numpy)."""

    def __init__(self, model: dict, weights: dict, calibration, device,
                 weight_bits: int = 8):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.layers = layers(model)
        self.device = torch.device(device)
        maxes = float_maxes(self.layers, weights, calibration, self.device)
        self.qlayers, self.input_scale = quantize(self.layers, weights, maxes,
                                                  weight_bits)

    def __call__(self, images, block: int = 16) -> np.ndarray:
        outs = []
        for lo in range(0, len(images), block):
            y = int8_forward(self.layers, self.qlayers, self.input_scale,
                             images[lo:lo + block], self.device)
            outs.append(y.cpu().numpy().astype(np.int16))
        return np.concatenate(outs)
