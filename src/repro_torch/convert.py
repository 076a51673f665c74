"""Carry a reference model and its quantization across into the port.

The reference (``repro``) and the port build the same MobileNetV2 weights
from the same seed, but parity tests and deployments want the port to run
exactly the reference's objects — above all its ``QuantizedModel``, whose
scales come from the reference's float calibration.  These functions take
the reference's ``ReinterpretedModel`` / ``QuantizedModel`` as plain
numpy arrays and per-layer fields and build the port's objects from them.
They duck-type their input and import nothing of ``repro``.

The LM converters do the same for a reference LM's parameter tree and
cache (KV and recurrent states, every family), given as nested dicts and
lists of arrays (numpy, or anything ``np.asarray`` takes, bf16 included),
so that tests run both packages on the same weights and cache;
:func:`convert_train_state` carries a training state (params and AdamW
moments) across, so that both start a step from the same state.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.executor import resolve_device
from .core.quantize import QuantizedLayer, QuantizedModel
from .core.reinterpret import LayerSpec, ReinterpretedModel
from .models import lm
from .nn.layers import torch_dtype


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


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """An array as a tensor on ``device``; numpy's bfloat16 (ml_dtypes, as
    JAX hands it out) goes across bit for bit."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def convert_lm_params(tree, cfg, device=None, dtype=None) -> dict:
    """The port's params for ``cfg`` from a reference LM's parameter tree
    (``lm.init_model``'s dict/list structure, leaves as arrays), cast to
    ``dtype`` (default ``cfg.dtype``) on ``device`` (CUDA unless the caller
    asks for the CPU).  Raises if the tree's keys or shapes differ from
    ``lm.model_defs``."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)

    def walk(defs, node, path):
        if isinstance(defs, dict):
            keys = sorted(node) if isinstance(node, Mapping) else None
            if keys != sorted(defs):
                raise ValueError(f"{path or '/'}: keys {keys} are not "
                                 f"{sorted(defs)}")
            return {k: walk(defs[k], node[k], f"{path}/{k}") for k in defs}
        if isinstance(defs, list):
            if len(node) != len(defs):
                raise ValueError(f"{path}: {len(node)} stacks, not "
                                 f"{len(defs)}")
            return [walk(d, n, f"{path}/{i}")
                    for i, (d, n) in enumerate(zip(defs, node))]
        t = _tensor(node, dev, dtype)
        if tuple(t.shape) != defs.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the model "
                             f"wants {defs.shape}")
        return t

    return walk(lm.model_defs(cfg), tree, "")


def convert_train_state(ref_params, ref_opt, cfg, device=None):
    """The port's (params, opt_state) from a reference training state:
    params as :func:`convert_lm_params`, the moments ``m`` and ``v`` in
    float32 and ``step`` as an int32 scalar tensor, all on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    opt = {name: convert_lm_params(ref_opt[name], cfg, dev, torch.float32)
           for name in ("m", "v")}
    opt["step"] = torch.tensor(int(np.asarray(ref_opt["step"])),
                               dtype=torch.int32, device=dev)
    return convert_lm_params(ref_params, cfg, dev), opt


def _layout(node):
    """A dict's sorted keys, a list's length or an array's shape."""
    if isinstance(node, Mapping):
        return sorted(node)
    if isinstance(node, (list, tuple)):
        return len(node)
    return tuple(node.shape) if hasattr(node, "shape") else np.shape(node)


def _cache_geometry(stacks) -> tuple[int, int]:
    """(batch, max_seq) of a cache's stacks: the batch from any leaf, the
    length from the longest self-attention cache (1 with none: no
    recurrent state depends on it)."""
    batch, seq = None, 1
    for stack in stacks:
        for blk in stack.values():
            attn = blk.get("self", blk) if isinstance(blk, Mapping) else {}
            if "kv_pos" in attn:
                seq = max(seq, int(np.shape(attn["kv_pos"])[1]))
            leaf = blk
            while isinstance(leaf, Mapping):
                leaf = next(iter(leaf.values()))
            batch = int(np.shape(leaf)[1])
    return batch or 1, seq


def convert_lm_cache(ref_cache, cfg, device=None) -> dict:
    """The port's cache for ``cfg`` from a reference one (``{"pos",
    "stacks"}``, every family's KV and recurrent states): ``pos`` as a host
    int, every array as a tensor of its own dtype on ``device`` (CUDA
    unless the caller asks for the CPU).  Raises if the stacks' keys or
    shapes differ from ``lm.init_cache``'s at the cache's own batch and
    length."""
    dev = resolve_device(device)
    want = lm.init_cache(cfg, *_cache_geometry(ref_cache["stacks"]),
                         device="meta")["stacks"]

    def walk(node, want, path):
        if _layout(node) != _layout(want):
            raise ValueError(f"{path}: {_layout(node)}, where the cache of "
                             f"{cfg.name} has {_layout(want)}")
        if isinstance(node, Mapping):
            return {k: walk(v, want[k], f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, want[i], f"{path}/{i}")
                    for i, v in enumerate(node)]
        return _tensor(node, dev)

    return {"pos": int(np.asarray(ref_cache["pos"])),
            "stacks": walk(ref_cache["stacks"], want, "/stacks")}
