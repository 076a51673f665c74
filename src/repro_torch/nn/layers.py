"""Parameter definitions and primitive layers, ported from
``repro/nn/layers.py``.

Models declare a nested dict (and list) of :class:`ParamDef`; the same tree
drives initialization, the parameter count, the meta-device stand-ins
(:func:`abstract_params`) and the logical names the sharding rules read
(:func:`spec_tree`).  Norms, RoPE and activations compute in float32 and cast
back to the input's dtype, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype string (or a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    names: tuple[str | None, ...]       # logical axes (as the reference's)
    init: str = "normal"                # normal | zeros | ones
    scale: float | None = None          # stddev; None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def map_defs(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list tree (``ParamDef``s or
    tensors), keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_defs(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a nested dict/list tree, dict keys sorted (the order
    of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template, flat):
    """A tree shaped like ``template`` whose leaves are ``flat``, taken in
    the order of :func:`leaves`."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(template)


def _std(d: ParamDef) -> float:
    fan_in = d.shape[0] if len(d.shape) == 1 else int(np.prod(d.shape[:-1]))
    # stacked-layer params: leading 'layers' axis is not fan-in
    if len(d.shape) >= 2 and d.names[0] == "layers":
        fan_in = int(np.prod(d.shape[1:-1])) or 1
    return d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))


def init_params(defs, generator: torch.Generator, dtype=None, place=None):
    """Materialize a ParamDef tree into tensors on the generator's device:
    normal leaves are float32 draws from ``generator`` times their scale,
    cast to the leaf's dtype.  A stacked leaf (leading ``layers`` axis) is drawn one
    layer at a time, so no float32 temporary larger than one layer's slice
    exists (a full-depth qwen3-14b ``wi`` would need 14 GB).  The draws
    differ from ``jax.random``'s; parity tests carry weights across with
    :func:`repro_torch.convert.convert_lm_params` instead.  ``place``, where
    given, maps each leaf as soon as it is made (a mesh placement)."""
    device = generator.device

    def mk(d: ParamDef):
        dt = torch_dtype(dtype) if dtype is not None else d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        std = _std(d)
        out = torch.empty(d.shape, dtype=dt, device=device)
        slices = out if d.names[0] == "layers" and len(d.shape) >= 2 \
            else out[None]
        for sl in slices:
            sl.copy_(torch.randn(sl.shape, generator=generator,
                                 device=device, dtype=torch.float32)
                     .mul_(std))
        return out

    return map_defs(mk if place is None else lambda d: place(mk(d)), defs)


def abstract_params(defs, dtype=None):
    """The ParamDef tree as tensors on the meta device: shapes and dtypes,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return map_defs(lambda d: torch.empty(
        d.shape, dtype=torch_dtype(dtype) if dtype is not None else d.dtype,
        device="meta"), defs)


def spec_tree(defs):
    """Tree of logical-name tuples (consumed by ``parallel.sharding``)."""
    return map_defs(lambda d: tuple(d.names), defs)


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in leaves(defs))


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def apply_norm(x, p, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def norm_defs(d: int, kind: str, prefix_shape: tuple[int, ...] = (),
              prefix_names: tuple[str, ...] = ()) -> dict:
    out = {"scale": ParamDef(prefix_shape + (d,), prefix_names + ("act_embed",),
                             init="ones")}
    if kind == "layernorm":
        out["bias"] = ParamDef(prefix_shape + (d,),
                               prefix_names + ("act_embed",), init="zeros")
    return out


def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_ROPE_FREQS: dict = {}


def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    """The RoPE frequencies, made once per device: a host-to-device copy
    per layer would make the host wait on the card in every decode step.
    One made under a fake-tensor mode (the dry-run's counting) is not
    kept: a fake tensor outlives its mode and turns every later
    computation that meets it into fake tensors."""
    key = (head_dim, theta, device)
    out = _ROPE_FREQS.get(key)
    if out is None:
        from torch._subclasses.fake_tensor import FakeTensor
        out = torch.as_tensor(rope_frequencies(head_dim, theta),
                              dtype=torch.float32, device=device)
        if not isinstance(out, FakeTensor):
            _ROPE_FREQS[key] = out
    return out


def apply_rope(x, positions, theta: float):
    """x: (B, S, ..., hd) with any number of head axes; positions: (B, S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                # (B, S, hd/2)
    ang = ang.reshape(*ang.shape[:2], *(1,) * (x.ndim - 3), hd // 2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swish(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap)
