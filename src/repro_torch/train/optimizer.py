"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup cosine schedule, ported from ``repro/train/optimizer.py``.

Plain functions over the port's dict/list trees (``nn.layers.map_defs`` /
``leaves``), not ``torch.optim.AdamW``, which folds weight decay and eps
in another order.  The order of operations is the reference's: the update
in float32, ``(p32 - lr * u)`` cast back to the param's dtype, the bias
corrections from a float32 step, the global norm summed leaf by leaf in
``leaves`` order.  The step counter is an int32 tensor on the params'
device, so the schedule and the corrections are float32 tensors there and
no step makes the host wait on the card.

The update is elementwise, so it walks each leaf in slices of
``UPDATE_SLICE`` elements: its float32 temporaries stay that small
whatever the leaf (a full-width embedding is 778 M elements).  With
``in_place`` it writes the params and moments it was given.

On a mesh the leaves are DTensors with one placement: the update runs on
each rank's local shards, and the global norm and the compression scale
count each element once (a sum or max over the ranks that shard a leaf,
not over those that hold copies of it).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..nn.layers import leaves, map_defs, unflatten
from ..parallel import sharding as sh

UPDATE_SLICE = 1 << 25          # elements per slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(step, cfg: OptConfig):
    """The learning rate at ``step`` (a tensor), as a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params`` (placed like them on a
    mesh) and a zero int32 step, on the params' device."""
    def zeros(p):
        return sh.like(p, lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                device=t.device))
    dev = leaves(params)[0].device
    return {"m": map_defs(zeros, params), "v": map_defs(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _leaf_reduce(g, fn, op):
    """``fn`` of a leaf's local shard, reduced by ``op`` ("sum" | "max")
    over the ranks that shard it on a mesh."""
    out = fn(sh.local(g))
    if sh.is_dtensor(g):
        import torch.distributed as dist
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        out = sh.reduce_over(out.clone(), g.device_mesh, g.placements, red)
    return out


def global_norm(tree):
    """sqrt of the sum over leaves (in ``leaves`` order) of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(
        _leaf_reduce(g, lambda t: torch.sum(torch.square(t.float())), "sum")
        for g in leaves(tree)))


def _slices(*ts):
    """Matching flat slices of equally sized contiguous tensors."""
    flat = [t.view(-1) for t in ts]
    n = flat[0].numel()
    for i in range(0, n, UPDATE_SLICE):
        yield [f[i:i + UPDATE_SLICE] for f in flat]


def adamw_update(grads, opt_state, params, cfg: OptConfig, *,
                 in_place: bool = False):
    """Returns (new_params, new_opt_state, metrics).  With ``in_place`` the
    params and ``opt_state``'s moments are overwritten and returned."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = schedule(step, cfg)
        stepf = step.float()
        b1c = 1 - torch.pow(cfg.b1, stepf)
        b2c = 1 - torch.pow(cfg.b2, stepf)

        def upd(g, m, v, p):
            if sh.is_dtensor(p) and not (
                    g.placements == m.placements == v.placements ==
                    p.placements):
                raise ValueError(f"a leaf's grad and moments are not placed "
                                 f"as its param ({p.placements})")
            if in_place:
                out = p, m, v
            else:
                out = (torch.empty_like(p), torch.empty_like(m),
                       torch.empty_like(v))
            for gs, ms, vs, ps, po, mo, vo in _slices(
                    *(sh.local(t) for t in (g, m, v, p, *out))):
                gs = gs.float() * scale
                mn = cfg.b1 * ms + (1 - cfg.b1) * gs
                vn = cfg.b2 * vs + (1 - cfg.b2) * gs * gs
                del gs
                u = (mn / b1c) / (torch.sqrt(vn / b2c) + cfg.eps)
                mo.copy_(mn)
                vo.copy_(vn)
                del mn, vn
                p32 = ps.float()
                u = u + cfg.weight_decay * p32
                po.copy_((p32 - lr * u).to(p.dtype))
            return out

        flat_p = leaves(params)
        flat = [leaves(grads), leaves(opt_state["m"]),
                leaves(opt_state["v"])]
        if any(len(f) != len(flat_p) for f in flat):
            raise ValueError("grads, moments and params differ in structure")
        new = [upd(*t) for t in zip(*flat, flat_p)]
        new_p, new_m, new_v = (unflatten(params, [o[i] for o in new])
                               for i in range(3))
        return new_p, {"m": new_m, "v": new_v, "step": step}, \
            {"grad_norm": gnorm, "lr": lr}


def fake_quant_grads(grads, bits: int = 8):
    """Lossy int-N gradient compression numerics (per-tensor symmetric
    scale from the whole tensor's largest magnitude, round half to even as
    ``jnp.round``).  The reference pairs it
    with a compressed cross-pod reducer on a mesh; here it reproduces the
    numerics, so convergence under compression is testable on one
    device."""
    qmax = 2.0 ** (bits - 1) - 1

    def q(g):
        top = _leaf_reduce(g, lambda t: torch.max(torch.abs(t.float())),
                           "max")
        s = torch.clamp(top, min=1e-12) / qmax
        return sh.like(g, lambda t: (torch.round(t.float() / s).clamp(
            -qmax, qmax) * s).to(t.dtype))

    return map_defs(q, grads)
