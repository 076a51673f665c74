"""Train step, ported from ``repro/train/trainer.py``: next-token loss
and gradients (autograd through ``models.lm``), microbatched gradient
accumulation in float32, optional int8 gradient compression numerics and
AdamW, on one device or on a mesh: FSDP over the data axes x the model
axis, with the paper's routing modes (``parallel.sharding.make_rules``).

The reference jits the step and donates params and optimizer state; the
port runs eagerly, and ``donate`` updates the params and moments in place
under ``torch.no_grad``, which is what donation buys there.  On a mesh the
params and moments are DTensors placed by the rules (``init_train_state``
with ``mesh``), and the batch is the global batch, which every rank holds
alike; each rank computes its rows (``models.lm``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..models import lm
from ..nn.layers import torch_dtype
from ..nn.layers import leaves, map_defs, unflatten
from ..parallel import sharding as sh
from ..parallel.sharding import (MeshRules, make_rules, param_shardings,
                                 use_rules)
from .optimizer import OptConfig, adamw_update, fake_quant_grads, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    routing: str = "direct"          # 'direct' | 'coordinator' (paper baseline)
    seq_parallel: bool = True
    microbatches: int = 1
    compress_grads: bool = False
    donate: bool = True


def batch_specs(cfg: ModelConfig, shape, rules: MeshRules) -> dict:
    """Stand-ins (shape, dtype, sharding) for a global batch of ``shape``
    (a ``configs.ShapeConfig``)."""
    gb, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    out: dict = {}
    if cfg.family == "vlm":
        p = cfg.n_patches
        out["tokens"] = rules.sds((gb, s - p), torch.int32, ("batch", None))
        out["patches"] = rules.sds((gb, p, d), dt, ("batch", None, None))
        out["loss_mask"] = rules.sds((gb, s - p), torch.float32,
                                     ("batch", None))
    elif cfg.family == "audio":
        out["tokens"] = rules.sds((gb, s), torch.int32, ("batch", None))
        out["frames"] = rules.sds((gb, cfg.n_audio_frames, d), dt,
                                  ("batch", None, None))
    else:
        out["tokens"] = rules.sds((gb, s), torch.int32, ("batch", None))
    return out


def to_device(batch: dict, device) -> dict:
    """A batch of host arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params, batch: dict, cfg: ModelConfig,
                   microbatches: int = 1):
    """(loss, grads) of ``lm.lm_loss`` at ``params``; grads shaped like
    params, in their dtype.  With ``microbatches`` k > 1 the batch is cut
    into k slices along its first axis, float32 gradients are summed over
    them, and loss and gradients are divided by k (the reference's scan)."""
    def one(micro):
        leaf = map_defs(lambda t: t.detach().requires_grad_(True), params)
        flat = leaves(leaf)
        with torch.enable_grad():
            loss = lm.lm_loss(leaf, micro, cfg)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads)

    if microbatches <= 1:
        loss, grads = one(batch)
        return loss, unflatten(params, grads)
    k = microbatches
    n = len(batch["tokens"])
    if n % k:
        raise ValueError(f"batch of {n} does not split into {k} microbatches")
    loss, acc = None, None
    for i in range(k):
        micro = {name: x[i * n // k:(i + 1) * n // k]
                 for name, x in batch.items()}
        loss_i, g_i = one(micro)
        if acc is None:
            loss = torch.zeros((), dtype=torch.float32, device=loss_i.device)
            acc = [sh.like(g, lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device)) for g in g_i]
        loss = loss + loss_i
        for a, g in zip(acc, g_i):
            sh.local(a).add_(sh.local(g).float())
        del g_i
    inv = 1.0 / k
    return loss * inv, unflatten(params, [sh.like(g, lambda t: t * inv)
                                          for g in acc])


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def train_rules(mesh, options: TrainOptions = TrainOptions()) -> MeshRules:
    return make_rules(mesh, mode="train", routing=options.routing,
                      seq_parallel=options.seq_parallel)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    options: TrainOptions = TrainOptions(), *, device=None,
                    mesh=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as tensors on
    the card.  The batch holds host arrays or tensors: ``tokens`` (B, S)
    [+ ``frames`` | ``patches``] [+ ``loss_mask``].  Runs on CUDA unless
    ``device="cpu"``.

    With ``mesh`` (a ``DeviceMesh``) the step runs under the mesh's train
    rules (``step.rules``) on the mesh's device, over params and moments
    placed by them (``init_train_state(..., mesh=, rules=step.rules)``);
    the batch is the global batch, the same on every rank (or DTensors of
    it).  Every family runs on a mesh."""
    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh step runs on its mesh's device: pass "
                             "mesh or device, not both")
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    rules = train_rules(mesh, options) if mesh is not None else None

    def step(params, opt_state, batch):
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, the step "
                             f"runs on {dev}")
        if (mesh is not None) != sh.is_dtensor(params["embed"]):
            raise ValueError("a mesh step takes DTensor params "
                             "(init_train_state with mesh=), a "
                             "single-device step plain tensors")
        batch = {k: v.full_tensor() if sh.is_dtensor(v) else v
                 for k, v in batch.items()}
        with use_rules(rules):
            loss, grads = loss_and_grads(params, to_device(batch, dev), cfg,
                                         options.microbatches)
            if options.compress_grads:
                grads = fake_quant_grads(grads)
            params, opt_state, metrics = adamw_update(
                grads, opt_state, params, opt_cfg, in_place=options.donate)
        metrics["loss"] = loss
        return params, opt_state, metrics

    step.rules = rules
    return step


def abstract_train_state(cfg: ModelConfig, rules: MeshRules):
    """Stand-ins (shape, dtype, sharding) for params and optimizer state:
    the allocation-free description of a train state on ``rules``' mesh."""
    params = lm.abstract_model(cfg)
    p_sh = param_shardings(lm.model_spec_tree(cfg), rules, shapes=params)

    def sds(dtype=None):
        return sh.map_names(lambda _, t, s: sh.Sds(
            tuple(t.shape), dtype or t.dtype, s), lm.model_spec_tree(cfg),
            params, p_sh)

    opt = {"m": sds(torch.float32), "v": sds(torch.float32),
           "step": sh.Sds((), torch.int32, rules.sharding(()))}
    return sds(), opt


def state_shardings(tree):
    """The shardings of a tree of stand-ins (``abstract_train_state``), as
    ``ckpt.restore_checkpoint`` takes them."""
    return map_defs(lambda s: s.sharding, tree)


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device=None,
                     mesh=None, rules: MeshRules | None = None):
    """(params, opt_state) from ``seed`` on ``device`` (CUDA unless the
    caller asks for the CPU); with ``mesh`` and its ``rules``, on the
    mesh's device, each param placed by the rules as it is made (every rank
    draws the same full tensor and keeps its shard), the moments placed
    alike and the step a plain tensor on every rank."""
    if mesh is None:
        params = lm.init_model(cfg, seed, device=resolve_device(device))
        return params, init_opt_state(params)
    if device is not None:
        raise ValueError("pass mesh or device, not both")
    if rules is None or rules.mesh is not mesh:
        raise ValueError("a mesh state needs the mesh's rules "
                         "(make_train_step(..., mesh=).rules)")
    p_sh = param_shardings(lm.model_spec_tree(cfg), rules,
                           shapes=lm.abstract_model(cfg))
    params = lm.init_model(cfg, seed, device=mesh_device(mesh),
                           shardings=p_sh)
    return params, init_opt_state(params)
