"""Single-device train step, ported from ``repro/train/trainer.py``:
next-token loss and gradients (autograd through ``models.lm``),
microbatched gradient accumulation in float32, optional int8 gradient
compression numerics and AdamW.

The reference jits the step and donates params and optimizer state; the
port runs eagerly, and ``donate`` updates the params and moments in place
under ``torch.no_grad``, which is what donation buys there.  The
reference's mesh half (``routing`` / ``seq_parallel`` options,
``batch_specs``, ``abstract_train_state`` and the sharded branch of
``make_train_step``) waits for the mesh slice (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..models import lm
from ..nn.layers import leaves, map_defs, unflatten
from .optimizer import OptConfig, adamw_update, fake_quant_grads, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1
    compress_grads: bool = False
    donate: bool = True


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
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in g_i]
        loss = loss + loss_i
        for a, g in zip(acc, g_i):
            a.add_(g.float())
        del g_i
    inv = 1.0 / k
    return loss * inv, unflatten(params, [g * inv for g in acc])


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    options: TrainOptions = TrainOptions(), *, device=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` as tensors on
    the card.  The batch holds host arrays or tensors: ``tokens`` (B, S)
    [+ ``frames`` | ``patches``] [+ ``loss_mask``].  Runs on CUDA unless
    ``device="cpu"``."""
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, the step "
                             f"runs on {dev}")
        loss, grads = loss_and_grads(params, to_device(batch, dev), cfg,
                                     options.microbatches)
        if options.compress_grads:
            grads = fake_quant_grads(grads)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, opt_cfg, in_place=options.donate)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device=None):
    """(params, opt_state) from ``seed`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    params = lm.init_model(cfg, seed, device=resolve_device(device))
    return params, init_opt_state(params)
