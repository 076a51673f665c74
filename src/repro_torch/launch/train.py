"""Training launcher, ported from ``repro/launch/train.py``: real steps on
one device (``device=``, CUDA unless the caller asks for the CPU) or on a
mesh (``mesh=``, a ``DeviceMesh`` from ``launch.mesh.make_mesh``) with
checkpointing, restart, data prefetch, AdamW and optional gradient
compression.  On a mesh every rank runs the loop on the same global
batches; rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b-smoke \
      --steps 50 --batch 8 --seq 64 --ckpt-dir ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..core.executor import resolve_device
from ..data.pipeline import Prefetcher, SyntheticLM
from ..train.optimizer import OptConfig
from ..train.trainer import (TrainOptions, abstract_train_state,
                             init_train_state, make_train_step,
                             state_shardings)


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
               ckpt_every: int = 50, device=None, mesh=None,
               lr: float = 3e-4,
               compress_grads: bool = False, microbatches: int = 1,
               seed: int = 0, log_every: int = 10,
               schedule_steps: int | None = None, on_step=None):
    """Train ``cfg`` from ``seed`` (or from the latest checkpoint in
    ``ckpt_dir``) up to step ``steps``.  Returns (params, opt_state, losses
    of the steps run).  ``on_step(i, metrics)``, where given, is called
    after step ``i`` (1-based) with its loss, grad norm and lr as
    floats.  With ``mesh`` the step runs on it, sequence parallel, and a
    checkpoint restores onto it, whatever mesh wrote it."""
    horizon = schedule_steps or steps
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(horizon // 20, 5),
                        total_steps=horizon)
    options = TrainOptions(compress_grads=compress_grads,
                           microbatches=microbatches,
                           seq_parallel=mesh is not None)
    if mesh is None:
        dev = resolve_device(device)
        step_fn = make_train_step(cfg, opt_cfg, options, device=dev)
        params, opt_state = init_train_state(cfg, seed, device=dev)
    else:
        if device is not None:
            raise ValueError("pass mesh or device, not both")
        step_fn = make_train_step(cfg, opt_cfg, options, mesh=mesh)
        params, opt_state = init_train_state(cfg, seed, mesh=mesh,
                                             rules=step_fn.rules)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            template = {"params": params, "opt": opt_state}
            if mesh is None:
                restored = restore_checkpoint(ckpt_dir, last, template,
                                              device=dev)
            else:
                p_abs, o_abs = abstract_train_state(cfg, step_fn.rules)
                restored = restore_checkpoint(
                    ckpt_dir, last, template, shardings={
                        "params": state_shardings(p_abs),
                        "opt": state_shardings(o_abs)})
            params, opt_state = restored["params"], restored["opt"]
            start = last
            if rank0:
                print(f"[train] restored step {last} from {ckpt_dir}")

    data = SyntheticLM(cfg.vocab_size, seed=seed)

    def make_batch(i):
        b = data.batch(start + i, batch, seq)
        if cfg.family == "audio":
            rng = np.random.default_rng(i)
            b["frames"] = rng.standard_normal(
                (batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            rng = np.random.default_rng(i)
            b["patches"] = rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return b

    pf = Prefetcher(make_batch)
    losses = []
    pending_save = None
    try:
        t0 = time.time()
        for i in range(start, steps):
            batch_i = next(pf)
            params, opt_state, metrics = step_fn(params, opt_state, batch_i)
            loss = float(metrics["loss"])
            losses.append(loss)
            if on_step is not None:
                on_step(i + 1, {"loss": loss,
                                "grad_norm": float(metrics["grad_norm"]),
                                "lr": float(metrics["lr"])})
            if rank0 and ((i + 1) % log_every == 0 or i == start):
                dt = (time.time() - t0) / max(i - start + 1, 1)
                print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} ({dt*1e3:.0f} ms/step)")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = save_checkpoint(
                    ckpt_dir, i + 1, {"params": params, "opt": opt_state},
                    blocking=False)
        if pending_save is not None:
            pending_save.join()
        if ckpt_dir:
            save_checkpoint(ckpt_dir, steps, {"params": params, "opt": opt_state})
    finally:
        pf.close()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
        compress_grads=args.compress_grads, microbatches=args.microbatches,
        device=args.device)
    print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(losses)} steps)")


if __name__ == "__main__":
    main()
