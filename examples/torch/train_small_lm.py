"""Train a small qwen3-family LM end to end on synthetic data with the
PyTorch port: data pipeline with prefetch, AdamW + cosine schedule,
checkpoint/restart, and optional int8 gradient compression.  The
counterpart of ``examples/train_small_lm.py``, with the same model (6 x 256,
4.6 M parameters by default; ``--full100m`` for a ~100M-param config) and
flags, plus ``--device``.  Checkpoints go to ``--ckpt-dir`` when one is given; rerun
with the same directory to resume.

Run:  PYTHONPATH=src python examples/torch/train_small_lm.py --steps 200
      (on CUDA; add ``--device cpu`` to train on the CPU)
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def small_config(full100m: bool = False):
    """qwen3-14b-smoke widened to 6 x 256 (or the ~100M config)."""
    cfg = get_config("qwen3-14b-smoke")
    if full100m:
        return dataclasses.replace(cfg, name="qwen3-100m", n_layers=8,
                                   d_model=512, n_heads=8, n_kv_heads=4,
                                   head_dim=64, d_ff=1536, vocab_size=50304)
    return dataclasses.replace(cfg, n_layers=6, d_model=256, n_heads=8,
                               n_kv_heads=4, head_dim=32, d_ff=512,
                               vocab_size=2048)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--full100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()

    cfg = small_config(args.full100m)
    print(f"training {cfg.name}: {cfg.n_params()/1e6:.1f}M params "
          f"(analytic), {args.steps} steps @ batch {args.batch} x seq "
          f"{args.seq}")
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 10),
        lr=args.lr, compress_grads=args.compress_grads, log_every=20,
        device=args.device)
    where = f"ckpts in {args.ckpt_dir}; rerun to resume" if args.ckpt_dir \
        else "no checkpoints"
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} ({where})")


if __name__ == "__main__":
    main()
