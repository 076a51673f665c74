"""Serve an LM with batched requests on the PyTorch port: prefill builds the
KV cache, then batched greedy decode, whose attention against the cache is
the hand-written CUDA flash-decode kernel on the card; last, the kernel is
checked against its plain version on the live cache.  The counterpart of
``examples/lm_decode_serve.py``, with the same flags and stages; ``--arch``
takes every config of ``repro_torch.configs`` and its ``-smoke`` variant,
of every family: the audio family's prefill takes stub frame embeddings
and the vlm family's stub patch embeddings, made from ``--seed``, as the
prompts and the check's query are; the weights come from ``--seed`` too.
The ssm family has no attention cache, so its run has no cross-check.

Run:  PYTHONPATH=src python examples/torch/lm_decode_serve.py --tokens 16
      (on CUDA; add ``--device cpu`` to run the plain versions on the CPU;
      ``--arch whisper-base-smoke`` and the like for the other families)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn.ops import flash_decode, flash_decode_ref
from repro_torch.models import lm
from repro_torch.train.serve import make_decode_step, make_prefill_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    params = lm.init_model(cfg, args.seed, device=args.device)
    dev = params["embed"].device
    B, S = args.batch, args.prompt_len
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    max_seq = prefix + S + args.tokens + 1
    rng = np.random.default_rng(args.seed)
    prompts = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    stub = {"audio": ("frames", cfg.n_audio_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:      # the stub frontend's embeddings
        name, n = stub
        prompts[name] = torch.from_numpy(rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)).to(dev)

    print(f"== prefill {B} requests x {S} tokens ({cfg.name}, {dev}) ==")
    cache = lm.init_cache(cfg, B, max_seq=max_seq, device=dev)
    prefill = make_prefill_step(cfg, B, max_seq, device=dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompts)
    _sync(dev)
    print(f"prefill: {(time.perf_counter()-t0)*1e3:.0f} ms "
          f"({B*S} tokens)")

    print(f"== batched greedy decode of {args.tokens} tokens ==")
    step = make_decode_step(cfg, B, max_seq, device=dev)
    tok = torch.argmax(logits, -1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        outs.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1).cpu().numpy()
    print(f"decode: {dt/args.tokens*1e3:.1f} ms/token/batch "
          f"({B*args.tokens/dt:.0f} tok/s aggregate)")
    for b in range(min(B, 2)):
        print(f"  request {b}: {gen[b].tolist()}")

    print("== flash-decode kernel cross-check on the live cache ==")
    attn = [blk.get("self", blk) for stack in cache["stacks"]
            for blk in stack.values() if "k" in blk or "self" in blk]
    if not attn:
        print(f"no attention cache in {cfg.name} ({cfg.family}): decode "
              f"launches no flash-decode")
        return
    ck, cv = attn[0]["k"][0], attn[0]["v"][0]
    hd = cfg.resolved_head_dim
    q = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.n_kv_heads, cfg.q_groups, hd)).astype(np.float32)).to(dev)
    lens = torch.full((B,), min(cache["pos"], ck.shape[1]),
                      dtype=torch.int32, device=dev)
    # block_s is the TPU kernel's cache tile: the CUDA kernel validates it
    # and tiles S its own way, so here it changes nothing
    got = flash_decode(q, ck, cv, lens, block_s=32)
    exp = flash_decode_ref(q, ck, cv, lens)
    print(f"kernel vs oracle max|err|: "
          f"{float((got - exp).abs().max()):.2e}")


if __name__ == "__main__":
    main()
