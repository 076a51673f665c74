"""Serving steps for one device, ported from ``repro/train/serve.py``:
prefill (fills the KV cache) and decode (one token against the cache).

The reference jits each step with sharded params and caches and donates the
cache; the port runs eagerly on one device and writes the caller's cache in
place, which is what donation buys there.  The cache and parameter
sharding specs wait for the mesh slice (``ROADMAP.md`` queue 1 item 10).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..models import lm


def _checked(cfg: ModelConfig, batch: int, max_seq: int, device, mode: str):
    dev = resolve_device(device)
    windows = [lm._attn_window(cfg, kind, max_seq)
               for pattern, _ in lm.pattern_stacks(cfg) for kind in pattern]

    def step(params, cache, tokens):
        inputs = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, the step "
                             f"runs on {dev}")
        for stack in cache["stacks"]:
            for blk in stack.values():
                if blk["k"].device != dev or blk["k"].shape[1] != batch \
                        or blk["k"].shape[2] not in windows:
                    raise ValueError(
                        f"cache {tuple(blk['k'].shape)} on {blk['k'].device}"
                        f" is not this step's (batch {batch}, max_seq "
                        f"{max_seq}, {dev})")
        if len(inputs["tokens"]) != batch:
            raise ValueError(f"{len(inputs['tokens'])} requests for a step "
                             f"of batch {batch}")
        return lm.forward(params, inputs, cfg, mode=mode, cache=cache)

    step.__name__ = f"{mode}_step"
    return step


def make_decode_step(cfg: ModelConfig, batch: int, max_seq: int, *,
                     device=None):
    """(params, cache, tokens (B, 1)) -> (logits (B, V), cache), the cache
    updated in place.  Runs on CUDA unless ``device="cpu"``."""
    return _checked(cfg, batch, max_seq, device, "decode")


def make_prefill_step(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None):
    """(params, cache, tokens (B, S) or {'tokens': ...}) -> (last-token
    logits (B, V), cache), the cache filled in place.  Runs on CUDA unless
    ``device="cpu"``."""
    return _checked(cfg, batch, max_seq, device, "prefill")
