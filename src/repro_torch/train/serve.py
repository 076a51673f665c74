"""Serving steps for one device, ported from ``repro/train/serve.py``:
prefill (fills the KV and recurrent caches) and decode (one token against
them), for every LM family.

The reference jits each step with sharded params and caches and donates the
cache; the port runs eagerly on one device and writes the caller's cache in
place, which is what donation buys there.  The cache and parameter
sharding specs wait for the mesh slice (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..models import lm
from ..nn.layers import leaves


def _want_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """Leaf shapes of ``lm.init_cache``'s blocks, by stack and block key
    (made on the meta device: nothing is allocated)."""
    return [{key: [tuple(t.shape) for t in leaves(blk)]
             for key, blk in stack.items()}
            for stack in lm.init_cache(cfg, batch, max_seq,
                                       device="meta")["stacks"]]


def _checked(cfg: ModelConfig, batch: int, max_seq: int, device, mode: str):
    dev = resolve_device(device)
    want = _want_shapes(cfg, batch, max_seq)
    frontend = {"audio": "frames", "vlm": "patches"}.get(cfg.family)

    def fits(cache) -> bool:
        """Every block of the cache has ``lm.block_cache``'s keys and leaf
        shapes for this step, on its device."""
        if len(cache["stacks"]) != len(want):
            return False
        for stack, stack_want in zip(cache["stacks"], want):
            if sorted(stack) != sorted(stack_want):
                return False
            for key, shapes in stack_want.items():
                got = leaves(stack[key])
                if [tuple(t.shape) for t in got] != shapes or any(
                        t.device != dev for t in got):
                    return False
        return True

    def step(params, cache, tokens):
        inputs = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, the step "
                             f"runs on {dev}")
        if not fits(cache):
            raise ValueError(
                f"the cache is not this step's (lm.init_cache of {cfg.name} "
                f"at batch {batch}, max_seq {max_seq}, on {dev})")
        if len(inputs["tokens"]) != batch:
            raise ValueError(f"{len(inputs['tokens'])} requests for a step "
                             f"of batch {batch}")
        if mode == "prefill" and frontend and frontend not in inputs:
            raise ValueError(f"the {cfg.family} prefill step takes "
                             f"{{'tokens', {frontend!r}}}")
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
    """(params, cache, tokens (B, S) or {'tokens': ...} [+ 'frames' (audio)
    | 'patches' (vlm)]) -> (last-token logits (B, V), cache), the cache
    filled in place.  Runs on CUDA unless ``device="cpu"``."""
    return _checked(cfg, batch, max_seq, device, "prefill")
