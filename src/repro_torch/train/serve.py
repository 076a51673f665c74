"""Serving steps, ported from ``repro/train/serve.py``: prefill (fills the
KV and recurrent caches) and decode (one token against them), for every LM
family on one device or on a mesh, with params placed by the serve rules
(tensor parallel over the model axis, FSDP over the data axes) and caches
sharded as the reference shards them (batch -> data, kv sequence ->
model, recurrent channels -> model), so that 32k-context x 128-batch
caches fit.

The reference jits each step and donates the cache; the port runs eagerly
and writes the caller's cache in place, which is what donation buys
there.  On a mesh the cache is the tree of DTensors that ``place_cache``
makes, and each rank writes its own shards: a decode step's new slot on
the rank that holds it (``models.lm``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..models import lm
from ..models.lm import pattern_stacks
from ..nn.layers import leaves, torch_dtype
from ..parallel import sharding as sh
from ..parallel.sharding import (MeshRules, make_rules, map_names,
                                 param_shardings, use_rules)
from .trainer import mesh_device


def _attn_cache_specs():
    # the cache shards along the kv *sequence* (32k+ contexts dominate
    # memory); the kv-head dim is replicated: a step writes one token
    return {"k": ("layers", "batch", "kv_seq", None, None),
            "v": ("layers", "batch", "kv_seq", None, None),
            "kv_pos": ("layers", "kv_seq")}


def block_cache_specs(kind: str, cfg: ModelConfig):
    if kind in ("attn", "moe"):
        return _attn_cache_specs()
    if kind == "xattn":
        return {"self": _attn_cache_specs(),
                "cross": {"k": ("layers", "batch", None, None, None),
                          "v": ("layers", "batch", None, None, None)}}
    if kind == "rec":
        return {"h": ("layers", "batch", "rnn"),
                "conv": ("layers", "batch", None, "rnn")}
    if kind == "mlstm":
        return {"C": ("layers", "batch", None, None, "ff"),
                "n": ("layers", "batch", None, None),
                "m": ("layers", "batch", None),
                "conv": ("layers", "batch", None, "ff")}
    if kind == "slstm":
        return {k: ("layers", "batch", None) for k in ("c", "n", "h", "m")}
    raise ValueError(kind)


def cache_spec_tree(cfg: ModelConfig):
    return {"pos": (),
            "stacks": [{f"{i}_{kind}": block_cache_specs(kind, cfg)
                        for i, kind in enumerate(pattern)}
                       for pattern, _ in pattern_stacks(cfg)]}


def _cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """``lm.init_cache`` on the meta device (``pos`` as a 0-d int32)."""
    shapes = lm.init_cache(cfg, batch, max_seq, device="meta")
    shapes["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return shapes


def cache_shardings(cfg: ModelConfig, rules: MeshRules, batch: int,
                    max_seq: int):
    """Divisibility-fitted shardings for the cache tree."""
    return map_names(lambda names, s: rules.fit_sharding(
        tuple(names), tuple(s.shape)), cache_spec_tree(cfg),
        _cache_shapes(cfg, batch, max_seq))


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   rules: MeshRules):
    return map_names(lambda _, s, d: sh.Sds(tuple(s.shape), s.dtype, d),
                     cache_spec_tree(cfg), _cache_shapes(cfg, batch, max_seq),
                     cache_shardings(cfg, rules, batch, max_seq))


def abstract_serve_params(cfg: ModelConfig, rules: MeshRules):
    params = lm.abstract_model(cfg)
    p_sh = param_shardings(lm.model_spec_tree(cfg), rules, shapes=params)
    return map_names(lambda _, s, d: sh.Sds(tuple(s.shape), s.dtype, d),
                     lm.model_spec_tree(cfg), params, p_sh), p_sh


def serve_rules(mesh, routing: str = "direct") -> MeshRules:
    return make_rules(mesh, mode="serve", routing=routing)


def init_serve_params(cfg: ModelConfig, rules: MeshRules, seed: int = 0):
    """Params from ``seed`` placed by the serve ``rules`` (each drawn whole
    as on one device, then sharded)."""
    _, p_sh = abstract_serve_params(cfg, rules)
    return lm.init_model(cfg, seed, device=mesh_device(rules.mesh),
                         shardings=p_sh)


def place_cache(cfg: ModelConfig, rules: MeshRules, batch: int,
                max_seq: int, dtype=None):
    """An empty cache placed by ``rules``: each leaf made whole and
    sharded as it is made."""
    c_sh = cache_shardings(cfg, rules, batch, max_seq)
    dev = mesh_device(rules.mesh)
    dtype = torch_dtype(dtype or cfg.dtype)
    cache = {"pos": 0, "stacks": []}
    for si, (pattern, ng) in enumerate(pattern_stacks(cfg)):
        stack = {}
        for i, kind in enumerate(pattern):
            key = f"{i}_{kind}"
            stack[key] = sh.shard_tree(
                lm.block_cache(kind, cfg, ng, batch, max_seq, dtype, dev),
                c_sh["stacks"][si][key])
        cache["stacks"].append(stack)
    return cache


def serve_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                      rules: MeshRules) -> dict:
    dt = torch_dtype(cfg.dtype)
    out: dict = {}
    if cfg.family == "vlm":
        p = cfg.n_patches
        out["tokens"] = rules.sds((batch, seq - p), torch.int32,
                                  ("batch", None))
        out["patches"] = rules.sds((batch, p, cfg.d_model), dt,
                                   ("batch", None, None))
    elif cfg.family == "audio":
        out["tokens"] = rules.sds((batch, seq), torch.int32, ("batch", None))
        out["frames"] = rules.sds((batch, cfg.n_audio_frames, cfg.d_model),
                                  dt, ("batch", None, None))
    else:
        out["tokens"] = rules.sds((batch, seq), torch.int32, ("batch", None))
    return out


def _want_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """Leaf shapes of ``lm.init_cache``'s blocks, by stack and block key
    (made on the meta device: nothing is allocated)."""
    return [{key: [tuple(t.shape) for t in leaves(blk)]
             for key, blk in stack.items()}
            for stack in lm.init_cache(cfg, batch, max_seq,
                                       device="meta")["stacks"]]


def _checked(cfg: ModelConfig, batch: int, max_seq: int, device, mode: str,
             mesh=None, routing: str = "direct"):
    if mesh is not None:
        if device is not None:
            raise ValueError("a mesh step runs on its mesh's device: pass "
                             "mesh or device, not both")
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    rules = serve_rules(mesh, routing) if mesh is not None else None
    want = _want_shapes(cfg, batch, max_seq)
    frontend = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    placed = None if rules is None else [
        {key: [s.placements for s in leaves(blk)]
         for key, blk in stack.items()}
        for stack in cache_shardings(cfg, rules, batch, max_seq)["stacks"]]
    if rules is not None:
        lg_place = rules.fit_sharding(("batch", "vocab"),
                                      (batch, cfg.padded_vocab)).placements

    def fits(cache) -> bool:
        """Every block of the cache has ``lm.block_cache``'s keys and leaf
        shapes for this step, on its device (on a mesh, DTensors placed by
        ``cache_shardings``)."""
        if len(cache["stacks"]) != len(want):
            return False
        for si, (stack, stack_want) in enumerate(zip(cache["stacks"], want)):
            if sorted(stack) != sorted(stack_want):
                return False
            for key, shapes in stack_want.items():
                got = leaves(stack[key])
                if [tuple(t.shape) for t in got] != shapes or any(
                        t.device != dev for t in got):
                    return False
                if placed is not None and (
                        not all(sh.is_dtensor(t) for t in got) or
                        [tuple(t.placements) for t in got] !=
                        placed[si][key]):
                    return False
        return True

    def step(params, cache, tokens):
        inputs = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, the step "
                             f"runs on {dev}")
        if (mesh is not None) != sh.is_dtensor(params["embed"]):
            raise ValueError("a mesh step takes DTensor params "
                             "(init_serve_params), a single-device step "
                             "plain tensors")
        if not fits(cache):
            raise ValueError(
                f"the cache is not this step's (lm.init_cache of {cfg.name} "
                f"at batch {batch}, max_seq {max_seq}, on {dev}"
                + (", placed by place_cache)" if mesh is not None else ")"))
        if len(inputs["tokens"]) != batch:
            raise ValueError(f"{len(inputs['tokens'])} requests for a step "
                             f"of batch {batch}")
        if mode == "prefill" and frontend and frontend not in inputs:
            raise ValueError(f"the {cfg.family} prefill step takes "
                             f"{{'tokens', {frontend!r}}}")
        if rules is None:
            return lm.forward(params, inputs, cfg, mode=mode, cache=cache)
        with use_rules(rules):
            logits, cache = lm.forward(params, inputs, cfg, mode=mode,
                                       cache=cache)
            return logits.redistribute(logits.device_mesh, lg_place), cache

    step.__name__ = f"{mode}_step"
    step.rules = rules
    return step


def make_decode_step(cfg: ModelConfig, batch: int, max_seq: int, *,
                     device=None, mesh=None, routing: str = "direct"):
    """(params, cache, tokens (B, 1)) -> (logits (B, V), cache), the cache
    updated in place.  Runs on CUDA unless ``device="cpu"``; with ``mesh``
    under its serve rules (``step.rules``, ``routing``), over params from
    ``init_serve_params`` and a cache from ``place_cache``, the logits a
    DTensor placed (batch, vocab)."""
    return _checked(cfg, batch, max_seq, device, "decode", mesh, routing)


def make_prefill_step(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None, mesh=None, routing: str = "direct"):
    """(params, cache, tokens (B, S) or {'tokens': ...} [+ 'frames' (audio)
    | 'patches' (vlm)]) -> (last-token logits (B, V), cache), the cache
    filled in place.  Runs on CUDA unless ``device="cpu"``; ``mesh`` and
    ``routing`` as for :func:`make_decode_step`."""
    return _checked(cfg, batch, max_seq, device, "prefill", mesh, routing)
