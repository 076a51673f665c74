"""Dense-family LM, ported from ``repro/models/lm.py``.

A model is a sequence of *block stacks*; each stack repeats a pattern of
block kinds, with its params stacked on a leading ``layers`` axis, as in
the reference, so that carrying reference weights across is a copy.  The
reference scans a stack; the port loops over that axis.

  dense : [('attn',) x L]

Execution modes: 'train' (logits), 'prefill' (last-position logits + the
KV cache filled) and 'decode' (one token against the cache).  The other
families of the reference (moe, hybrid, ssm, audio, vlm) raise
``NotImplementedError`` until their slice (``ROADMAP.md`` queue 1 item 9);
``lm_loss`` waits for the training slice, ``abstract_model`` and
``model_spec_tree`` for the mesh slice, and ``shard_act`` has no
counterpart on one device.

Where the reference is pure and returns new caches, the port writes the
caller's cache **in place** (slice assignment) and returns it; the
position counter ``cache["pos"]`` is a host int, so no decode step waits
on the card.  The decode branch attends through :func:`flash_decode`,
the hand-written CUDA kernel on the card: for this family the cache's
valid slots are exactly its first ``min(pos + 1, window)``, which is the
kernel's ``lengths`` (the reference masks the same slots with ``kv_pos``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..kernels.decode_attn.ops import flash_decode
from ..nn.attention import gqa_attention, update_cache
from ..nn.layers import (ParamDef, apply_norm, apply_rope, gelu, init_params,
                         map_defs, norm_defs, rmsnorm, swish, torch_dtype)

FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue 1 item 9); the port serves {FAMILIES}")


# ---------------------------------------------------------------------------
# pattern machinery
# ---------------------------------------------------------------------------

def pattern_stacks(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(pattern, n_groups), ...] covering exactly cfg.n_layers blocks."""
    _check_family(cfg)
    return [(("attn",), cfg.n_layers)]


def _attn_defs(cfg: ModelConfig, ng: int) -> dict:
    """Head-structured projection weights (d, K, G, hd), as the
    reference's."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    ps, pn = (ng,), ("layers",)
    ax_k = "kv_heads" if kv > 1 else None
    ax_g = "heads" if kv == 1 else None
    defs = {
        "ln": norm_defs(d, cfg.norm, ps, pn),
        "wq": ParamDef(ps + (d, kv, g, hd), pn + ("embed", ax_k, ax_g, None)),
        "wk": ParamDef(ps + (d, kv, hd), pn + ("embed", ax_k, None)),
        "wv": ParamDef(ps + (d, kv, hd), pn + ("embed", ax_k, None)),
        "wo": ParamDef(ps + (kv, g, hd, d), pn + (ax_k, ax_g, None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(ps + (kv, g, hd), pn + (ax_k, ax_g, None),
                              init="zeros")
        defs["bk"] = ParamDef(ps + (kv, hd), pn + (ax_k, None), init="zeros")
        defs["bv"] = ParamDef(ps + (kv, hd), pn + (ax_k, None), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(ps + (hd,), pn + (None,), init="ones")
        defs["k_norm"] = ParamDef(ps + (hd,), pn + (None,), init="ones")
    return defs


def _mlp_defs(cfg: ModelConfig, ng: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    ps, pn = (ng,), ("layers",)
    defs = {
        "ln": norm_defs(d, cfg.norm, ps, pn),
        "wi": ParamDef(ps + (d, ff), pn + ("embed", "ff")),
        "wo": ParamDef(ps + (ff, d), pn + ("ff_in", "embed")),
    }
    if cfg.act == "swiglu":
        defs["wg"] = ParamDef(ps + (d, ff), pn + ("embed", "ff"))
    return defs


def block_defs(kind: str, cfg: ModelConfig, ng: int) -> dict:
    if kind == "attn":
        return {"attn": _attn_defs(cfg, ng), "mlp": _mlp_defs(cfg, ng)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                              f"(ROADMAP.md queue 1 item 9)")


def model_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"),
                          scale=0.02),
        "out_ln": norm_defs(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab), ("embed", "vocab"))
    defs["stacks"] = [
        {f"{i}_{kind}": block_defs(kind, cfg, ng)
         for i, kind in enumerate(pattern)}
        for pattern, ng in pattern_stacks(cfg)
    ]
    return defs


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random params in ``cfg.dtype`` on ``device`` (CUDA unless the caller
    asks for the CPU), drawn from a ``torch.Generator`` seeded with
    ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(model_defs(cfg), gen, dtype=torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                      # train | prefill | decode
    positions: torch.Tensor        # (B, S) absolute positions
    pos: int = 0                   # decode: the new token's position
    lengths: torch.Tensor | None = None   # decode: (B,) valid cache slots


def _project_qkv(p, xn, ctx: Ctx):
    """Returns q (B, S, K, G, hd); k, v (B, S, K, hd)."""
    cfg = ctx.cfg
    b, s, d = xn.shape
    kv, g, hd = p["wq"].shape[1:]
    q = (xn @ p["wq"].reshape(d, -1).to(xn.dtype)).view(b, s, kv, g, hd)
    k = (xn @ p["wk"].reshape(d, -1).to(xn.dtype)).view(b, s, kv, hd)
    v = (xn @ p["wv"].reshape(d, -1).to(xn.dtype)).view(b, s, kv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope_theta > 0:
        q = apply_rope(q, ctx.positions, cfg.rope_theta)
        k = apply_rope(k, ctx.positions, cfg.rope_theta)
    return q, k, v


def _apply_attn(p, x, ctx: Ctx, cache):
    """Self-attention sublayer.  Returns x + attention output; writes the
    layer's ``cache`` (views into the stacked cache) in place."""
    cfg = ctx.cfg
    b, s, d = x.shape
    xn = apply_norm(x, p["ln"], cfg.norm, 1e-6)
    q, k, v = _project_qkv(p, xn, ctx)
    if ctx.mode == "decode":
        w = cache["k"].shape[1]
        slot = min(ctx.pos, w - 1)
        update_cache(cache["k"], cache["v"], k, v, slot)
        # fill_, not item assignment: that copies a host scalar to the
        # card and makes the host wait for it in every layer
        cache["kv_pos"][slot:slot + 1].fill_(ctx.pos)
        out = flash_decode(q, cache["k"], cache["v"], ctx.lengths)
    else:
        out = gqa_attention(q, k, v, q_pos=ctx.positions,
                            kv_pos=ctx.positions, chunk=cfg.attn_chunk)
        if cache is not None:   # prefill: persist (the window of) kv
            w = cache["k"].shape[1]
            if s >= w:
                # the last w positions; the reference's ring order for a
                # sliding window belongs to the hybrid family
                update_cache(cache["k"], cache["v"], k[:, s - w:],
                             v[:, s - w:], 0)
                cache["kv_pos"][:] = ctx.positions[0, s - w:]
            else:
                # position p at slot p; the rest zero and marked unwritten
                update_cache(cache["k"], cache["v"], k, v, 0)
                cache["kv_pos"][:s] = ctx.positions[0]
                cache["k"][:, s:].zero_()
                cache["v"][:, s:].zero_()
                cache["kv_pos"][s:].fill_(-1)
    proj = out.to(x.dtype).reshape(b, s, -1) @ \
        p["wo"].reshape(-1, d).to(x.dtype)
    return x + proj


def _apply_mlp(p, x, ctx: Ctx):
    cfg = ctx.cfg
    xn = apply_norm(x, p["ln"], cfg.norm, 1e-6)
    h = xn @ p["wi"]
    if cfg.act == "swiglu":
        h = swish(xn @ p["wg"]) * h
    else:
        h = gelu(h)
    return x + (h @ p["wo"]).to(x.dtype)


def apply_block(kind: str, p, x, ctx: Ctx, cache):
    """Returns x after the block; writes the block's cache in place."""
    if kind == "attn":
        x = _apply_attn(p["attn"], x, ctx, cache)
        return _apply_mlp(p["mlp"], x, ctx)
    raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                              f"(ROADMAP.md queue 1 item 9)")


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _attn_window(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    if kind == "attn" and cfg.family == "hybrid" and cfg.local_window:
        return min(cfg.local_window, max_seq)
    return max_seq


def block_cache(kind: str, cfg: ModelConfig, ng: int, batch: int,
                max_seq: int, dtype, device) -> dict:
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    if kind == "attn":
        window = _attn_window(cfg, kind, max_seq)
        return {"k": torch.zeros((ng, batch, window, kv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((ng, batch, window, kv, hd), dtype=dtype,
                                 device=device),
                "kv_pos": torch.full((ng, window), -1, dtype=torch.int32,
                                     device=device)}
    raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                              f"(ROADMAP.md queue 1 item 9)")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device=None):
    """An empty KV cache on ``device`` (CUDA unless the caller asks for the
    CPU).  ``pos`` is a host int; the tensors are written in place by
    prefill and decode."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    cache = {"pos": 0, "stacks": []}
    for pattern, ng in pattern_stacks(cfg):
        cache["stacks"].append({
            f"{i}_{kind}": block_cache(kind, cfg, ng, batch, max_seq, dtype,
                                       dev)
            for i, kind in enumerate(pattern)})
    return cache


# ---------------------------------------------------------------------------
# top-level forward
# ---------------------------------------------------------------------------

def _run_stacks(params, x, ctx: Ctx, cache, cfg: ModelConfig):
    """Run each stack's layers in order, one slice of the stacked params
    (and cache) at a time.  Returns x."""
    for si, (pattern, ng) in enumerate(pattern_stacks(cfg)):
        stack_params = params["stacks"][si]
        stack_cache = None if cache is None else cache["stacks"][si]
        if ctx.mode == "decode":
            w = stack_cache[f"0_{pattern[0]}"]["k"].shape[2]
            b = x.shape[0]
            ctx = dataclasses.replace(ctx, lengths=torch.full(
                (b,), min(ctx.pos + 1, w), dtype=torch.int32,
                device=x.device))
        for layer in range(ng):
            for i, kind in enumerate(pattern):
                key = f"{i}_{kind}"
                gp = map_defs(lambda t: t[layer], stack_params[key])
                bc = None if stack_cache is None else map_defs(
                    lambda t: t[layer], stack_cache[key])
                x = apply_block(kind, gp, x, ctx, bc)
    return x


@torch.no_grad()
def forward(params, inputs: dict, cfg: ModelConfig, mode: str = "train",
            cache=None):
    """inputs: {'tokens': (B, S)} on the params' device (or a host array).

    train   -> logits (B, S, V)
    prefill -> (last-position logits (B, V), cache filled in place)
    decode  -> (logits (B, V), cache updated in place); tokens is (B, 1)
    """
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train" and cache is None:
        raise ValueError(f"mode {mode!r} needs a cache (lm.init_cache)")
    dt = torch_dtype(cfg.dtype)
    dev = params["embed"].device
    tokens = torch.as_tensor(inputs["tokens"], device=dev).long()
    b, s = tokens.shape

    pos0 = int(cache["pos"]) if mode == "decode" else 0
    if mode == "decode":
        positions = torch.full((b, 1), pos0, dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)

    x = params["embed"].to(dt)[tokens]
    ctx = Ctx(cfg=cfg, mode=mode, positions=positions, pos=pos0)
    x = _run_stacks(params, x, ctx, cache if mode != "train" else None, cfg)
    x = apply_norm(x, params["out_ln"], cfg.norm, 1e-6)

    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dt)
    if mode == "train":
        return x @ head
    if mode == "prefill":
        cache["pos"] = s
        return x[:, -1, :] @ head, cache
    cache["pos"] = pos0 + 1
    return x[:, 0, :] @ head, cache
