"""LM-family model builder covering every family of the reference, ported
from ``repro/models/lm.py``.

A model is a sequence of *block stacks*; each stack repeats a pattern of
block kinds, with its params stacked on a leading ``layers`` axis, as in
the reference, so that carrying reference weights across is a copy.  The
reference scans a stack; the port loops over that axis.

  dense / vlm : [('attn',) x L]
  moe         : [('moe',) x L]
  hybrid      : [('rec','rec','attn') x L//3] (+ remainder stack)
  ssm         : [('mlstm' x (k-1), 'slstm') x L//k] (+ remainder)
  audio       : encoder [('enc_attn',) x Le] + decoder [('xattn',) x Ld]

Execution modes: 'train' (logits, recorded by autograd where it is on;
:func:`lm_loss` is the next-token loss over them), 'prefill'
(last-position logits + the KV and recurrent caches filled) and 'decode'
(one token against the caches); prefill and decode run under
``torch.no_grad``, so serving builds no graph.  Where autograd records,
each layer of a stack runs under ``torch.utils.checkpoint`` as
``cfg.remat`` / ``cfg.remat_policy`` say (the reference's per-layer
``jax.checkpoint``): ``"full"`` keeps the layer's input alone,
``"dots"`` keeps its matmul outputs too.  The
modality frontends of the audio and vlm families are stubs, as in the
reference: inputs carry precomputed frame or patch embeddings.
``abstract_model`` and ``model_spec_tree`` wait for the mesh slice, and
``shard_act`` has no counterpart on one device.

Where the reference is pure and returns new caches, the port writes the
caller's cache **in place** and returns it: attention caches by slice
assignment, recurrent states by ``copy_`` into the layer's view of the
stacked cache; the position counter ``cache["pos"]`` is a host int, so no
decode step waits on the card.  Every decode attention against a cache
goes through :func:`flash_decode`, the hand-written CUDA kernel on the
card: a self-attention cache's valid slots are its first
``min(pos + 1, window)`` (in ring order for the hybrid's local window,
which attention over a set does not see), which is the kernel's
``lengths``; a cross-attention cache's are all of its frames.  The
reference masks the same slots with ``kv_pos``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core.executor import resolve_device
from ..kernels.decode_attn.ops import flash_decode
from ..nn.attention import NEG_INF, gqa_attention, update_cache
from ..nn.layers import (ParamDef, apply_norm, apply_rope, gelu, init_params,
                         leaves, map_defs, norm_defs, rmsnorm, swish,
                         torch_dtype)
from ..nn.moe import moe_defs, moe_ffn
from ..nn.recurrent import (causal_conv1d, mlstm_defs, mlstm_sequence,
                            mlstm_step, rglru_block, rglru_defs, slstm_defs,
                            slstm_sequence, slstm_state)

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


# ---------------------------------------------------------------------------
# pattern machinery
# ---------------------------------------------------------------------------

def pattern_stacks(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(pattern, n_groups), ...] covering exactly cfg.n_layers blocks."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "audio":
        return [(("xattn",), cfg.n_layers)]
    if cfg.family == "moe":
        return [(("moe",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(cfg.block_pattern)
        n, r = divmod(cfg.n_layers, len(pat))
        stacks = [(pat, n)] if n else []
        if r:
            stacks.append((pat[:r], 1))
        return stacks
    if cfg.family == "ssm":
        k = cfg.slstm_every or cfg.n_layers + 1
        if k > cfg.n_layers:
            return [(("mlstm",), cfg.n_layers)]
        pat = ("mlstm",) * (k - 1) + ("slstm",)
        n, r = divmod(cfg.n_layers, k)
        stacks = [(pat, n)] if n else []
        if r:
            stacks.append((("mlstm",) * r, 1))
        return stacks
    return [(("attn",), cfg.n_layers)]     # dense, vlm


def _attn_defs(cfg: ModelConfig, ng: int) -> dict:
    """Head-structured projection weights (d, K, G, hd), as the
    reference's (its cross-attention takes the same)."""
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
    ps, pn = (ng,), ("layers",)
    if kind in ("attn", "enc_attn"):
        return {"attn": _attn_defs(cfg, ng), "mlp": _mlp_defs(cfg, ng)}
    if kind == "xattn":
        return {"attn": _attn_defs(cfg, ng), "xa": _attn_defs(cfg, ng),
                "mlp": _mlp_defs(cfg, ng)}
    if kind == "moe":
        return {"attn": _attn_defs(cfg, ng),
                "moe_ln": norm_defs(cfg.d_model, cfg.norm, ps, pn),
                "moe": moe_defs(cfg, ps, pn)}
    if kind == "rec":
        return {"ln": norm_defs(cfg.d_model, cfg.norm, ps, pn),
                "rec": rglru_defs(cfg.d_model, cfg.d_rnn or cfg.d_model,
                                  cfg.conv_width, ps, pn),
                "mlp": _mlp_defs(cfg, ng)}
    if kind == "mlstm":
        return {"ln": norm_defs(cfg.d_model, cfg.norm, ps, pn),
                "cell": mlstm_defs(cfg, ps, pn)}
    if kind == "slstm":
        return {"ln": norm_defs(cfg.d_model, cfg.norm, ps, pn),
                "cell": slstm_defs(cfg, ps, pn)}
    raise ValueError(kind)


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
    if cfg.family == "audio":
        defs["encoder"] = {
            "stacks": [{"0_enc_attn": block_defs("enc_attn", cfg,
                                                 cfg.n_encoder_layers)}],
            "out_ln": norm_defs(d, cfg.norm),
        }
    if cfg.family == "vlm":
        defs["mm_proj"] = ParamDef((d, d), ("embed", "act_embed"))
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
    enc_out: torch.Tensor | None = None   # (B, F, d) encoder output (audio)
    causal: bool = True
    # decode: (B,) int32 lengths by valid-slot count, made once a step
    lengths: dict = dataclasses.field(default_factory=dict)

    def lengths_of(self, n: int) -> torch.Tensor:
        if n not in self.lengths:
            self.lengths[n] = torch.full(
                (self.positions.shape[0],), n, dtype=torch.int32,
                device=self.positions.device)
        return self.lengths[n]


def _sinusoid(positions, d: int):
    """(B, S) -> (B, S, d) fixed sinusoidal embeddings (whisper-style), in
    float32."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _project(x, w):
    """x (B, S, d) @ w (d, *heads) -> (B, S, *heads)."""
    d = x.shape[-1]
    return (x @ w.reshape(d, -1).to(x.dtype)).view(*x.shape[:2], *w.shape[1:])


def _project_qkv(p, xn, ctx: Ctx):
    """Returns q (B, S, K, G, hd); k, v (B, S, K, hd)."""
    cfg = ctx.cfg
    q, k, v = _project(xn, p["wq"]), _project(xn, p["wk"]), \
        _project(xn, p["wv"])
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


def _cross_attn(p, xn, ctx: Ctx, cache):
    """Cross-attention of xn against the encoder output: k and v are made
    from it (train, prefill; prefill stores them in ``cache``) or read
    from the cache (decode, through the kernel over all frames)."""
    q = _project(xn, p["wq"])
    if ctx.mode == "decode":
        ck, cv = cache["k"], cache["v"]
        return flash_decode(q, ck, cv, ctx.lengths_of(ck.shape[1]))
    eo = ctx.enc_out.to(xn.dtype)
    k, v = _project(eo, p["wk"]), _project(eo, p["wv"])
    if cache is not None:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                          device=k.device)[None].expand(k.shape[:2])
    return gqa_attention(q, k, v, q_pos=ctx.positions, kv_pos=kv_pos,
                         causal=False, chunk=ctx.cfg.attn_chunk)


def _self_attn(p, xn, ctx: Ctx, cache, local_window: int):
    """Self-attention; writes the layer's ``cache`` (views into the
    stacked cache) in place."""
    cfg = ctx.cfg
    s = xn.shape[1]
    q, k, v = _project_qkv(p, xn, ctx)
    if ctx.mode == "decode":
        w = cache["k"].shape[1]
        slot = ctx.pos % w if local_window else min(ctx.pos, w - 1)
        update_cache(cache["k"], cache["v"], k, v, slot)
        # fill_, not item assignment: that copies a host scalar to the
        # card and makes the host wait for it in every layer
        cache["kv_pos"][slot:slot + 1].fill_(ctx.pos)
        return flash_decode(q, cache["k"], cache["v"],
                            ctx.lengths_of(min(ctx.pos + 1, w)))
    out = gqa_attention(q, k, v, q_pos=ctx.positions, kv_pos=ctx.positions,
                        causal=ctx.causal, local_window=local_window,
                        chunk=cfg.attn_chunk)
    if cache is not None:   # prefill: persist (the window of) kv
        w = cache["k"].shape[1]
        if s >= w:
            ks, vs, kp = k[:, s - w:], v[:, s - w:], ctx.positions[0, s - w:]
            if local_window:
                # ring layout: position p lives at slot p % w, so that
                # decode's slot = pos % w overwrites the oldest entry
                # (the reference's argsort order is this rotation)
                r = (s - w) % w
                ks, vs, kp = (torch.roll(t, r, dims=d) for t, d in
                              ((ks, 1), (vs, 1), (kp, 0)))
            update_cache(cache["k"], cache["v"], ks, vs, 0)
            cache["kv_pos"].copy_(kp)
        else:
            # position p at slot p; the rest zero and marked unwritten
            update_cache(cache["k"], cache["v"], k, v, 0)
            cache["kv_pos"][:s] = ctx.positions[0]
            cache["k"][:, s:].zero_()
            cache["v"][:, s:].zero_()
            cache["kv_pos"][s:].fill_(-1)
    return out


def _apply_attn(p, x, ctx: Ctx, cache, *, local_window: int = 0,
                cross: bool = False):
    """Self- or cross-attention sublayer.  Returns x + attention output."""
    b, s, d = x.shape
    xn = apply_norm(x, p["ln"], ctx.cfg.norm, 1e-6)
    out = _cross_attn(p, xn, ctx, cache) if cross else \
        _self_attn(p, xn, ctx, cache, local_window)
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


def _store(cache, new: dict) -> None:
    """Copy a block's new recurrent state into its cache views (rebinding
    the keys would leave the stacked cache stale)."""
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)


def _apply_mlstm(cell, xn, ctx: Ctx, cache):
    cfg = ctx.cfg
    b, s, d = xn.shape
    di = int(cfg.proj_factor * d)
    hh = cfg.n_heads
    dk = di // hh
    u = xn @ cell["w_up"]
    z = xn @ cell["w_gate"]
    cu, new_conv = causal_conv1d(u, cell["conv_w"],
                                 None if cache is None else cache["conv"])
    cu = swish(cu)
    q = (cu @ cell["wq"]).view(b, s, hh, dk)
    # float32, as the reference's division by a numpy float64 promotes it
    k = (cu @ cell["wk"]).view(b, s, hh, dk).float() / math.sqrt(dk)
    v = (u @ cell["wv"]).view(b, s, hh, dk)
    gates = xn @ cell["w_if"] + cell["b_if"]
    i_gate = gates[..., :hh].float()
    lf = torch.nn.functional.logsigmoid(gates[..., hh:].float())
    state = None if cache is None else (cache["C"], cache["n"], cache["m"])
    if ctx.mode == "decode":
        h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_gate[:, 0],
                                  lf[:, 0], state)
        h = h[:, None]
    else:
        h, (C, n, m) = mlstm_sequence(q, k, v, i_gate, lf, state=state,
                                      chunk=cfg.mlstm_chunk)
    _store(cache, {"C": C, "n": n, "m": m, "conv": new_conv})
    h = rmsnorm(h.reshape(b, s, di), cell["hnorm"])
    return (h * swish(z)) @ cell["w_down"]


def apply_block(kind: str, p, x, ctx: Ctx, cache):
    """Returns x after the block; writes the block's cache in place."""
    cfg = ctx.cfg
    if kind in ("attn", "enc_attn"):
        lw = cfg.local_window if (kind == "attn"
                                  and cfg.family == "hybrid") else 0
        x = _apply_attn(p["attn"], x, ctx, cache, local_window=lw)
        return _apply_mlp(p["mlp"], x, ctx)
    if kind == "xattn":
        x = _apply_attn(p["attn"], x, ctx,
                        None if cache is None else cache["self"])
        x = _apply_attn(p["xa"], x, ctx,
                        None if cache is None else cache["cross"], cross=True)
        return _apply_mlp(p["mlp"], x, ctx)
    if kind == "moe":
        x = _apply_attn(p["attn"], x, ctx, cache)
        xn = apply_norm(x, p["moe_ln"], cfg.norm, 1e-6)
        return x + moe_ffn(p["moe"], xn, cfg).to(x.dtype)
    xn = apply_norm(x, p["ln"], cfg.norm, 1e-6)
    if kind == "rec":
        y, new = rglru_block(p["rec"], xn, cfg, cache=cache)
        _store(cache, new)
        return _apply_mlp(p["mlp"], x + y.to(x.dtype), ctx)
    if kind == "mlstm":
        return x + _apply_mlstm(p["cell"], xn, ctx, cache).to(x.dtype)
    if kind == "slstm":
        cell = p["cell"]
        state = None if cache is None else (cache["c"], cache["n"],
                                            cache["h"], cache["m"])
        h, (c_, n_, h_, m_) = slstm_sequence(cell, xn, cfg.n_heads,
                                             state=state)
        _store(cache, {"c": c_, "n": n_, "h": h_, "m": m_})
        y = gelu(h @ cell["up"]) @ cell["down"]
        return x + y.to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _attn_window(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    if kind == "attn" and cfg.family == "hybrid" and cfg.local_window:
        return min(cfg.local_window, max_seq)
    return max_seq


def block_cache(kind: str, cfg: ModelConfig, ng: int, batch: int,
                max_seq: int, dtype, device) -> dict:
    """One block kind's cache, stacked over ``ng`` layers: the reference's
    keys, shapes, dtypes and initial values."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    d = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(window):
        return {"k": zeros(ng, batch, window, kv, hd),
                "v": zeros(ng, batch, window, kv, hd),
                "kv_pos": torch.full((ng, window), -1, dtype=torch.int32,
                                     device=device)}

    if kind == "attn":
        return attn_cache(_attn_window(cfg, kind, max_seq))
    if kind == "xattn":
        f = cfg.n_audio_frames
        return {"self": attn_cache(max_seq),
                "cross": {"k": zeros(ng, batch, f, kv, hd),
                          "v": zeros(ng, batch, f, kv, hd)}}
    if kind == "moe":
        return attn_cache(max_seq)
    if kind == "rec":
        dr = cfg.d_rnn or d
        return {"h": zeros(ng, batch, dr),
                "conv": zeros(ng, batch, cfg.conv_width - 1, dr)}
    if kind == "mlstm":
        di = int(cfg.proj_factor * d)
        dk = di // cfg.n_heads
        f32 = torch.float32
        return {"C": zeros(ng, batch, cfg.n_heads, dk, dk, dt=f32),
                "n": zeros(ng, batch, cfg.n_heads, dk, dt=f32),
                "m": zeros(ng, batch, cfg.n_heads, dt=f32),
                "conv": zeros(ng, batch, 3, di)}
    if kind == "slstm":
        c, n, h, m = slstm_state(ng * batch, d, device)
        return {name: t.view(ng, batch, d)
                for name, t in zip("cnhm", (c, n, h, m))}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device=None):
    """An empty cache on ``device`` (CUDA unless the caller asks for the
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

# matmul outputs, which the "dots" policy keeps (jax's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, x, cfg: ModelConfig):
    """fn(x) under the layer checkpoint that ``cfg.remat_policy`` names."""
    if cfg.remat_policy == "dots":
        return checkpoint(fn, x, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return checkpoint(fn, x, use_reentrant=False)


def _run_stacks(params, x, ctx: Ctx, cache, stacks):
    """Run each stack's layers in order, one slice of the stacked params
    (and cache) at a time.  Returns x.  Where autograd records a stack's
    params and ``cfg.remat`` is set, each layer of the pattern (one step
    of the reference's scan) is a checkpoint."""
    cfg = ctx.cfg
    for si, (pattern, ng) in enumerate(stacks):
        stack_params = params["stacks"][si]
        stack_cache = None if cache is None else cache["stacks"][si]

        def body(x, layer, stack_params=stack_params,
                 stack_cache=stack_cache, pattern=pattern):
            for i, kind in enumerate(pattern):
                key = f"{i}_{kind}"
                gp = map_defs(lambda t: t[layer], stack_params[key])
                bc = None if stack_cache is None else map_defs(
                    lambda t: t[layer], stack_cache[key])
                x = apply_block(kind, gp, x, ctx, bc)
            return x

        remat = cfg.remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(stack_params))
        for layer in range(ng):
            x = _remat(functools.partial(body, layer=layer), x, cfg) \
                if remat else body(x, layer)
    return x


def _frontend_input(inputs: dict, name: str, want: int, cfg, dev, dt):
    if name not in inputs:
        raise ValueError(f"{cfg.name} ({cfg.family}) takes "
                         f"{{'tokens', {name!r}}} outside decode")
    t = torch.as_tensor(inputs[name], device=dev).to(dt)
    if t.dim() != 3 or t.shape[2] != cfg.d_model or (want and
                                                     t.shape[1] != want):
        raise ValueError(f"{name} {tuple(t.shape)}: want (B, "
                         f"{want or 'n'}, {cfg.d_model})")
    return t


def forward(params, inputs: dict, cfg: ModelConfig, mode: str = "train",
            cache=None):
    """inputs: {'tokens': (B, S)} [+ 'frames' (B, F, d) | 'patches'
    (B, P, d) outside decode], on the params' device (or host arrays).

    train   -> logits (B, S_total, V), recorded by autograd where it is on
               and a param requires grad
    prefill -> (last-position logits (B, V), cache filled in place)
    decode  -> (logits (B, V), cache updated in place); tokens is (B, 1)

    Prefill and decode run under ``torch.no_grad``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        return _forward(params, inputs, cfg, mode, None)
    if cache is None:
        raise ValueError(f"mode {mode!r} needs a cache (lm.init_cache)")
    with torch.no_grad():
        return _forward(params, inputs, cfg, mode, cache)


def _forward(params, inputs: dict, cfg: ModelConfig, mode: str, cache):
    stacks = pattern_stacks(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = params["embed"].device
    tokens = torch.as_tensor(inputs["tokens"], device=dev).long()
    b = tokens.shape[0]
    d = cfg.d_model

    x = params["embed"].to(dt)[tokens]
    enc_out = None
    if cfg.family == "vlm" and mode != "decode":
        patches = _frontend_input(inputs, "patches", 0, cfg, dev, dt) @ \
            params["mm_proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
    if cfg.family == "audio" and mode != "decode":
        # prefill fills the cross cache, which holds n_audio_frames
        frames = _frontend_input(inputs, "frames", cfg.n_audio_frames
                                 if mode == "prefill" else 0, cfg, dev, dt)
        f = frames.shape[1]
        fpos = torch.arange(f, dtype=torch.int32, device=dev)[None].expand(
            b, f)
        xe = frames + _sinusoid(fpos, d).to(dt)
        ectx = Ctx(cfg=cfg, mode="train", positions=fpos, causal=False)
        xe = _run_stacks(params["encoder"], xe, ectx, None,
                         [(("enc_attn",), cfg.n_encoder_layers)])
        enc_out = apply_norm(xe, params["encoder"]["out_ln"], cfg.norm, 1e-6)

    pos0 = int(cache["pos"]) if mode == "decode" else 0
    if mode == "decode":
        positions = torch.full((b, 1), pos0, dtype=torch.int32, device=dev)
    else:
        s_total = x.shape[1]
        positions = torch.arange(s_total, dtype=torch.int32,
                                 device=dev)[None].expand(b, s_total)
    if cfg.rope_theta == 0:   # whisper: absolute sinusoidal positions
        x = x + _sinusoid(positions, d).to(dt)

    ctx = Ctx(cfg=cfg, mode=mode, positions=positions, pos=pos0,
              enc_out=enc_out)
    x = _run_stacks(params, x, ctx, cache if mode != "train" else None,
                    stacks)
    x = apply_norm(x, params["out_ln"], cfg.norm, 1e-6)

    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dt)
    if mode == "train":
        return x @ head
    if mode == "prefill":
        cache["pos"] = x.shape[1]
        return x[:, -1, :] @ head, cache
    cache["pos"] = pos0 + 1
    return x[:, 0, :] @ head, cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(params, batch: dict, cfg: ModelConfig):
    """Next-token cross entropy in float32 (prefix positions from stub
    frontends and the final position are excluded; padded vocab columns
    are masked to -1e30).  batch: inputs + optional 'loss_mask' (B, S),
    whose ``[:, 1:]`` weighs each target; the sum is divided by
    ``max(mask.sum(), 1)``."""
    logits = forward(params, batch, cfg, mode="train")
    dev = logits.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    prefix = logits.shape[1] - tokens.shape[1]
    tgt = tokens[:, 1:]
    lg = logits[:, prefix:-1, :].float()
    if cfg.padded_vocab != cfg.vocab_size:   # mask padded vocab columns
        pad = torch.arange(cfg.padded_vocab, device=dev) >= cfg.vocab_size
        lg = lg.masked_fill(pad, NEG_INF)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else torch.as_tensor(
        mask, device=dev)[:, 1:].float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
