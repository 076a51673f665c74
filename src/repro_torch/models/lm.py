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

On a mesh (DTensor params under ``parallel.sharding.use_rules``; every
family) the residual between layers and the logits are DTensors placed by
the rules at the reference's ``shard_act`` sites; each layer runs the
single-device blocks on this rank's batch rows (``_mesh_layer``), with the
model axis's compute split as the rules place it:

* the MLP and the MoE's shared experts over ``ff`` (column-parallel in,
  row-parallel out, the paper's Alg. 2);
* the routed experts over ``experts`` (train: this rank's E / model
  experts' capacity buffers) or ``expert_ff`` (serve: every expert's
  columns), each rank dispatching only the groups of its own rows
  (``_moe``);
* train and prefill attention over ``seq`` (sequence parallel, direct
  routing): this rank's slice of the positions is normed, projected and
  attends every position's k and v, gathered over the model axis; the
  sublayer's output is gathered whole for the MLP or MoE that follows;
* a decode attention on this rank's slice of a KV cache split along its
  slots (the hybrid's ring too), merged across the model axis by
  log-sum-exp (``_decode_kv_shard``).

The other params are gathered whole, and recurrent states that the rules
split along their channels are gathered whole for the layer and written
back to this rank's slice (``_state_whole``).  Every split runs alike on
a model axis of one.  The frontends run on this rank's rows:
the audio encoder as a stack of mesh layers, the vlm's patch projection.
``abstract_model`` and ``model_spec_tree`` give the rules their shapes and
names.

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
from ..nn.layers import (ParamDef, abstract_params, apply_norm, apply_rope,
                         gelu, init_params, leaves, map_defs, norm_defs,
                         rmsnorm, spec_tree, swish, torch_dtype)
from ..nn.moe import (_shared_ffn, group_size, group_tokens, moe_defs,
                      moe_ffn, routed_experts)
from ..parallel import sharding as sh
from ..parallel.sharding import shard_act
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


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None,
               shardings=None):
    """Random params in ``cfg.dtype`` on ``device`` (CUDA unless the caller
    asks for the CPU), drawn from a ``torch.Generator`` seeded with
    ``seed``.  With ``shardings`` (``parallel.sharding.param_shardings``),
    each param is placed on its mesh as soon as it is drawn (the draws are
    the single-device ones), so no rank holds more than one whole param."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    place = None
    if shardings is not None:
        order: list = []
        map_defs(order.append, shardings)    # the order init_params draws
        it = iter(order)
        place = lambda t: sh.shard_tensor(t, next(it))  # noqa: E731
    return init_params(model_defs(cfg), gen, dtype=torch_dtype(cfg.dtype),
                       place=place)


def abstract_model(cfg: ModelConfig):
    """The params as meta-device tensors of ``cfg.dtype`` (no storage)."""
    return abstract_params(model_defs(cfg), dtype=torch_dtype(cfg.dtype))


def model_spec_tree(cfg: ModelConfig):
    """The params' logical axis names, a tuple a leaf."""
    return spec_tree(model_defs(cfg))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshCtx:
    """The layout of a forward on a mesh (``_mesh_forward``): its rules;
    the batch rows this rank computes, ``rows`` of a global ``batch``
    (placements of a (B, ...) activation split by rows); the gradient
    placements of a gathered param (``Partial`` along the mesh dims whose
    ranks compute other rows); and, for a KV cache split along its slots,
    the model group, its size and this rank's index in it."""
    rules: Any
    mesh: Any
    batch: int
    rows: tuple
    row_range: tuple[int, int]
    grad: tuple
    kv: tuple | None = None
    # the model axis's mesh dim when the rules split the MLP's ff over it
    # (``act_ff``: direct routing), else None
    ff_dim: int | None = None
    # the model axis's mesh dim when the rules put ``seq`` on it (direct
    # routing, sequence parallel): train and prefill attention split their
    # queries by position over it; else None
    seq_dim: int | None = None
    # (the model axis's mesh dim, "experts" | "expert_ff") when the rules
    # split the routed experts' params over it (``experts`` in train,
    # ``expert_ff`` in serve), else None
    experts: tuple[int, str] | None = None

    def parted(self, dim: int) -> tuple:
        """The gradient placements of a gathered param whose gradient is a
        part on each rank of mesh dim ``dim`` too (``Partial`` there): an
        attention sublayer's under a sequence split, whose model ranks each
        see a slice of the positions; the router's where they each combine
        their own experts."""
        from torch.distributed.tensor import Partial
        return tuple(Partial() if d == dim else p
                     for d, p in enumerate(self.grad))


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
    mesh: MeshCtx | None = None    # a mesh forward's layout
    # a mesh forward's slice [s0, s1) of the positions on this rank where
    # the model axis splits attention's queries (``MeshCtx.seq_dim``)
    seq: tuple[int, int] | None = None

    @property
    def q_pos(self) -> torch.Tensor:
        """The positions of this rank's queries: all, or ``seq``'s."""
        if self.seq is None:
            return self.positions
        return self.positions[:, self.seq[0]:self.seq[1]]

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


def _attn_act_names(mode: str):
    """Sharding names for q (5D) and k, v (4D), as the reference's: q keeps
    its seq dim sharded through the attention (sequence parallel), k and v
    are replicated along the model axis; decode has one query, so q is
    split by batch only and balance comes from the seq-sharded cache."""
    if mode == "decode":
        return ("batch", None, None, None, None), ("batch", None, None, None)
    return ("batch", "seq", None, None, None), ("batch", None, None, None)


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
        q = apply_rope(q, ctx.q_pos, cfg.rope_theta)
        k = apply_rope(k, ctx.q_pos, cfg.rope_theta)
    qn, kn = _attn_act_names(ctx.mode)
    return shard_act(q, qn), shard_act(k, kn), shard_act(v, kn)


def _cross_attn(p, xn, ctx: Ctx, cache):
    """Cross-attention of xn against the encoder output: k and v are made
    from it (train, prefill; prefill stores them in ``cache``) or read
    from the cache (decode, through the kernel over all frames)."""
    q = shard_act(_project(xn, p["wq"]), _attn_act_names(ctx.mode)[0])
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
    return gqa_attention(q, k, v, q_pos=ctx.q_pos, kv_pos=kv_pos,
                         causal=False, chunk=ctx.cfg.attn_chunk)


def _self_attn(p, xn, ctx: Ctx, cache, local_window: int):
    """Self-attention; writes the layer's ``cache`` (views into the
    stacked cache) in place.  Under a sequence split (``ctx.seq``) ``xn``
    is this rank's slice of the positions: its queries attend every
    position's k and v, gathered over the model axis."""
    cfg = ctx.cfg
    s = xn.shape[1]
    q, k, v = _project_qkv(p, xn, ctx)
    if ctx.seq is not None:
        k, v = _seq_gather(k, ctx, parted=True), _seq_gather(v, ctx,
                                                             parted=True)
    if ctx.mesh is not None and cache is not None:
        if ctx.mode == "decode":
            return _decode_kv_shard(q, k, v, cache, ctx, local_window)
        _prefill_kv_shard(k, v, cache, ctx, local_window)
        return gqa_attention(q, k, v, q_pos=ctx.q_pos,
                             kv_pos=ctx.positions, causal=ctx.causal,
                             local_window=local_window, chunk=cfg.attn_chunk)
    if ctx.mode == "decode":
        w = cache["k"].shape[1]
        slot = ctx.pos % w if local_window else min(ctx.pos, w - 1)
        update_cache(cache["k"], cache["v"], k, v, slot)
        # fill_, not item assignment: that copies a host scalar to the
        # card and makes the host wait for it in every layer
        cache["kv_pos"][slot:slot + 1].fill_(ctx.pos)
        return flash_decode(q, cache["k"], cache["v"],
                            ctx.lengths_of(min(ctx.pos + 1, w)))
    out = gqa_attention(q, k, v, q_pos=ctx.q_pos, kv_pos=ctx.positions,
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


def _kv_slice(ctx: Ctx, w_loc: int) -> tuple[int, int]:
    """(first slot of this rank's slice, slots of the whole cache) when
    the model axis splits the cache's ``w_loc * n`` slots: rank r holds
    [r * w_loc, (r + 1) * w_loc)."""
    if ctx.mesh.kv is None:
        return 0, w_loc
    _, n, r = ctx.mesh.kv
    return r * w_loc, w_loc * n


def _prefill_kv_shard(k, v, cache, ctx: Ctx, local_window: int = 0) -> None:
    """Prefill's cache write on this rank's slice of the slots: the whole
    cache's slots hold what the single-device write leaves there (the last
    ``w`` positions, rotated to the ring order ``p % w`` for a local
    window), this rank copies its ``[off, off + w_loc)``; a slot past the
    prompt is zero and marked unwritten."""
    ck, cv, kp = cache["k"], cache["v"], cache["kv_pos"]
    s, w_loc = k.shape[1], ck.shape[1]
    off, w = _kv_slice(ctx, w_loc)
    n = min(max(min(s, w) - off, 0), w_loc)
    slots = torch.arange(off, off + n, device=k.device)
    if s >= w and local_window:
        # slot j holds the position p of the last w with p % w == j
        src = s - w + (slots - (s - w)) % w
    else:
        src = slots + max(s - w, 0)
    ck[:, :n] = k[:, src]
    cv[:, :n] = v[:, src]
    kp[:n] = ctx.positions[0, src]
    ck[:, n:].zero_()
    cv[:, n:].zero_()
    kp[n:].fill_(-1)


def _decode_kv_shard(q, k, v, cache, ctx: Ctx, local_window: int = 0):
    """One decode attention against a cache whose slots the model axis
    splits: the rank that holds the new token's slot (``pos % w`` on a
    local window's ring, else ``min(pos, w - 1)``) writes it; each rank
    attends its share of the first ``min(pos + 1, w)`` slots (0 where it
    holds none) through the kernel's log-sum-exp output; the ranks merge by
    an all-reduce MAX of the lse, then one SUM of exp(lse - max) * out
    beside exp(lse - max).  Attention over a set of slots does not see
    their order, so the merge is the same for the ring."""
    ck, cv, kp = cache["k"], cache["v"], cache["kv_pos"]
    w_loc = ck.shape[1]
    off, w = _kv_slice(ctx, w_loc)
    slot = ctx.pos % w if local_window else min(ctx.pos, w - 1)
    if off <= slot < off + w_loc:
        update_cache(ck, cv, k, v, slot - off)
        kp[slot - off:slot - off + 1].fill_(ctx.pos)
    n_valid = min(max(min(ctx.pos + 1, w) - off, 0), w_loc)
    out, lse = flash_decode(q, ck, cv, ctx.lengths_of(n_valid),
                            return_lse=True)
    if ctx.mesh.kv is not None:
        import torch.distributed as dist
        group = ctx.mesh.kv[0]
        top = lse.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        wgt = torch.exp(lse - top)[..., None]
        acc = torch.cat([out * wgt, wgt], dim=-1)
        dist.all_reduce(acc, group=group)
        out = acc[..., :-1] / acc[..., -1:]
    return out.to(q.dtype)


def _apply_attn(p, x, ctx: Ctx, cache, *, local_window: int = 0,
                cross: bool = False):
    """Self- or cross-attention sublayer.  Returns x + attention output
    (a sequence split's slice of it may hold no position)."""
    xn = apply_norm(x, p["ln"], ctx.cfg.norm, 1e-6)
    out = _cross_attn(p, xn, ctx, cache) if cross else \
        _self_attn(p, xn, ctx, cache, local_window)
    proj = out.to(x.dtype).flatten(2) @ \
        p["wo"].reshape(-1, x.shape[-1]).to(x.dtype)
    return x + proj


def _apply_mlp(p, x, ctx: Ctx):
    cfg = ctx.cfg
    xn = apply_norm(x, p["ln"], cfg.norm, 1e-6)
    split = ctx.mesh is not None and ctx.mesh.ff_dim is not None and \
        p["wi"].shape[-1] != cfg.d_ff
    if split:
        # each model rank holds a slice of ff: xn's gradient is summed over
        # them, the output projection's parts are summed below
        xn = sh.grads_summed(xn, ctx.mesh.mesh, ctx.mesh.rows,
                             ctx.mesh.ff_dim)
    h = xn @ p["wi"]
    if cfg.act == "swiglu":
        h = swish(xn @ p["wg"]) * h
    else:
        h = gelu(h)
    h = shard_act(h, ("batch", None, "act_ff"))
    y = h @ p["wo"]
    if split:
        y = sh.summed(y, ctx.mesh.mesh, ctx.mesh.rows, ctx.mesh.ff_dim)
    return x + y.to(x.dtype)


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


def _moe(p, xn, ctx: Ctx):
    """``moe_ffn``.  On a mesh: the dispatch groups that hold this rank's
    rows' tokens, of every rank's rows gathered (groups run over the
    global token order: one may span two ranks' rows, and a short batch
    shrinks the group); where the rules split the routed experts over the
    model axis (``MeshCtx.experts``), this rank's experts (train) or
    columns of each (serve) alone, and the shared experts on their slice
    of ff as the MLP; the parts summed over the model axis; this rank's
    rows of the result.  The router runs whole on every model rank, but
    its gradient there, through the combine weights of this rank's
    experts, is a part too."""
    mc, cfg = ctx.mesh, ctx.cfg
    if mc is None:
        return moe_ffn(p, xn, cfg)
    from torch.distributed.tensor import Replicate
    full = sh.replicated(_from_rows(xn, mc), mc.grad)
    b, s, d = full.shape
    t = b * s
    gs = group_size(cfg, t)
    r0, r1 = mc.row_range
    g0, g1 = r0 * s // gs, -(-r1 * s // gs)
    xt = group_tokens(full.reshape(t, d)[g0 * gs:min(g1 * gs, t)], gs)
    whole = (Replicate(),) * mc.mesh.ndim
    e_dim, experts = mc.experts or (None, None)
    if experts == "experts":
        n = p["wi"].shape[0]
        e0 = mc.mesh.get_local_rank(e_dim) * n
        experts = (e0, e0 + n)
    else:
        experts = None
    sff = cfg.moe_d_ff * cfg.n_shared_experts
    ff_dim = mc.ff_dim if sff and mc.ff_dim is not None and \
        sff % mc.mesh.size(mc.ff_dim) == 0 else None

    def parts(dim):
        """xt, its gradient summed over mesh dim ``dim``, whose ranks each
        take a part of the work."""
        return xt if dim is None else sh.grads_summed(xt, mc.mesh, whole,
                                                      dim)

    xe = parts(e_dim)
    xs = xe if ff_dim == e_dim else parts(ff_dim)

    def summed(y, dim):
        return y if dim is None else sh.summed(y, mc.mesh, whole, dim)

    out = routed_experts(p, xe, cfg, t, first=g0, experts=experts)
    if not cfg.n_shared_experts:
        out = summed(out, e_dim)
    elif ff_dim == e_dim:
        out = summed(out + _shared_ffn(p, xs), e_dim)
    else:
        out = summed(out, e_dim) + summed(_shared_ffn(p, xs), ff_dim)
    out = out.reshape(-1, d)[r0 * s - g0 * gs:r1 * s - g0 * gs]
    return out.view(r1 - r0, s, d)


# block kinds that open with attention: under a sequence split they take
# this rank's slice of the positions and gather their output whole
_SEQ_KINDS = ("attn", "enc_attn", "xattn", "moe")


def _seq_whole(x, ctx: Ctx):
    """An attention sublayer's output: whole along the sequence for the
    MLP or MoE that follows (``_seq_gather``)."""
    return x if ctx.seq is None else _seq_gather(x, ctx)


def apply_block(kind: str, p, x, ctx: Ctx, cache):
    """Returns x after the block; writes the block's cache in place."""
    cfg = ctx.cfg
    if kind in ("attn", "enc_attn"):
        lw = cfg.local_window if (kind == "attn"
                                  and cfg.family == "hybrid") else 0
        x = _apply_attn(p["attn"], x, ctx, cache, local_window=lw)
        return _apply_mlp(p["mlp"], _seq_whole(x, ctx), ctx)
    if kind == "xattn":
        x = _apply_attn(p["attn"], x, ctx,
                        None if cache is None else cache["self"])
        x = _apply_attn(p["xa"], x, ctx,
                        None if cache is None else cache["cross"], cross=True)
        return _apply_mlp(p["mlp"], _seq_whole(x, ctx), ctx)
    if kind == "moe":
        x = _seq_whole(_apply_attn(p["attn"], x, ctx, cache), ctx)
        xn = apply_norm(x, p["moe_ln"], cfg.norm, 1e-6)
        return x + _moe(p["moe"], xn, ctx).to(x.dtype)
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
        # the residual between layers: under sequence parallelism sharded
        # by (batch, seq); the ssm family shards channels instead
        carry_seq = ctx.mode != "decode" and cfg.family != "ssm"
        carry_names = ("batch", "seq" if carry_seq else None, "act_embed")

        def body(x, layer, stack_params=stack_params,
                 stack_cache=stack_cache, pattern=pattern,
                 carry_names=carry_names):
            x = shard_act(x, carry_names)
            if ctx.mesh is not None:
                return _mesh_layer(x, layer, stack_params, stack_cache,
                                   pattern, ctx)
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


def _strides(shape) -> tuple[int, ...]:
    """Contiguous strides of ``shape``."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _from_rows(x, mc: MeshCtx):
    """This rank's rows ``x`` of a (B, ...) activation as a DTensor."""
    from torch.distributed.tensor import DTensor
    shape = (mc.batch, *x.shape[1:])
    return DTensor.from_local(x, mc.mesh, mc.rows, run_check=False,
                              shape=shape, stride=_strides(shape))


def _rows(x, mc: MeshCtx):
    """This rank's rows of the activation DTensor ``x``, whole along every
    other dim (an all-gather along the model axis where it is split)."""
    return x.redistribute(mc.mesh, mc.rows).to_local()


def _layer_param(t, layer: int, mc: MeshCtx, keep: int | None = None,
                 grad=None):
    """Layer ``layer`` of a stacked param on this rank: gathered from its
    shards (its gradient returns as ``grad`` says, by default
    ``mc.grad``), but left in its slice along mesh dim ``keep``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    grad = list(mc.grad if grad is None else grad)
    place = [Shard(p.dim - 1) if isinstance(p, Shard) else p
             for p in t.placements]
    sl = DTensor.from_local(t.to_local()[layer], t.device_mesh, place,
                            run_check=False, shape=t.shape[1:],
                            stride=_strides(t.shape[1:]))
    if keep is None:
        return sh.replicated(sl, tuple(grad))
    want = [Replicate()] * len(place)
    want[keep] = grad[keep] = place[keep]
    return sl.redistribute(t.device_mesh, want).to_local(
        grad_placements=grad)


# the leaves a mesh layer keeps in their model-axis slice of ff (where the
# rules split ``act_ff``): the MLP's, and the MoE's shared experts'
_FF_SPLIT = {"mlp": ("wi", "wg", "wo"),
             "moe": ("shared_wi", "shared_wg", "shared_wo")}
# the routed experts' leaves, kept in their slice where ``MeshCtx.experts``
_EXPERTS_SPLIT = ("wi", "wg", "wo")
# the attention sublayers, whose gradients a sequence split makes parts
_ATTN_SUBLAYERS = ("attn", "xa")


def _kept(name: str, mc: MeshCtx) -> dict:
    """{leaf: mesh dim} of a block's subtree ``name`` that stay in their
    model-axis slice."""
    out = {}
    if mc.ff_dim is not None:
        out.update(dict.fromkeys(_FF_SPLIT.get(name, ()), mc.ff_dim))
    if name == "moe" and mc.experts is not None:
        out.update(dict.fromkeys(_EXPERTS_SPLIT, mc.experts[0]))
    return out


def _gather_block(tree: dict, layer: int, mc: MeshCtx, seq: bool = False,
                  keep=None, grad=None) -> dict:
    """A block's layer-``layer`` params on this rank (``_layer_param``):
    the leaves ``_kept`` names stay in their model-axis slice.  Their
    gradients return as ``grad`` says (default ``mc.grad``), and as parts
    summed over the model axis too (``MeshCtx.parted``) for an attention
    sublayer under a sequence split (``seq``) and for the router where the
    model axis splits the routed experts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = mc.parted(mc.seq_dim) if seq and k in _ATTN_SUBLAYERS \
                else grad
            out[k] = _gather_block(v, layer, mc, seq, _kept(k, mc), sub)
        else:
            g = mc.parted(mc.experts[0]) if k == "router" and mc.experts \
                else grad
            out[k] = _layer_param(v, layer, mc, (keep or {}).get(k), g)
    return out


def _seq_range(n: int, mc: MeshCtx) -> tuple[int, int]:
    """[s0, s1) of an ``n``-long sequence on this rank where the model axis
    splits it: ``torch.chunk``'s split, as DTensor's ``Shard`` takes it
    (uneven: the last ranks hold less, or nothing)."""
    m = mc.mesh.size(mc.seq_dim)
    c = -(-n // m)
    s0 = min(mc.mesh.get_local_rank(mc.seq_dim) * c, n)
    return s0, min(s0 + c, n)


def _seq_place(mc: MeshCtx) -> tuple:
    """Placements of a (B, S, ...) activation split by rows and along S
    over the model axis."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(1) if d == mc.seq_dim else p
                 for d, p in enumerate(mc.rows))


def _seq_gather(t, ctx: Ctx, parted: bool = False):
    """This rank's slice ``t`` (rows, s1 - s0, ...) of the positions,
    all-gathered whole along them over the model axis.  Its gradient comes
    back as this rank's slice of one that every model rank holds alike,
    or, ``parted`` (k and v, which each rank's own queries attend), as the
    sum over the model ranks of theirs (a reduce-scatter)."""
    from torch.distributed.tensor import DTensor, Partial
    mc = ctx.mesh
    shape = (mc.batch, ctx.positions.shape[1], *t.shape[2:])
    dt = DTensor.from_local(t, mc.mesh, _seq_place(mc), run_check=False,
                            shape=shape, stride=_strides(shape))
    grad = tuple(Partial() if d == mc.seq_dim else p
                 for d, p in enumerate(mc.rows)) if parted else None
    return dt.redistribute(mc.mesh, mc.rows).to_local(grad_placements=grad)


def _block_input(h, kind: str, ctx: Ctx):
    """A block's input on this rank, from the layer's DTensor input or the
    previous block's whole rows: this rank's rows, and under a sequence
    split an attention block's slice of the positions (its gradient
    gathered back whole)."""
    mc = ctx.mesh
    sliced = ctx.seq is not None and kind in _SEQ_KINDS
    if not sh.is_dtensor(h):
        if not sliced:
            return h
        h = _from_rows(h, mc)
    return h.redistribute(mc.mesh, _seq_place(mc) if sliced
                          else mc.rows).to_local()


# block kinds whose cache is recurrent state (the rest hold attention caches)
_RECURRENT = ("rec", "mlstm", "slstm")


def _state_whole(blk: dict, layer: int, mc: MeshCtx):
    """A recurrent block's layer-``layer`` state on this rank: its batch
    rows, whole along the channels that the rules split over the model axis
    (``rec``'s along ``rnn``, ``mlstm``'s along ``ff``: gathered), and a
    ``write_back()`` that copies this rank's channel slice of each gathered
    leaf into its local shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out, back = {}, []
    for name, t in blk.items():
        loc = t.to_local()[layer]
        # the stacked (layers, batch, ...) leaf's placements, less layers
        place = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                 for p in t.placements]
        split = [d for d, p in enumerate(place)
                 if isinstance(p, Shard) and p.dim > 0]
        if not split:
            out[name] = loc
            continue
        want = [Replicate() if d in split else p for d, p in enumerate(place)]
        whole = DTensor.from_local(loc, t.device_mesh, place, run_check=False,
                                   shape=t.shape[1:],
                                   stride=_strides(t.shape[1:])) \
            .redistribute(t.device_mesh, want).to_local()
        out[name] = whole
        mine = [slice(None)] * whole.dim()
        for dim in {place[d].dim for d in split}:
            mine[dim] = slice(*sh.row_range(whole.shape[dim], t.device_mesh,
                                            place, dim=dim))
        back.append((loc, whole, tuple(mine)))

    def write_back():
        for loc, whole, mine in back:
            loc.copy_(whole[mine])

    return out, write_back


def _mesh_layer(x, layer: int, stack_params, stack_cache, pattern,
                ctx: Ctx):
    """One layer of a stack on a mesh: this rank's rows of ``x`` (an
    attention block's slice of the positions under a sequence split,
    ``_block_input``) and the layer's params (``_gather_block``), the
    pattern's blocks applied to them with the single-device code
    (attention caches through this rank's local shards, recurrent states
    whole along their channels, ``_state_whole``), and the rows back as a
    DTensor."""
    mc = ctx.mesh
    h = x
    for i, kind in enumerate(pattern):
        key = f"{i}_{kind}"
        h = _block_input(h, kind, ctx)
        gp = _gather_block(stack_params[key], layer, mc, ctx.seq is not None)
        bc, write_back = None, None
        if stack_cache is not None and kind in _RECURRENT:
            bc, write_back = _state_whole(stack_cache[key], layer, mc)
        elif stack_cache is not None:
            bc = map_defs(lambda t: sh.local(t)[layer], stack_cache[key])
        h = apply_block(kind, gp, h, ctx, bc)
        if write_back is not None:
            write_back()
    return _from_rows(h, mc)


def _self_cache(blk: dict) -> dict | None:
    """A block cache's self-attention cache (``xattn``'s ``self``), or None
    for recurrent state."""
    if "self" in blk:
        return blk["self"]
    return blk if "kv_pos" in blk else None


def _mesh_ctx(rules, cfg: ModelConfig, b: int, cache) -> MeshCtx:
    from torch.distributed.tensor import Shard
    if rules is None or rules.mesh is None:
        raise ValueError("DTensor params need a mesh's rules "
                         "(parallel.sharding.use_rules)")
    mesh = rules.mesh
    rows = sh.rows_placements(rules, (b, 1))
    kv = None
    attn = [] if cache is None else [
        c for stack in cache["stacks"] for blk in stack.values()
        if (c := _self_cache(blk)) is not None]
    if attn:       # every self-attention cache of a model is split alike
        for d, p in enumerate(attn[0]["k"].placements):
            if isinstance(p, Shard) and p.dim == 2:      # kv_seq
                kv = (mesh.get_group(d), mesh.size(d),
                      mesh.get_local_rank(d))
    names = tuple(mesh.mesh_dim_names)
    model = names.index("model") if "model" in names else None
    r = rules.rules

    def on_model(name):
        return model if model is not None and r.get(name) == "model" \
            else None

    experts = None
    if cfg.n_experts and "model" in (r.get("act_experts"),
                                     r.get("expert_ff")):
        # the params' own split (``fit_spec``: a dim the axis does not
        # divide stays whole)
        spec = rules.fit_spec(("experts", "embed", "expert_ff"),
                              (cfg.n_experts, cfg.d_model, cfg.moe_d_ff))
        for name, axes in zip(("experts", None, "expert_ff"), spec):
            if name and axes and "model" in axes:
                experts = (model, name)
    return MeshCtx(rules=rules, mesh=mesh, batch=b, rows=rows,
                   row_range=sh.row_range(b, mesh, rows),
                   grad=sh.partial_over(rows), kv=kv,
                   ff_dim=on_model("act_ff"), seq_dim=on_model("seq"),
                   experts=experts)


def _seq_of(n: int, mc: MeshCtx, mode: str) -> tuple[int, int] | None:
    """This rank's slice of ``n`` positions where the model axis splits
    attention by sequence (train and prefill), else None."""
    if mc.seq_dim is None or mode == "decode":
        return None
    return _seq_range(n, mc)


def _mesh_forward(params, inputs: dict, cfg: ModelConfig, mode: str,
                  cache):
    """``_forward`` over DTensor params on the rules' mesh: the frontends,
    the embedding and every layer on this rank's batch rows with gathered
    params (the decode attention on this rank's slice of a split cache),
    the residual between layers placed by the rules, the logits a
    DTensor."""
    dt = torch_dtype(cfg.dtype)
    dev = params["embed"].device
    d = cfg.d_model

    def whole(t):
        return t.full_tensor() if sh.is_dtensor(t) else \
            torch.as_tensor(t, device=dev)

    tokens = whole(inputs["tokens"])
    b = tokens.shape[0]
    mc = _mesh_ctx(sh.current_rules(), cfg, b, cache)
    r0, r1 = mc.row_range

    def gathered(tree):
        return map_defs(lambda t: sh.replicated(t, mc.grad), tree)

    x = gathered(params["embed"]).to(dt)[tokens[r0:r1].to(dev).long()]
    local = {k: whole(v)[r0:r1] for k, v in inputs.items()
             if k in ("frames", "patches")}
    enc_out = None
    if cfg.family == "vlm" and mode != "decode":
        patches = _frontend_input(local, "patches", 0, cfg, dev, dt) @ \
            gathered(params["mm_proj"]).to(dt)
        x = torch.cat([patches, x], dim=1)
    if cfg.family == "audio" and mode != "decode":
        frames = _frontend_input(local, "frames", cfg.n_audio_frames
                                 if mode == "prefill" else 0, cfg, dev, dt)
        f = frames.shape[1]
        fpos = torch.arange(f, dtype=torch.int32, device=dev)[None].expand(
            r1 - r0, f)
        xe = _from_rows(frames + _sinusoid(fpos, d).to(dt), mc)
        ectx = Ctx(cfg=cfg, mode="train", positions=fpos, causal=False,
                   mesh=mc, seq=_seq_of(f, mc, "train"))
        xe = _run_stacks(params["encoder"], xe, ectx, None,
                         [(("enc_attn",), cfg.n_encoder_layers)])
        enc_out = apply_norm(_rows(xe, mc),
                             gathered(params["encoder"]["out_ln"]), cfg.norm,
                             1e-6)
        if mc.seq_dim is not None:
            # each model rank's queries attend the whole encoder output:
            # its gradient is the sum of theirs
            enc_out = sh.grads_summed(enc_out, mc.mesh, mc.rows, mc.seq_dim)
    pos0 = int(cache["pos"]) if mode == "decode" else 0
    if mode == "decode":
        positions = torch.full((r1 - r0, 1), pos0, dtype=torch.int32,
                               device=dev)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=dev)[None].expand(r1 - r0, -1)
    if cfg.rope_theta == 0:   # whisper: absolute sinusoidal positions
        x = x + _sinusoid(positions, d).to(dt)
    x = shard_act(_from_rows(x, mc), ("batch", "seq", "act_embed"))
    ctx = Ctx(cfg=cfg, mode=mode, positions=positions, pos=pos0,
              enc_out=enc_out, mesh=mc, seq=_seq_of(x.shape[1], mc, mode))
    x = _run_stacks(params, x, ctx, cache if mode != "train" else None,
                    pattern_stacks(cfg))
    if mode == "train":
        x = shard_act(x, ("batch", None, "act_embed"))
    x = apply_norm(_rows(x, mc), gathered(params["out_ln"]), cfg.norm, 1e-6)
    head = (gathered(params["embed"]).T if cfg.tie_embeddings
            else gathered(params["lm_head"])).to(dt)
    if mode == "train":
        return shard_act(_from_rows(x @ head, mc), ("batch", None, "vocab"))
    if mode == "prefill":
        cache["pos"] = x.shape[1]
        return _from_rows(x[:, -1, :] @ head, mc), cache
    cache["pos"] = pos0 + 1
    return _from_rows(x[:, 0, :] @ head, mc), cache


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
    if sh.is_dtensor(params["embed"]):
        return _mesh_forward(params, inputs, cfg, mode, cache)
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
    x = shard_act(x, ("batch", "seq", "act_embed"))

    ctx = Ctx(cfg=cfg, mode=mode, positions=positions, pos=pos0,
              enc_out=enc_out)
    x = _run_stacks(params, x, ctx, cache if mode != "train" else None,
                    stacks)
    x = apply_norm(x, params["out_ln"], cfg.norm, 1e-6)

    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dt)
    if mode == "train":
        x = shard_act(x, ("batch", None, "act_embed"))
        return shard_act(x @ head, ("batch", None, "vocab"))
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
    tokens, mask = batch["tokens"], batch.get("loss_mask")
    if not sh.is_dtensor(logits):
        num, den = _nll_sums(logits, tokens, mask, cfg)
        return num / torch.clamp(den, min=1.0)
    # on a mesh: this rank's rows of the logits, whole along the vocab;
    # the sums over every rank's rows
    mc_rows = sh.rows_placements(sh.current_rules(), tuple(logits.shape))
    mesh = logits.device_mesh
    r0, r1 = sh.row_range(logits.shape[0], mesh, mc_rows)
    lg = logits.redistribute(mesh, mc_rows).to_local()

    def rows(t):
        t = t.full_tensor() if sh.is_dtensor(t) else torch.as_tensor(t)
        return t[r0:r1]

    num, den = _nll_sums(lg, rows(tokens), None if mask is None
                         else rows(mask), cfg)
    tot = sh.sum_over(torch.stack([num, den]), mesh, mc_rows)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def _nll_sums(logits, tokens, mask, cfg: ModelConfig):
    """(sum of mask-weighted next-token NLL, sum of the mask weights)."""
    dev = logits.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    prefix = logits.shape[1] - tokens.shape[1]
    tgt = tokens[:, 1:]
    lg = logits[:, prefix:-1, :].float()
    if cfg.padded_vocab != cfg.vocab_size:   # mask padded vocab columns
        pad = torch.arange(cfg.padded_vocab, device=dev) >= cfg.vocab_size
        lg = lg.masked_fill(pad, NEG_INF)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else torch.as_tensor(
        mask, device=dev)[:, 1:].float()
    return (nll * mask).sum(), mask.sum()
