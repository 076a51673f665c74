"""Mixture-of-Experts FFN (GShard-style capacity dispatch), ported from
``repro/nn/moe.py``, with both dispatch implementations of ``cfg.moe_impl``:

* ``einsum`` — the one-hot dispatch and combine products (GShard
  [arXiv:2006.16668]), the reference's default;
* ``gather`` — a scatter builds the (group, expert, capacity) table of
  source tokens, then gathers fill the capacity buffer and read it back.

Tokens are dispatched in groups of ``moe_group_size``; the last group is
padded and its padding parked on expert ``e - 1`` with zero weight.  Each
expert takes ``max(int(k * gs / e * capacity_factor), 1)`` tokens a group;
a token-major, choice-minor cumsum decides which (token, choice) pairs fit,
and the rest are dropped (their residual carries them), as in the
reference.  The capacity is host arithmetic on static shapes, and routing
uses only ``topk``, ``cumsum``, comparisons, ``scatter`` and ``gather``:
nothing here makes the host wait on the card.

On a mesh (``models/lm.py::_moe``) a rank dispatches only the groups that
hold its own rows' tokens (``route``'s ``first``), and where the rules put
the model axis on the routed experts (train: ``experts``) it builds and
runs the capacity buffers of its own experts alone (``routed_experts``'
``experts``); where they split each expert's hidden dim (serve:
``expert_ff``) every expert runs on this rank's columns.  Either way the
rank's output is a part, summed over the model axis.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import shard_act
from .layers import ParamDef, swish


def moe_defs(cfg, prefix_shape=(), prefix_names=()) -> dict:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    ps, pn = prefix_shape, prefix_names
    defs = {
        "router": ParamDef(ps + (d, e), pn + ("embed", None), scale=0.02),
        "wi": ParamDef(ps + (e, d, ff), pn + ("experts", "embed", "expert_ff")),
        "wg": ParamDef(ps + (e, d, ff), pn + ("experts", "embed", "expert_ff")),
        "wo": ParamDef(ps + (e, ff, d), pn + ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared_wi"] = ParamDef(ps + (d, sff), pn + ("embed", "ff"))
        defs["shared_wg"] = ParamDef(ps + (d, sff), pn + ("embed", "ff"))
        defs["shared_wo"] = ParamDef(ps + (sff, d), pn + ("ff_in", "embed"))
    return defs


def _expert_ffn(p, x):
    """x: (G, E, C, d) -> (G, E, C, d); per-expert SwiGLU."""
    h = torch.einsum("gecd,edf->gecf", x, p["wi"])
    g = torch.einsum("gecd,edf->gecf", x, p["wg"])
    h = swish(g) * h
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def _shared_ffn(p, x):
    h = swish(x @ p["shared_wg"]) * (x @ p["shared_wi"])
    return h @ p["shared_wo"]


def _top_k_routing(logits, top_k: int):
    """Returns (weights (T, k) float32 normalized, idx (T, k) int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(cfg, group_size: int) -> int:
    """Tokens each expert takes from one group (reference :77)."""
    return max(int(cfg.top_k * group_size / cfg.n_experts
                   * cfg.capacity_factor), 1)


def group_size(cfg, t: int) -> int:
    """Tokens of a dispatch group when ``t`` tokens are dispatched (a short
    batch shrinks the group)."""
    return min(cfg.moe_group_size, t)


def group_tokens(xf, gs: int):
    """Tokens xf (n, d) as (ceil(n / gs), gs, d) groups, the last padded
    with zeros."""
    n, d = xf.shape
    pad = (-n) % gs
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))], dim=0)
    return xf.view(-1, gs, d)


def route(p, xt, cfg, t: int, first: int = 0):
    """Routing of the grouped tokens xt (ng, gs, d): groups ``first`` ..
    ``first + ng`` of the global token order, whose first ``t`` tokens are
    real.  Returns (weights (ng, gs, k) float32, zero where dropped; idx
    (ng, gs, k); pos_tok (ng, gs, k), each choice's slot in its expert;
    keep (ng, gs, k) bool; cap)."""
    ng, gs, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, gs)
    valid = (torch.arange(first * gs, (first + ng) * gs, device=xt.device)
             < t).view(ng, gs)
    logits = torch.einsum("gsd,de->gse", xt, p["router"])
    weights, idx = _top_k_routing(logits.reshape(ng * gs, e), k)
    weights = weights.view(ng, gs, k) * valid[..., None]
    idx = idx.view(ng, gs, k)
    idx = torch.where(valid[..., None], idx, e - 1)   # park padding
    # position of each (token, choice) within its expert: cumsum over the
    # flattened (token-major, choice-minor) order
    onehot = _one_hot(idx, e, torch.int32) * \
        valid[..., None, None].to(torch.int32)             # (g, s, k, e)
    flat = onehot.view(ng, gs * k, e)
    pos = torch.cumsum(flat, dim=1) - 1                    # (g, s*k, e)
    pos_tok = (pos * flat).sum(-1).view(ng, gs, k)
    keep = (pos_tok < cap) & (pos_tok >= 0) & valid[..., None]
    return weights * keep, idx, pos_tok, keep, cap


def routed_experts(p, xt, cfg, t: int, *, first: int = 0, experts=None):
    """The routed experts' output (ng, gs, d) of the grouped tokens xt
    (``route``'s ``first`` and ``t``).  ``experts`` = (e0, e1): ``p``'s
    ``wi``/``wg``/``wo`` hold experts e0..e1 alone, so only their capacity
    buffers are built and run and only the choices routed to them
    combined: a part of the output (and of the gradients of xt and the
    router, through the combine weights)."""
    ng, gs, d = xt.shape
    weights, idx, pos_tok, keep, cap = route(p, xt, cfg, t, first)
    e0, e1 = experts or (0, cfg.n_experts)
    n = e1 - e0
    loc = idx - e0                     # each choice's expert among e0..e1
    if cfg.moe_impl == "einsum":
        # GShard dispatch/combine one-hot products.  The reference sums
        # the (g, s, k, e, cap) product over k; a token's k choices go to
        # k distinct experts, so at most one term of each sum is nonzero
        # and the contraction over k gives the same 0/1 table.  A choice
        # of an expert outside e0..e1 has a row of zeros.
        oh_e = _one_hot(loc, n, xt.dtype)
        oh_c = _one_hot(pos_tok, cap, xt.dtype) * keep[..., None]
        disp = torch.einsum("gske,gskc->gsec", oh_e, oh_c)
        disp = shard_act(disp, ("moe_groups", None, "act_experts", None))
        ex_in = torch.einsum("gsec,gsd->gecd", disp, xt)
        ex_out = _expert_ffn(p, ex_in)
        comb = torch.einsum(
            "gske,gskc->gsec",
            _one_hot(loc, n, torch.float32) * weights[..., None],
            _one_hot(pos_tok, cap, torch.float32) * keep[..., None])
        return torch.einsum("gsec,gecd->gsd", comb.to(xt.dtype), ex_out)
    # gather dispatch: a (g, e, cap) source-token table by scatter, then
    # gathers.  Dropped choices, and those of experts outside e0..e1,
    # write the trash slot ``cap``.
    k = idx.shape[-1]
    mine = (loc >= 0) & (loc < n)
    loc = torch.where(mine, loc, 0)
    tok = torch.arange(gs, device=xt.device)[None, :, None].expand(ng, gs, k)
    safe_pos = torch.where(keep & mine, pos_tok, cap)
    src = torch.zeros((ng, n * (cap + 1)), dtype=torch.long, device=xt.device)
    src.scatter_(1, (loc * (cap + 1) + safe_pos).view(ng, gs * k),
                 tok.reshape(ng, gs * k))
    src = src.view(ng, n, cap + 1)[..., :cap].reshape(ng, n * cap)
    ex_in = torch.gather(xt, 1, src[..., None].expand(ng, n * cap, d))
    ex_in = shard_act(ex_in.view(ng, n, cap, d),
                      ("moe_groups", "act_experts", None, None))
    ex_out = _expert_ffn(p, ex_in)
    # combine: gather each token's k expert outputs from the buffer
    slot = loc * cap + torch.clamp(pos_tok, max=cap - 1)
    gathered = torch.gather(ex_out.reshape(ng, n * cap, d), 1,
                            slot.view(ng, gs * k, 1).expand(-1, -1, d))
    weights = torch.where(mine, weights, 0.0)
    return (gathered.view(ng, gs, k, d)
            * weights[..., None].to(xt.dtype)).sum(2)


def moe_ffn(p, x, cfg):
    """x: (B, S, d) -> (B, S, d).  Groups of ``moe_group_size`` tokens are
    dispatched independently (bounds the dispatch tensor)."""
    b, s, d = x.shape
    t = b * s
    xt = shard_act(group_tokens(x.reshape(t, d), group_size(cfg, t)),
                   ("moe_groups", None, None))
    out = routed_experts(p, xt, cfg, t)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, xt)
    return out.reshape(-1, d)[:t].reshape(b, s, d)
