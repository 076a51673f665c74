"""Recurrent sequence mixers, ported from ``repro/nn/recurrent.py``:

* RG-LRU (Griffin / RecurrentGemma, arXiv:2402.19427) — a gated diagonal
  linear recurrence, run over the sequence as a log-depth scan;
* mLSTM (xLSTM, arXiv:2405.04517) — matrix memory with exponential gating,
  chunkwise-parallel over the sequence (a loop over chunks carrying
  (C, n, m)) for train and prefill, and a single-step form for decode;
* sLSTM — scalar memory with block-diagonal recurrent weights, a loop over
  time.

Every state update computes in float32 whatever the activation dtype, as
the reference's casts do.  The functions are pure, as the reference's:
they return new states, which ``models/lm.py`` copies into the cache.
"""
from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F

from .layers import ParamDef, swish


# ---------------------------------------------------------------------------
# generic first-order linear recurrence h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def _slice(x, axis: int, start: int, stop, step: int = 1):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a, b, axis: int):
    """[a0, b0, a1, b1, ...] along ``axis``; a has as many elements as b or
    one more."""
    n = b.shape[axis]
    pairs = torch.stack([_slice(a, axis, 0, n), b], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, _slice(a, axis, n, None)], dim=axis)
    return out


def _associative_scan(a, b, axis: int):
    """Inclusive scan of (a, b) pairs under (a1, b1) o (a2, b2) =
    (a1 a2, b1 a2 + b2), in the odd/even recursion of
    ``jax.lax.associative_scan``: log depth, O(S) work, and the same
    order of products and sums as the reference's."""
    n = a.shape[axis]
    if n < 2:
        return a, b

    def combine(x, y):
        return x[0] * y[0], x[1] * y[0] + y[1]

    odd = combine((_slice(a, axis, 0, n - 1, 2), _slice(b, axis, 0, n - 1, 2)),
                  (_slice(a, axis, 1, None, 2), _slice(b, axis, 1, None, 2)))
    odd = _associative_scan(*odd, axis)
    rest = (_slice(a, axis, 2, None, 2), _slice(b, axis, 2, None, 2))
    if n % 2 == 0:
        even = combine(tuple(_slice(e, axis, 0, -1) for e in odd), rest)
    else:
        even = combine(odd, rest)
    even = tuple(torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
                 for e, r in zip((a, b), even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def linear_scan(a, b, h0=None, axis: int = 1):
    """Scan for h_t = a_t h_{t-1} + b_t (all (..., S, D))."""
    if h0 is not None:
        # fold the carried state into the first step
        b0 = _slice(b, axis, 0, 1) + _slice(a, axis, 0, 1) * \
            h0.unsqueeze(axis)
        b = torch.cat([b0, _slice(b, axis, 1, None)], dim=axis)
    return _associative_scan(a, b, axis)[1]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_defs(d_model: int, d_rnn: int, conv_width: int,
               prefix_shape=(), prefix_names=()) -> dict:
    ps, pn = prefix_shape, prefix_names
    return {
        "w_x": ParamDef(ps + (d_model, d_rnn), pn + ("embed", "rnn")),
        "w_gate": ParamDef(ps + (d_model, d_rnn), pn + ("embed", "rnn")),
        "w_out": ParamDef(ps + (d_rnn, d_model), pn + ("rnn", "embed")),
        "conv_w": ParamDef(ps + (conv_width, d_rnn), pn + (None, "rnn"),
                           scale=0.5),
        "w_a": ParamDef(ps + (d_rnn, d_rnn), pn + ("rnn", "rnn"), scale=0.02),
        "w_i": ParamDef(ps + (d_rnn, d_rnn), pn + ("rnn", "rnn"), scale=0.02),
        "lam": ParamDef(ps + (d_rnn,), pn + ("rnn",), init="ones"),
    }


def causal_conv1d(u, w, state=None):
    """u: (B, S, D); w: (W, D) depthwise causal conv.  ``state``: (B, W-1, D)
    trailing inputs from the previous segment (decode); returns (y,
    new_state)."""
    width = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], width - 1, u.shape[2]))
    ext = torch.cat([state.to(u.dtype), u], dim=1)     # (B, S+W-1, D)
    s = u.shape[1]
    y = sum(ext[:, i:i + s, :] * w[i] for i in range(width))
    return y.to(u.dtype), ext[:, ext.shape[1] - (width - 1):, :]


def rglru(u, p, h0=None, u_all=None, cols=None):
    """u: (B, S, dr) post-conv recurrence-branch input.  Returns (h,
    h_last), h_last in float32.  Where the model axis splits the channels,
    ``u``, ``h0`` and ``p["lam"]`` are this rank's slice ``cols`` of them
    and ``u_all`` (B, S, dr) is every channel's input: the gates' (dr, dr)
    products take all of its channels and their columns ``cols``.  The
    slice's own input is then read back from ``u_all``, after the gates,
    so that its gradient sums in the order of one device's."""
    gf = (u if u_all is None else u_all).float()
    w_a, w_i = p["w_a"], p["w_i"]
    if cols is not None:
        w_a, w_i = w_a[:, cols], w_i[:, cols]
    r = torch.sigmoid(gf @ w_a.float())
    i = torch.sigmoid(gf @ w_i.float())
    log_a = -_RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    uf = u.float() if u_all is None else u_all[..., cols].float()
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * uf)
    h = linear_scan(a, gated, h0=None if h0 is None else h0.float())
    return h.to(u.dtype), h[:, -1, :]


def rglru_block(p, x, cfg, cache=None, split=None):
    """Griffin recurrent block: gate branch * (conv -> RG-LRU) branch.
    cache: dict(h=(B, dr), conv=(B, W-1, dr)) or None (train).  Returns
    (y, new_cache).  ``split``, where the model axis splits the channels
    (``p``'s channel leaves and ``cache`` hold this rank's slice): a
    function of the slice's post-conv u giving (every channel's u, the
    slice's columns) for :func:`rglru`; y is then the slice's part of the
    output, which the caller sums over the axis."""
    gate = swish(x @ p["w_gate"])
    u = x @ p["w_x"]
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv1d(u, p["conv_w"], conv_state)
    h0 = cache["h"] if cache is not None else None
    u_all, cols = (None, None) if split is None else split(u)
    h, h_last = rglru(u, p, h0=h0, u_all=u_all, cols=cols)
    y = (h * gate) @ p["w_out"]
    return y, {"h": h_last.to(x.dtype), "conv": new_conv}


# ---------------------------------------------------------------------------
# mLSTM (chunkwise-parallel) — per-head matrix memory
# ---------------------------------------------------------------------------

def mlstm_defs(cfg, prefix_shape=(), prefix_names=()) -> dict:
    d = cfg.d_model
    di = int(cfg.proj_factor * d)
    h = cfg.n_heads
    ps, pn = prefix_shape, prefix_names
    return {
        "w_up": ParamDef(ps + (d, di), pn + ("embed", "ff")),
        "w_gate": ParamDef(ps + (d, di), pn + ("embed", "ff")),
        "conv_w": ParamDef(ps + (4, di), pn + (None, "ff"), scale=0.5),
        "wq": ParamDef(ps + (di, di), pn + ("ff_in", "ff")),
        "wk": ParamDef(ps + (di, di), pn + ("ff_in", "ff")),
        "wv": ParamDef(ps + (di, di), pn + ("ff_in", "ff")),
        "w_if": ParamDef(ps + (d, 2 * h), pn + ("embed", None), scale=0.02),
        "b_if": ParamDef(ps + (2 * h,), pn + (None,), init="zeros"),
        "hnorm": ParamDef(ps + (di,), pn + ("ff",), init="ones"),
        "w_down": ParamDef(ps + (di, d), pn + ("ff_in", "embed")),
    }


def _chunk_whole(qf, kf, i_gate, lf, n_prev, m_prev, scale: float):
    """The part of one chunk that holds no value dim, which every rank
    computes alike where the model axis splits C's value dim: the decayed
    scores s (B, H, L, L), the inter-chunk decay (B, H, L), the normaliser
    max(|den|, exp(-m_t)) (B, H, L), the state update's weights w_tau
    (B, H, L) and decay (B, H), and the new (n, m)."""
    L = qf.shape[-2]
    b_cum = torch.cumsum(lf, dim=-1)                      # (B, H, L)
    # stabilizer: m_t = B_t + max(m_prev, max_{tau<=t}(i_tau - B_tau))
    a_run = torch.cummax(i_gate - b_cum, dim=-1).values
    m_t = b_cum + torch.maximum(m_prev[..., None], a_run)
    # intra-chunk decay D[t, tau] = i_tau + B_t - B_tau - m_t (tau <= t)
    dmat = (i_gate[:, :, None, :] + b_cum[:, :, :, None]
            - b_cum[:, :, None, :] - m_t[..., None])
    mask = torch.ones((L, L), dtype=torch.bool, device=qf.device).tril()
    # exp after the mask (the reference takes it before): the same values,
    # but exp(dmat) above the diagonal overflows to inf in long chunks
    # (the decay grows with the distance), and the where's gradient there,
    # 0 x inf, is NaN in every gate
    dexp = torch.exp(torch.where(mask, dmat, -math.inf))
    del dmat
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale * dexp
    del dexp
    inter_decay = torch.exp(b_cum + m_prev[..., None] - m_t)   # (B, H, L)
    den = s.sum(-1) + inter_decay * torch.einsum(
        "bhtd,bhd->bht", qf, n_prev) * scale
    norm = torch.maximum(torch.abs(den), torch.exp(-m_t))
    # state update to the end of the chunk
    m_new = m_t[..., -1]
    w_tau = torch.exp(i_gate + b_cum[..., -1:] - b_cum - m_new[..., None])
    decay = torch.exp(b_cum[..., -1] + m_prev - m_new)
    n_new = decay[..., None] * n_prev + torch.einsum("bhs,bhsd->bhd", w_tau,
                                                     kf)
    return s, inter_decay, norm, w_tau, decay, (n_new, m_new)


def _mlstm_chunk(q, k, v, i_gate, lf, state):
    """One chunk, all heads.  q, k, v: (B, H, L, dk|dv); i_gate/lf: (B, H, L)
    (input gate pre-activation, log-sigmoid forget).  state: (C, n, m) with
    C (B, H, dk, dv), n (B, H, dk), m (B, H).  Returns (h, new_state).  v,
    C and h may hold a slice of the value dim (a model-axis split): the
    rest (:func:`_chunk_whole`) does not depend on it."""
    dk = q.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    qf, kf, vf = q.float(), k.float(), v.float()
    c_prev, n_prev, m_prev = state
    s, inter_decay, norm, w_tau, decay, (n_new, m_new) = _chunk_whole(
        qf, kf, i_gate, lf, n_prev, m_prev, scale)
    num = torch.einsum("bhts,bhsv->bhtv", s, vf) + \
        inter_decay[..., None] * torch.einsum(
            "bhtd,bhdv->bhtv", qf, c_prev) * scale
    del s
    h = num / norm[..., None]
    c_new = decay[..., None, None] * c_prev + torch.einsum(
        "bhsd,bhsv->bhdv", w_tau[..., None] * kf, vf)
    return h, (c_new, n_new, m_new)


def mlstm_sequence(q, k, v, i_gate, lf, state=None, chunk: int = 256):
    """Chunkwise mLSTM over a full sequence.  q, k, v: (B, S, H, dk); gates
    (B, S, H).  Returns (h (B, S, H, dv), final_state).  S must be a
    multiple of ``min(chunk, S)``, as the reference asserts: nothing is
    padded."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = (q.new_zeros((B, H, dk, dv), dtype=torch.float32),
                 q.new_zeros((B, H, dk), dtype=torch.float32),
                 q.new_zeros((B, H), dtype=torch.float32))
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mLSTM sequence of {S} is no multiple of its "
                         f"chunk {chunk}")
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, state = _mlstm_chunk(
            q[:, sl].transpose(1, 2), k[:, sl].transpose(1, 2),
            v[:, sl].transpose(1, 2), i_gate[:, sl].transpose(1, 2),
            lf[:, sl].transpose(1, 2), state)
        hs.append(h.transpose(1, 2))                    # (B, L, H, dv)
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    return h.to(q.dtype), state


def _step_whole(qf, kf, i_gate, lf, n_prev, m_prev, scale: float):
    """The part of a decode step that holds no value dim (every rank's
    alike under a split of it, as :func:`_chunk_whole`): the input and
    forget weights (B, H), the normaliser (B, H) and the new (n, m)."""
    m_new = torch.maximum(lf + m_prev, i_gate)
    i_p = torch.exp(i_gate - m_new)
    f_p = torch.exp(lf + m_prev - m_new)
    n_new = f_p[..., None] * n_prev + i_p[..., None] * kf
    den = torch.einsum("bhd,bhd->bh", qf, n_new) * scale
    norm = torch.maximum(torch.abs(den), torch.exp(-m_new))
    return i_p, f_p, norm, (n_new, m_new)


def mlstm_step(q, k, v, i_gate, lf, state):
    """Single decode step.  q, k, v: (B, H, dk|dv); gates (B, H).  v, C
    and h may hold a slice of the value dim, as in :func:`_mlstm_chunk`."""
    c_prev, n_prev, m_prev = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf = q.float(), k.float()
    i_p, f_p, norm, (n_new, m_new) = _step_whole(qf, kf, i_gate, lf, n_prev,
                                                 m_prev, scale)
    c_new = f_p[..., None, None] * c_prev + i_p[..., None, None] * \
        torch.einsum("bhd,bhv->bhdv", kf, v.float())
    num = torch.einsum("bhd,bhdv->bhv", qf, c_new) * scale
    h = num / norm[..., None]
    return h.to(q.dtype), (c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM — sequential loop with block-diagonal recurrent weights
# ---------------------------------------------------------------------------

def slstm_defs(cfg, prefix_shape=(), prefix_names=()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    ps, pn = prefix_shape, prefix_names
    dff = int(4 * d / 3 // 64 * 64) or d
    return {
        "w_in": ParamDef(ps + (d, 4 * d), pn + ("embed", "ff")),     # z,i,f,o
        "r": ParamDef(ps + (4, h, dh, dh), pn + (None, "heads", None, None),
                      scale=0.02),
        "b": ParamDef(ps + (4 * d,), pn + (None,), init="zeros"),
        "up": ParamDef(ps + (d, dff), pn + ("embed", "ff")),
        "down": ParamDef(ps + (dff, d), pn + ("ff_in", "embed")),
    }


def slstm_state(batch: int, d: int, device):
    """The initial (c, n, h, m), as the reference's."""
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return z, z + 1e-6, z.clone(), z - 10.0


# runs ``run_steps``' loops in its place where set: ``launch/analysis.py``
# counts a loop of identical steps as one step times its trip count
STEPS_HOOK: contextvars.ContextVar = contextvars.ContextVar("steps_hook",
                                                           default=None)


def run_steps(step, carry: tuple, xs, consts: tuple):
    """``carry, y = step(carry, xs[:, t], *consts)`` for each t along dim 1
    of ``xs``: the final carry and the ys stacked along dim 1 (the
    reference's ``lax.scan`` over time)."""
    hook = STEPS_HOOK.get()
    if hook is not None:
        return hook(step, carry, xs, consts)
    ys = []
    for t in range(xs.shape[1]):
        carry, y = step(carry, xs[:, t], *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _slstm_step(state, pre_t, r):
    """One sLSTM step: state (c, n, h, m), each (B, d); pre_t (B, 4d) the
    input projection; r (4, H, dh, dh) the block-diagonal recurrence."""
    c, n, h, m = state
    b, d = h.shape
    n_heads, dh = r.shape[1], r.shape[2]
    hh = h.reshape(b, n_heads, dh)
    rec = torch.einsum("bhd,ghde->bghe", hh, r).reshape(b, 4 * d)
    g = pre_t.float() + rec
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h = ot * c / torch.clamp(n, min=1e-6)
    return (c, n, h, m_new), h


def slstm_sequence(p, x, n_heads: int, state=None):
    """x: (B, S, d).  Returns (h_seq (B, S, d), final_state).
    ``n_heads`` (the reference's argument) is ``p["r"]``'s second dim."""
    B, S, d = x.shape
    pre = x @ p["w_in"] + p["b"]                      # (B, S, 4d)
    if state is None:
        state = slstm_state(B, d, x.device)
    r = p["r"].float()                                # (4, H, dh, dh)
    state, hs = run_steps(_slstm_step, tuple(state), pre, (r,))
    return hs.to(x.dtype), state
