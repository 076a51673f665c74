"""The port's moe, hybrid, ssm, audio and vlm LM families against the
reference's (CPU).

Weights are made with numpy from a seed (normal leaves scaled as the
reference's init, ones and zeros drawn around 1 and 0 so that they matter)
and handed to both packages: as jnp arrays to ``repro`` and through
``repro_torch.convert.convert_lm_params`` to the port.  Float32 results
agree to 1e-5 (rtol and atol) unless a test states otherwise: both sum
float32 products in other orders, nothing else differs.  The port's
decode attends through ``flash_decode`` (its plain version on the CPU),
the reference's through ``gqa_attention`` with a ``kv_pos`` mask.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.nn import moe as jmoe
from repro.nn import recurrent as jrec

from repro_torch import configs
from repro_torch.convert import convert_lm_cache, convert_lm_params
from repro_torch.kernels.decode_attn import decode_attn as decode_mod
from repro_torch.models import lm
from repro_torch.nn import layers, moe, recurrent
from repro_torch.train.serve import make_decode_step, make_prefill_step

FAMILY_ARCHS = ["deepseek-moe-16b", "dbrx-132b", "recurrentgemma-9b",
                "xlstm-1.3b", "whisper-base", "llava-next-mistral-7b"]
SMOKE = [a + "-smoke" for a in FAMILY_ARCHS]
RTOL = ATOL = 1e-5
B, S = 2, 12


def _draw(defs, rng):
    """numpy float32 arrays for a tree of reference ParamDefs."""
    def mk(d):
        if d.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.standard_normal(d.shape)
        else:
            fan_in = d.shape[0] if len(d.shape) == 1 else int(
                np.prod(d.shape[:-1]))
            if len(d.shape) >= 2 and d.names[0] == "layers":
                fan_in = int(np.prod(d.shape[1:-1])) or 1
            std = d.scale if d.scale is not None else fan_in ** -0.5
            a = std * rng.standard_normal(d.shape)
        return a.astype(np.float32)

    return jax.tree.map(mk, defs,
                        is_leaf=lambda x: isinstance(x, jlayers.ParamDef))


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_config(arch), **kw),
            dataclasses.replace(jconfigs.get_config(arch), **kw))


def _both(jcfg, cfg, seed=0):
    """(reference params, port params) holding the same numpy weights."""
    tree = _draw(jlm.model_defs(jcfg), np.random.default_rng(seed))
    jdt = jnp.dtype(jcfg.dtype)
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), tree),
            convert_lm_params(tree, cfg, device="cpu"))


def _inputs(cfg, seed, s=S):
    """numpy inputs: tokens, and stub frames or patches (from the seed)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _prefix(cfg):
    return cfg.n_patches if cfg.family == "vlm" else 0


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, exp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(exp), rtol=rtol, atol=atol)


def _cache_close(cache, jcache):
    """Every leaf of the two caches (keys sorted, as ``jax.tree.leaves``):
    integer leaves equal, float leaves within the tolerance."""
    jl, tl = jax.tree.leaves(jcache["stacks"]), layers.leaves(
        cache["stacks"])
    assert len(jl) == len(tl)
    for got, exp in zip(tl, jl):
        assert tuple(got.shape) == exp.shape
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        else:
            _close(got, exp)
    assert cache["pos"] == int(jcache["pos"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _ref_keep(jcfg, jp, x):
    """The reference's kept (token, choice) pairs and their expert slots,
    from its routing (``_top_k_routing``) and the dispatch order of
    ``moe_ffn`` (token-major, choice-minor, per group), in numpy."""
    b, s, d = x.shape
    t = b * s
    gs = min(jcfg.moe_group_size, t)
    pad = (-t) % gs
    xf = np.concatenate([x.reshape(t, d), np.zeros((pad, d), np.float32)])
    ng, e, k = (t + pad) // gs, jcfg.n_experts, jcfg.top_k
    cap = max(int(k * gs / e * jcfg.capacity_factor), 1)
    _, idx = jmoe._top_k_routing(jnp.asarray(xf) @ jp["router"], k)
    idx = np.asarray(idx).reshape(ng, gs, k)
    valid = (np.arange(t + pad) < t).reshape(ng, gs)
    keep = np.zeros((ng, gs, k), bool)
    pos = np.zeros((ng, gs, k), np.int64)
    for g in range(ng):
        fill = np.zeros(e, np.int64)
        for tok in range(gs):
            for c in range(k):
                if valid[g, tok]:
                    pos[g, tok, c] = fill[idx[g, tok, c]]
                    fill[idx[g, tok, c]] += 1
                    keep[g, tok, c] = pos[g, tok, c] < cap
    return keep, idx, pos


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b-smoke",
                                  "dbrx-132b-smoke"])
def test_moe_ffn_vs_reference(arch, impl):
    """Default capacity factor, 26 tokens in groups of 16 (the last group
    padded): tokens are dropped, and the dropped set is the reference's."""
    cfg, jcfg = _cfgs(arch, moe_impl=impl)
    tree = _draw(jmoe.moe_defs(jcfg), np.random.default_rng(1))
    jp = jax.tree.map(jnp.asarray, tree)
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    x = np.random.default_rng(2).standard_normal((2, 13, cfg.d_model)).astype(
        np.float32)
    exp = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    _close(got, exp)

    keep, idx, pos = _ref_keep(jcfg, jp, x)
    xt = torch.cat([torch.from_numpy(x).reshape(26, -1),
                    torch.zeros(6, cfg.d_model)]).view(2, 16, -1)
    weights, t_idx, t_pos, t_keep, cap = moe.route(p, xt, cfg, 26)
    assert cap == moe.capacity(cfg, 16)
    valid = (np.arange(32) < 26).reshape(2, 16)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_idx.numpy()[valid], idx[valid])
    np.testing.assert_array_equal(t_pos.numpy()[t_keep.numpy()], pos[keep])
    assert (~keep[valid]).any() and keep[valid].any()    # some dropped
    assert (t_idx.numpy()[~valid] == cfg.n_experts - 1).all()
    assert (weights.numpy()[~keep] == 0).all()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b-smoke",
                                  "dbrx-132b-smoke"])
def test_routed_experts_by_groups_and_experts(arch, impl):
    """The mesh's splits of the routed experts (``models/lm.py::_moe``):
    groups 1..3 of 58 tokens in 4 groups of 16 (the last padded), dispatched
    alone with ``first=1``, give those groups' rows of the whole dispatch
    bit for bit; the experts split in two halves, each with its own
    ``wi``/``wg``/``wo`` and the whole router, give parts that sum to the
    whole output (float32, within 1e-6 of its largest magnitude)."""
    cfg, jcfg = _cfgs(arch, moe_impl=impl)
    tree = _draw(jmoe.moe_defs(jcfg), np.random.default_rng(5))
    p = {k: torch.from_numpy(v) for k, v in tree.items()}
    t, gs, e = 58, cfg.moe_group_size, cfg.n_experts
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (t, cfg.d_model)).astype(np.float32))
    xt = moe.group_tokens(x, gs)
    assert xt.shape[0] == 4
    whole = moe.routed_experts(p, xt, cfg, t)
    torch.testing.assert_close(
        moe.routed_experts(p, xt[1:], cfg, t, first=1), whole[1:], rtol=0,
        atol=0)
    halves = []
    for e0, e1 in ((0, e // 2), (e // 2, e)):
        mine = {k: v[e0:e1] if k in ("wi", "wg", "wo") else v
                for k, v in p.items()}
        halves.append(moe.routed_experts(mine, xt, cfg, t,
                                         experts=(e0, e1)))
    assert all(float(h.abs().max()) > 0 for h in halves)
    scale = float(whole.abs().max())
    torch.testing.assert_close(halves[0] + halves[1], whole, rtol=0,
                               atol=1e-6 * scale)


def test_moe_impls_agree_in_bf16():
    """Both dispatch implementations route the same tokens to the same
    slots, so in bf16 they agree to the combine's rounding."""
    cfg = dataclasses.replace(configs.get_config("deepseek-moe-16b-smoke"),
                              dtype="bfloat16")
    tree = _draw(jmoe.moe_defs(jconfigs.get_config(
        "deepseek-moe-16b-smoke")), np.random.default_rng(3))
    p = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out = [moe.moe_ffn(p, x, dataclasses.replace(cfg, moe_impl=impl))
           for impl in ("einsum", "gather")]
    assert out[0].dtype == torch.bfloat16
    _close(out[0], out[1], rtol=2e-2, atol=2e-2 * float(
        out[1].float().abs().max()))


# ---------------------------------------------------------------------------
# recurrent cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_vs_reference(s, with_h0):
    """The port walks the reference's odd/even recursion; held at the
    reference's scan tolerance (tests/test_substrate.py), 1e-5."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.1, 0.99, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32) if with_h0 else None
    exp = jrec.linear_scan(jnp.asarray(a), jnp.asarray(b),
                           h0=None if h0 is None else jnp.asarray(h0))
    got = recurrent.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                h0=None if h0 is None else
                                torch.from_numpy(h0))
    _close(got, exp)
    h = np.zeros((2, 5), np.float32) if h0 is None else h0
    for t in range(s):                    # the sequential recurrence
        h = a[:, t] * h + b[:, t]
    _close(got[:, -1], h)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_vs_reference(with_state):
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if with_state else None
    ey, es = jrec.causal_conv1d(jnp.asarray(u), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    gy, gs = recurrent.causal_conv1d(torch.from_numpy(u), torch.from_numpy(w),
                                     None if st is None else
                                     torch.from_numpy(st))
    _close(gy, ey)
    _close(gs, es)


def _rec_params(jdefs, seed):
    tree = _draw(jdefs, np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, tree),
            layers.map_defs(torch.from_numpy, tree))


@pytest.mark.parametrize("with_cache", [False, True])
def test_rglru_block_vs_reference(with_cache):
    cfg = configs.get_config("recurrentgemma-9b-smoke")
    jp, p = _rec_params(jrec.rglru_defs(64, 64, 4), 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    cache = {"h": rng.standard_normal((2, 64)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)} \
        if with_cache else None
    ey, ec = jrec.rglru_block(jp, jnp.asarray(x), cfg, None if cache is None
                              else jax.tree.map(jnp.asarray, cache))
    gy, gc = recurrent.rglru_block(p, torch.from_numpy(x), cfg,
                                   None if cache is None else
                                   layers.map_defs(torch.from_numpy, cache))
    _close(gy, ey)
    for name in ("h", "conv"):
        _close(gc[name], ec[name])


def _mlstm_inputs(rng, s, h=2, dk=8):
    q = rng.standard_normal((2, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((2, s, h, dk)).astype(np.float32) / np.sqrt(dk)
    v = rng.standard_normal((2, s, h, dk)).astype(np.float32)
    ig = rng.standard_normal((2, s, h)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(
        rng.standard_normal((2, s, h)).astype(np.float32)))
    state = (rng.standard_normal((2, h, dk, dk)).astype(np.float32),
             rng.standard_normal((2, h, dk)).astype(np.float32),
             rng.standard_normal((2, h)).astype(np.float32))
    return (q, k, v, ig, lf), state


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_sequence_vs_reference(chunk, with_state):
    """Chunks of 4 over 16 positions (four chunks, the state carried) and
    one chunk; 1e-5."""
    arrays, state = _mlstm_inputs(np.random.default_rng(8), 16)
    eh, es = jrec.mlstm_sequence(*map(jnp.asarray, arrays),
                                 state=tuple(map(jnp.asarray, state))
                                 if with_state else None, chunk=chunk)
    gh, gs = recurrent.mlstm_sequence(
        *map(torch.from_numpy, arrays),
        state=tuple(map(torch.from_numpy, state)) if with_state else None,
        chunk=chunk)
    _close(gh, eh)
    for g, e in zip(gs, es):
        _close(g, e)


def test_mlstm_sequence_needs_whole_chunks():
    arrays, _ = _mlstm_inputs(np.random.default_rng(9), 10)
    with pytest.raises(ValueError, match="chunk"):
        recurrent.mlstm_sequence(*map(torch.from_numpy, arrays), chunk=4)


def test_mlstm_step_vs_reference():
    arrays, state = _mlstm_inputs(np.random.default_rng(10), 1)
    step = [a[:, 0] for a in arrays]
    eh, es = jrec.mlstm_step(*map(jnp.asarray, step),
                             tuple(map(jnp.asarray, state)))
    gh, gs = recurrent.mlstm_step(*map(torch.from_numpy, step),
                                  tuple(map(torch.from_numpy, state)))
    _close(gh, eh)
    for g, e in zip(gs, es):
        _close(g, e)


def test_mlstm_chunks_equal_steps():
    """The port's chunkwise form against its own step form over 16
    positions, at the reference's tolerance for that pair
    (tests/test_substrate.py): 2e-4."""
    arrays, _ = _mlstm_inputs(np.random.default_rng(11), 16)
    q, k, v, ig, lf = map(torch.from_numpy, arrays)
    h_chunk, final = recurrent.mlstm_sequence(q, k, v, ig, lf, chunk=4)
    state = (torch.zeros(2, 2, 8, 8), torch.zeros(2, 2, 8), torch.zeros(2, 2))
    outs = []
    for t in range(16):
        h_t, state = recurrent.mlstm_step(q[:, t], k[:, t], v[:, t],
                                          ig[:, t], lf[:, t], state)
        outs.append(h_t)
    _close(h_chunk, torch.stack(outs, 1), rtol=2e-4, atol=2e-4)
    _close(final[0], state[0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_sequence_vs_reference(with_state):
    cfg = configs.get_config("xlstm-1.3b-smoke")
    jp, p = _rec_params(jrec.slstm_defs(cfg), 12)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = tuple(rng.standard_normal((2, cfg.d_model)).astype(np.float32)
                      for _ in range(4))
        state = (state[0], np.abs(state[1]) + 0.5, state[2], state[3])
    eh, es = jrec.slstm_sequence(jp, jnp.asarray(x), cfg.n_heads,
                                 None if state is None
                                 else tuple(map(jnp.asarray, state)))
    gh, gs = recurrent.slstm_sequence(p, torch.from_numpy(x), cfg.n_heads,
                                      None if state is None else
                                      tuple(map(torch.from_numpy, state)))
    _close(gh, eh)
    for g, e in zip(gs, es):
        _close(g, e)


# ---------------------------------------------------------------------------
# whole families against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_pattern_stacks_equal_reference(arch):
    for name in (arch, arch + "-smoke"):
        assert lm.pattern_stacks(configs.get_config(name)) == \
            jlm.pattern_stacks(jconfigs.get_config(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE)
def test_init_cache_equal_reference(arch, dtype):
    """Keys, shapes, dtypes and initial values, leaf by leaf (sLSTM's
    n = 1e-6 and m = -10, kv_pos = -1)."""
    cfg, jcfg = _cfgs(arch, dtype=dtype)
    jc = jlm.init_cache(jcfg, B, 20)
    tc = lm.init_cache(cfg, B, 20, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jc["stacks"])) == \
        jax.tree.structure(layers.map_defs(lambda _: 0, tc["stacks"]))
    for got, exp in zip(layers.leaves(tc["stacks"]),
                        jax.tree.leaves(jc["stacks"])):
        assert str(got.dtype).split(".")[-1] == str(exp.dtype)
        np.testing.assert_array_equal(_np(got), _np(exp))
    assert tc["pos"] == 0


CASES = SMOKE + ["deepseek-moe-16b-smoke/gather"]


@pytest.mark.parametrize("case", CASES)
def test_train_prefill_and_greedy_decode_vs_reference(case):
    """Train-mode logits, then prefill and 4 greedy decode steps: logits,
    tokens and every cache leaf equal to the reference's at 1e-5."""
    arch, _, impl = case.partition("/")
    cfg, jcfg = _cfgs(arch, moe_impl=impl or "einsum")
    jparams, params = _both(jcfg, cfg)
    inp = _inputs(cfg, 1)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    _close(lm.forward(params, tin, cfg, "train"),
           jlm.forward(jparams, jin, jcfg, "train"))

    max_seq = S + _prefix(cfg) + 8
    jlg, jcache = jlm.forward(jparams, jin, jcfg, "prefill",
                              jlm.init_cache(jcfg, B, max_seq))
    cache = lm.init_cache(cfg, B, max_seq, device="cpu")
    lg, out = lm.forward(params, tin, cfg, "prefill", cache)
    assert out is cache
    _close(lg, jlg)
    _cache_close(cache, jcache)
    for _ in range(4):
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(lg, -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlg, jcache = jlm.forward(jparams, {"tokens": jtok}, jcfg, "decode",
                                  jcache)
        lg, _ = lm.forward(params, {"tokens": tok}, cfg, "decode", cache)
        _close(lg, jlg)
    _cache_close(cache, jcache)


def test_hybrid_ring_wraps_vs_reference():
    """A prompt longer than the local window (20 > 16) fills the ring in
    the reference's order; 6 decode steps then wrap it, overwriting the
    oldest slot each step.  kv_pos equal, logits at 1e-5."""
    arch = "recurrentgemma-9b-smoke"
    cfg, jcfg = _cfgs(arch)
    jparams, params = _both(jcfg, cfg, seed=2)
    toks = _inputs(cfg, 3, s=20)["tokens"]
    max_seq = 40
    jlg, jcache = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                              "prefill", jlm.init_cache(jcfg, B, max_seq))
    cache = lm.init_cache(cfg, B, max_seq, device="cpu")
    lg, _ = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg,
                       "prefill", cache)
    blk = cache["stacks"][0]["2_attn"]
    assert blk["k"].shape[2] == cfg.local_window == 16
    _cache_close(cache, jcache)
    assert blk["kv_pos"][0].tolist() == [16, 17, 18, 19] + list(range(4, 16))
    nxt = _inputs(cfg, 4, s=6)["tokens"]
    for i in range(6):
        jlg, jcache = jlm.forward(jparams, {"tokens": jnp.asarray(
            nxt[:, i:i + 1])}, jcfg, "decode", jcache)
        lg, _ = lm.forward(params, {"tokens": torch.from_numpy(
            nxt[:, i:i + 1])}, cfg, "decode", cache)
        _close(lg, jlg)
    _cache_close(cache, jcache)
    assert blk["kv_pos"][0].tolist() == [16, 17, 18, 19, 20, 21, 22, 23, 24,
                                         25] + list(range(10, 16))


def test_hybrid_ring_wrap_matches_full_forward():
    """Prefill + decode through a wrapped ring equal the port's own full
    (train mode) forward, whose local attention masks by position."""
    cfg = configs.get_config("recurrentgemma-9b-smoke")
    params = lm.init_model(cfg, 5, device="cpu")
    toks = torch.from_numpy(_inputs(cfg, 6, s=26)["tokens"])
    full = lm.forward(params, {"tokens": toks}, cfg, "train")
    cache = lm.init_cache(cfg, B, 40, device="cpu")
    lm.forward(params, {"tokens": toks[:, :20]}, cfg, "prefill", cache)
    for i in range(20, 26):
        lg, _ = lm.forward(params, {"tokens": toks[:, i:i + 1]}, cfg,
                           "decode", cache)
        _close(lg, full[:, i], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_from_converted_reference_cache(arch):
    """Both packages decode from the same reference-made cache, recurrent
    states included; the converter checks the tree against the config."""
    cfg, jcfg = _cfgs(arch)
    jparams, params = _both(jcfg, cfg, seed=4)
    inp = _inputs(cfg, 5)
    max_seq = S + _prefix(cfg) + 4
    _, jcache = jlm.forward(jparams, {k: jnp.asarray(v) for k, v in
                                      inp.items()}, jcfg, "prefill",
                            jlm.init_cache(jcfg, B, max_seq))
    cache = convert_lm_cache(jcache, cfg, device="cpu")
    _cache_close(cache, jcache)
    nxt = _inputs(cfg, 6, s=1)["tokens"]
    for _ in range(2):
        jlg, jcache = jlm.forward(jparams, {"tokens": jnp.asarray(nxt)}, jcfg,
                                  "decode", jcache)
        lg, _ = lm.forward(params, {"tokens": torch.from_numpy(nxt)}, cfg,
                           "decode", cache)
        _close(lg, jlg)
    _cache_close(cache, jcache)


def test_convert_cache_rejects_other_tree():
    cfg, jcfg = _cfgs("xlstm-1.3b-smoke")
    jcache = jlm.init_cache(jcfg, B, 16)
    other = jlm.init_cache(jconfigs.get_config("recurrentgemma-9b-smoke"), B,
                           16)
    with pytest.raises(ValueError, match="xlstm"):
        convert_lm_cache(other, cfg, device="cpu")
    jcache["stacks"][0]["1_slstm"]["c"] = jnp.zeros((1, B, 3))
    with pytest.raises(ValueError, match="1_slstm/c"):
        convert_lm_cache(jcache, cfg, device="cpu")
    del jcache["stacks"][0]["1_slstm"]["c"]
    with pytest.raises(ValueError, match="1_slstm"):
        convert_lm_cache(jcache, cfg, device="cpu")


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_decode_matches_full_forward(arch):
    """The reference's strongest invariant (tests/test_models.py), on the
    port alone at its tolerance (2e-3, 2e-4), over three decode steps;
    MoE with capacity factor 8, as the reference's test."""
    cfg = configs.get_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = lm.init_model(cfg, 1, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 2,
                                                      s=S + 3).items()}
    full = lm.forward(params, inp, cfg, "train")
    p = _prefix(cfg)
    assert full.shape == (B, p + S + 3, cfg.padded_vocab)
    assert bool(torch.isfinite(full).all())
    cache = lm.init_cache(cfg, B, p + S + 8, device="cpu")
    lm.forward(params, dict(inp, tokens=inp["tokens"][:, :S]), cfg,
               "prefill", cache)
    for i in range(3):
        lg, _ = lm.forward(params, {"tokens": inp["tokens"][:, S + i:
                                                           S + i + 1]},
                           cfg, "decode", cache)
        _close(lg, full[:, p + S + i], rtol=2e-3, atol=2e-4)


def _attention_calls(cfg) -> int:
    """Decode attentions against a cache per step: one per self-attention
    block, two per whisper decoder layer."""
    return sum(ng * sum({"attn": 1, "moe": 1, "xattn": 2}.get(k, 0)
                        for k in pattern)
               for pattern, ng in lm.pattern_stacks(cfg))


ATTENTION = [a for a in SMOKE if not a.startswith("xlstm")]


@pytest.mark.parametrize("arch", ATTENTION)
def test_decode_attends_through_the_kernel_wrapper(arch, monkeypatch):
    """Each decode step calls the flash-decode wrapper once per attention
    against a cache, with the cache's valid length (all frames for
    cross-attention); prefill never does.  On the CPU the wrapper takes the
    plain version, so that is where the calls are counted."""
    calls = []
    real = decode_mod.decode_attn_ref

    def counted(q, k, v, lengths):
        calls.append((tuple(k.shape), lengths.tolist()))
        return real(q, k, v, lengths)

    monkeypatch.setattr(decode_mod, "decode_attn_ref", counted)
    cfg = configs.get_config(arch)
    params = lm.init_model(cfg, 5, device="cpu")
    p = _prefix(cfg)
    max_seq = p + S + 4
    cache = lm.init_cache(cfg, B, max_seq, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 16).items()}
    lm.forward(params, inp, cfg, "prefill", cache)
    assert calls == []
    nxt = torch.from_numpy(_inputs(cfg, 17, s=2)["tokens"])
    for i in range(2):
        lm.forward(params, {"tokens": nxt[:, i:i + 1]}, cfg, "decode", cache)
    n = _attention_calls(cfg)
    assert n > 0 and len(calls) == 2 * n
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    w = min(cfg.local_window, max_seq) if cfg.local_window else max_seq
    self_len = [[min(p + S + 1 + i, w)] * B for i in range(2)]
    for shape, lens in calls:
        assert shape[:2] == (B, kv) and shape[3] == hd
        if shape[2] == cfg.n_audio_frames and cfg.family == "audio":
            assert lens == [cfg.n_audio_frames] * B
        else:
            assert shape[2] == w and lens in self_len


def test_ssm_decode_has_no_attention(monkeypatch):
    """The ssm family has no attention block: its decode never calls the
    kernel wrapper, and its cache holds only recurrent states."""
    calls = []
    monkeypatch.setattr(decode_mod, "decode_attn_ref",
                        lambda *a: calls.append(1))
    cfg = configs.get_config("xlstm-1.3b-smoke")
    params = lm.init_model(cfg, 0, device="cpu")
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    assert all("k" not in blk for st in cache["stacks"] for blk in st.values())
    toks = torch.from_numpy(_inputs(cfg, 0, s=4)["tokens"])
    lm.forward(params, {"tokens": toks}, cfg, "prefill", cache)
    lm.forward(params, {"tokens": toks[:, :1]}, cfg, "decode", cache)
    assert calls == [] and cache["pos"] == 5


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SMOKE)
def test_serve_steps_equal_forward(arch):
    cfg = configs.get_config(arch)
    params = lm.init_model(cfg, 3, device="cpu")
    max_seq = _prefix(cfg) + S + 4
    prefill = make_prefill_step(cfg, B, max_seq, device="cpu")
    decode = make_decode_step(cfg, B, max_seq, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 15,
                                                      s=S + 1).items()}
    pre = dict(inp, tokens=inp["tokens"][:, :S])
    c1 = lm.init_cache(cfg, B, max_seq, device="cpu")
    c2 = lm.init_cache(cfg, B, max_seq, device="cpu")
    lg1, out = prefill(params, c1, pre)
    assert out is c1
    lg2, _ = lm.forward(params, pre, cfg, "prefill", c2)
    assert torch.equal(lg1, lg2)
    lg1, _ = decode(params, c1, inp["tokens"][:, S:])
    lg2, _ = lm.forward(params, {"tokens": inp["tokens"][:, S:]}, cfg,
                        "decode", c2)
    assert torch.equal(lg1, lg2) and c1["pos"] == c2["pos"]
    assert all(torch.equal(a, b) for a, b in zip(
        layers.leaves(c1["stacks"]), layers.leaves(c2["stacks"])))
    with pytest.raises(ValueError, match="cache"):
        decode(params, lm.init_cache(cfg, B + 1, max_seq, device="cpu"),
               inp["tokens"][:, :1])
    with pytest.raises(ValueError, match="cache"):
        other = "qwen3-14b" if cfg.family == "ssm" else "xlstm-1.3b"
        decode(params, lm.init_cache(configs.get_config(other + "-smoke"),
                                     B, max_seq, device="cpu"),
               inp["tokens"][:, :1])
    if cfg.family in ("audio", "vlm"):
        with pytest.raises(ValueError, match="frames|patches"):
            prefill(params, c1, inp["tokens"])


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SMOKE)
def test_bf16_smoke_vs_reference(arch):
    """bf16 weights, activations and cache.  The frameworks round to bf16
    after other operations (XLA fuses casts; torch rounds each op's
    output), so each result carries a few bf16 roundings (2^-8 relative
    each) of difference, compounding over the layers: prefill and one
    decode's logits are held to 0.05 of their largest magnitude, as the
    dense family's (tests/test_torch_lm.py)."""
    cfg, jcfg = _cfgs(arch, dtype="bfloat16")
    jparams, params = _both(jcfg, cfg, seed=12)
    inp = _inputs(cfg, 13)
    max_seq = S + _prefix(cfg) + 4
    jlg, jcache = jlm.forward(jparams, {k: jnp.asarray(v) for k, v in
                                        inp.items()}, jcfg, "prefill",
                              jlm.init_cache(jcfg, B, max_seq))
    cache = lm.init_cache(cfg, B, max_seq, device="cpu")
    lg, _ = lm.forward(params, {k: torch.from_numpy(v) for k, v in
                                inp.items()}, cfg, "prefill", cache)
    assert lg.dtype == torch.bfloat16
    _close(lg, jlg, rtol=0, atol=0.05 * float(np.abs(_np(jlg)).max()))
    nxt = _inputs(cfg, 14, s=1)["tokens"]
    jlg, _ = jlm.forward(jparams, {"tokens": jnp.asarray(nxt)}, jcfg,
                         "decode", jcache)
    lg, _ = lm.forward(params, {"tokens": torch.from_numpy(nxt)}, cfg,
                       "decode", cache)
    assert bool(torch.isfinite(lg).all())
    _close(lg, jlg, rtol=0, atol=0.05 * float(np.abs(_np(jlg)).max()))
