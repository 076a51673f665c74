"""The port's dense-LM serving path against the reference's (CPU).

Weights are made with numpy from a seed (``_numpy_params``: normal leaves
scaled as the reference's init, norm scales and qkv biases drawn around 1
and 0 so that they matter) and handed to both packages: as jnp arrays to
``repro`` and through ``repro_torch.convert.convert_lm_params`` to the
port.  Float32 results agree to 1e-5 (both sum float32 products in other
orders; nothing else differs).  The decode path of the port attends
through ``flash_decode`` (its plain version on the CPU), the reference's
through ``gqa_attention`` with a ``kv_pos`` mask.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import attention as jattention
from repro.nn import layers as jlayers

from repro_torch import configs
from repro_torch.convert import convert_lm_cache, convert_lm_params
from repro_torch.kernels.decode_attn.decode_attn import decode_attn
from repro_torch.models import lm
from repro_torch.nn import attention, layers
from repro_torch.train.serve import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["qwen3-14b-smoke", "qwen2.5-32b-smoke"]
RTOL = ATOL = 1e-5
B, S = 2, 12


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

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

    return jax.tree.map(mk, jlm.model_defs(cfg),
                        is_leaf=lambda x: isinstance(x, jlayers.ParamDef))


def _both(cfg, seed=0):
    """(reference params, port params) holding the same numpy weights."""
    tree = _numpy_params(cfg, seed)
    jdt = jnp.dtype(cfg.dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    return jparams, convert_lm_params(tree, cfg, device="cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_config_copies_equal_reference(arch):
    for name in (arch, arch + "-smoke"):
        ref, port = jconfigs.get_config(name), configs.get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.n_params(), port.n_active_params(), port.padded_vocab,
                port.q_groups, port.resolved_head_dim) == (
            ref.n_params(), ref.n_active_params(), ref.padded_vocab,
            ref.q_groups, ref.resolved_head_dim)


def test_shape_configs_equal_reference():
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.LM_SHAPES]
    for arch in configs.ARCHS:
        for shape in configs.LM_SHAPES:
            assert configs.shape_applicable(configs.get_config(arch), shape) \
                == jconfigs.shape_applicable(jconfigs.get_config(arch), shape)
        assert configs.get_shape("decode_32k") == configs.LM_SHAPES[2]
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# model definitions at full size (no allocation)
# ---------------------------------------------------------------------------

def _def_rows(defs, is_ref):
    leaves = (jax.tree.leaves(defs, is_leaf=lambda x: isinstance(
        x, jlayers.ParamDef)) if is_ref else layers.leaves(defs))
    return [(tuple(d.shape), tuple(d.names), d.init, d.scale)
            for d in leaves]


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_full_size_defs_equal_reference(arch):
    ref, port = jlm.model_defs(jconfigs.get_config(arch)), \
        lm.model_defs(configs.get_config(arch))
    assert jax.tree.structure(jax.tree.map(
        lambda _: 0, ref, is_leaf=lambda x: isinstance(x, jlayers.ParamDef))
    ) == jax.tree.structure(layers.map_defs(lambda _: 0, port))
    assert _def_rows(port, False) == _def_rows(ref, True)
    assert layers.param_count(port) == jlayers.param_count(ref)


# ---------------------------------------------------------------------------
# primitive layers and attention
# ---------------------------------------------------------------------------

# (port or reference module, x, gamma, beta, positions) -> output
LAYER_CASES = {
    "rmsnorm": lambda m, x, g, b, pos: m.rmsnorm(x, g),
    "layernorm": lambda m, x, g, b, pos: m.layernorm(x, g, b),
    "apply_norm": lambda m, x, g, b, pos: m.apply_norm(
        x, {"scale": g, "bias": b}, "layernorm", 1e-6),
    "rope": lambda m, x, g, b, pos: m.apply_rope(x, pos, 1e6),
    "swish": lambda m, x, g, b, pos: m.swish(x),
    "gelu": lambda m, x, g, b, pos: m.gelu(x),
    "softcap": lambda m, x, g, b, pos: m.softcap(x, 1.5),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layers_vs_reference(name):
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal((2, 5, 3, 4, 16)).astype(np.float32),
              (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
              (0.1 * rng.standard_normal(16)).astype(np.float32),
              rng.integers(0, 3000, (2, 5)).astype(np.int32))
    got = LAYER_CASES[name](layers, *(torch.from_numpy(a) for a in arrays))
    exp = LAYER_CASES[name](jlayers, *(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,chunk,valid", [
    (True, 0, 0, False), (True, 0, 4, False), (False, 0, 0, True),
    (True, 3, 0, True), (True, 3, 4, False)])
def test_gqa_attention_vs_reference(causal, window, chunk, valid):
    rng = np.random.default_rng(7)
    b, sq, sk, k, g, hd = 2, 8, 8, 2, 3, 16
    q = rng.standard_normal((b, sq, k, g, hd)).astype(np.float32)
    kk = rng.standard_normal((b, sk, k, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, k, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    kv_valid = (rng.uniform(size=(b, sk)) > 0.3) | (np.arange(sk) == 0)
    kw = dict(causal=causal, local_window=window, chunk=chunk)
    exp = jattention.gqa_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v), q_pos=pos,
        kv_pos=pos, kv_valid=jnp.asarray(kv_valid) if valid else None, **kw)
    got = attention.gqa_attention(
        *(torch.from_numpy(a) for a in (q, kk, v)),
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
        kv_valid=torch.from_numpy(kv_valid) if valid else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                               atol=ATOL)


def test_update_cache_in_place_vs_reference():
    rng = np.random.default_rng(8)
    ck = rng.standard_normal((2, 10, 2, 4)).astype(np.float32)
    cv = rng.standard_normal((2, 10, 2, 4)).astype(np.float32)
    kn = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    for pos in (0, 4, 9):   # 9 is clamped to 7, as dynamic_update_slice
        ek, ev = jattention.update_cache(jnp.asarray(ck), jnp.asarray(cv),
                                         jnp.asarray(kn), jnp.asarray(vn),
                                         pos)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        gk, gv = attention.update_cache(tk, tv, torch.from_numpy(kn),
                                        torch.from_numpy(vn), pos)
        assert gk is tk and gv is tv
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ek))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ev))


def test_init_params_per_layer_draws():
    cfg = configs.get_config("qwen3-14b-smoke")
    defs = lm.model_defs(cfg)
    gen = torch.Generator().manual_seed(0)
    params = layers.init_params(defs, gen, dtype="bfloat16")
    flat_p, flat_d = layers.leaves(params), layers.leaves(defs)
    assert [tuple(p.shape) for p in flat_p] == [d.shape for d in flat_d]
    assert all(p.dtype == torch.bfloat16 for p in flat_p)
    wi = params["stacks"][0]["0_attn"]["mlp"]["wi"].float()
    # fan-in 64 per layer slice, not 4 * 64; every layer drawn anew
    assert abs(float(wi.std()) - 64 ** -0.5) < 0.01
    assert not torch.equal(wi[0], wi[1])
    assert torch.all(params["out_ln"]["scale"] == 1)
    again = layers.init_params(defs, torch.Generator().manual_seed(0),
                               dtype="bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(flat_p,
                                                 layers.leaves(again)))


# ---------------------------------------------------------------------------
# the serving path against the reference
# ---------------------------------------------------------------------------

def _ref_prefill(cfg, jparams, toks, max_seq):
    cache = jlm.init_cache(cfg, toks.shape[0], max_seq=max_seq)
    return jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg,
                       mode="prefill", cache=cache)


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_and_greedy_decode_vs_reference(arch):
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    jparams, params = _both(jcfg)
    toks = _tokens(cfg, 1, (B, S))
    max_seq = S + 8
    jlg, jcache = _ref_prefill(jcfg, jparams, toks, max_seq)
    cache = lm.init_cache(cfg, B, max_seq, device="cpu")
    lg, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg,
                           mode="prefill", cache=cache)
    np.testing.assert_allclose(_np(lg), _np(jlg), rtol=RTOL, atol=ATOL)
    jblk, blk = jcache["stacks"][0]["0_attn"], cache["stacks"][0]["0_attn"]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(blk[name]), _np(jblk[name]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(blk["kv_pos"].numpy(),
                                  np.asarray(jblk["kv_pos"]))
    assert cache["pos"] == int(jcache["pos"]) == S

    jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(lg, -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    before = decode_attn.launches
    for _ in range(4):
        jlg, jcache = jlm.forward(jparams, {"tokens": jtok}, jcfg,
                                  mode="decode", cache=jcache)
        lg, cache = lm.forward(params, {"tokens": tok}, cfg, mode="decode",
                               cache=cache)
        np.testing.assert_allclose(_np(lg), _np(jlg), rtol=RTOL, atol=ATOL)
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(lg, -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert decode_attn.launches == before     # plain version on the CPU
    np.testing.assert_allclose(_np(blk["k"]), _np(jcache["stacks"][0][
        "0_attn"]["k"]), rtol=RTOL, atol=ATOL)
    assert cache["pos"] == S + 4


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_decode_matches_full_forward(arch):
    """The reference's strongest invariant (tests/test_models.py), on the
    port alone, at the reference's tolerance; and over three decode steps
    at every position."""
    cfg = configs.get_config(arch)
    params = lm.init_model(cfg, 1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, (B, S + 3)))
    full = lm.forward(params, {"tokens": toks}, cfg, mode="train")
    assert full.shape == (B, S + 3, cfg.padded_vocab)
    cache = lm.init_cache(cfg, B, S + 8, device="cpu")
    _, cache = lm.forward(params, {"tokens": toks[:, :S]}, cfg,
                          mode="prefill", cache=cache)
    for i in range(3):
        lg, cache = lm.forward(params, {"tokens": toks[:, S + i:S + i + 1]},
                               cfg, mode="decode", cache=cache)
        np.testing.assert_allclose(lg.numpy(), full[:, S + i].numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_decode_attends_through_the_kernel_wrapper(monkeypatch):
    """Each decode step calls the flash-decode wrapper once per layer, with
    the cache's valid length; on the CPU the wrapper takes the plain
    version, so that is where the calls are counted."""
    from repro_torch.kernels.decode_attn import decode_attn as mod
    calls = []
    real = mod.decode_attn_ref

    def counted(q, k, v, lengths):
        calls.append((tuple(k.shape), lengths.tolist()))
        return real(q, k, v, lengths)

    monkeypatch.setattr(mod, "decode_attn_ref", counted)
    cfg = configs.get_config("qwen3-14b-smoke")
    params = lm.init_model(cfg, 5, device="cpu")
    cache = lm.init_cache(cfg, B, S + 4, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 16, (B, S + 2)))
    lm.forward(params, {"tokens": toks[:, :S]}, cfg, "prefill", cache)
    assert calls == []                      # prefill: plain attention
    for i in range(2):
        lm.forward(params, {"tokens": toks[:, S + i:S + i + 1]}, cfg,
                   "decode", cache)
    hd = cfg.resolved_head_dim
    assert calls == [((B, cfg.n_kv_heads, S + 4, hd), [S + 1 + i] * B)
                     for i in range(2) for _ in range(cfg.n_layers)]


def test_decode_from_converted_reference_cache():
    """Both packages decode from the same reference-made cache."""
    arch = "qwen3-14b-smoke"
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jparams, params = _both(jcfg, seed=4)
    toks = _tokens(cfg, 5, (B, S))
    _, jcache = _ref_prefill(jcfg, jparams, toks, S + 4)
    cache = convert_lm_cache(jcache, cfg, device="cpu")
    assert cache["pos"] == S and cache["stacks"][0]["0_attn"][
        "kv_pos"].dtype == torch.int32
    nxt = _tokens(cfg, 6, (B, 1))
    jlg, _ = jlm.forward(jparams, {"tokens": jnp.asarray(nxt)}, jcfg,
                         mode="decode", cache=jcache)
    lg, _ = lm.forward(params, {"tokens": torch.from_numpy(nxt)}, cfg,
                       mode="decode", cache=cache)
    np.testing.assert_allclose(_np(lg), _np(jlg), rtol=RTOL, atol=ATOL)


def test_prompt_longer_than_cache_keeps_last_window():
    """Prefill of S >= max_seq keeps the last max_seq positions; decode then
    overwrites the last slot, as the reference does."""
    arch = "qwen3-14b-smoke"
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jparams, params = _both(jcfg, seed=9)
    toks = _tokens(cfg, 10, (B, S))
    jlg, jcache = _ref_prefill(jcfg, jparams, toks, S - 4)
    cache = lm.init_cache(cfg, B, S - 4, device="cpu")
    lg, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg,
                           mode="prefill", cache=cache)
    np.testing.assert_array_equal(cache["stacks"][0]["0_attn"][
        "kv_pos"].numpy(), np.asarray(jcache["stacks"][0]["0_attn"]["kv_pos"]))
    nxt = _tokens(cfg, 11, (B, 1))
    jlg, _ = jlm.forward(jparams, {"tokens": jnp.asarray(nxt)}, jcfg,
                         mode="decode", cache=jcache)
    lg, _ = lm.forward(params, {"tokens": torch.from_numpy(nxt)}, cfg,
                       mode="decode", cache=cache)
    np.testing.assert_allclose(_np(lg), _np(jlg), rtol=RTOL, atol=ATOL)


def test_bf16_smoke_vs_reference():
    """bf16 weights, activations and cache.  The two frameworks round to
    bf16 after other operations (XLA fuses the norm, rope and bias casts;
    torch rounds each op's output), and the port's decode casts the
    unnormalised p to bf16 where the reference casts the normalised probs,
    so each result carries a few bf16 roundings (2^-8 relative each) of
    difference, compounding over the layers: logits and the cache are held
    to 0.05 of their largest magnitude (measured: 0.014-0.016).  Layer 0's
    k and v, computed before any rounding differs, are equal."""
    arch = "qwen3-14b-smoke"
    cfg = dataclasses.replace(configs.get_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_config(arch), dtype="bfloat16")
    jparams, params = _both(jcfg, seed=12)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(params["embed"]),
                                  _np(jparams["embed"]))
    toks = _tokens(cfg, 13, (B, S))
    jlg, jcache = _ref_prefill(jcfg, jparams, toks, S + 4)
    cache = lm.init_cache(cfg, B, S + 4, device="cpu")
    lg, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg,
                           mode="prefill", cache=cache)
    assert lg.dtype == torch.bfloat16
    assert cache["stacks"][0]["0_attn"]["k"].dtype == torch.bfloat16
    atol = 0.05 * float(np.abs(_np(jlg)).max())
    np.testing.assert_allclose(_np(lg), _np(jlg), rtol=0, atol=atol)
    jk, k = jcache["stacks"][0]["0_attn"]["k"], cache["stacks"][0][
        "0_attn"]["k"]
    np.testing.assert_array_equal(_np(k[0]), _np(jk[0]))
    np.testing.assert_allclose(_np(k), _np(jk), rtol=0,
                               atol=0.05 * float(np.abs(_np(jk)).max()))
    nxt = _tokens(cfg, 14, (B, 1))
    jlg, _ = jlm.forward(jparams, {"tokens": jnp.asarray(nxt)}, jcfg,
                         mode="decode", cache=jcache)
    lg, _ = lm.forward(params, {"tokens": torch.from_numpy(nxt)}, cfg,
                       mode="decode", cache=cache)
    atol = 0.05 * float(np.abs(_np(jlg)).max())
    np.testing.assert_allclose(_np(lg), _np(jlg), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# steps, conversion and devices
# ---------------------------------------------------------------------------

def test_serve_steps_equal_forward():
    cfg = configs.get_config("qwen2.5-32b-smoke")
    params = lm.init_model(cfg, 3, device="cpu")
    prefill = make_prefill_step(cfg, B, S + 4, device="cpu")
    decode = make_decode_step(cfg, B, S + 4, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 15, (B, S + 1)))
    c1 = lm.init_cache(cfg, B, S + 4, device="cpu")
    c2 = lm.init_cache(cfg, B, S + 4, device="cpu")
    lg1, out = prefill(params, c1, toks[:, :S])
    assert out is c1                        # filled in place
    lg2, _ = lm.forward(params, {"tokens": toks[:, :S]}, cfg, mode="prefill",
                        cache=c2)
    assert torch.equal(lg1, lg2)
    lg1, _ = decode(params, c1, {"tokens": toks[:, S:]})
    lg2, _ = lm.forward(params, {"tokens": toks[:, S:]}, cfg, mode="decode",
                        cache=c2)
    assert torch.equal(lg1, lg2) and c1["pos"] == c2["pos"] == S + 1
    with pytest.raises(ValueError, match="batch"):
        decode(params, lm.init_cache(cfg, B + 1, S + 4, device="cpu"),
               toks[:, :1])
    with pytest.raises(ValueError, match="requests"):
        decode(params, c1, toks[:1, :1])


def test_convert_rejects_wrong_tree():
    cfg = configs.get_config("qwen3-14b-smoke")
    tree = _numpy_params(jconfigs.get_config("qwen3-14b-smoke"))
    tree["lm_head"] = tree["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        convert_lm_params(tree, cfg, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        convert_lm_params(tree, cfg, device="cpu")


@pytest.mark.parametrize("entry", ["init_model", "init_cache", "prefill_step",
                                   "decode_step", "convert_lm_params",
                                   "convert_lm_cache"])
def test_entry_points_need_cuda_unless_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen3-14b-smoke")
    calls = {
        "init_model": lambda: lm.init_model(cfg),
        "init_cache": lambda: lm.init_cache(cfg, 1, 8),
        "prefill_step": lambda: make_prefill_step(cfg, 1, 8),
        "decode_step": lambda: make_decode_step(cfg, 1, 8),
        "convert_lm_params": lambda: convert_lm_params(
            _numpy_params(jconfigs.get_config("qwen3-14b-smoke")), cfg),
        "convert_lm_cache": lambda: convert_lm_cache(
            {"pos": 0, "stacks": []}, cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# one -smoke config of each family
EXAMPLE_ARCHS = ["qwen3-14b-smoke", "deepseek-moe-16b-smoke",
                 "recurrentgemma-9b-smoke", "xlstm-1.3b-smoke",
                 "whisper-base-smoke", "llava-next-mistral-7b-smoke"]


@pytest.mark.parametrize("arch", EXAMPLE_ARCHS)
def test_example_runs_on_cpu(arch):
    proc = subprocess.run(
        [sys.executable, "examples/torch/lm_decode_serve.py", "--device",
         "cpu", "--batch", "2", "--prompt-len", "8", "--tokens", "3",
         "--arch", arch],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "prefill 2 requests x 8 tokens" in out and "decode:" in out
    last = out.strip().splitlines()[-1]
    if arch.startswith("xlstm"):      # no attention cache, no kernel
        assert "no attention cache" in last
        return
    assert float(last.split()[-1]) < 1e-5
