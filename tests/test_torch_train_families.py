"""The port's LM loss and its gradients against the reference's, on every
family (CPU).

Weights are made with numpy from a seed (normal leaves scaled as the
reference's init, ones and zeros drawn around 1 and 0 so that they matter)
and handed to both packages.  The reference's gradients come from
``jax.grad(repro.models.lm.lm_loss)``, the port's from autograd through
``repro_torch.models.lm.lm_loss`` (``train.trainer.loss_and_grads``).
Float32 losses and every gradient agree to 1e-5 (rtol and atol): both sum
float32 products in other orders, nothing else differs.  The smoke configs
checkpoint each layer (``remat``, policy ``"full"``) in both packages.
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

from repro_torch import configs
from repro_torch.convert import convert_lm_params
from repro_torch.models import lm
from repro_torch.nn.layers import leaves, map_defs
from repro_torch.train.serve import make_decode_step, make_prefill_step
from repro_torch.train.trainer import loss_and_grads

ARCHS = ["qwen3-14b", "deepseek-moe-16b", "dbrx-132b", "recurrentgemma-9b",
         "xlstm-1.3b", "whisper-base", "llava-next-mistral-7b"]
SMOKE = [a + "-smoke" for a in ARCHS]
RTOL = ATOL = 1e-5
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small CPU ops are fastest so, and the
    suite's workers share the cores (a thread pool per worker oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    tree = _draw(jlm.model_defs(jcfg), np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, tree),
            convert_lm_params(tree, cfg, device="cpu"))


def _batch(cfg, seed, s=S, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((B, s)) < 0.6).astype(np.float32)
    return out


def _check(cfg, jcfg, batch, seed=0):
    jp, p = _both(jcfg, cfg, seed)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = loss_and_grads(p, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    jl, tl = jax.tree.leaves(jgrads), leaves(grads)
    assert len(jl) == len(tl)
    for got, exp in zip(tl, jl):
        assert tuple(got.shape) == exp.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                                   atol=ATOL)
    return float(loss), grads


@pytest.mark.parametrize("arch", SMOKE)
def test_loss_and_grads_vs_reference(arch):
    cfg, jcfg = _cfgs(arch)
    assert cfg.remat and cfg.remat_policy == "full"
    loss, grads = _check(cfg, jcfg, _batch(cfg, 1))
    assert np.isfinite(loss)
    # every leaf takes part in the loss
    assert all(float(g.abs().max()) > 0 for g in leaves(grads))


def test_loss_mask_vs_reference():
    """The vlm batch's ``loss_mask`` (its [:, 1:] weighs the targets)."""
    cfg, jcfg = _cfgs("llava-next-mistral-7b-smoke")
    batch = _batch(cfg, 2, mask=True)
    assert 0 < batch["loss_mask"][:, 1:].sum() < batch["loss_mask"][:, 1:].size
    masked, _ = _check(cfg, jcfg, batch)
    unmasked, _ = _check(cfg, jcfg, {k: v for k, v in batch.items()
                                     if k != "loss_mask"})
    assert masked != unmasked


def test_padded_vocab_masked_vs_reference():
    """A vocab that is no multiple of 128: the padded logit columns are
    masked out of the loss, and their head columns take no gradient."""
    cfg, jcfg = _cfgs("qwen3-14b-smoke", vocab_size=200)
    assert cfg.padded_vocab == 256
    _, grads = _check(cfg, jcfg, _batch(cfg, 3))
    assert float(grads["lm_head"][:, 200:].abs().max()) == 0.0


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "recurrentgemma-9b-smoke",
                                  "whisper-base-smoke",
                                  "deepseek-moe-16b-smoke"])
def test_chunked_attention_and_remat_vs_reference(arch, policy):
    """attn_chunk=4 over S=12: the port's chunk loop, each chunk a
    checkpoint under autograd, against the reference's scan of
    checkpointed chunks, with the same remat policy in both."""
    cfg, jcfg = _cfgs(arch, attn_chunk=4, remat_policy=policy)
    _check(cfg, jcfg, _batch(cfg, 4))


def test_remat_off_vs_reference():
    cfg, jcfg = _cfgs("qwen3-14b-smoke", remat=False, attn_chunk=4)
    _check(cfg, jcfg, _batch(cfg, 5))


def _saved(fn):
    """How many tensors autograd saves outside any checkpoint while ``fn``
    runs."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return n[0], out


def test_remat_saves_less_and_equals_no_remat():
    cfg = configs.get_config("qwen3-14b-smoke")
    params = lm.init_model(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    counts, grads = {}, {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        counts[remat, policy], (_, grads[remat, policy]) = _saved(
            lambda c=c: loss_and_grads(params, batch, c))
        for got, exp in zip(leaves(grads[remat, policy]),
                            leaves(grads[False, "full"])):
            torch.testing.assert_close(got, exp, rtol=0, atol=0)
    assert counts[True, "full"] < counts[False, "full"] / 2
    assert counts[True, "dots"] == counts[True, "full"]


@pytest.mark.parametrize("arch", ["qwen3-14b-smoke", "xlstm-1.3b-smoke"])
def test_serving_records_no_graph(arch):
    """Prefill and decode run under no_grad: with params that require
    grad they return no graph and autograd saves nothing."""
    cfg = configs.get_config(arch)
    params = map_defs(lambda t: t.requires_grad_(True),
                      lm.init_model(cfg, 0, device="cpu"))
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    tokens = torch.from_numpy(_batch(cfg, 7, s=8)["tokens"])
    n, (logits, cache) = _saved(lambda: make_prefill_step(
        cfg, B, 16, device="cpu")(params, cache, tokens))
    assert n == 0 and not logits.requires_grad
    n, (logits, _) = _saved(lambda: make_decode_step(
        cfg, B, 16, device="cpu")(params, cache, tokens[:, :1]))
    assert n == 0 and not logits.requires_grad
    # train mode records where autograd is on
    assert lm.forward(params, {"tokens": tokens}, cfg).requires_grad


@pytest.mark.parametrize("length", [64, 256])
def test_mlstm_chunk_gate_grads_vs_reference(length):
    """One mLSTM chunk of ``length`` steps: the output equals the
    reference's; so do the gradients of q and of both gates where the
    reference's are finite (64 steps).  At 256 steps the decay above the
    chunk's diagonal, exp(B_t - B_tau), overflows: the reference takes exp
    before its mask, and the where's gradient there (0 x inf) makes every
    gate gradient NaN; the port masks first and keeps them finite (its
    output bit for bit what exp before the mask gives).  Each array is held
    at a tolerance of its largest magnitude: 1e-5 at 64 steps, 1e-4 at 256,
    where both packages sum 256 float32 products in other orders and divide
    by the normaliser."""
    from repro.nn import recurrent as jrec
    from repro_torch.nn import recurrent as rec
    rng = np.random.default_rng(length)
    b, h, dk = 2, 2, 8
    q, k, v = (rng.standard_normal((b, h, length, dk)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(np.float32(dk))          # as the model scales its keys
    ig = rng.standard_normal((b, h, length)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, h, length))
                                - 0.5))).astype(np.float32)
    state = (np.zeros((b, h, dk, dk), np.float32),
             np.zeros((b, h, dk), np.float32), np.zeros((b, h), np.float32))

    def jloss(q_, ig_, lf_):
        out, _ = jrec._mlstm_chunk(q_, jnp.asarray(k), jnp.asarray(v), ig_,
                                   lf_, tuple(map(jnp.asarray, state)))
        return out.sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(ig), jnp.asarray(lf))
    tq, tig, tlf = (torch.from_numpy(a).requires_grad_() for a in (q, ig, lf))
    out, _ = rec._mlstm_chunk(tq, torch.from_numpy(k), torch.from_numpy(v),
                              tig, tlf, tuple(map(torch.from_numpy, state)))
    out.sum().backward()
    tol = 1e-5 if length == 64 else 1e-4

    def close(got, exp):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got, exp, rtol=tol,
                                   atol=tol * float(np.abs(exp).max()))

    close(out.detach().numpy(), jout)
    grads = (tq.grad, tig.grad, tlf.grad)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    finite = [bool(jnp.isfinite(g).all()) for g in jg]
    assert finite == ([True] * 3 if length == 64 else [True, False, False])
    for got, exp, ok in zip(grads, jg, finite):
        if ok:
            close(got.numpy(), exp)
