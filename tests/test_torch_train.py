"""The port's training substrate against the reference's (CPU): AdamW and
its schedule, the synthetic data, checkpoints, the train step and the
training loop.

Inputs are made with numpy from a seed and handed to both packages.  Each
optimizer function agrees with the reference's to 1e-6 on identical
inputs.  Five train steps from the same state (``convert_train_state``)
over the same ``SyntheticLM`` batches track the reference's loss,
``grad_norm`` and ``lr`` at rtol 1e-5 for step 1 and 1e-4 for steps 2-5.
Params after step 1 agree at atol 1e-5 where the reference's gradient
exceeds 1e-4 in magnitude, and at 2 x lr elsewhere: Adam's first step is
``g / (|g| + eps)``, which flips between 0 and +-1 where |g| is near eps.
The reference's own tests of the substrate (``tests/test_substrate.py``,
``tests/test_system.py``) run here on the port with ``device="cpu"``.
"""
import dataclasses
import json
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
from repro.ckpt import checkpoint as jckpt
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer

from repro_torch import configs
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import convert_train_state
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.train import train_loop
from repro_torch.nn.layers import leaves, map_defs
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (TrainOptions, init_train_state,
                                       loss_and_grads, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = 1e-6
ARCH = "qwen3-14b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small CPU ops are fastest so, and the
    suite's workers share the cores (a thread pool per worker oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, dtype=np.float32):
    """A small params-like tree of numpy arrays (dict keys out of order,
    lists, a scalar leaf)."""
    return {"w": rng.standard_normal((5, 3)).astype(dtype),
            "b": [rng.standard_normal(4).astype(dtype),
                  rng.standard_normal((2, 2)).astype(dtype)],
            "a": {"z": rng.standard_normal(7).astype(dtype),
                  "s": rng.standard_normal(()).astype(dtype)}}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _close(got, exp, tol=OPT_TOL):
    jl, tl = jax.tree.leaves(exp), leaves(got)
    assert len(jl) == len(tl)
    for g, e in zip(tl, jl):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

CFGS = [jopt.OptConfig(), jopt.OptConfig(lr=1e-2, warmup_steps=3,
                                          total_steps=20, clip_norm=0.5),
        jopt.OptConfig(warmup_steps=0, total_steps=1, min_lr_frac=1.0)]


@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_schedule_vs_reference(ci):
    jcfg = CFGS[ci]
    cfg = opt.OptConfig(**dataclasses.asdict(jcfg))
    for step in (0, 1, 2, 3, 5, 19, 20, 50, 100, 9999, 10000, 20000):
        got = opt.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            float(got), float(jopt.schedule(jnp.asarray(step, jnp.int32),
                                            jcfg)), rtol=OPT_TOL, atol=0)


def test_init_opt_state_and_global_norm_vs_reference():
    tree = _tree(np.random.default_rng(0))
    state = opt.init_opt_state(_t(tree))
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, tree))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for got, exp in zip(leaves(state["m"]) + leaves(state["v"]),
                        jax.tree.leaves(jstate["m"])
                        + jax.tree.leaves(jstate["v"])):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert not got.any()
    np.testing.assert_allclose(float(opt.global_norm(_t(tree))),
                               float(jopt.global_norm(tree)), rtol=OPT_TOL)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_adamw_update_vs_reference(ci, in_place):
    """Three updates from nonzero moments, gradients both clipped and not;
    in place or not, the same numbers."""
    jcfg = CFGS[ci]
    cfg = opt.OptConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(ci)
    params = _tree(rng)
    state = {"m": _tree(rng), "v": jax.tree.map(np.abs, _tree(rng)),
             "step": np.asarray(4, np.int32)}
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    p, s = _t(params), {"m": _t(state["m"]), "v": _t(state["v"]),
                        "step": torch.tensor(4, dtype=torch.int32)}
    for i, gscale in enumerate((0.01, 10.0, 1.0)):
        grads = jax.tree.map(lambda a: a * gscale, _tree(rng))
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, grads), js,
                                       jp, jcfg)
        before = leaves(p)
        p, s, m = opt.adamw_update(_t(grads), s, p, cfg, in_place=in_place)
        assert all((a is b) == in_place for a, b in zip(leaves(p), before))
        _close(p, jp)
        _close(s["m"], js["m"])
        _close(s["v"], js["v"])
        assert int(s["step"]) == int(js["step"]) == 5 + i
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=OPT_TOL)


def test_adamw_update_walks_big_leaves_in_slices(monkeypatch):
    """A leaf longer than a slice updates as a whole one does."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal(1000).astype(np.float32)}
    grads = {"w": rng.standard_normal(1000).astype(np.float32)}
    cfg = opt.OptConfig()
    whole = opt.adamw_update(_t(grads), opt.init_opt_state(_t(params)),
                             _t(params), cfg)
    monkeypatch.setattr(opt, "UPDATE_SLICE", 64)
    sliced = opt.adamw_update(_t(grads), opt.init_opt_state(_t(params)),
                              _t(params), cfg, in_place=True)
    for a, b in zip(leaves(whole[:2]), leaves(sliced[:2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adamw_bf16_params_vs_reference():
    """bf16 params: the update in float32, cast back to bf16."""
    rng = np.random.default_rng(6)
    params = _tree(rng)
    grads = _tree(rng)
    jcfg = jopt.OptConfig(lr=1e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jp2, _, _ = jopt.adamw_update(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads),
        jopt.init_opt_state(jp), jp, jcfg)
    p = map_defs(lambda t: t.to(torch.bfloat16), _t(params))
    p2, _, _ = opt.adamw_update(map_defs(lambda t: t.to(torch.bfloat16),
                                         _t(grads)),
                                opt.init_opt_state(p), p,
                                opt.OptConfig(lr=1e-2))
    for got, exp in zip(leaves(p2), jax.tree.leaves(jp2)):
        assert got.dtype == torch.bfloat16
        # one bf16 step where the float32 results straddle a rounding point
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(exp, np.float32), rtol=8e-3,
                                   atol=0)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_grads_vs_reference(bits):
    rng = np.random.default_rng(bits)
    grads = _tree(rng)
    grads["a"]["z"][:] = 0.0           # an all-zero leaf: the 1e-12 floor
    grads["w"][0, :] = [2.5, -2.5, 0.5]
    grads["w"][1, :] = 127 / (2 ** (bits - 1) - 1) * np.array([2.5, 1.5, 0.5])
    _close(opt.fake_quant_grads(_t(grads), bits=bits),
           jopt.fake_quant_grads(jax.tree.map(jnp.asarray, grads), bits=bits))


def test_fake_quant_rounds_half_to_even():
    g = {"w": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])}
    np.testing.assert_array_equal(opt.fake_quant_grads(g)["w"].numpy(),
                                  [127.0, 0.0, 2.0, 2.0, 0.0, -2.0])


# counterparts of tests/test_substrate.py::TestOptimizer

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    cfg = opt.OptConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                        total_steps=200, min_lr_frac=1.0)
    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), w)
        params, state, _ = opt.adamw_update({"w": g}, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_clipping():
    params = {"w": torch.zeros(3)}
    state = opt.init_opt_state(params)
    g = {"w": torch.full((3,), 100.0)}
    _, _, metrics = opt.adamw_update(g, state, params,
                                     opt.OptConfig(clip_norm=1.0))
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(opt.global_norm(g)))


def test_schedule_warmup_and_decay():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    assert float(opt.schedule(torch.tensor(5), cfg)) == pytest.approx(0.5)
    assert float(opt.schedule(torch.tensor(10), cfg)) == pytest.approx(1.0)
    assert float(opt.schedule(torch.tensor(100), cfg)) == pytest.approx(
        0.1, rel=1e-2)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
def test_fake_quant_error_bound(bits, seed):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy(rng.standard_normal(100).astype(np.float32))}
    gq = opt.fake_quant_grads(g, bits=bits)
    scale = float(g["w"].abs().max()) / (2 ** (bits - 1) - 1)
    assert float((gq["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-7


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 0, 1),
                                                 (2, 3, 4), (117, 1, 2)])
def test_synthetic_batches_equal_reference(step, shard, n_shards):
    for vocab, seed in ((256, 0), (151936, 3)):
        got = SyntheticLM(vocab, seed).batch(step, 8, 33, shard, n_shards)
        exp = jdata.SyntheticLM(vocab, seed).batch(step, 8, 33, shard,
                                                   n_shards)
        assert got.keys() == exp.keys()
        assert got["tokens"].dtype == exp["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], exp["tokens"])


def test_data_deterministic():
    d = SyntheticLM(1000, seed=3)
    np.testing.assert_array_equal(d.batch(5, 8, 16)["tokens"],
                                  d.batch(5, 8, 16)["tokens"])


def test_shards_disjoint_and_cover():
    d = SyntheticLM(1000, seed=3)
    shards = [d.batch(2, 8, 16, shard=i, n_shards=4) for i in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    assert not np.array_equal(shards[0]["tokens"], shards[1]["tokens"])


def test_prefetcher():
    pf = Prefetcher(lambda i: {"i": i}, depth=2)
    seen = [next(pf)["i"] for _ in range(5)]
    pf.close()
    assert seen == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"m": [torch.zeros(2), torch.ones(3)],
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _state_tree()
    ckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore_checkpoint(str(tmp_path), 7, tree, device="cpu")
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_tmp_ignored(tmp_path):
    os.makedirs(tmp_path / "step_5.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(2)})
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_async_save_holds_the_state_it_was_given(tmp_path):
    """The leaves reach the host before save_checkpoint returns, so an
    in-place update after it (donation) does not reach the file."""
    w = torch.ones(4)
    t = ckpt.save_checkpoint(str(tmp_path), 1, {"w": w}, blocking=False)
    w.add_(5.0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 1
    out = ckpt.restore_checkpoint(str(tmp_path), 1, {"w": w}, device="cpu")
    torch.testing.assert_close(out["w"], torch.ones(4))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)},
                                device="cpu")


def test_checkpoint_missing_entry_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"u": torch.zeros(2)},
                                device="cpu")


def test_checkpoint_overwrite_same_step(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    out = ckpt.restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)},
                                  device="cpu")
    torch.testing.assert_close(out["w"], torch.ones(2))


def test_checkpoint_bf16_roundtrip_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((33, 5)).astype(
        np.float32)).to(torch.bfloat16)
    tree = {"params": {"w": w}, "opt": {"step": torch.tensor(3)}}
    ckpt.save_checkpoint(str(tmp_path), 3, tree)
    meta = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert meta["entries"]["params/w"] == {"shape": [33, 5],
                                           "dtype": "bfloat16"}
    out = ckpt.restore_checkpoint(str(tmp_path), 3, tree, device="cpu")
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"].view(torch.int16),
                       w.view(torch.int16))


def test_checkpoint_layout_equals_reference(tmp_path):
    """The same tree saved by both packages: the same manifest and the
    same npz entries, byte for byte."""
    rng = np.random.default_rng(1)
    tree = {"params": _tree(rng), "opt": {"m": _tree(rng),
                                          "step": np.asarray(2, np.int32)}}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2,
                          jax.tree.map(jnp.asarray, tree))
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, _t(tree))
    for name in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / name / "step_2")) == [
            "manifest.json", "shard_0.npz"]
    manifests = [json.loads((tmp_path / n / "step_2" / "manifest.json")
                            .read_text()) for n in ("ref", "port")]
    assert manifests[0] == manifests[1]
    with np.load(tmp_path / "ref" / "step_2" / "shard_0.npz") as a, \
            np.load(tmp_path / "port" / "step_2" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt|m|a|s" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_port_reads_reference_checkpoint(tmp_path):
    """float32 and int32 leaf for leaf; bf16 bit for bit (the reference
    writes 2-byte records and ``"bfloat16"`` in its manifest)."""
    rng = np.random.default_rng(2)
    tree = {"params": _tree(rng), "step": np.asarray(9, np.int32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["bf"] = jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 9, jtree)
    template = _t(tree)
    template["bf"] = torch.zeros((4, 3), dtype=torch.bfloat16)
    assert ckpt.latest_step(str(tmp_path)) == 9
    out = ckpt.restore_checkpoint(str(tmp_path), 9, template, device="cpu")
    for got, exp in zip(leaves(out), jax.tree.leaves(jtree)):
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(exp).view(np.int16))
        else:
            assert got.dtype == {np.dtype(np.float32): torch.float32,
                                 np.dtype(np.int32): torch.int32}[exp.dtype]
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_reference_reads_port_checkpoint(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"params": _tree(rng), "opt": {"step": np.asarray(4, np.int32)}}
    ckpt.save_checkpoint(str(tmp_path), 4, _t(tree))
    assert jckpt.latest_step(str(tmp_path)) == 4
    out = jckpt.restore_checkpoint(str(tmp_path), 4,
                                   jax.tree.map(jnp.asarray, tree))
    for got, exp in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(np.asarray(got), exp)


def test_train_state_checkpoint_roundtrip(tmp_path):
    """A smoke model's whole training state, bf16 params included."""
    cfg = dataclasses.replace(configs.get_config(ARCH), dtype="bfloat16")
    params, state = init_train_state(cfg, 0, device="cpu")
    tree = {"params": params, "opt": state}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    out = ckpt.restore_checkpoint(str(tmp_path), 1, tree, device="cpu")
    assert len(leaves(out)) == len(leaves(tree))
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8) if a.dim() else a,
                           b.view(-1).view(torch.uint8) if b.dim() else b)


# ---------------------------------------------------------------------------
# train step against the reference
# ---------------------------------------------------------------------------

def _draw(defs, rng):
    """numpy float32 arrays for a tree of reference ParamDefs (ones and
    zeros drawn around 1 and 0 so that they matter)."""
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


def _ref_state(jcfg, seed=0):
    """A reference training state (params drawn with numpy, moments zero)."""
    tree = _draw(jlm.model_defs(jcfg), np.random.default_rng(seed))
    params = jax.tree.map(jnp.asarray, tree)
    return params, jopt.init_opt_state(params)


@pytest.mark.parametrize("variant", ["plain", "microbatches", "compress"])
def test_five_train_steps_vs_reference(variant):
    jcfg = jconfigs.get_config(ARCH)
    cfg = configs.get_config(ARCH)
    kw = {"plain": {}, "microbatches": {"microbatches": 2},
          "compress": {"compress_grads": True}}[variant]
    jocfg = jopt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    ocfg = opt.OptConfig(**dataclasses.asdict(jocfg))
    jstep, _ = jtrainer.make_train_step(
        jcfg, jocfg, None, jtrainer.TrainOptions(donate=False, **kw))
    step = make_train_step(cfg, ocfg, TrainOptions(**kw), device="cpu")
    jp, js = _ref_state(jcfg)
    p, s = convert_train_state(jp, js, cfg, device="cpu")
    assert int(s["step"]) == 0 and s["step"].dtype == torch.int32
    data = SyntheticLM(cfg.vocab_size, seed=0)
    # the reference's gradient at the start, as AdamW takes it
    b0 = data.batch(0, 4, 16)
    g_ref = jax.grad(jlm.lm_loss)(jp, {"tokens": jnp.asarray(b0["tokens"])},
                                  jcfg)
    if variant == "compress":
        g_ref = jopt.fake_quant_grads(g_ref)
    for i in range(5):
        b = data.batch(i, 4, 16)
        jp, js, jm = jstep(jp, js, b)
        p, s, m = step(p, s, b)
        tol = 1e-5 if i == 0 else 1e-4
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"step {i + 1} {k}")
        if i == 0:
            for got, exp, g in zip(leaves(p), jax.tree.leaves(jp),
                                   jax.tree.leaves(g_ref)):
                err = np.abs(got.numpy() - np.asarray(exp))
                big = np.abs(np.asarray(g)) > 1e-4
                assert err[big].max(initial=0) <= 1e-5
                assert err.max() <= 2 * float(jm["lr"])
    assert int(s["step"]) == int(js["step"]) == 5


def test_convert_train_state_carries_moments():
    jcfg = jconfigs.get_config(ARCH)
    jp, js = _ref_state(jcfg, seed=1)
    rng = np.random.default_rng(0)
    js = {"m": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape), jnp.float32), js["m"]),
          "v": js["v"], "step": jnp.asarray(3, jnp.int32)}
    p, s = convert_train_state(jp, js, configs.get_config(ARCH),
                               device="cpu")
    assert int(s["step"]) == 3
    for got, exp in zip(leaves(s["m"]), jax.tree.leaves(js["m"])):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for got, exp in zip(leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_donated_step_updates_in_place():
    cfg = configs.get_config(ARCH)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=5)
    batch = SyntheticLM(cfg.vocab_size).batch(0, 4, 16)
    outs = {}
    for donate in (False, True):
        p, s = init_train_state(cfg, 0, device="cpu")
        before = leaves(p) + leaves(s["m"])
        p2, s2, m = make_train_step(cfg, ocfg, TrainOptions(donate=donate),
                                    device="cpu")(p, s, batch)
        after = leaves(p2) + leaves(s2["m"])
        assert all((a is b) == donate for a, b in zip(before, after))
        assert not any(t.requires_grad for t in after)
        outs[donate] = after, float(m["loss"])
    assert outs[False][1] == outs[True][1]
    for a, b in zip(outs[False][0], outs[True][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_microbatch_grads_vs_full_batch():
    cfg = configs.get_config(ARCH)
    params = init_train_state(cfg, 0, device="cpu")[0]
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size).batch(0, 8, 16).items()}
    l1, g1 = loss_and_grads(params, batch, cfg)
    l4, g4 = loss_and_grads(params, batch, cfg, microbatches=4)
    torch.testing.assert_close(l4, l1, rtol=1e-5, atol=1e-5)
    for a, b in zip(leaves(g4), leaves(g1)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        loss_and_grads(params, batch, cfg, microbatches=3)


# ---------------------------------------------------------------------------
# training loop: counterparts of tests/test_system.py
# ---------------------------------------------------------------------------

def test_training_loss_decreases():
    cfg = configs.get_config(ARCH)
    _, _, losses = train_loop(cfg, steps=40, batch=16, seq=32,
                              ckpt_dir=None, lr=3e-3, log_every=100,
                              device="cpu")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


def test_restart_from_checkpoint(tmp_path):
    """Kill-and-resume: a run interrupted at step 6 resumes at 6 and reaches
    the same final state as an uninterrupted run."""
    cfg = configs.get_config(ARCH)
    d1 = str(tmp_path / "a")
    train_loop(cfg, steps=6, batch=4, seq=16, ckpt_dir=d1, ckpt_every=3,
               log_every=100, schedule_steps=10, device="cpu")
    assert ckpt.latest_step(d1) == 6
    _, _, resumed = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=d1,
                               ckpt_every=100, log_every=100, device="cpu")
    assert len(resumed) == 4
    d2 = str(tmp_path / "b")
    _, _, full = train_loop(cfg, steps=10, batch=4, seq=16, ckpt_dir=d2,
                            ckpt_every=100, log_every=100, device="cpu")
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-4)


def test_grad_compression_still_converges():
    cfg = configs.get_config(ARCH)
    _, _, losses = train_loop(cfg, steps=30, batch=16, seq=32,
                              ckpt_dir=None, lr=3e-3, compress_grads=True,
                              log_every=100, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_microbatched_equals_full_batch():
    cfg = configs.get_config(ARCH)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=5)
    batch = SyntheticLM(cfg.vocab_size, seed=0).batch(0, 8, 32)

    def run(micro):
        step = make_train_step(cfg, ocfg, TrainOptions(microbatches=micro),
                               device="cpu")
        params, state = init_train_state(cfg, 0, device="cpu")
        params, _, m = step(params, state, batch)
        return float(m["loss"]), params

    l1, p1 = run(1)
    l4, p4 = run(4)
    assert abs(l1 - l4) < 0.05
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p4))) < 0.05


@pytest.mark.parametrize("arch", ["whisper-base-smoke",
                                  "llava-next-mistral-7b-smoke"])
def test_loop_feeds_frontend_inputs(arch, capsys):
    cfg = configs.get_config(arch)
    seen = []
    _, _, losses = train_loop(cfg, steps=2, batch=2, seq=8, ckpt_dir=None,
                              log_every=1, device="cpu",
                              on_step=lambda i, m: seen.append((i, m)))
    assert [i for i, _ in seen] == [1, 2]
    assert [m["loss"] for _, m in seen] == losses
    assert all(np.isfinite(m["grad_norm"]) and m["lr"] > 0 for _, m in seen)
    assert "[train] step 2/2 loss=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["init_train_state", "make_train_step",
                                   "train_loop", "restore_checkpoint"])
def test_entry_points_need_cuda_unless_cpu(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config(ARCH)
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    call = {
        "init_train_state": lambda **kw: init_train_state(cfg, 0, **kw),
        "make_train_step": lambda **kw: make_train_step(
            cfg, opt.OptConfig(), **kw),
        "train_loop": lambda **kw: train_loop(
            cfg, steps=1, batch=2, seq=8, ckpt_dir=None, log_every=100,
            **kw),
        "restore_checkpoint": lambda **kw: ckpt.restore_checkpoint(
            str(tmp_path), 1, {"w": torch.zeros(2)}, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def test_launch_main_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] loss" in proc.stdout
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_example_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "examples/torch/train_small_lm.py", "--device",
         "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loss:" in proc.stdout
    assert ckpt.latest_step(str(tmp_path)) == 4
