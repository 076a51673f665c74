"""The hybrid, ssm, audio and vlm families on the port's mesh
(``torch.distributed`` + DTensor) against the port on one device and
against the reference's own sharded steps (CPU, float32).

As ``tests/test_torch_mesh.py`` holds dense and moe: the reference runs
unmodified in one subprocess with 8 forced host devices on meshes of
``AxisType.Auto``: 3 train steps of each config on (2, 2, 2) ("pod",
"data", "model") and on one device, prefill + 3 decode steps on (2, 2, 2)
and on (1, 2) ("data", "model"), and for ``recurrentgemma-9b-smoke`` a
prompt of 8 and 12 decode steps, past the wrap of its 16-slot window,
which the model axis splits in two.  Its initial params are the port's
too; the batches, prompts and frontend stubs (``frames``, ``patches``) are
numpy arrays from seeds, handed to both.  The port runs in gloo ranks on
the CPU (``tests/torch_mesh_ranks.py``): one group of 8 for the train
step, the checkpoints and the (2, 2, 2) serves, one of 2 for the (1, 2)
serves (with each rank's final recurrent states) and one (1, 2) train step
of the recurrent families.

Tolerances are ``tests/test_torch_mesh.py``'s: losses rtol 1e-5, logits
atol 1e-5; params after 3 steps, where the gradient stayed above 1e-4,
within the gaps between two correct orders of the same sums plus 1e-5 of
a leaf's largest magnitude, else within Adam's 2 x lr a step.  Against one
device the gaps are the port's to the reference on one device and the
reference's own between its (2, 2, 2) mesh and one device: the RG-LRU's
gate weights and the embedding move by 1.1e-5 of their largest magnitude
between the reference's mesh and its one device, more than dense and moe
leaves do, so the reference's own mesh gap is part of the yardstick.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.nn.layers import leaves

# the module spawns groups of 8 and 2 rank processes: one xdist worker
pytestmark = pytest.mark.xdist_group("runtime")

ROOT = Path(__file__).resolve().parents[1]
RTOL, REL, ATOL = 1e-5, 1e-5, 1e-5
BIG_GRAD = 1e-4
TIMEOUT = 600
ARCHS = ranks.FAMILY_ARCHS

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import lm
from repro.train import serve
from repro.train.optimizer import OptConfig
from repro.train.trainer import TrainOptions, init_train_state, make_train_step

B, MAX, STEPS = {consts}
inp = dict(np.load(sys.argv[2]))
out = {{}}

def mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))

def arrays(prefix):
    return {{k[len(prefix):]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(prefix)}}

for arch in {archs}:
    cfg = get_config(arch)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    m = mesh((2, 2, 2), ("pod", "data", "model"))
    step, rules = make_train_step(cfg, ocfg, m, TrainOptions(donate=False))
    p, o = init_train_state(cfg, jax.random.PRNGKey(0), mesh=m, rules=rules)
    init = [np.asarray(x) for x in jax.tree.leaves(p)]
    for i, x in enumerate(init):
        out[f"{{arch}}/init/{{i}}"] = x
    losses = []
    with m:
        for i in range(STEPS):
            p, o, met = step(p, o, arrays(f"{{arch}}/batch/{{i}}/"))
            losses.append(float(met["loss"]))
    out[f"{{arch}}/train_losses"] = np.array(losses)
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{{arch}}/final/{{i}}"] = np.asarray(x)
    params = jax.tree.unflatten(jax.tree.structure(p),
                                [jnp.asarray(x) for x in init])
    # the same steps on one device: the reordering yardstick for params
    step1, _ = make_train_step(cfg, ocfg, None, TrainOptions(donate=False))
    p1 = params
    o1 = {{"m": jax.tree.map(jnp.zeros_like, o["m"]),
           "v": jax.tree.map(jnp.zeros_like, o["v"]),
           "step": jnp.zeros((), jnp.int32)}}
    for i in range(STEPS):
        p1, o1, _ = step1(p1, o1, arrays(f"{{arch}}/batch/{{i}}/"))
    for i, x in enumerate(jax.tree.leaves(p1)):
        out[f"{{arch}}/single_plain/{{i}}"] = np.asarray(x)
    tags = [t for t in ("", "_ring") if f"{{arch}}/dec{{t}}" in inp]
    for name, shape, axes in (("222", (2, 2, 2), ("pod", "data", "model")),
                              ("12", (1, 2), ("data", "model"))):
        sm = mesh(shape, axes)
        pre, _ = serve.make_prefill_step(cfg, sm, B, MAX)
        de, _ = serve.make_decode_step(cfg, sm, B, MAX)
        for tag in tags:
            dec = inp[f"{{arch}}/dec{{tag}}"]
            with sm:
                # copies: the reference's sLSTM cache holds one zeros array
                # as both c and h, which its donating steps refuse
                cache = jax.tree.map(jnp.copy, lm.init_cache(cfg, B, MAX))
                lg, cache = pre(params, cache, arrays(f"{{arch}}/prompt{{tag}}/"))
                logits = [np.asarray(lg)]
                for t in range(len(dec)):
                    lg, cache = de(params, cache, jnp.asarray(dec[t]))
                    logits.append(np.asarray(lg))
            out[f"{{arch}}/serve_{{name}}{{tag}}"] = np.stack(logits)
np.savez(sys.argv[1], **out)
"""


def _inputs(path: Path) -> None:
    """The batches, prompts, stubs and decode tokens both packages take."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for i in range(ranks.TRAIN_STEPS):
            for k, v in ranks.train_batch(cfg, i).items():
                out[f"{arch}/batch/{i}/{k}"] = v
        cases = [("", ranks.SERVE_S, ranks.SERVE_N)]
        if arch == ranks.RING_ARCH:
            cases.append(("_ring", ranks.RING_PROMPT, ranks.RING_STEPS))
        for tag, s, n in cases:
            prompt, dec = ranks.serve_inputs(cfg, s, n)
            for k, v in prompt.items():
                out[f"{arch}/prompt{tag}/{k}"] = v
            out[f"{arch}/dec{tag}"] = dec
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref_families")
    path, inp = work / "ref.npz", work / "inputs.npz"
    _inputs(inp)
    code = textwrap.dedent(REFERENCE).format(
        consts=(ranks.SERVE_B, ranks.SERVE_MAX, ranks.TRAIN_STEPS),
        archs=ARCHS)
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    try:
        r = subprocess.run([sys.executable, "-c", code, str(path), str(inp)],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=TIMEOUT)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the reference's mesh run passed {TIMEOUT} s:\n"
                    f"{(e.stderr or '')[-4000:]}")
    assert r.returncode == 0, r.stderr[-4000:]
    return path


@pytest.fixture(scope="module")
def suite(ref, tmp_path_factory):
    work = tmp_path_factory.mktemp("families8")
    out = ranks.spawn(ranks.family_suite, 8, work, str(ref), timeout=TIMEOUT)
    out["workdir"] = work
    return out


@pytest.fixture(scope="module")
def serve12(ref, tmp_path_factory):
    return ranks.spawn(ranks.family_serve_12, 2,
                       tmp_path_factory.mktemp("families2"), str(ref),
                       timeout=TIMEOUT)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gaps(got, exp, grad_min, *yards):
    """Each leaf's largest |got - exp| and the sum of its largest |a - b|
    for each (a, b) in ``yards``, over the elements whose gradient stayed
    above BIG_GRAD, as fractions of the leaf's largest |exp|; and the
    largest |got - exp| elsewhere (``tests/test_torch_mesh.py``'s)."""
    out, small = [], 0.0
    for i, (g, e, m) in enumerate(zip(leaves(got), leaves(exp), grad_min)):
        big = _np(m) > BIG_GRAD
        scale = max(float(np.abs(_np(e)).max()), 1e-30)
        err = np.abs(_np(g) - _np(e))
        yard = sum(np.abs(_np(a[i]) - _np(b[i]))[big].max(initial=0.0)
                   for a, b in yards)
        out.append((float(err[big].max(initial=0.0)) / scale,
                    float(yard) / scale))
        small = max(small, float(err[~big].max(initial=0.0)))
    return out, small


def _ref_leaves(ref, tag, n):
    return [ref[f"{tag}/{i}"] for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device(suite, ref, arch):
    r = suite["train"][arch]
    np.testing.assert_allclose(r["mesh"], r["single"], rtol=RTOL)
    n = len(leaves(r["params"]))
    single = leaves(r["single_params"])
    want = np.load(ref)
    one = _ref_leaves(want, f"{arch}/single_plain", n)
    gaps, small = _gaps(r["params"], single, r["grad_min"], (single, one),
                        (_ref_leaves(want, f"{arch}/final", n), one))
    print(f"{arch}: params (mesh vs one device, one device vs the "
          f"reference) {max(gaps)}, elsewhere {small}")
    for mesh_gap, yard in gaps:
        assert mesh_gap <= yard + REL, (mesh_gap, yard)
    assert small <= 2 * r["lr"] * ranks.TRAIN_STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference_mesh(suite, ref, arch):
    """The port's (2,2,2) step against the reference's on an Auto mesh."""
    r = suite["train"][arch]
    want = np.load(ref)
    np.testing.assert_allclose(r["mesh"], want[f"{arch}/train_losses"],
                               rtol=RTOL)
    n = len(leaves(r["params"]))
    final = _ref_leaves(want, f"{arch}/final", n)
    one = _ref_leaves(want, f"{arch}/single_plain", n)
    gaps, small = _gaps(r["params"], final, r["grad_min"],
                        (leaves(r["single_params"]), one), (final, one))
    for mesh_gap, yard in gaps:
        assert mesh_gap <= yard + REL, (mesh_gap, yard)
    assert small <= 2 * r["lr"] * ranks.TRAIN_STEPS


# each rank's share of the first self-attention cache's slots (model 2),
# and of the recurrent state's split channels: rec's h along rnn
# (d_rnn 64), mlstm's C along ff (its value dim, 32); xlstm has no
# attention cache
SLOTS = {"recurrentgemma-9b-smoke": 8, "xlstm-1.3b-smoke": None,
         "whisper-base-smoke": ranks.SERVE_MAX // 2,
         "llava-next-mistral-7b-smoke": ranks.SERVE_MAX // 2}
STATE = {"recurrentgemma-9b-smoke": ("0_rec", "h", -1, 32),
         "xlstm-1.3b-smoke": ("0_mlstm", "C", -1, 16)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["222", "12"])
def test_serve_steps_on_mesh(suite, serve12, ref, arch, mesh):
    r = (suite["serve"] if mesh == "222" else serve12)[(arch, mesh)]
    single = r["single"]
    want = np.load(ref)[f"{arch}/serve_{mesh}"]
    got = r["mesh"].numpy()
    assert got.shape == (ranks.SERVE_N + 1, ranks.SERVE_B,
                         get_config(arch).padded_vocab)
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert r["local_slots"] == SLOTS[arch]
    if arch in STATE:
        key, leaf, dim, n = STATE[arch]
        shape = r["local_state"][key][leaf]
        assert shape[dim] == n and shape[1] == ranks.SERVE_B // (
            4 if mesh == "222" else 1), shape


def _attn_calls(cfg, s: int) -> list:
    """(queries, keys, causal) of each attention of a forward over ``s``
    tokens on a model axis of 2: S / 2 of the positions against all."""
    if cfg.family == "ssm":
        return []
    s += cfg.n_patches if cfg.family == "vlm" else 0
    calls = [(s // 2, s, True)]
    if cfg.family == "audio":       # the encoder's, and the cross's
        f = cfg.n_audio_frames
        calls += [(f // 2, f, False), (s // 2, f, False)]
    return sorted(calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_splits_queries(suite, arch):
    """Every rank of (2,2,2) attends S / model of the positions in train
    and prefill: the self-attention's queries against all of its keys, the
    audio encoder's likewise, the cross-attention's against all frames."""
    cfg = get_config(arch)
    rec = suite["splits"][arch]
    assert len(rec["train"]) == len(rec["serve"]) == 8
    for r in rec["train"]:
        assert r["attn"] == _attn_calls(cfg, ranks.TRAIN_SEQ), r["attn"]
    for r in rec["serve"]:
        assert r["attn"] == _attn_calls(cfg, ranks.SERVE_S), r["attn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_splits_vocab_and_heads(suite, serve12, arch):
    """What each rank of (2,2,2) computed, and rank 0 of the (1,2)
    serve: in train and serve the embedding of its padded_vocab / model
    rows and the LM head of as many columns, and in train the loss over
    them; at decode its q, k and v projections over K / model kv heads
    (MQA: q over G / model groups), the audio decoder's cross-attention's
    q too; none for the ssm."""
    cfg = get_config(arch)
    rec = suite["splits"][arch]
    for mode in ("train", "serve"):
        for r in rec[mode]:
            want = ranks.vocab_calls(cfg, 2, mode == "train")
            assert r["vocab"] == want, r["vocab"]
    for r in rec["serve"] + [serve12[(arch, "12")]["probe"]]:
        assert ranks.decode_proj(r) == ranks.decode_proj_want(cfg, 2), \
            r["proj"]
    assert sorted(set(serve12[(arch, "12")]["probe"]["vocab"])) == \
        ranks.vocab_calls(cfg, 2, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_splits_recurrences(suite, serve12, arch):
    """What each rank of (2,2,2), and rank 0 of (1,2), read of the
    recurrent blocks in train and serve (``ranks.recurrent_want``): the
    RG-LRU's w_x, w_gate and w_out at d_rnn / model, the mLSTM's w_up at
    di / model and its v at dv / model, the sLSTM's up and down at dff /
    model; in serve each state leaf as its local shard, its batch rows and
    its channels / model (the mLSTM's C at dv / model), so that no state
    is gathered; nothing for the other families."""
    cfg = get_config(arch)
    rec = suite["splits"][arch]
    for mode, rows in (("train", None), ("serve", ranks.SERVE_B // 4)):
        for r in rec[mode]:
            assert r["recurrent"] == ranks.recurrent_want(cfg, 2, rows), \
                r["recurrent"]
    got = sorted(set(serve12[(arch, "12")]["probe"]["recurrent"]))
    assert got == ranks.recurrent_want(cfg, 2, ranks.SERVE_B), got
    if arch in ranks.RECURRENT_ARCHS:
        r = serve12[(arch, "12_train")]
        np.testing.assert_allclose(r["mesh"], r["single"], rtol=RTOL)
        got = sorted(set(r["probe"]["recurrent"]))
        assert got == ranks.recurrent_want(cfg, 2, None), got


# the recurrent state leaves that the model axis splits along their last
# dim: the RG-LRU's channels, the mLSTM's value dim (C) and di (conv)
SPLIT_STATE = {"rec": ("h", "conv"), "mlstm": ("C", "conv")}


@pytest.mark.parametrize("arch", ranks.RECURRENT_ARCHS)
def test_mesh_recurrent_states_are_slices(serve12, arch):
    """After the (1,2) prefill and decode steps, each rank's local shard
    of every recurrent state equals its slice of one device's final state
    (SPLIT_STATE's leaves: slice r of 2 along the last dim; the mLSTM's n
    and m and the sLSTM's state whole), within the file's RTOL and ATOL:
    past the first layer each layer's input holds sums over the model axis
    in another order (on seed-0 params the sLSTM's n moved by 9.8e-6)."""
    st = serve12[(arch, "12")]["states"]
    assert len(st["mesh"]) == 2 and st["single"]
    for r, mine in enumerate(st["mesh"]):
        assert mine.keys() == st["single"].keys()
        for key, t in mine.items():
            whole = st["single"][key].numpy()
            if key[2] in SPLIT_STATE.get(key[1].split("_", 1)[1], ()):
                n = whole.shape[-1] // 2
                whole = whole[..., r * n:(r + 1) * n]
            assert t.shape == whole.shape, (key, t.shape, whole.shape)
            np.testing.assert_allclose(t.numpy(), whole, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("mesh", ["222", "12"])
def test_hybrid_ring_decode_wraps(suite, serve12, ref, mesh):
    """Prompt 8, then 12 decode steps through positions 8..19 of the
    16-slot window split over the model axis (8 slots a rank): from
    position 16 on each step overwrites the oldest slot of the ring, on the
    rank that holds it; the logits of every step equal one device's and
    the reference's."""
    arch = ranks.RING_ARCH
    r = (suite["serve"] if mesh == "222" else serve12)[(arch, mesh +
                                                        "_ring")]
    want = np.load(ref)[f"{arch}/serve_{mesh}_ring"]
    got = r["mesh"].numpy()
    assert got.shape[0] == ranks.RING_STEPS + 1
    assert ranks.RING_PROMPT + ranks.RING_STEPS > 16 == 2 * r["local_slots"]
    for t in range(ranks.RING_STEPS + 1):
        np.testing.assert_allclose(got[t], r["single"][t].numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=ATOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_reads_mesh_checkpoint(suite, arch):
    """A port checkpoint saved from DTensors on (2,2,2) is read by the
    reference's restore in one process: the whole params, as the port's
    mesh step left them."""
    import jax
    from repro.ckpt.checkpoint import restore_checkpoint as jrestore
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    r = suite["train"][arch]
    template = {"params": jlm.abstract_model(jget(arch))}
    got = jrestore(str(suite["workdir"] / f"ckpt_{arch}"),
                   ranks.TRAIN_STEPS, template)
    for a, b in zip(jax.tree.leaves(got["params"]), leaves(r["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture
def world1():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_world1_equals_single_device(world1, arch):
    """A world-1 gloo mesh (1,1,1): every family's train step equals one
    device's exactly, its serve steps within ATOL."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    m = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    cfg = get_config(arch)
    init = lm.init_model(cfg, 0, device="cpu")
    single = ranks._train(cfg, init, 2)
    mesh = ranks._train(cfg, init, 2, mesh=m)
    np.testing.assert_allclose(mesh[0], single[0], rtol=RTOL)
    for g, e in zip(leaves(ranks._full(mesh[1])), leaves(single[1])):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    prompt, dec = ranks.serve_inputs(cfg)
    got, slots = ranks._serve(cfg, init, prompt, dec, mesh=m)
    want, _ = ranks._serve(cfg, init, prompt, dec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    assert slots == (None if SLOTS[arch] is None else 2 * SLOTS[arch])
