"""The port's mesh (``torch.distributed`` + DTensor) against the port on
one device and against the reference's own sharded steps (CPU, float32).

The reference runs unmodified in one subprocess with 8 forced host devices
on meshes of ``AxisType.Auto`` (jax 0.9's ``make_mesh`` defaults to
``Explicit``, under which the reference's jit stops): 3 train steps of
each config on (2, 2, 2) ("pod", "data", "model"), prefill + 3 decode
steps on (2, 2, 2) and on (1, 2) ("data", "model").  Its initial params
are the port's too.  The port runs in gloo ranks on the CPU
(``tests/torch_mesh_ranks.py``): one group of 8 for the train variants,
the serve steps, the lse merge, the checkpoint reshard, the compressed
psum and the first half of an elastic restart; one of 4 for its second
half; one of 2 for the (1, 2) serve.

Tolerances (float32; the mesh sums partial gradients, norms and
softmaxes in another order than one device): losses rtol 1e-5; logits atol
1e-5.  Params after 3 steps: Adam's update is scale-free per element, so a
gradient element that is a small sum of large terms carries its rounding
into the update at full size, and one near eps flips between 0 and 1
(``g / (|g| + eps)``).  Two correct orders of the same sums then differ by
more than 1e-5 of a leaf's largest magnitude: the port and the reference,
each on one device, by up to 9e-5 on qwen3-14b-smoke's embedding.  So,
over the elements whose gradient stayed above 1e-4 at every step, each
leaf's largest error against the port on one device is held to the gap
between the port and the reference on one device (the same steps, options
and initial params) plus 1e-5 of the leaf's largest magnitude; against the
reference's (2,2,2) params to that gap plus the reference's own gap
between (2,2,2) and one device, plus 1e-5.  Elsewhere an element is held
within 2 x lr a step (the bound of ``tests/test_torch_train.py``).  With
``compress_grads`` a last-bit difference in a gradient can move one int8
rounding step, so losses there are held at rtol 1e-4 and the params'
largest error is printed, not bounded.
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

# the module spawns groups of 8, 4 and 2 rank processes: one xdist worker
pytestmark = pytest.mark.xdist_group("runtime")

ROOT = Path(__file__).resolve().parents[1]
RTOL, REL, ATOL = 1e-5, 1e-5, 1e-5
COMPRESS_RTOL = 1e-4
TIMEOUT = 600

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.data.pipeline import SyntheticLM
from repro.models import lm
from repro.train import serve
from repro.train.optimizer import OptConfig
from repro.train.trainer import TrainOptions, init_train_state, make_train_step

B, S, N, MAX, TB, TS, STEPS = {consts}
out = {{}}

def mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))

for arch in {archs}:
    cfg = get_config(arch)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    data = SyntheticLM(cfg.vocab_size, seed=0)
    m = mesh((2, 2, 2), ("pod", "data", "model"))
    step, rules = make_train_step(cfg, ocfg, m, TrainOptions(donate=False))
    p, o = init_train_state(cfg, jax.random.PRNGKey(0), mesh=m, rules=rules)
    init = [np.asarray(x) for x in jax.tree.leaves(p)]
    for i, x in enumerate(init):
        out[f"{{arch}}/init/{{i}}"] = x
    losses = []
    with m:
        for i in range(STEPS):
            p, o, met = step(p, o, data.batch(i, TB, TS))
            losses.append(float(met["loss"]))
    out[f"{{arch}}/train_losses"] = np.array(losses)
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{{arch}}/final/{{i}}"] = np.asarray(x)
    params = jax.tree.unflatten(jax.tree.structure(p),
                                [jnp.asarray(x) for x in init])
    # the same steps on one device: the reordering yardstick for params
    for name, kw in (("plain", {{}}), ("microbatches_2", {{"microbatches": 2}}),
                     ("compress_grads", {{"compress_grads": True}})):
        step1, _ = make_train_step(cfg, ocfg, None,
                                   TrainOptions(donate=False, **kw))
        p1, o1 = params, jax.tree.map(jnp.zeros_like, o)
        o1 = {{"m": o1["m"], "v": o1["v"], "step": jnp.zeros((), jnp.int32)}}
        for i in range(STEPS):
            p1, o1, _ = step1(p1, o1, data.batch(i, TB, TS))
        for i, x in enumerate(jax.tree.leaves(p1)):
            out[f"{{arch}}/single_{{name}}/{{i}}"] = np.asarray(x)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab_size, (N, B, 1)).astype(np.int32)
    for name, shape, axes in (("222", (2, 2, 2), ("pod", "data", "model")),
                              ("12", (1, 2), ("data", "model"))):
        sm = mesh(shape, axes)
        pre, _ = serve.make_prefill_step(cfg, sm, B, MAX)
        de, _ = serve.make_decode_step(cfg, sm, B, MAX)
        with sm:
            cache = lm.init_cache(cfg, B, MAX)
            lg, cache = pre(params, cache, {{"tokens": jnp.asarray(prompt)}})
            logits = [np.asarray(lg)]
            for t in range(N):
                lg, cache = de(params, cache, jnp.asarray(dec[t]))
                logits.append(np.asarray(lg))
        out[f"{{arch}}/serve_{{name}}"] = np.stack(logits)
np.savez(sys.argv[1], **out)
"""


def _run_reference(path: Path):
    code = textwrap.dedent(REFERENCE).format(
        consts=(ranks.SERVE_B, ranks.SERVE_S, ranks.SERVE_N, ranks.SERVE_MAX,
                ranks.TRAIN_BATCH, ranks.TRAIN_SEQ, ranks.TRAIN_STEPS),
        archs=ranks.ARCHS)
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    try:
        r = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=TIMEOUT)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the reference's mesh run passed {TIMEOUT} s:\n"
                    f"{(e.stderr or '')[-4000:]}")
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    _run_reference(path)
    return path


@pytest.fixture(scope="module")
def suite(ref, tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh8")
    out = ranks.spawn(ranks.mesh_suite, 8, work, str(ref), timeout=TIMEOUT)
    out["workdir"] = work
    return out


@pytest.fixture(scope="module")
def elastic(suite, ref):
    return ranks.spawn(ranks.elastic_second, 4, suite["workdir"], str(ref),
                       timeout=TIMEOUT)


@pytest.fixture(scope="module")
def serve12(ref, tmp_path_factory):
    return ranks.spawn(ranks.serve_12, 2, tmp_path_factory.mktemp("mesh2"),
                       str(ref), timeout=TIMEOUT)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


BIG_GRAD = 1e-4


def _gaps(got, exp, grad_min, *yards):
    """Each leaf's largest |got - exp| and the sum of its largest
    |a - b| for each (a, b) in ``yards``, over the elements whose gradient
    stayed above BIG_GRAD, as fractions of the leaf's largest |exp|; and
    the largest |got - exp| elsewhere."""
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


@pytest.mark.parametrize("arch", ranks.ARCHS)
@pytest.mark.parametrize("variant", [v[0] for v in ranks.VARIANTS])
def test_sharded_train_step_matches_single_device(suite, ref, arch,
                                                  variant):
    r = suite["train"][(arch, variant)]
    rtol = COMPRESS_RTOL if variant == "compress_grads" else RTOL
    np.testing.assert_allclose(r["mesh"], r["single"], rtol=rtol)
    one = {"direct": "plain", "coordinator": "plain"}.get(variant, variant)
    n = len(leaves(r["params"]))
    single = leaves(r["single_params"])
    gaps, small = _gaps(r["params"], single, r["grad_min"], (
        single, _ref_leaves(np.load(ref), f"{arch}/single_{one}", n)))
    print(f"{arch} {variant}: params (mesh vs one device, one device vs "
          f"the reference) {max(gaps)}, elsewhere {small}")
    if variant != "compress_grads":
        for mesh_gap, yard in gaps:
            assert mesh_gap <= yard + REL, (mesh_gap, yard)
        assert small <= 2 * r["lr"] * ranks.TRAIN_STEPS


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_train_step_matches_reference_mesh(suite, ref, arch):
    """The port's (2,2,2) step against the reference's on an Auto mesh."""
    r = suite["train"][(arch, "direct")]
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


@pytest.mark.parametrize("arch", ranks.ARCHS)
@pytest.mark.parametrize("mesh", ["222", "12"])
def test_serve_steps_on_mesh(suite, serve12, ref, arch, mesh):
    r = (suite["serve"] if mesh == "222" else serve12)[(arch, mesh)]
    single = suite["serve"][(arch, "222")]["single"]
    want = np.load(ref)[f"{arch}/serve_{mesh}"]
    got = r["mesh"].numpy()
    assert got.shape == (ranks.SERVE_N + 1, ranks.SERVE_B,
                         get_config(arch).padded_vocab)
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # every rank holds S / model slots of the cache (model = 2 here)
    assert r["local_slots"] == ranks.SERVE_MAX // 2


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_serve_uneven_sequence_split(serve12, arch):
    """A prompt of SERVE_S - 1 = 15 on (1,2): prefill's positions split 8
    and 7 over the model axis; every step's logits equal one device's."""
    r = serve12[(arch, "12_odd")]
    np.testing.assert_allclose(r["mesh"].numpy(), r["single"].numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_model_axis_splits_experts_and_queries(suite, arch):
    """What each of the 8 ranks of (2,2,2) computed: under the train rules
    every expert buffer holds E / model experts, of the dispatch groups of
    its own 2 rows alone (64 tokens: 4 of the batch's 16 groups); under
    the serve rules every expert's moe_d_ff / model columns (prefill's 2
    groups of 16 tokens, decode's one of 8); each train and prefill
    attention's queries cover S / model positions against all S keys."""
    from repro_torch.nn.moe import capacity
    cfg = get_config(arch)
    m, rows = 2, ranks.TRAIN_BATCH // 4
    rec = suite["splits"][arch]
    assert len(rec["train"]) == len(rec["serve"]) == 8
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gs = cfg.moe_group_size
    for r in rec["train"]:
        assert r["attn"] == [(ranks.TRAIN_SEQ // m, ranks.TRAIN_SEQ, True)]
        assert r["experts"] == ([] if not e else [(
            (rows * ranks.TRAIN_SEQ // gs, e // m, capacity(cfg, gs), d),
            (e // m, d, ff))])
    for r in rec["serve"]:
        assert r["attn"] == [(ranks.SERVE_S // m, ranks.SERVE_S, True)]
        assert r["experts"] == ([] if not e else sorted([
            ((rows * ranks.SERVE_S // gs, e, capacity(cfg, gs), d),
             (e, d, ff // m)),
            ((1, e, capacity(cfg, ranks.SERVE_B), d), (e, d, ff // m))]))


@pytest.mark.parametrize("model", [2, 4])
def test_lse_merge_across_ranks(suite, model):
    cases = suite["lse"][model]
    assert [c["empty_ranks"] for c in cases][0] == [model - 1]
    assert cases[-1]["empty_ranks"] == list(range(1, model))
    for c in cases:
        assert not torch.isnan(c["got"]).any()
        np.testing.assert_allclose(c["got"].numpy(), c["exp"].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_compressed_psum_eight_ranks(suite):
    """As tests/test_distributed.py:99-101: a sum over 8 ranks of the same
    tensor is 8x it, within 8 half int8 steps."""
    g, out = suite["psum"]["g"], suite["psum"]["out"]
    bound = 8 * float(g.abs().max()) / 127 / 2 * 1.05
    err = float((out - g * 8).abs().max())
    assert err <= bound, (err, bound)


def test_checkpoint_reshard_restore(suite):
    r = suite["reshard"]
    np.testing.assert_array_equal(r["full"].numpy(),
                                  np.arange(64.0).reshape(8, 8))
    assert r["model"] == 4 and tuple(r["local"].shape) == r["want_local"]


def test_elastic_rescale_matches_single_device(suite, elastic):
    """2 steps on (4,2), restored onto (2,2), 2 more: the losses of 4
    single-device steps (stronger than the reference's "finite")."""
    assert elastic["step"] == 2
    np.testing.assert_allclose(suite["elastic_first"] + elastic["second"],
                               elastic["single"], rtol=RTOL)


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_reference_reads_mesh_checkpoint(suite, arch):
    """A port checkpoint saved from DTensors on (2,2,2) is read by the
    reference's restore in one process: the whole params, as the port's
    mesh step left them."""
    import jax
    from repro.ckpt.checkpoint import restore_checkpoint as jrestore
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    r = suite["train"][(arch, "direct")]
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


def test_make_mesh_checks(world1):
    from repro_torch.launch.mesh import (data_axis_size, make_mesh,
                                         make_production_mesh)
    m = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert tuple(m.mesh_dim_names) == ("pod", "data", "model")
    assert data_axis_size(m) == 1
    with pytest.raises(ValueError, match="world"):
        make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="world"):
        make_production_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 1), ("data", "model"))


def test_mesh_step_world1_equals_single_device(world1):
    """A world-1 gloo mesh (1,1,1): train, prefill and decode equal the
    single-device steps."""
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    for arch in ranks.ARCHS:
        cfg = get_config(arch)
        from repro_torch.models import lm
        init = lm.init_model(cfg, 0, device="cpu")
        single = ranks._train(cfg, init, 2)
        mesh = ranks._train(cfg, init, 2, mesh=m)
        np.testing.assert_allclose(mesh[0], single[0], rtol=RTOL)
        for g, e in zip(leaves(ranks._full(mesh[1])), leaves(single[1])):
            torch.testing.assert_close(g, e, rtol=0, atol=0)
        prompt, dec = ranks.serve_inputs(cfg)
        got, slots = ranks._serve(cfg, init, prompt, dec, mesh=m)
        want, _ = ranks._serve(cfg, init, prompt, dec)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)
        assert slots == ranks.SERVE_MAX


@pytest.mark.parametrize("lengths", [(5, 40, 1), (0, 40, 17)])
def test_decode_attn_return_lse_plain(lengths):
    """The plain version's ``return_lse`` on the CPU (what the wrapper takes
    for CPU tensors): the float32 output equals the reference's
    ``decode_attn_ref`` where a row has a valid slot, and 0 where it has
    none; the lse is the log-sum-exp of the scaled, masked logits (-inf on
    an empty row)."""
    import jax.numpy as jnp
    from repro.kernels.decode_attn.ref import decode_attn_ref as jref
    from repro_torch.kernels.decode_attn.decode_attn import decode_attn
    rng = np.random.default_rng(3)
    b, k, g, hd, s = 3, 2, 4, 16, 40
    q = rng.standard_normal((b, k, g, hd)).astype(np.float32)
    kk, vv = (rng.standard_normal((b, k, s, hd)).astype(np.float32)
              for _ in range(2))
    lens = np.array(lengths, np.int32)
    out, lse = decode_attn(*(torch.from_numpy(a) for a in (q, kk, vv, lens)),
                           return_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, k, g)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                           jnp.asarray(lens)))
    logits = np.einsum("bkgh,bksh->bkgs", q, kk) / np.sqrt(np.float32(hd))
    for i, n in enumerate(lens):
        if n == 0:
            assert (out[i] == 0).all() and torch.isneginf(lse[i]).all()
            continue
        np.testing.assert_allclose(out[i].numpy(), want[i], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            lse[i].numpy(), torch.logsumexp(torch.from_numpy(
                logits[i, :, :, :n]), -1).numpy(), rtol=1e-5, atol=1e-5)
