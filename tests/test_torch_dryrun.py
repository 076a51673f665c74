"""The port's dry-run and roofline analysis (``repro_torch.launch.dryrun``,
``repro_torch.launch.analysis``) against the reference's
(``repro.launch.{dryrun,analysis}``), on the CPU.

The port counts a step on fake tensors under a ``fake`` process group (no
process behind the other ranks), where the reference compiles it and
walks the HLO.  Here: the report's terms with the H100 constants; the
analytic model FLOPs equal to the reference's for every arch and shape;
:func:`count_step` exact on a matmul and on an all-gather and an
all-reduce of a fake (2,2,2) mesh; the five families' reduced configs
counted for train, prefill and decode on a fake (2,2,2) mesh, the
counterpart of ``tests/test_distributed.py``'s
``test_dryrun_reduced_cells_compile_multipod``; the matmul FLOPs of a
world-1 step within 10% of the reference's ``analyze_hlo`` of its own
compiled step; and one full-size cell through the CLI.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, LM_SHAPES, ShapeConfig, get_config
from repro_torch.launch import analysis as A

ROOT = Path(__file__).resolve().parents[1]
# the reference's reduced cells (tests/test_distributed.py:63-83)
FAMILIES = ("qwen3-14b", "deepseek-moe-16b", "recurrentgemma-9b",
            "whisper-base", "xlstm-1.3b")
CELLS = (ShapeConfig("t", 32, 8, "train"), ShapeConfig("p", 32, 4, "prefill"),
         ShapeConfig("d", 32, 8, "decode"))
FLOPS_REL = 0.10
FULL_CELL_S = 60.0


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0, destroyed after the block."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import init_fake_world
    init_fake_world(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_count_step_leaves_no_fake_tensor_behind(monkeypatch):
    """A step counted on fake tensors leaves nothing fake in the module
    caches that later real steps read (the RoPE frequencies, made once a
    device, here first made under the count): a real forward after the
    count gives the logits of one with the cache emptied."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.models import lm
    from repro_torch.nn import layers
    cfg = get_config("qwen3-14b-smoke")
    params = lm.init_model(cfg, 0, device="cpu")
    tokens = torch.arange(24).reshape(2, 12) % cfg.vocab_size
    monkeypatch.setattr(layers, "_ROPE_FREQS", {})
    A.count_step(lambda p: lm.forward(p, {"tokens": tokens}, cfg), params)
    after = lm.forward(params, {"tokens": tokens}, cfg)
    monkeypatch.setattr(layers, "_ROPE_FREQS", {})
    fresh = lm.forward(params, {"tokens": tokens}, cfg)
    assert not isinstance(after, FakeTensor)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)


class TestRooflineReport:
    def test_terms_and_bottleneck(self):
        r = A.RooflineReport(
            arch="x", shape="train_4k", mesh="16x16",
            flops=A.PEAK_FLOPS, hbm_bytes=A.HBM_BW,
            coll_bytes={"all-gather": A.LINK_BW},
            model_flops=A.PEAK_FLOPS / 2, peak_mem_bytes=1e9)
        assert r.t_compute == pytest.approx(1.0)
        assert r.t_memory == pytest.approx(1.0)
        assert r.t_collective == pytest.approx(1.0)
        assert r.useful_flops_frac == pytest.approx(0.5)
        assert r.roofline_frac == pytest.approx(0.5)
        r.hbm_bytes *= 2
        assert r.bottleneck == "memory"
        assert r.roofline_frac == pytest.approx(0.25)

    def test_h100_constants(self):
        """The NVIDIA H100 SXM datasheet's dense bf16 rate, HBM3 and one
        direction of NVLink 4."""
        assert (A.PEAK_FLOPS, A.HBM_BW, A.LINK_BW) == (989e12, 3.35e12,
                                                       450e9)

    def test_model_flops_modes(self):
        cfg = get_config("qwen3-14b")
        n = cfg.n_params()
        tr = A.model_flops_for(cfg, ShapeConfig("t", 4096, 256, "train"))
        pf = A.model_flops_for(cfg, ShapeConfig("p", 4096, 256, "prefill"))
        de = A.model_flops_for(cfg, ShapeConfig("d", 4096, 256, "decode"))
        assert tr == pytest.approx(6 * n * 4096 * 256)
        assert pf == pytest.approx(tr / 3)
        assert de == pytest.approx(2 * n * 256)

    def test_to_dict_keys_are_the_reference(self):
        from repro.launch.analysis import RooflineReport as JReport
        kw = dict(arch="x", shape="s", mesh="m", flops=1.0, hbm_bytes=1.0,
                  coll_bytes={}, model_flops=1.0, peak_mem_bytes=1.0)
        assert list(A.RooflineReport(**kw).to_dict()) == list(
            JReport(**kw).to_dict())


@pytest.mark.parametrize("shape", [s.name for s in LM_SHAPES])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch, shape):
    from repro.configs import get_config as jget
    from repro.configs import get_shape as jshape
    from repro.launch.analysis import model_flops_for as jflops
    from repro_torch.configs import get_shape
    assert A.model_flops_for(get_config(arch), get_shape(shape)) == \
        jflops(jget(arch), jshape(shape))


def test_count_step_matmul_exact():
    """(M, K) @ (K, N) in bf16: 2 M K N FLOPs; the operands read and the
    result written once; real inputs are read as fake ones."""
    m, k, n = 48, 80, 24
    a = torch.randn(m, k, dtype=torch.bfloat16)
    b = torch.randn(k, n, dtype=torch.bfloat16)
    t = A.count_step(lambda x, y: x @ y, a, b)
    assert t.flops == 2 * m * k * n
    assert t.bytes == 2 * (m * k + k * n + m * n)
    assert t.coll == {} and t.ops == {"aten.mm": 1}
    # views move nothing; an elementwise op reads and writes
    t = A.count_step(lambda x: (x * 2).T.unsqueeze(0), a)
    assert t.flops == 0 and t.bytes == 2 * 2 * m * k


def test_count_step_collectives_exact():
    """On a fake (2,2,2) mesh: an all-gather of a (8, 16) float32 tensor
    split 2 x 2 x 2 along its rows counts each of its three gathers'
    operands (the shard, then 2 and 4 shards: 7 x 64 bytes x 4); a
    ``dist.all_reduce`` of 10 float32 counts its 40 bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")

        def gather(x):
            d = distribute_tensor(x, mesh, [Shard(0)] * 3, src_data_rank=None)
            return d.redistribute(mesh, [Replicate()] * 3).to_local()

        t = A.count_step(gather, torch.zeros(8, 16))
        assert t.coll == {"all-gather": (1 + 2 + 4) * 16 * 4}
        assert t.flops == 0

        def reduce(x):
            dist.all_reduce(x)
            return x

        t = A.count_step(reduce, torch.zeros(10))
        assert t.coll == {"all-reduce": 40}


def test_count_step_steps_loop_counts_trip_count():
    """``nn.recurrent.run_steps`` counts its step as many times as the
    loop has steps: the sLSTM's FLOPs equal the unrolled loop's exactly
    (the first step's h0, which needs no gradient, aside: within 0.5%)."""
    from repro_torch.nn import recurrent as R
    from repro_torch.nn.layers import init_params
    cfg = get_config("xlstm-1.3b-smoke")
    p = init_params(R.slstm_defs(cfg), torch.Generator().manual_seed(0),
                    dtype=torch.float32)
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.randn(2, 24, cfg.d_model, requires_grad=True)

    def fwd(x):
        return R.slstm_sequence(p, x, cfg.n_heads)[0]

    def grad(x):
        h, st = R.slstm_sequence(p, x, cfg.n_heads)
        return torch.autograd.grad(h.sum() + st[0].sum(),
                                   [x, p["w_in"], p["r"]])

    for fn, tol in ((fwd, 0.0), (grad, 5e-3)):
        looped = A.count_step(fn, x)
        with contextlib.ExitStack() as st:
            st.callback(setattr, A, "_counted_steps", A._counted_steps)
            A._counted_steps = lambda c: contextlib.nullcontext()
            unrolled = A.count_step(fn, x)
        assert R.STEPS_HOOK.get() is None
        assert looped.flops == pytest.approx(unrolled.flops, rel=tol)
        assert looped.bytes == pytest.approx(unrolled.bytes, rel=tol)


@pytest.mark.parametrize("mode", [c.mode for c in CELLS])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_reduced_cells_count_multipod(arch, mode):
    """The five families' reduced configs on a fake (2,2,2) ("pod",
    "data", "model") mesh: each step counts, with FLOPs, bytes and the
    collectives of FSDP and the model axis."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_mesh
    shape = next(c for c in CELLS if c.mode == mode)
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        t, n_chips = lower_cell(get_config(arch + "-smoke"), shape, mesh)
    assert n_chips == 8
    assert t.flops > 0 and t.bytes > 0 and t.peak_mem > 0
    assert t.coll.get("all-gather", 0) > 0
    if mode == "train":
        assert t.coll.get("reduce-scatter", 0) > 0


def _no_expert_ffn(p, x):
    """The experts' FFN with no matmul (its params still take a
    gradient)."""
    return x + 0 * sum(p[k].sum() for k in ("wi", "wg", "wo"))


def _no_attn(p, x, ctx, cache, **kw):
    """An attention sublayer with no matmul (its params still take a
    gradient)."""
    from repro_torch.nn.layers import leaves
    return x + 0 * sum(t.sum() for t in leaves(p))


def _no_head(x, head):
    """The LM head with no matmul (its param still takes a gradient)."""
    return x.sum(-1, keepdim=True) * 0 + (head * 0).sum(0)


def _no_project(x, w):
    """An attention projection (d -> heads) with no matmul."""
    lead = x.sum(-1).view(*x.shape[:2], *[1] * (w.dim() - 1))
    return (lead + w.sum(0).to(x.dtype)) * 0


def _no_out_proj(out, wo):
    """The attention's output projection (heads -> d) with no matmul."""
    return (out.flatten(2).sum(-1, keepdim=True)
            + wo.reshape(-1, wo.shape[-1]).sum(0).to(out.dtype)) * 0


def _no_rglru(p, x, cfg, cache=None, split=None):
    """The RG-LRU block with no matmul (its params still take a gradient,
    its state stays as it was)."""
    from repro_torch.nn.layers import leaves
    new = {} if cache is None else {k: cache[k] for k in ("h", "conv")}
    return x + 0 * sum(t.sum() for t in leaves(p)), new


def _no_mlstm(cell, xn, ctx, cache):
    """The mLSTM cell with no matmul (its params still take a gradient)."""
    from repro_torch.nn.layers import leaves
    return xn + 0 * sum(t.sum() for t in leaves(cell))


def _no_gates(cell, xn, hh):
    """The mLSTM's gate projection with no matmul."""
    g = (xn.sum(-1, keepdim=True) + cell["w_if"].sum(0)
         + cell["b_if"]).float()
    return g[..., :hh], torch.nn.functional.logsigmoid(g[..., hh:])


def _no_chunk_whole(qf, kf, i_gate, lf, n_prev, m_prev, scale):
    """An mLSTM chunk's part without a value dim (``_chunk_whole``), its
    shapes and its inputs' gradients, with no matmul."""
    g = i_gate + lf
    qs, ks = qf.sum(-1), kf.sum(-1)
    s = qs[..., :, None] + ks[..., None, :] + g[..., None, :]
    inter = g + qs + n_prev.sum(-1)[..., None] + m_prev[..., None]
    return (s, inter, inter.exp(), g + ks, m_prev + g.sum(-1),
            (n_prev + kf.sum(-2), m_prev + g[..., -1]))


def _no_step_whole(qf, kf, i_gate, lf, n_prev, m_prev, scale):
    """A decode step's part without a value dim (``_step_whole``) with no
    matmul."""
    g = i_gate + lf + qf.sum(-1) + n_prev.sum(-1)
    return (g, g + m_prev, g.exp(), (n_prev + kf, m_prev + g))


# the parts whose FLOPs the model axis splits: (module, name, stand-in)s
SPLIT_PARTS = {
    "experts": [("repro_torch.nn.moe", "_expert_ffn", _no_expert_ffn)],
    "attn": [("repro_torch.models.lm", "_apply_attn", _no_attn)],
    "head": [("repro_torch.models.lm", "_lm_head", _no_head)],
    "proj": [("repro_torch.models.lm", "_project", _no_project),
             ("repro_torch.models.lm", "_out_proj", _no_out_proj)],
    "rglru": [("repro_torch.models.lm", "rglru_block", _no_rglru)],
    "mlstm": [("repro_torch.models.lm", "_apply_mlstm", _no_mlstm)],
    # the mLSTM's matmuls that every model rank computes alike: the gates,
    # and the scores q k^T and the normaliser's q n of each chunk or step
    "mlstm_whole": [("repro_torch.models.lm", "_mlstm_gates", _no_gates),
                    ("repro_torch.nn.recurrent", "_chunk_whole",
                     _no_chunk_whole),
                    ("repro_torch.nn.recurrent", "_step_whole",
                     _no_step_whole)],
}
# a part whose FLOPs the model axis splits but for a whole part, which
# each model rank computes for its rows: (2,2,2) splits the whole part 4
# ways (the rows) and the rest 8
WHOLE_PARTS = {"mlstm": "mlstm_whole"}
# (arch, mode, part): deepseek-moe-16b-smoke's routed experts' FFN and
# qwen3-14b-smoke's attention sublayers in train and prefill, its LM head
# in train, its decode q/k/v/o projections; recurrentgemma-9b-smoke's
# RG-LRU block and xlstm-1.3b-smoke's mLSTM cell in train, prefill and
# decode
SPLIT_CASES = [
    pytest.param("deepseek-moe-16b", mode, "experts",
                 id=f"deepseek-moe-16b-{mode}") for mode in ("train",
                                                            "prefill")
] + [
    pytest.param("qwen3-14b", mode, "attn", id=f"qwen3-14b-{mode}")
    for mode in ("train", "prefill")
] + [
    pytest.param("qwen3-14b", "train", "head", id="qwen3-14b-train-head"),
    pytest.param("qwen3-14b", "decode", "proj", id="qwen3-14b-decode-proj"),
] + [
    pytest.param(arch, c.mode, part, id=f"{arch}-{c.mode}-{part}")
    for arch, part in (("recurrentgemma-9b", "rglru"),
                       ("xlstm-1.3b", "mlstm")) for c in CELLS
]


@pytest.mark.parametrize("arch,mode,part", SPLIT_CASES)
def test_model_axis_splits_sublayer_flops(arch, mode, part, monkeypatch):
    """The FLOPs of deepseek-moe-16b-smoke's routed experts' FFN, of
    qwen3-14b-smoke's attention sublayers (q/k/v/o and the scores) and LM
    head, forward and backward, of its decode projections (q/k/v/o), and
    of recurrentgemma-9b-smoke's RG-LRU block: per card of a fake (2,2,2)
    mesh, one device's (a (1,1,1) mesh) / pod·data·model = 8, exactly, as
    the groups (64 tokens a rank in train, 32 in prefill, of 16 a group),
    the experts (8 over a model axis of 2), the positions (32), the
    vocabulary (256), the kv heads (2) and the RG-LRU's channels (64)
    divide evenly.  xlstm-1.3b-smoke's mLSTM cell: its whole part W (the
    gates, q k^T, q n) / 4 (pod·data: each model rank computes it for its
    rows) plus the rest / 8 (di 128, dv 32).  A part's FLOPs: the step's
    less the step's with the part's matmuls taken out."""
    import importlib
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config(arch + "-smoke")
    shape = next(c for c in CELLS if c.mode == mode)
    parts = [part, WHOLE_PARTS[part]] if part in WHOLE_PARTS else [part]
    flops = {}
    for world, mesh_shape in ((1, (1, 1, 1)), (8, (2, 2, 2))):
        with fake_world(world):
            mesh = make_mesh(mesh_shape, ("pod", "data", "model"),
                             device="cpu")
            step = lower_cell(cfg, shape, mesh)[0].flops
            for name_ in parts:
                with monkeypatch.context() as mp:
                    for module, name, stub in SPLIT_PARTS[name_]:
                        mp.setattr(importlib.import_module(module), name,
                                   stub)
                    rest = lower_cell(cfg, shape, mesh)[0].flops
                flops[name_, world] = step - rest
    one, card = flops[part, 1], flops[part, 8]
    print(f"{arch} {mode} {part}: one device {one:.6e}, a card of (2,2,2) "
          f"{card:.6e}")
    assert card > 0
    if part not in WHOLE_PARTS:
        assert card * 8 == one
        return
    w1, w8 = flops[WHOLE_PARTS[part], 1], flops[WHOLE_PARTS[part], 8]
    print(f"  whole part: one device {w1:.6e}, a card {w8:.6e}")
    assert 0 < w1 < one and w8 * 4 == w1
    assert card == w1 / 4 + (one - w1) / 8


def _reference_step_flops(mode: str) -> float:
    """``analyze_hlo``'s FLOPs of the reference's own qwen3-14b-smoke step
    (the CELLS shape of ``mode``), compiled on one CPU device with an Auto
    (1, 1) mesh."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config as jget
    from repro.launch.analysis import analyze_hlo
    from repro.train import serve, trainer
    from repro.train.optimizer import OptConfig
    cfg = jget("qwen3-14b-smoke")
    shape = next(c for c in CELLS if c.mode == mode)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    if mode == "train":
        step, rules = trainer.make_train_step(cfg, OptConfig(), mesh,
                                              trainer.TrainOptions())
        params, opt = trainer.abstract_train_state(cfg, rules)
        args = (params, opt, trainer.batch_specs(cfg, shape, rules))
    else:
        step, rules = serve.make_prefill_step(cfg, mesh, shape.global_batch,
                                              shape.seq_len)
        params, _ = serve.abstract_serve_params(cfg, rules)
        cache = serve.abstract_cache(cfg, shape.global_batch, shape.seq_len,
                                     rules)
        args = (params, cache, serve.serve_batch_specs(
            cfg, shape.global_batch, shape.seq_len, rules))
    with mesh:
        hlo = step.lower(*args).compile().as_text()
    return analyze_hlo(hlo).flops


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_world1_flops_near_reference_hlo(mode):
    """The port's counted matmul FLOPs of the world-1 qwen3-14b-smoke step
    within FLOPS_REL of the reference's HLO count of its own step (the
    port recomputes each layer's forward under remat, as the reference's
    checkpoint does)."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_mesh
    shape = next(c for c in CELLS if c.mode == mode)
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        port = lower_cell(get_config("qwen3-14b-smoke"), shape, mesh)[0]
    ref = _reference_step_flops(mode)
    print(f"qwen3-14b-smoke {mode}: port {port.flops:.6e} FLOPs, reference "
          f"HLO {ref:.6e}, ratio {port.flops / ref:.4f}")
    assert port.flops == pytest.approx(ref, rel=FLOPS_REL)


def test_full_size_cell_through_the_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on qwen3-14b x train_4k, a
    fake 16x16 mesh of 256 ranks, in a process of its own: one JSONL
    record, ``ok``, counted within FULL_CELL_S, its terms the H100's."""
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-14b", "--shape", "train_4k", "--tag", "t", "--out",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    print({k: rec[k] for k in ("t_count_s", "flops", "hbm_bytes",
                               "coll_bytes", "bottleneck",
                               "useful_flops_frac")})
    assert rec["status"] == "ok" and rec["device"] == "fake"
    assert rec["mesh"] == "16x16" and rec["tag"] == "t"
    assert rec["t_count_s"] < FULL_CELL_S
    assert not any(k.startswith("xla_") for k in rec)
    assert rec["t_compute"] == pytest.approx(rec["flops"] / A.PEAK_FLOPS)
    assert rec["model_flops"] == pytest.approx(A.model_flops_for(
        get_config("qwen3-14b"), LM_SHAPES[0]) / 256)
    assert 0 < rec["useful_flops_frac"] < 1
