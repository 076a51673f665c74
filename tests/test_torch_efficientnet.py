"""EfficientNet-B0 on the port, on the CPU: its layer list, the
squeeze-and-excitation gate in the three split modes, the planner's
accounting of it, and its int8 answers against the benchmark's plain
reference (``portbench/reference/efficientnet_b0.py``, plain PyTorch,
imported here from the repository's root).

Everything runs on the reduced preset (``efficientnet_b0_smoke``: a 3x3
block without expansion, a stride-2 5x5 block, a residual 5x5 block, a
stride-2 3x3 block, at 32x32) with the benchmark's seeded random weights.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro_torch.core as T  # noqa: E402
from portbench import inputs  # noqa: E402
from portbench.harness import gaps  # noqa: E402
from portbench.programs.efficientnet_b0 import program_model  # noqa: E402
from portbench.reference import efficientnet_b0 as ref  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.api import Cluster, Planner, Session  # noqa: E402
from repro_torch.core.fusion import group_blocks, se_cut  # noqa: E402
from repro_torch.core.memory import layerwise_peak  # noqa: E402
from repro_torch.core.reinterpret import trace_sequential  # noqa: E402
from repro_torch.models import efficientnet_b0  # noqa: E402
from repro_torch.models.efficientnet import SMOKE_CFG  # noqa: E402

MODEL = {"arch": "efficientnet_b0", "input": [3, 32, 32], "stem_channels": 16,
         "mbconv": [list(r) for r in SMOKE_CFG], "se_ratio": 0.25,
         "last_channels": 64, "num_classes": 10}
SEED = 2 ** 31 + 29
RATINGS = [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]
MODES = ("spatial", "kernel", "neuron")
# int8 answers of the program against the reference's, mean |code gap|: the
# two calibrate apart (float32 against float64 maxima) and a one-code
# difference grows through the blocks; the int4 control reads far above
GAP_LIMIT = 0.5
# the sigmoid's codes at 0 or 127 (a saturated gate), at most
SATURATED_SHARE = 0.05


@pytest.fixture(scope="module")
def bench():
    """The reference's layers, the seeded weights and images, the port's
    model carrying those weights, and its calibrated int8 session."""
    lyrs = ref.layers(MODEL)
    shape = tuple(MODEL["input"])
    weights = inputs.weights(lyrs, SEED, "cpu")
    calib = inputs.calibration(shape, 8, SEED, "cpu")
    pool = inputs.pool(shape, 16, SEED, "cpu")
    model = program_model(MODEL, weights, lyrs)
    sess = Session(T.split_model(model, RATINGS, mode="spatial"),
                   calibration=list(calib), device="cpu", max_batch=16)
    return dict(lyrs=lyrs, weights=weights, calib=calib, pool=pool,
                model=model, sess=sess)


def test_published_layer_list():
    """EfficientNet-B0 at 224: 16 MBConv blocks, each with a gate, 9 of
    them 5x5, 390.5 M MACs and 5.3 M parameters (the paper: 0.39 B, 5.3 M),
    every block grouped with its squeeze-and-excitation cut."""
    m = efficientnet_b0()
    gates = [lyr for lyr in m.layers if lyr.kind == "gate"]
    assert len(gates) == 16
    assert sum(lyr.kind == "dwconv" and lyr.kernel == (5, 5)
               for lyr in m.layers) == 9
    assert m.total_macs() == 390_490_528
    params = sum(lyr.weight.size + lyr.bias.size for lyr in m.layers
                 if lyr.weight is not None)
    assert 5.25e6 < params < 5.30e6
    cuts = [se_cut(m, b.indices) for b in group_blocks(m)]
    assert sum(c is not None for c in cuts) == 16
    assert m.out_shape == (1000, 1, 1)


def test_gate_layer_passes_and_fails_the_model_checks():
    """A gate scales a stashed activation of its own output shape by one
    factor a channel; the chain check refuses anything else."""
    base = [dict(kind="conv", name="c", out_channels=4, kernel=(3, 3),
                 save_as="k"),
            dict(kind="avgpool", name="p"),
            dict(kind="linear", name="f", features=4, activation="sigmoid")]
    m = trace_sequential(base + [dict(kind="gate", name="g", gate_from="k")],
                         (3, 6, 6))
    assert (m.layers[-1].in_shape, m.layers[-1].out_shape) == ((4, 1, 1),
                                                               (4, 6, 6))
    with pytest.raises(ValueError, match="nothing stashed"):
        trace_sequential(base + [dict(kind="gate", name="g",
                                      gate_from="other")], (3, 6, 6))
    layers = list(m.layers)
    bad = T.LayerSpec("g", "gate", (4, 1, 1), (4, 3, 3), gate_from="k")
    with pytest.raises(ValueError, match="gates 'k'"):
        T.ReinterpretedModel(layers[:-1] + [bad], (3, 6, 6))
    wide = [dict(kind="linear", name="f", features=8)]
    m2 = trace_sequential(base[:2] + wide, (3, 6, 6))
    with pytest.raises(ValueError, match="one factor"):
        T.ReinterpretedModel(list(m2.layers) + [
            T.LayerSpec("g", "gate", (8, 1, 1), (4, 6, 6), gate_from="k")],
            (3, 6, 6))


def test_float_forward_matches_the_reference(bench):
    """The port's float forward, unsplit and split spatially, against the
    reference's float64 forward: within 1e-4 of the output's largest
    magnitude, the room float32 rounding takes through ~30 layers (sums of
    up to 1,024 products, swish's exp) against float64."""
    xs = bench["pool"][:4]
    want = ref.float_forward(bench["lyrs"], bench["weights"], xs,
                             "cpu").numpy()
    atol = 1e-4 * np.abs(want).max()
    unsplit = np.stack([T.reference_forward(bench["model"], x,
                                            device="cpu").reshape(-1)
                        for x in xs])
    np.testing.assert_allclose(unsplit, want, rtol=1e-4, atol=atol)
    plan = T.split_model(bench["model"], RATINGS, mode="spatial")
    split = T.CompiledSplitExecutor(plan, device="cpu").run_batch(xs)
    np.testing.assert_allclose(split.reshape(len(xs), -1), want, rtol=1e-4,
                               atol=atol)


def test_int8_codes_near_the_reference_and_int4_control_far(bench):
    """The program's int8 answers against the reference's within
    ``GAP_LIMIT`` codes on average; the reference with int4 weights (the
    control) reads over 4x that and over the limit."""
    pool = bench["pool"]
    got = bench["sess"].submit_many(pool).reshape(len(pool), -1)
    ids = np.arange(len(pool))
    want = ref.Reference(MODEL, bench["weights"], bench["calib"], "cpu")(pool)
    ctrl = ref.Reference(MODEL, bench["weights"], bench["calib"], "cpu",
                         weight_bits=4)(pool)
    codes = dict(enumerate(want))
    program = gaps(ids, got, codes, len(pool))["mean_code_gap"]
    control = gaps(ids, ctrl, codes, len(pool))["mean_code_gap"]
    assert program <= GAP_LIMIT
    assert control > max(GAP_LIMIT, 4 * program)


@pytest.mark.parametrize("executor", ["compiled", "eager"])
@pytest.mark.parametrize("mode", MODES)
def test_int8_split_bit_exact_with_unsplit(bench, mode, executor):
    """Every split's int8 answer equals the unsplit int8 walk bit for bit:
    the spatial split's pool counts each row of each band once, and the
    flat splits' gates scale every position."""
    qmodel = bench["sess"].qmodel
    xs = bench["pool"][:3]
    want = np.stack([T.reference_forward(bench["model"], x, device="cpu",
                                         qmodel=qmodel).reshape(-1)
                     for x in xs])
    plan = T.split_model(bench["model"], RATINGS, mode=mode)
    if executor == "compiled":
        got = T.CompiledSplitExecutor(plan, qmodel, device="cpu").run_batch(
            xs, mode="int8")
    else:
        ex = T.SplitExecutor(plan, qmodel, device="cpu")
        got = np.stack([ex.run(x, mode="int8") for x in xs])
    np.testing.assert_array_equal(got.reshape(len(xs), -1), want)


def test_calibrated_gate_is_not_saturated(bench):
    """The sigmoid's int8 codes over the pool: at most ``SATURATED_SHARE``
    of them at 0 or 127, so the gate scales rather than switches."""
    qmodel = bench["sess"].qmodel
    plan = T.split_model(bench["model"], RATINGS, mode="neuron")
    ex = T.SplitExecutor(plan, qmodel, device="cpu")
    fc2 = [i for i, lyr in enumerate(bench["model"].layers)
           if lyr.activation == "sigmoid"]
    codes = []
    for x in bench["pool"][:8]:
        _, acts = ex.run(x, mode="int8", collect_activations=True)
        codes += [acts[i].reshape(-1) for i in fc2]
    codes = np.concatenate(codes).astype(int)
    assert codes.min() >= 0
    assert np.mean((codes == 0) | (codes == 127)) <= SATURATED_SHARE


def test_spatial_plan_cuts_each_block_at_its_pool(bench):
    """In the spatial plan each MBConv block is one group whose banded
    stages hold spatial shards, pool and FCs flat splits, and whose gate
    takes the project conv's bands; the pool is a reduction each band
    uploads its partial sums to."""
    model = bench["model"]
    plan = T.split_model(model, RATINGS, mode="spatial")
    groups = [g for g in plan.block_groups if se_cut(model, g)]
    assert len(groups) == 4
    for g in groups:
        cut = se_cut(model, g)
        modes = {i: plan.splits[i].mode for i in g}
        assert [modes[i] for i in cut.reduce] == ["neuron"] * 3
        assert modes[cut.gate] == modes[cut.dw] == "spatial"
        gate, proj = plan.splits[cut.gate], plan.splits[cut.project]
        assert [(s.row_lo, s.row_hi) for s in gate.shards] == [
            (s.row_lo, s.row_hi) for s in proj.shards]
        vol = T.comm_volume(plan.splits[cut.dw], model.layers[cut.pool],
                            plan.splits[cut.pool])
        active = sum(s.n_positions > 0 for s in plan.splits[cut.dw].shards)
        assert vol.upload_bytes.sum() == active * 4 * model.layers[
            cut.pool].in_shape[0]


def test_planner_counts_the_kept_depthwise_band():
    """The planner returns a feasible plan of EfficientNet, and a spatial
    plan's per-worker peak RAM at the pool, the FCs and the gate holds the
    depthwise band each worker keeps across the squeeze-and-excitation."""
    from repro_torch.models import efficientnet_b0_smoke
    model = efficientnet_b0_smoke()
    plan = Planner(model, Cluster.heterogeneous_demo(4)).plan()
    assert plan.latency_s > 0 and plan.max_peak_ram > 0
    split = T.split_model(model, RATINGS[:4], mode="spatial")
    peak = layerwise_peak(split)
    for g in split.block_groups:
        cut = se_cut(model, g)
        if cut is None:
            continue
        band = np.array([s.n_positions for s in split.splits[cut.dw].shards])
        for i in (*cut.reduce, cut.gate):
            assert np.all(peak[i] >= band)
        assert np.all(peak[cut.gate] >= 2 * band)   # kept band + its output


def test_runtime_and_mixed_plans_refuse_the_gate(bench):
    """The socket runtime and the mixed plans do not run gates yet: they
    refuse with the gate layer named."""
    from repro_torch.runtime.shards import build_coordinator_plan
    model = bench["model"]
    with pytest.raises(NotImplementedError, match="b0_se_gate"):
        T.split_model_mixed(model, RATINGS,
                            ("spatial",) * len(group_blocks(model)))
    plan = T.split_model(model, RATINGS, mode="kernel")
    with pytest.raises(NotImplementedError, match="b0_se_gate"):
        build_coordinator_plan(plan, bench["sess"].qmodel, "int8")


def test_block_spans_name_the_se_stages(bench):
    """Walking the spatial plan records four ``executor.block`` spans for
    each cut group, named for its stages, one after another."""
    sess = bench["sess"]
    xs = bench["pool"][:2]
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sess.dispatch_async(xs).wait()
    blocks = [s for s in trace.spans() if s[0] == "executor.block"]
    kinds = [s[4]["kind"] for s in blocks]
    n_cut = sum(se_cut(sess.split.model, g) is not None
                for g in sess.split.block_groups)
    assert len(blocks) == len(sess.split.block_groups) + 3 * n_cut
    for k in ("se_pool", "se_fc", "se_gate+conv"):
        assert kinds.count(k) == n_cut
    assert kinds.count("dwconv") + kinds.count("conv+dwconv") == n_cut
    assert all(a[3] <= b[2] for a, b in zip(blocks, blocks[1:]))
    trace.clear()
