"""The port's host layer (numpy copies) against the reference.

``repro_torch`` carries copies of the reference's numpy-only modules
(reinterpret, fusion, allocation, splitting, mapping, the MobileNetV2
builder and quantize's numpy half), because the reference package cannot be
imported without JAX.  These tests pin the copies to the reference's outputs:
weights, shard and band geometry, block grouping, the compiled band
schedule and the quantized arrays must be *equal*, for the smoke and the
paper MobileNetV2, in every mode plus one mixed assignment, at 1, 2, 4 and 8
workers of unequal ratings.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core.executor import _compile_banded_block as ref_banded
from repro.models import mobilenet_v2_paper as ref_paper
from repro.models import mobilenet_v2_smoke as ref_smoke

import repro_torch.core as T
from repro_torch.core.executor import _compile_banded_block as port_banded
from repro_torch.models import mobilenet_v2_paper, mobilenet_v2_smoke

# unequal ratings: the first n of them rate an n-worker cluster
RATINGS = [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]
WORKERS = (1, 2, 4, 8)
MODELS = {"smoke": (ref_smoke, mobilenet_v2_smoke),
          "paper": (ref_paper, mobilenet_v2_paper)}


@pytest.fixture(scope="module")
def models():
    return {name: (ref(), port()) for name, (ref, port) in MODELS.items()}


def assert_same(a, b, path="value"):
    """Structural equality across the two packages' (distinct) classes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name == "layer":       # LayerSplit.layer: checked by weights
                continue
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _mixed_assignment(model_pkg, model):
    """Spatial for the first half of the fused blocks, then kernel and
    neuron alternating: every kind of seam."""
    n = len(model_pkg.group_blocks(model))
    return tuple("spatial" if i < n // 2 else ("kernel", "neuron")[i % 2]
                 for i in range(n))


def _plans(mode, ref_model, port_model, n):
    ratings = RATINGS[:n]
    if mode == "mixed":
        return (R.split_model_mixed(ref_model, ratings,
                                    _mixed_assignment(R, ref_model)),
                T.split_model_mixed(port_model, ratings,
                                    _mixed_assignment(T, port_model)))
    return (R.split_model(ref_model, ratings, mode=mode),
            T.split_model(port_model, ratings, mode=mode))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weights_equal(models, name):
    ref, port = models[name]
    assert port.input_shape == ref.input_shape
    assert len(port.layers) == len(ref.layers)
    for a, b in zip(ref.layers, port.layers):
        for f in ("name", "kind", "in_shape", "out_shape", "stride",
                  "padding", "kernel", "activation", "save_as",
                  "residual_from"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        assert_same(a.weight, b.weight, f"{a.name}.weight")
        assert_same(a.bias, b.bias, f"{a.name}.bias")
    assert port.total_macs() == ref.total_macs()
    assert_same(R.group_blocks(ref), T.group_blocks(port))


@pytest.mark.parametrize("n", WORKERS)
@pytest.mark.parametrize("mode", ["neuron", "kernel", "spatial", "mixed"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_geometry_equal(models, name, mode, n):
    """Shards, ShardGeometry, SpatialBandGeometry, block groups and the
    compiled band schedule are equal to the reference's."""
    ref_model, port_model = models[name]
    rp, tp = _plans(mode, ref_model, port_model, n)
    assert (tp.mode, tp.block_groups, tp.group_modes, tp.assignment) == (
        rp.mode, rp.block_groups, rp.group_modes, rp.assignment)
    assert_same(rp.ratings, tp.ratings)
    for i, (a, b) in enumerate(zip(rp.splits, tp.splits)):
        assert_same(a, b, f"split[{i}]")
        assert_same(R.compile_shard_geometry(a.layer, a),
                    T.compile_shard_geometry(b.layer, b), f"geometry[{i}]")
        if a.mode == "spatial":
            assert_same(R.spatial_band_geometry(a.layer, a),
                        T.spatial_band_geometry(b.layer, b), f"bands[{i}]")
    for idxs in rp.block_groups:
        if rp.splits[idxs[0]].mode != "spatial":
            continue
        assert_same(
            ref_banded(ref_model, idxs,
                       [R.spatial_band_geometry(rp.splits[i].layer,
                                                rp.splits[i]) for i in idxs]),
            port_banded(port_model, idxs,
                        [T.spatial_band_geometry(tp.splits[i].layer,
                                                 tp.splits[i]) for i in idxs]),
            f"banded{idxs}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantized_model_equal(models, name):
    """quantize_model and epilogue_params give the reference's arrays for
    the same activation scales."""
    ref, port = models[name]
    rng = np.random.default_rng(1)
    scales = list(rng.uniform(0.01, 0.1, len(ref.layers) + 1))
    rq, tq = R.quantize_model(ref, scales), T.quantize_model(port, scales)
    assert tq.input_scale == rq.input_scale
    for a, b in zip(rq.layers, tq.layers):
        assert_same(a, b)
        if a.w_q is not None:
            assert_same(R.epilogue_params(a), T.epilogue_params(b))
