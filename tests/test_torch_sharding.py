"""The port's sharding rules against the reference's, in one process: no
ranks, no process group.

The reference runs on ``jax.sharding.AbstractMesh``, the port on
``launch.mesh.MeshShape`` (sizes and names only).  For every leaf of the
params (``model_spec_tree`` / ``abstract_model``), of the caches
(``cache_spec_tree`` / ``cache_shardings``) and of the batches
(``batch_specs`` / ``serve_batch_specs``), the logical names, the shape and
the dtype are equal, the port's ``fit_spec`` is the reference's (as a
tuple of axis tuples), and the port's DTensor placements are what that
spec implies: ``Shard(d)`` on each mesh axis that names tensor dim d,
``Replicate()`` elsewhere.  The grid: the seven ``-smoke`` configs plus
full-width qwen3-14b and deepseek-moe-16b (shapes only) x mode train /
serve x routing direct / coordinator x seq_parallel on / off x meshes
(16,16), (2,16,16), (2,2,2), (4,2), (1,1,1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.parallel.sharding import make_rules as jmake_rules
from repro.train import serve as jserve
from repro.train import trainer as jtrainer

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm
from repro_torch.nn.layers import leaves
from repro_torch.parallel.sharding import make_rules, shard_act, use_rules
from repro_torch.train import serve, trainer

ARCHS = ("qwen3-14b-smoke", "deepseek-moe-16b-smoke", "dbrx-132b-smoke",
         "recurrentgemma-9b-smoke", "xlstm-1.3b-smoke", "whisper-base-smoke",
         "llava-next-mistral-7b-smoke", "qwen3-14b", "deepseek-moe-16b")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1x1": ((1, 1, 1), ("pod", "data", "model"))}
BATCH, MAX_SEQ = 8, 64
SHAPES = ((32, 8), (4096, 256))       # (seq, global batch)


def _axes(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec(p) -> tuple:
    return tuple(_axes(e) for e in p)


def _placements(spec, axes) -> tuple:
    out = []
    for a in axes:
        dims = [d for d, e in enumerate(spec) if e and a in e]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _jdtype(dt) -> str:
    return str(jnp.dtype(dt))


def _tdtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _check(port_rules, ref_rules, names, shape, axes):
    want = _spec(ref_rules.fit_spec(names, shape))
    got = port_rules.fit_spec(names, shape)
    assert got == want, (names, shape, got, want)
    assert port_rules.placements(names, shape) == _placements(want, axes)


def _names_leaves(tree):
    """Leaves of a tree of logical-name tuples, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _names_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _names_leaves(v)]
    return [tree]


@functools.cache
def _ref_model(arch):
    cfg = jget(arch)
    return (cfg, jax.tree.leaves(jlm.model_spec_tree(cfg),
                                 is_leaf=lambda v: isinstance(v, tuple)),
            jax.tree.leaves(jlm.abstract_model(cfg)))


@functools.cache
def _ref_cache(arch):
    cfg = jget(arch)
    shapes = jax.eval_shape(lambda: jlm.init_cache(cfg, BATCH, MAX_SEQ))
    return (jax.tree.leaves(jserve.cache_spec_tree(cfg),
                            is_leaf=lambda v: isinstance(v, tuple)),
            jax.tree.leaves(shapes))


@pytest.mark.parametrize("routing", ["direct", "coordinator"])
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_reference(arch, mesh, mode, routing):
    sizes, axes = MESHES[mesh]
    jcfg, jnames, jshapes = _ref_model(arch)
    cfg = get_config(arch)
    names = _names_leaves(lm.model_spec_tree(cfg))
    shapes = leaves(lm.abstract_model(cfg))
    assert names == jnames
    assert [tuple(t.shape) for t in shapes] == [s.shape for s in jshapes]
    assert [_tdtype(t.dtype) for t in shapes] == \
        [_jdtype(s.dtype) for s in jshapes]
    assert all(t.device.type == "meta" for t in shapes)
    cnames, cshapes = _ref_cache(arch)
    pcache = serve._cache_shapes(cfg, BATCH, MAX_SEQ)
    assert _names_leaves(serve.cache_spec_tree(cfg)) == cnames
    assert [tuple(t.shape) for t in leaves(pcache)] == \
        [s.shape for s in cshapes]
    assert [_tdtype(t.dtype) for t in leaves(pcache)] == \
        [_jdtype(s.dtype) for s in cshapes]
    for seq_parallel in (True, False):
        ref = jmake_rules(AbstractMesh(sizes, axes), mode, routing,
                          seq_parallel)
        port = make_rules(MeshShape(sizes, axes), mode, routing,
                          seq_parallel)
        assert port.rules == {k: v for k, v in ref.rules.items()}
        for n, s in zip(names, jshapes):
            _check(port, ref, n, s.shape, axes)
        # the shardings trees, as the serve and train builders make them
        p_sh = leaves(trainer.abstract_train_state(cfg, port)[0])
        assert [x.sharding.spec for x in p_sh] == [
            _spec(ref.fit_spec(n, s.shape)) for n, s in zip(names, jshapes)]
        c_sh = leaves(serve.cache_shardings(cfg, port, BATCH, MAX_SEQ))
        r_sh = jax.tree.leaves(jserve.cache_shardings(jcfg, ref, BATCH,
                                                      MAX_SEQ))
        assert [x.spec for x in c_sh] == [_spec(x.spec) for x in r_sh]
        for n, s in zip(cnames, cshapes):
            _check(port, ref, n, s.shape, axes)
        for seq, gb in SHAPES:
            for got, want in (
                    (trainer.batch_specs(cfg, ShapeConfig("t", seq, gb,
                                                          "train"), port),
                     jtrainer.batch_specs(jcfg, JShape("t", seq, gb,
                                                       "train"), ref)),
                    (serve.serve_batch_specs(cfg, gb, seq, port),
                     jserve.serve_batch_specs(jcfg, gb, seq, ref))):
                assert sorted(got) == sorted(want)
                for k in got:
                    assert got[k].shape == want[k].shape
                    assert _tdtype(got[k].dtype) == _jdtype(want[k].dtype)
                    assert got[k].sharding.spec == _spec(
                        want[k].sharding.spec)
                    assert got[k].sharding.placements == _placements(
                        _spec(want[k].sharding.spec), axes)


def test_shard_act_rank_mismatch_raises():
    rules = make_rules(MeshShape((2, 2), ("data", "model")))
    x = torch.zeros(4, 3)
    with use_rules(rules):
        with pytest.raises(ValueError, match="rank mismatch"):
            shard_act(x, ("batch", "seq", "act_embed"))
        # a plain tensor of the right rank passes through
        assert shard_act(x, ("batch", None)) is x
    # without rules, nothing is checked
    assert shard_act(x, ("batch", "seq", "act_embed")) is x


def test_spec_axes_out_of_mesh_order_raise():
    rules = make_rules(MeshShape((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="mesh order"):
        rules.spec_placements((("model", "data"),))


def test_sds_is_meta():
    rules = make_rules(MeshShape((2, 2, 2), ("pod", "data", "model")))
    s = rules.sds((8, 6), torch.float32, ("batch", "ff"))
    assert s.sharding.spec == (("pod", "data"), ("model",))
    t = s.meta()
    assert t.device.type == "meta" and tuple(t.shape) == (8, 6)
    np.testing.assert_equal(s.sharding.placements,
                            (Shard(0), Shard(0), Shard(1)))
