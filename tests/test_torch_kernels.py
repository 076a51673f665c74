"""The port's kernels against the reference's Pallas kernels.

On the CPU each wrapper takes its plain torch version, which is held here
against the JAX Pallas kernel run in interpret mode (as ``tests/test_kernels.py``
runs it): int8 output with the int32 bias is ``array_equal``; the real-domain
float bias path is within a stated tolerance.  The CUDA kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import flash_decode as jax_flash_decode
from repro.kernels.decode_attn.ops import \
    flash_decode_ref as jax_flash_decode_ref
from repro.kernels.dwconv.ops import dwconv as jax_dwconv
from repro.kernels.dwconv.ops import dwconv_bands as jax_dwconv_bands
from repro.kernels.dwconv.ops import dwconv_window as jax_dwconv_window
from repro.kernels.qgemm.ops import qconv2d as jax_qconv2d
from repro.kernels.qgemm.ops import qgemm_padded as jax_qgemm
from repro.models import mobilenet_v2_smoke as ref_smoke

import repro_torch.core as T
from repro_torch.convert import convert_model
from repro_torch.kernels import backend
from repro_torch.kernels.decode_attn.decode_attn import decode_attn
from repro_torch.kernels.decode_attn.ops import flash_decode, flash_decode_ref
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels.dwconv import dwconv as dw_mod
from repro_torch.kernels.dwconv.dwconv import dwconv3x3, dwconv3x3_bands
from repro_torch.kernels.dwconv.ops import (dwconv, dwconv_bands,
                                            dwconv_bands_unpadded,
                                            dwconv_shards, dwconv_window,
                                            shard_table)
from repro_torch.kernels.dwconv.ref import dwconv_shards_ref
from repro_torch.kernels.qgemm.ops import qconv2d, qgemm_padded
from repro_torch.kernels.qgemm.qgemm import qgemm
from repro_torch.kernels.qgemm.ref import qgemm_ref

ACTS = (None, "relu", "relu6")


def _gemm_inputs(rng, m, k, n, int_bias):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, n) / (127 * 127 * np.sqrt(k))).astype(
        np.float32)
    b = (rng.integers(-3000, 3000, n).astype(np.int32) if int_bias
         else rng.uniform(-1, 1, n).astype(np.float32))
    return x, w, s, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_matches(got, exp, int_bias, out_scale):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype
    if int_bias:
        # the int8 contract: exact int32 bias, multiplies only -> bit-exact
        np.testing.assert_array_equal(got, exp)
    elif out_scale is not None:
        # XLA may contract the float bias's mul+add into an FMA, which can
        # flip a requantization tie by one step
        assert np.max(np.abs(got.astype(np.int32) - exp.astype(np.int32))) <= 1
    else:
        # the same FMA contraction: one rounding of difference
        np.testing.assert_allclose(got, exp, rtol=1e-6,
                                   atol=1e-6 * np.abs(exp).max())


class TestQGEMMPlain:
    @pytest.mark.parametrize("out_scale", [None, 0.05])
    @pytest.mark.parametrize("act", ACTS)
    @pytest.mark.parametrize("int_bias", [True, False])
    def test_epilogues_vs_pallas(self, int_bias, act, out_scale):
        """Every epilogue variant on a shape ragged in M, K and N."""
        rng = np.random.default_rng(0)
        x, w, s, b = _gemm_inputs(rng, 37, 200, 72, int_bias)
        exp = jax_qgemm(x, w, s, b, activation=act, out_scale=out_scale,
                        interpret=True)
        got = qgemm_padded(*_t(x, w, s, b), activation=act,
                           out_scale=out_scale)
        _assert_matches(got, exp, int_bias, out_scale)

    @pytest.mark.parametrize("m,k,n", [(1, 1280, 100), (8, 1280, 1000),
                                       (300, 27, 32), (129, 16, 96)])
    def test_main_path_shapes_vs_pallas(self, m, k, n):
        """Classifier (M = batch), stem (K = 27) and expand shapes."""
        rng = np.random.default_rng(m + k + n)
        x, w, s, b = _gemm_inputs(rng, m, k, n, True)
        exp = jax_qgemm(x, w, s, b, activation="relu6", out_scale=0.05,
                        interpret=True)
        got = qgemm(*_t(x, w, s, b), activation="relu6", out_scale=0.05)
        _assert_matches(got, exp, True, 0.05)

    def test_int32_accumulation_exact(self):
        """No epilogue scaling at K=512: the accumulation is exact."""
        rng = np.random.default_rng(42)
        x = rng.integers(-127, 128, (128, 512)).astype(np.int8)
        w = rng.integers(-127, 128, (512, 128)).astype(np.int8)
        ones = np.ones(128, np.float32)
        zeros = np.zeros(128, np.int32)
        got = qgemm(*_t(x, w, ones, zeros)).numpy()
        np.testing.assert_array_equal(got.astype(np.int64),
                                      x.astype(np.int64) @ w.astype(np.int64))
        np.testing.assert_array_equal(
            got, np.asarray(jax_qgemm(x, w, ones, zeros, interpret=True)))

    @pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
    def test_qconv2d_vs_pallas(self, stride):
        rng = np.random.default_rng(3)
        x = rng.integers(-127, 128, (16, 9, 9)).astype(np.int8)
        w = rng.integers(-127, 128, (24, 16, 3, 3)).astype(np.int8)
        s = (rng.uniform(0.5, 1.5, 24) / (127 * 127 * 12)).astype(np.float32)
        b = rng.integers(-3000, 3000, 24).astype(np.int32)
        exp = jax_qconv2d(x, w, s, b, stride=stride, padding=(1, 1),
                          activation="relu6", out_scale=0.05, interpret=True)
        got = qconv2d(*_t(x, w, s, b), stride=stride, padding=(1, 1),
                      activation="relu6", out_scale=0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        # a leading batch axis computes every sample as one
        both = qconv2d(torch.from_numpy(np.stack([x, x[::-1].copy()])),
                       *_t(w, s, b), stride=stride, padding=(1, 1),
                       activation="relu6", out_scale=0.05)
        np.testing.assert_array_equal(both[0].numpy(), np.asarray(exp))


def _dw_inputs(rng, c, int_bias=True):
    w = rng.integers(-127, 128, (c, 3, 3)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, c) / (127 * 127 * 3)).astype(np.float32)
    b = (rng.integers(-3000, 3000, c).astype(np.int32) if int_bias
         else rng.uniform(-1, 1, c).astype(np.float32))
    return w, s, b


class TestDWConvPlain:
    @pytest.mark.parametrize("int_bias", [True, False])
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("c,hw", [(8, 16), (19, 12)])
    def test_single_sample_vs_pallas(self, c, hw, stride, int_bias):
        rng = np.random.default_rng(c * hw + stride)
        x = rng.integers(-127, 128, (c, hw, hw)).astype(np.int8)
        w, s, b = _dw_inputs(rng, c, int_bias)
        exp = jax_dwconv(x, w, s, b, stride=stride, activation="relu6",
                         out_scale=0.05, interpret=True)
        got = dwconv(*_t(x, w, s, b), stride=stride, activation="relu6",
                     out_scale=0.05)
        _assert_matches(got, exp, int_bias, 0.05)

    @pytest.mark.parametrize("act", ACTS)
    def test_float_out_vs_pallas(self, act):
        rng = np.random.default_rng(5)
        x = rng.integers(-127, 128, (12, 10, 10)).astype(np.int8)
        w, s, b = _dw_inputs(rng, 12)
        exp = jax_dwconv(x, w, s, b, activation=act, interpret=True)
        got = dwconv(*_t(x, w, s, b), activation=act)
        _assert_matches(got, exp, True, None)

    @pytest.mark.parametrize("stride", [1, 2])
    def test_row_window_vs_pallas(self, stride):
        """One band window (halo rows in place, width padded by 1), VALID
        over its rows, with a channel count off the reference's block."""
        rng = np.random.default_rng(20 + stride)
        c, out_rows, width = 13, 3, 9
        x = rng.integers(-127, 128, (c, (out_rows - 1) * stride + 3,
                                     width + 2)).astype(np.int8)
        w, s, b = _dw_inputs(rng, c)
        exp = jax_dwconv_window(x, w, s, b, stride=stride, activation="relu6",
                                out_scale=0.05, interpret=True)
        got = dwconv_window(*_t(x, w, s, b), stride=stride,
                            activation="relu6", out_scale=0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("bands", [1, 2, 4, 7])
    def test_band_stack_vs_pallas(self, bands, stride):
        rng = np.random.default_rng(bands * 10 + stride)
        c, rows, width = 12, 7, 10
        x = rng.integers(-127, 128, (bands, c, rows, width + 2)).astype(
            np.int8)
        w, s, b = _dw_inputs(rng, c)
        exp = jax_dwconv_bands(x, w, s, b, stride=stride, activation="relu6",
                               out_scale=0.05, interpret=True)
        got = dwconv_bands(*_t(x, w, s, b), stride=stride, activation="relu6",
                           out_scale=0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))

    @pytest.mark.parametrize("int_bias", [True, False])
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("bands", [1, 2, 4, 7])
    def test_unpadded_band_stack_vs_pallas(self, bands, stride, int_bias):
        """The engine's band form, width padded by the kernel, against the
        Pallas kernel on the padded stack."""
        rng = np.random.default_rng(bands * 10 + stride + 100)
        c, rows, width = 11, 7, 9
        x = rng.integers(-127, 128, (bands, c, rows, width)).astype(np.int8)
        w, s, b = _dw_inputs(rng, c, int_bias)
        exp = jax_dwconv_bands(np.pad(x, ((0, 0), (0, 0), (0, 0), (1, 1))),
                               w, s, b, stride=stride, activation="relu6",
                               out_scale=0.05, interpret=True)
        got = dwconv_bands_unpadded(*_t(x, w, s, b), stride=stride,
                                    activation="relu6", out_scale=0.05)
        _assert_matches(got, exp, int_bias, 0.05)


def _jax_shard_loop(cur, geoms, w, s, b, stride, hw):
    """The reference's flat depthwise loop (``repro/core/executor.py``,
    ``_layer_int8``): per shard, ``dwconv`` over its channel span, the
    shard's flat range of the fragment, then the concatenation."""
    parts = []
    for g in geoms:
        span = slice(g.c_lo, g.c_hi + 1)
        y = jax_dwconv(cur[span], w[span], s[span], b[span], stride=stride,
                       activation="relu6", out_scale=0.05, interpret=True)
        off = g.start - g.c_lo * hw
        parts.append(np.asarray(y).reshape(-1)[off:off + g.n_positions])
    return np.concatenate(parts)


class TestDWConvShards:
    """A flat layer over all of its worker shards in one call, against the
    reference's per-shard loop, on smoke MobileNetV2's own plans."""

    @pytest.mark.parametrize("workers", [1, 3, 8])
    @pytest.mark.parametrize("mode", ["kernel", "neuron"])
    def test_plan_shards_vs_pallas_loop(self, mode, workers):
        model = convert_model(ref_smoke())
        ratings = [1.0, 1.7, 0.6, 1.2, 0.9, 1.4, 0.5, 1.1][:workers]
        plan = T.split_model(model, ratings, mode=mode)
        rng = np.random.default_rng(workers)
        split_channels = 0
        for i, layer in enumerate(model.layers):
            if layer.kind != "dwconv":
                continue
            geoms = [g for g in T.compile_shard_geometry(layer,
                                                         plan.splits[i])
                     if g is not None]
            c, h, wd = layer.in_shape
            hw = layer.out_shape[1] * layer.out_shape[2]
            split_channels += sum(a.c_hi == b.c_lo
                                  for a, b in zip(geoms, geoms[1:]))
            x = rng.integers(-127, 128, (2, c, h, wd)).astype(np.int8)
            w, s, b = _dw_inputs(rng, c)
            table = shard_table([(g.c_lo, g.c_hi, g.start, g.stop)
                                 for g in geoms])
            got = dwconv_shards(*_t(x), table, *_t(w, s, b),
                                stride=layer.stride[0], activation="relu6",
                                out_scale=0.05)
            assert got.shape == (2, c * hw)
            for n in range(2):
                exp = _jax_shard_loop(x[n], geoms, w, s, b, layer.stride[0],
                                      hw)
                np.testing.assert_array_equal(got[n].numpy(), exp)
        if mode == "neuron" and workers > 1:
            # a channel split between two neuron shards is among the cases
            assert split_channels > 0

    def test_destinations_are_running_sums(self):
        table = shard_table([(0, 2, 0, 40), (2, 2, 40, 45), (2, 4, 45, 80)])
        assert [r[4] for r in table.rows] == [0, 40, 45]
        assert [r[1] for r in table.rows] == [3, 3, 5]
        assert table.spans == (3, 1, 3) and table.positions == 80
        assert list(table.packed) == [v for row in table.rows for v in row]
        with pytest.raises(ValueError):
            shard_table([])
        with pytest.raises(ValueError):
            shard_table([(2, 1, 0, 4)])
        # any number of shards on the CPU (the kernel takes MAX_SHARDS)
        many = shard_table([(c, c, c * 4, c * 4 + 4)
                            for c in range(dw_mod.MAX_SHARDS + 1)])
        x = torch.ones((1, dw_mod.MAX_SHARDS + 1, 2, 2), dtype=torch.int8)
        w, s, b = _t(*_dw_inputs(np.random.default_rng(0),
                                 dw_mod.MAX_SHARDS + 1))
        assert dwconv_shards(x, many, w, s, b).shape == (1, 4 * len(
            many.rows))


def _uneven_table(rng, n: int, kernel_mode: bool):
    """``n`` shards of uneven size over a layer: kernel mode cuts whole
    channels (spans of 1-4), neuron mode cuts flat positions anywhere (so
    shards split channels).  Returns (table, C, H, W)."""
    h = w = 5
    hw = h * w
    if kernel_mode:
        spans = rng.integers(1, 5, n)
        c = int(spans.sum())
        lo = np.concatenate([[0], np.cumsum(spans)[:-1]])
        rows = [(int(a), int(a + s - 1), int(a) * hw, int(a + s) * hw)
                for a, s in zip(lo, spans)]
    else:
        c = 3 * n // 4 + 1
        cuts = np.sort(rng.choice(np.arange(1, c * hw), n - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [c * hw]])
        rows = [(int(a) // hw, (int(b) - 1) // hw, int(a), int(b))
                for a, b in zip(bounds[:-1], bounds[1:])]
    return shard_table(rows), c, h, w


class TestSplitTable:
    """A table of more shards than one launch takes is cut into launches of
    at most ``MAX_SHARDS`` rows, each writing its own slice of the one
    output: its rows keep their destinations."""

    @pytest.mark.parametrize("kernel_mode", [True, False])
    @pytest.mark.parametrize("n", [65, 128, 130])
    def test_chunks_equal_the_whole_table(self, n, kernel_mode):
        rng = np.random.default_rng(n + kernel_mode)
        table, c, h, w = _uneven_table(rng, n, kernel_mode)
        assert len(set(table.spans)) > 1
        x = torch.from_numpy(rng.integers(-127, 128, (2, c, h, w))
                             .astype(np.int8))
        wt, sc, b = _t(*_dw_inputs(rng, c))
        kw = dict(stride=1, activation="relu6", out_scale=0.05)
        whole = dwconv_shards_ref(x, table.rows, wt, sc, b, **kw)
        chunks = dw_mod.split_table(table, dw_mod.MAX_SHARDS)
        assert len(chunks) == -(-n // dw_mod.MAX_SHARDS) == len(table.launches)
        assert [len(sub.rows) for sub, _, _ in chunks] == [
            min(dw_mod.MAX_SHARDS, n - i)
            for i in range(0, n, dw_mod.MAX_SHARDS)]
        out = torch.zeros_like(whole)
        covered = first = 0
        for sub, lo, hi in chunks:
            assert lo == covered and sub.positions == hi - lo
            assert sub.rows == table.rows[first:first + len(sub.rows)]
            assert list(sub.packed) == [v for row in sub.rows for v in row]
            first += len(sub.rows)
            out[:, lo:hi] = dwconv_shards_ref(x, sub.rows, wt, sc, b, **kw)
            # as the kernel stores: each row at its own destination
            for row in sub.rows:
                part = dwconv_shards_ref(x, [row], wt, sc, b, **kw)
                assert torch.equal(whole[:, row[4]:row[4] + part.shape[1]],
                                   part)
            covered = hi
        assert covered == table.positions
        assert torch.equal(out, whole)

    def test_small_tables_are_one_launch(self):
        table = shard_table([(0, 2, 0, 40), (2, 2, 40, 45), (2, 4, 45, 80)])
        assert dw_mod.split_table(table, 64) == [(table, 0, 80)]
        assert table.launches == ((table, 0, 80),)
        assert [(lo, hi) for _, lo, hi in dw_mod.split_table(table, 2)] == [
            (0, 45), (45, 80)]
        with pytest.raises(ValueError):
            dw_mod.split_table(table, 0)


class TestWrappers:
    def test_cpu_takes_plain_version_without_launch(self):
        rng = np.random.default_rng(0)
        x, w, s, b = _gemm_inputs(rng, 5, 9, 7, True)
        before = (qgemm.launches, dwconv3x3.launches,
                  dwconv3x3_bands.launches)
        got = qgemm(*_t(x, w, s, b), out_scale=0.1)
        np.testing.assert_array_equal(
            got.numpy(), qgemm_ref(*_t(x, w, s, b), out_scale=0.1).numpy())
        xd = torch.zeros((2, 4, 6, 6), dtype=torch.int8)
        wd, sd, bd = _t(*_dw_inputs(rng, 4))
        dwconv3x3(xd, wd, sd, bd)
        dwconv3x3_bands(xd, wd, sd, bd)
        dwconv(xd, wd, sd, bd)
        dwconv_bands_unpadded(xd, wd, sd, bd)
        dwconv_shards(xd, shard_table([(0, 3, 0, 144)]), wd, sd, bd)
        assert (qgemm.launches, dwconv3x3.launches,
                dwconv3x3_bands.launches) == before

    def test_other_devices_raise(self):
        """Neither a kernel nor a plain version runs off cpu and cuda."""
        x = torch.empty((4, 8), dtype=torch.int8, device="meta")
        w = torch.empty((8, 3), dtype=torch.int8, device="meta")
        s = torch.empty(3, dtype=torch.float32, device="meta")
        b = torch.empty(3, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            qgemm(x, w, s, b)
        xd = torch.empty((1, 3, 5, 5), dtype=torch.int8, device="meta")
        wd = torch.empty((3, 3, 3), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            dwconv3x3_bands(xd, wd, s, b)

    def test_bad_operands_raise(self):
        x = torch.zeros((4, 8), dtype=torch.int8)
        w = torch.zeros((9, 3), dtype=torch.int8)
        s, b = torch.ones(3), torch.zeros(3, dtype=torch.int32)
        with pytest.raises(ValueError, match="chain"):
            qgemm(x, w, s, b)
        with pytest.raises(TypeError):
            qgemm(x.float(), w[:8], s, b)
        with pytest.raises(ValueError, match="activation"):
            qgemm(x, w[:8], s, b, activation="gelu")
        with pytest.raises(ValueError, match="weight"):
            dwconv3x3(torch.zeros((3, 5, 5), dtype=torch.int8),
                      torch.zeros((3, 5, 5), dtype=torch.int8), s, b)

    @pytest.mark.parametrize("nb,spans,h,w,stride,pad", [
        (1, [96], 56, 56, 2, (1, 1)), (8, [960], 4, 4, 1, (1, 1)),
        (8, [32], 56, 56, 1, (1, 1)), (1, [8], 6, 1000, 2, (1, 1)),
        (8, [12, 13, 11, 12, 12, 12, 12, 12], 56, 56, 2, (1, 1)),
        (32, [960], 3, 4, 1, (0, 1)), (64, [96], 11, 56, 2, (0, 1)),
        (1, [3], 5, 7000, 1, (1, 1))])
    def test_dwconv_tiles_fit_shared_memory(self, nb, spans, h, w, stride,
                                            pad):
        sched = dw_mod.dwconv_schedule(nb, spans, h, w, stride, pad)
        oh, _ = dw_mod.out_size(h, w, stride, pad)
        assert 1 <= sched.rows_tile <= oh and 1 <= sched.c_tile <= max(spans)
        assert sched.slab >= dw_mod.slab_bytes(sched.rows_tile, h, w, stride)
        assert sched.smem <= dw_mod.SMEM_BUDGET

    def test_dwconv_rows_too_wide_raise(self):
        with pytest.raises(ValueError, match="do not fit"):
            dw_mod.dwconv_schedule(1, [1], 3, 9000, 1)

    def test_build_flags_target_hopper(self):
        assert "arch=compute_90a,code=sm_90a" in backend.NVCC_FLAGS
        assert set(backend.sources()) == {"qgemm", "dwconv", "decode_attn",
                                          "se", "bands"}


class TestDecodeAttnPlain:
    """The port's flash-decode on the CPU (its plain version) against the
    reference's Pallas kernel in interpret mode, with the tolerances of
    ``tests/test_kernels.py::TestDecodeAttn``: both sum float32 products in
    other orders; in bf16 the Pallas kernel also casts p to bf16 before the
    PV product, which the plain version does not."""

    @pytest.mark.parametrize("b,k,g,hd,s,bs", [
        (2, 4, 5, 64, 1024, 256),
        (1, 8, 1, 128, 512, 512),
        (3, 2, 8, 32, 768, 128),
        (2, 1, 16, 64, 640, 128),
    ])
    def test_sweep_vs_pallas(self, b, k, g, hd, s, bs):
        rng = np.random.default_rng(b * 1000 + s)
        q = rng.standard_normal((b, 1, k, g, hd)).astype(np.float32)
        ck = rng.standard_normal((b, s, k, hd)).astype(np.float32)
        cv = rng.standard_normal((b, s, k, hd)).astype(np.float32)
        lens = rng.integers(s // 2, s + 1, b).astype(np.int32)
        exp = np.asarray(jax_flash_decode(q, ck, cv, lens, block_s=bs))
        before = decode_attn.launches
        got = flash_decode(*_t(q, ck, cv, lens), block_s=bs)
        assert decode_attn.launches == before    # no kernel on the CPU
        assert got.shape == (b, 1, k, g, hd) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(
            flash_decode_ref(*_t(q, ck, cv, lens)).numpy(),
            np.asarray(jax_flash_decode_ref(q, ck, cv, lens)), rtol=1e-5,
            atol=2e-5)

    def test_bf16_dtype(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        b, k, g, hd, s = 2, 2, 4, 64, 512
        arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
                ((b, 1, k, g, hd), (b, s, k, hd), (b, s, k, hd))]
        lens = np.full(b, s, np.int32)
        exp = np.asarray(jax_flash_decode(
            *(jnp.asarray(a, jnp.bfloat16) for a in arrs), lens,
            block_s=128), np.float32)
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrs)
        got = flash_decode(tq, tk, tv, torch.from_numpy(lens), block_s=128)
        assert got.dtype == torch.bfloat16
        # outputs average v over 512 slots and are ~0.1: the atol is scaled
        # to their largest magnitude, a few bf16 steps there
        np.testing.assert_allclose(got.float().numpy(), exp, rtol=2e-2,
                                   atol=2e-2 * np.abs(exp).max())

    def test_length_masking(self):
        """Slots beyond ``lengths`` must not influence the output, and the
        port agrees with the Pallas kernel on a ragged S (no padding to
        ``block_s``)."""
        rng = np.random.default_rng(2)
        b, k, g, hd, s = 1, 2, 2, 32, 256
        q = rng.standard_normal((b, 1, k, g, hd)).astype(np.float32)
        ck = rng.standard_normal((b, s, k, hd)).astype(np.float32)
        cv = rng.standard_normal((b, s, k, hd)).astype(np.float32)
        lens = np.array([100], np.int32)
        out1 = flash_decode(*_t(q, ck, cv, lens), block_s=64).numpy()
        ck2, cv2 = ck.copy(), cv.copy()
        ck2[:, 100:] = 99.0
        cv2[:, 100:] = -99.0
        out2 = flash_decode(*_t(q, ck2, cv2, lens), block_s=64).numpy()
        np.testing.assert_allclose(out1, out2, rtol=1e-6, atol=1e-6)
        ragged = flash_decode(*_t(q, ck[:, :230], cv[:, :230], lens),
                              block_s=64).numpy()
        np.testing.assert_allclose(ragged, np.asarray(jax_flash_decode(
            q, ck[:, :230], cv[:, :230], lens, block_s=64)), rtol=1e-5,
            atol=2e-5)

    def test_mixed_q_f32_cache_bf16(self):
        """(f32 q, bf16 cache), the third pair the kernel takes: output in
        q's dtype, equal to the plain version on float32 copies."""
        rng = np.random.default_rng(3)
        q = torch.from_numpy(rng.standard_normal((2, 1, 2, 5, 64)).astype(
            np.float32))
        ck, cv = (torch.from_numpy(rng.standard_normal((2, 40, 2, 64))
                                   .astype(np.float32)).bfloat16()
                  for _ in range(2))
        lens = torch.tensor([40, 17], dtype=torch.int32)
        got = flash_decode(q, ck, cv, lens)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, flash_decode(q, ck.float(),
                                                     cv.float(), lens))

    def test_contract_checks(self):
        q = torch.zeros((1, 2, 3, 32))
        k = torch.zeros((1, 2, 16, 32))
        lens = torch.full((1,), 16, dtype=torch.int32)
        for bad in (0, -512, 1.5, True):
            with pytest.raises(ValueError, match="block_s"):
                decode_attn(q, k, k, lens, block_s=bad)
        with pytest.raises(ValueError, match="int32"):
            decode_attn(q, k, k, lens.long())
        with pytest.raises(TypeError, match="dtypes"):
            decode_attn(q.bfloat16(), k, k, lens)
        with pytest.raises(ValueError, match="disagree"):
            decode_attn(q, k[..., :16], k[..., :16], lens)
        meta = [t.to("meta") for t in (q, k, k, lens)]
        with pytest.raises(ValueError, match="cuda or cpu"):
            decode_attn(*meta)
        # the plain version takes any strides: a transposed cache view
        cache = torch.randn((1, 16, 2, 32))
        np.testing.assert_allclose(
            decode_attn(q, cache.transpose(1, 2), cache.transpose(1, 2),
                        lens).numpy(),
            decode_attn_ref(q, cache.transpose(1, 2).contiguous(),
                            cache.transpose(1, 2).contiguous(),
                            lens).numpy(), rtol=1e-6, atol=1e-6)
