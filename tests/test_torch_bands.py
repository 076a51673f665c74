"""The band staging of the port's spatial split on the CPU: the row tables
the engine uploads, the plain versions of ``band_windows`` and
``band_take`` against the torch chain they replaced (index_select or
gather, where, permute, copy, index_select, ``_residual_add_int8``), and a
step-by-step emulation of ``csrc/bands.cu``'s tile walk, fed the
wrappers' own launch arguments, against the plain versions.  The card's
tests are in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.core as T
from repro_torch.core.executor import (_compile_banded_block,
                                       _residual_add_int8, _row_table)
from repro_torch.core.quantize import f32
from repro_torch.kernels.bands import band_take, band_windows, bands
from repro_torch.kernels.bands.ref import band_take_ref, band_windows_ref
from repro_torch.models import mobilenet_v2_paper, mobilenet_v2_smoke

# unequal ratings; 12 workers over the 112x112 model's 4- and 7-row layers
# leave bands whose halos exceed them
GEOMETRIES = [("smoke", [1.0, 0.8, 1.2, 0.6]),
              ("paper", [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]),
              ("paper", [3.0, 0.2, 1.0, 0.3, 2.5, 0.4, 1.7, 0.25, 2.0, 0.3,
                         1.1, 0.5])]
MODELS = {"smoke": mobilenet_v2_smoke, "paper": mobilenet_v2_paper}


def _blocks(name, ratings):
    """(model, [(block indices, _BandedBlock)]) of a spatial plan."""
    model = MODELS[name](seed=0)
    plan = T.split_model(model, ratings, mode="spatial")
    out = []
    for idxs in plan.block_groups:
        if plan.splits[idxs[0]].mode != "spatial":
            continue
        geoms = [T.spatial_band_geometry(plan.splits[i].layer, plan.splits[i])
                 for i in idxs]
        out.append((idxs, _compile_banded_block(model, idxs, geoms)))
    return model, out


def _old_windows(x, src, mask, bsz, first):
    """The chain ``_block_spatial`` ran before the staging kernels: int64
    source rows, a bool mask, (bsz*bands, C, R, W)."""
    n_bands, r_win = src.shape
    if first:
        c_in, width = x.shape[1], x.shape[3]
        xw = x.index_select(2, src.reshape(-1))
        xw = xw.reshape(bsz, c_in, n_bands, r_win, width)
        xw = xw.permute(0, 2, 1, 3, 4)
    else:
        c_in, rows, width = x.shape[1], x.shape[2], x.shape[3]
        xv = x.reshape(bsz, n_bands, c_in, rows, width)
        index = src[None, :, None, :, None].expand(bsz, n_bands, c_in, r_win,
                                                   width)
        xw = torch.gather(xv, 3, index)
    xw = torch.where(mask, xw, 0)
    return xw.reshape(bsz * n_bands, c_in, r_win, width)


def _old_take(x, out_flat, bsz):
    n_bands = x.shape[0] // bsz
    c_out, r_out, width = x.shape[1], x.shape[2], x.shape[3]
    y = x.reshape(bsz, n_bands, c_out, r_out, width).permute(0, 2, 1, 3, 4)
    y = y.reshape(bsz, c_out, n_bands * r_out, width)
    return y.index_select(2, out_flat)


def _codes(rng, shape, dtype=torch.int8):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _nhwc_view(t):
    """``t`` (N, C, H, W) in NHWC memory, as a qgemm output's view."""
    n, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).contiguous().reshape(n * h * w, c).reshape(
        n, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name,ratings", GEOMETRIES)
def test_row_table_is_src_rows_where_masked(name, ratings):
    """The table the kernels read: ``src_rows`` where ``mask`` holds, -1
    elsewhere, int32 of (bands, R_win): the edge's padding rows and the
    fill of the shorter bands are -1."""
    _, blocks = _blocks(name, ratings)
    zeros = 0
    for _, bb in blocks:
        for st in bb.stages:
            table = _row_table(st)
            assert table.dtype == np.int32 and table.shape == st.src_rows.shape
            m = st.mask[:, 0, :, 0]
            np.testing.assert_array_equal(table[m], st.src_rows[m])
            assert (table[~m] == -1).all() and (table[m] >= 0).all()
            zeros += int((~m).sum())
    assert zeros > 0


@pytest.mark.parametrize("name,ratings", GEOMETRIES)
def test_windows_ref_is_the_old_chain(name, ratings):
    """``band_windows_ref`` on the table gives the old chain's windows at
    every stage of every block, from the block input and from the previous
    stage's stack in either layout, and pads and lays them out as asked."""
    model, blocks = _blocks(name, ratings)
    rng = np.random.default_rng(len(ratings))
    bsz = 2
    for idxs, bb in blocks:
        n_bands = len(bb.bands)
        for li, st in enumerate(bb.stages):
            layer = model.layers[st.index]
            c_in, h_in, w_in = layer.in_shape
            first = li == 0
            rows = h_in if first else bb.stages[li - 1].r_out
            x = _codes(rng, (bsz if first else bsz * n_bands, c_in, rows,
                             w_in))
            table = torch.from_numpy(_row_table(st))
            want = _old_windows(x, torch.from_numpy(st.src_rows).long(),
                                torch.from_numpy(st.mask), bsz, first)
            for src in (x, _nhwc_view(x)):
                got = band_windows(src, table, bsz)
                assert got.is_contiguous()
                assert torch.equal(got, want)
            pw = layer.padding[1]
            got = band_windows(x, table, bsz, pw=pw)
            assert torch.equal(got, F.pad(want, (pw, pw)))
            got = band_windows(x, table, bsz, channels_last=True)
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(got, want)


@pytest.mark.parametrize("name,ratings", GEOMETRIES)
def test_take_ref_is_the_old_chain_and_residual_add(name, ratings):
    """``band_take_ref`` gives the old output gather, and with a residual
    the old gather followed by ``_residual_add_int8``, code for code."""
    model, blocks = _blocks(name, ratings)
    rng = np.random.default_rng(3)
    bsz = 3
    for idxs, bb in blocks:
        last = model.layers[idxs[-1]]
        c, h_out, w = last.out_shape
        x = _codes(rng, (bsz * len(bb.bands), c, bb.stages[-1].r_out, w))
        rows = torch.from_numpy(bb.out_flat)
        want = _old_take(x, rows.long(), bsz)
        for src in (x, _nhwc_view(x)):
            assert torch.equal(band_take(src, rows, bsz), want)
        res = _codes(rng, (bsz, c, h_out, w))
        scales = rng.uniform(0.01, 0.2, 2)
        ratio = f32(float(scales[1]) / float(scales[0]))
        assert torch.equal(
            band_take(x, rows, bsz, res, ratio),
            _residual_add_int8(want, scales[0], res, scales[1]))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 4, 5, 6), dtype=torch.int8)
    table = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        band_windows(x, table, 2, pw=1, channels_last=True)
    with pytest.raises(ValueError):
        band_windows(x, table, 3)
    with pytest.raises(ValueError):
        band_take(x, torch.zeros(5, dtype=torch.int32), 2,
                  torch.zeros((2, 4, 4, 6), dtype=torch.int8), 1.0)
    with pytest.raises(ValueError):
        band_take(x.float(), torch.zeros(5, dtype=torch.int32), 2,
                  torch.zeros((2, 4, 5, 6), dtype=torch.int8), 1.0)


# -- csrc/bands.cu, step by step ----------------------------------------------

TILE_P, TILE_B, PITCH, THREADS = 64, 64, 68, 256


def _fast_div(d):
    """csrc/bands.cu's FastDiv: n / d by a multiply-high."""
    lg = 0
    while (1 << lg) < d:
        lg += 1
    p = 31 + lg
    m = 0 if d == 1 else ((1 << p) + d - 1) // d
    assert m < 1 << 32
    return (lambda n: n) if d == 1 else (lambda n: ((n * m) >> 32) >> (p - 32))


def _memory(t):
    """The bytes of ``t``'s memory, in memory order (writable)."""
    return torch.as_strided(t, (t.numel(),), (1,)).view(torch.uint8)


def _emulate(args, tensors):
    """``bands_copy`` with the wrapper's arguments ``args``, on CPU
    tensors found by their ``data_ptr``: every CTA and thread of
    ``copy_tile``, its shared tile a byte array, in the kernel's order.
    Returns the paths the CTAs took."""
    (take, es, src, out, rows, res, ratio, n_out, nbo, r, wo, pw, nbs,
     band_step, hs, w, c, src_nhwc, out_nhwc, vb) = args
    assert vb in (16, 8, 4, 1) and vb >= es and (c * es) % vb == 0
    assert wo == w + 2 * pw and not (out_nhwc and pw) and not (take and
                                                                out_nhwc)
    src_b, out_b = _memory(tensors[src]), _memory(tensors[out])
    res_b = None if res is None else _memory(tensors[res])
    table = tensors[rows].reshape(-1).tolist()
    dtype = torch.int8 if es == 1 else torch.float32
    tc, v = TILE_B // es, max(1, vb // es)
    quads_n = TILE_P // 4
    plane = r * wo
    pos_tiles = -(-plane // TILE_P)
    by_wo, by_hs, by_nbo = _fast_div(wo), _fast_div(hs), _fast_div(nbo)
    by_tiles = _fast_div(pos_tiles)
    cs = hs * w
    paths = set()

    def word(buf, at):
        return bytes(buf[at:at + 4].tolist())

    def transpose4(words):
        return [bytes(words[i][j] for i in range(4)) for j in range(4)]

    def residual(code, rcode):
        a = int(np.rint(np.float32(rcode) * np.float32(ratio)))
        return min(max(code + a, -127), 127)

    for bx in range(pos_tiles * n_out):
        for by in range(-(-c // tc)):
            n = by_tiles(bx)
            p0 = (bx - n * pos_tiles) * TILE_P
            s = by_nbo(n)
            b = n - s * nbo
            c0 = by * tc
            nc = min(tc, c - c0)
            np_ = min(TILE_P, plane - p0)
            pos_src = []
            for pl in range(TILE_P):
                off = -1
                if pl < np_:
                    pos = p0 + pl
                    t = by_wo(pos)
                    col = pos - t * wo - pw
                    q = table[b * r + t]
                    if q >= 0 and 0 <= col < w:
                        k = by_hs(q)
                        img = s * nbs + b * band_step + k
                        row = q - k * hs
                        off = (((img * hs + row) * w + col) * c if src_nhwc
                               else (img * c * hs + row) * w + col)
                pos_src.append(off)
            tile = bytearray(TILE_P * PITCH)
            if src_nhwc:
                kc = nc // v
                for e in range(np_ * kc):
                    pl, k = divmod(e, kc)
                    o = pos_src[pl]
                    chunk = bytes(vb)
                    if o >= 0:
                        at = (o + c0 + k * v) * es
                        assert at % vb == 0
                        chunk = bytes(src_b[at:at + vb].tolist())
                    tile[pl * PITCH + k * vb:pl * PITCH + (k + 1) * vb] = chunk
            elif (es == 1 and w % 4 == 0 and pw % 4 == 0
                  and tensors[src].data_ptr() % 4 == 0):
                paths.add("read4")
                for tid in range(THREADS):
                    pl, cl = (tid % quads_n) * 4, (tid // quads_n) * 4
                    if pl >= np_ or cl >= nc:
                        continue
                    o = pos_src[pl]
                    ws = []
                    for i in range(4):
                        if o >= 0 and cl + i < nc:
                            at = o + (c0 + cl + i) * cs
                            assert at % 4 == 0
                            ws.append(word(src_b, at))
                        else:
                            ws.append(bytes(4))
                    for j, wj in enumerate(transpose4(ws)):
                        tile[(pl + j) * PITCH + cl:(pl + j) * PITCH + cl + 4] = wj
            else:
                paths.add("read1")
                for tid in range(THREADS):
                    pl = tid % TILE_P
                    if pl >= np_:
                        continue
                    o = pos_src[pl]
                    for cl in range(tid // TILE_P, nc, THREADS // TILE_P):
                        chunk = bytes(es)
                        if o >= 0:
                            at = (o + (c0 + cl) * cs) * es
                            chunk = bytes(src_b[at:at + es].tolist())
                        tile[pl * PITCH + cl * es:pl * PITCH + (cl + 1) * es] = \
                            chunk
            first = (n * c + c0) * plane + p0
            if out_nhwc:
                kc = nc // v
                for e in range(np_ * kc):
                    pl, k = divmod(e, kc)
                    at = pl * PITCH + k * vb
                    o = ((n * plane + p0 + pl) * c + c0 + k * v) * es
                    assert o % vb == 0
                    out_b[o:o + vb] = torch.tensor(list(tile[at:at + vb]),
                                                   dtype=torch.uint8)
            elif (es == 1 and plane % 4 == 0 and tensors[out].data_ptr() % 4
                  == 0 and (res is None or tensors[res].data_ptr() % 4 == 0)):
                paths.add("write4")
                for tid in range(THREADS):
                    pl, cl = (tid % quads_n) * 4, (tid // quads_n) * 4
                    if pl >= np_ or cl >= nc:
                        continue
                    ws = transpose4([bytes(tile[(pl + j) * PITCH + cl:
                                                (pl + j) * PITCH + cl + 4])
                                     for j in range(4)])
                    for i in range(4):
                        if cl + i >= nc:
                            break
                        o = first + (cl + i) * plane + pl
                        assert o % 4 == 0
                        vals = list(np.frombuffer(ws[i], np.int8))
                        if res_b is not None:
                            rs = np.frombuffer(word(res_b, o), np.int8)
                            vals = [residual(int(x), int(y))
                                    for x, y in zip(vals, rs)]
                        out_b[o:o + 4] = torch.tensor(
                            np.array(vals, np.int8).view(np.uint8))
            else:
                paths.add("write1")
                for tid in range(THREADS):
                    pl = tid % TILE_P
                    if pl >= np_:
                        continue
                    for cl in range(tid // TILE_P, nc, THREADS // TILE_P):
                        at = pl * PITCH + cl * es
                        val = torch.tensor(list(tile[at:at + es]),
                                           dtype=torch.uint8).view(dtype)
                        o = first + cl * plane + pl
                        if res_b is not None:
                            val = torch.tensor([residual(
                                int(val[0]), int(res_b[o].view(torch.int8)))],
                                dtype=torch.int8)
                        out_b[o * es:(o + 1) * es] = val.view(torch.uint8)
    return paths


def _emulated(take, x, table, bsz, pw=0, channels_last=False, residual=None,
              ratio=1.0):
    """What the wrapper would launch for CPU tensors, emulated."""
    x, src_nhwc = bands._source(x)
    c, w = x.shape[1], x.shape[3]
    if take:
        out = torch.full((bsz, c, table.shape[0], w), 99, dtype=x.dtype)
        args = bands._args(True, x, out, table, residual, ratio, 1,
                           table.shape[0], 0, x.shape[0] // bsz, 0,
                           src_nhwc, False)
    else:
        n_bands, r_win = table.shape
        fmt = (torch.channels_last if channels_last
               else torch.contiguous_format)
        out = torch.full((bsz * n_bands, c, r_win, w + 2 * pw), 99,
                         dtype=x.dtype).contiguous(memory_format=fmt)
        per_band = x.shape[0] != bsz
        args = bands._args(False, x, out, table, None, 1.0, n_bands, r_win,
                           pw, n_bands if per_band else 1, int(per_band),
                           src_nhwc, channels_last)
    tensors = {t.data_ptr(): t for t in (x, out, table, residual)
               if t is not None}
    paths = _emulate(args, tensors)
    return out, args[-1], paths


# (bsz, C, H_in, W, bands, R, dtype, source: input / nchw / nhwc)
EMU_CASES = [(2, 24, 9, 7, 3, 5, torch.int8, "input"),
             (2, 24, 9, 7, 3, 5, torch.int8, "nhwc"),
             (1, 16, 4, 12, 2, 3, torch.int8, "nchw"),
             (2, 3, 11, 10, 2, 7, torch.int8, "input"),
             (1, 70, 3, 5, 2, 4, torch.int8, "nhwc"),
             (1, 6, 3, 5, 2, 4, torch.int8, "nhwc"),
             (1, 5, 3, 5, 2, 4, torch.int8, "nhwc"),
             (2, 20, 5, 9, 3, 4, torch.float32, "nhwc"),
             (1, 18, 6, 4, 2, 5, torch.float32, "nchw"),
             (1, 3, 6, 4, 1, 5, torch.float32, "input"),
             (2, 24, 9, 8, 3, 5, torch.int8, "input"),
             (2, 6, 6, 12, 3, 4, torch.int8, "nchw"),
             (1, 70, 3, 8, 2, 4, torch.int8, "nhwc"),
             (1, 40, 5, 4, 2, 3, torch.int8, "nhwc")]


def _table(rng, n_bands, r_win, rows):
    """A random row table, one band empty where there are several."""
    t = rng.integers(0, rows, (n_bands, r_win)).astype(np.int32)
    t[rng.random((n_bands, r_win)) < 0.3] = -1
    if n_bands > 1:
        t[1] = -1
    return torch.from_numpy(t)


@pytest.mark.parametrize("case", EMU_CASES)
@pytest.mark.parametrize("out", ["nchw", "pad", "nhwc"])
def test_kernel_walk_windows_equal_plain(case, out):
    """The emulated ``band_windows_kernel`` writes the plain version's
    windows: a source row or zeros at each window row, an empty band all
    zeros, the pad columns zero, NCHW or NHWC, int8 or float32, at every
    vector width the channels allow, its NCHW side in 4 x 4 byte blocks
    where the widths allow and element by element elsewhere."""
    bsz, c, h, w, n_bands, r_win, dtype, source = case
    rng = np.random.default_rng(c * h + w)
    first = source == "input"
    x = _codes(rng, (bsz if first else bsz * n_bands, c, h, w), dtype)
    if source == "nhwc":
        x = _nhwc_view(x)
    table = _table(rng, n_bands, r_win, h)
    pw = 2 if out == "pad" else 0
    got, vb, paths = _emulated(False, x, table, bsz, pw, out == "nhwc")
    want = band_windows_ref(x, table, bsz, pw, out == "nhwc")
    assert torch.equal(got, want)
    int8 = dtype == torch.int8
    if source != "nhwc":
        assert ("read4" in paths) == (int8 and w % 4 == 0 and pw % 4 == 0)
    if out != "nhwc":
        assert ("write4" in paths) == (int8 and r_win * (w + 2 * pw) % 4
                                       == 0)
    if source == "nhwc" or out == "nhwc":
        assert vb == max(v for v in (16, 8, 4, 1)
                         if (c * got.element_size()) % v == 0)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("case", [(2, 40, 3, 14, 4, 10, "nhwc"),
                                  (3, 24, 2, 7, 3, 5, "nchw"),
                                  (1, 66, 5, 9, 2, 7, "nhwc"),
                                  (2, 12, 1, 4, 2, 2, "nchw")])
def test_kernel_walk_take_equals_plain(case, residual):
    """The emulated ``band_take_kernel`` gathers the output rows of the
    plain version and, with an int8 residual, adds it as
    ``_residual_add_int8`` does, code for code."""
    bsz, c, r_out, w, n_bands, h_out, source = case
    rng = np.random.default_rng(c + r_out)
    x = _codes(rng, (bsz * n_bands, c, r_out, w))
    if source == "nhwc":
        x = _nhwc_view(x)
    rows = torch.from_numpy(np.sort(rng.choice(
        n_bands * r_out, h_out, replace=False)).astype(np.int32))
    res = ratio = None
    if residual:
        res = _codes(rng, (bsz, c, h_out, w))
        ratio = f32(0.7311)
    got, _, paths = _emulated(True, x, rows, bsz, residual=res,
                              ratio=1.0 if ratio is None else ratio)
    want = band_take_ref(x, rows, bsz, res, 1.0 if ratio is None else ratio)
    assert torch.equal(got, want)
    assert ("write4" in paths) == (h_out * w % 4 == 0)
    if residual:
        assert torch.equal(got, _residual_add_int8(
            _old_take(x, rows.long(), bsz), 1.0, res, 0.7311))


def test_kernel_walk_float_take():
    x = _codes(np.random.default_rng(5), (4, 10, 3, 6), torch.float32)
    rows = torch.tensor([0, 2, 3, 5], dtype=torch.int32)
    got, _, _ = _emulated(True, _nhwc_view(x), rows, 2)
    assert torch.equal(got, band_take_ref(x, rows, 2))
