"""The schedules of the port's redesigned CUDA kernels, on the CPU.

``qgemm_schedule`` (tile height and split over K), ``decode_schedule``
(split over the cache) and ``dwconv_schedule`` (a depthwise CTA's channels
and rows) are plain Python that the wrappers call; here they are checked
over the shapes the main paths launch and over sweeps.  Each algorithm is
then emulated in plain torch, exactly as the kernel cuts the work, and held
against the reference's Pallas kernel run in interpret mode: int32 split-K
partials summed, then the epilogue, ``array_equal``; per-chunk float32
flash-decode partials (m, l, acc) merged by their maxima, at 1e-5; the
depthwise tile walk (16-byte-aligned staging at the input's own byte
offsets, the zero border made in the kernel, row windows shared by 4
adjacent outputs, stores only of a shard's own positions), ``array_equal``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attn.ops import flash_decode as jax_flash_decode
from repro.kernels.dwconv.ops import dwconv as jax_dwconv
from repro.kernels.dwconv.ops import dwconv_bands as jax_dwconv_bands
from repro.kernels.qgemm.ops import qgemm_padded as jax_qgemm

import repro_torch.core as T
from repro_torch.core.quantize import epilogue
from repro_torch.kernels.decode_attn.decode_attn import (
    MAX_CHUNK_TILES, TILE_S, chunk_is_empty, decode_schedule)
from repro_torch.kernels.decode_attn.ref import softmax_scale
from repro_torch.kernels.dwconv import dwconv as dw
from repro_torch.kernels.qgemm.qgemm import (BK, BN, MIN_SPLIT_STEPS,
                                             TILE_M, WORKSPACE_MAX,
                                             qgemm_schedule)

N_SM = 132

# qgemm launches of the CNN main path at batch 8 (M, K, N): spatial plan,
# then the flat plans' shards; M = 1 is Session.run's classifier shard
CNN_SHAPES = [(35840, 27, 32), (39424, 16, 96), (128, 960, 320),
              (128, 320, 1280), (8, 1280, 78), (8, 1280, 181),
              (25088, 27, 3), (25088, 27, 7), (25088, 16, 8),
              (25088, 16, 19), (128, 960, 13), (128, 960, 59),
              (128, 320, 99), (128, 320, 234), (1, 1280, 130),
              (8, 1280, 1000)]
# flash-decode calls (S, B*K): qwen3-14b's live cache at batch 8, the 32k
# yardstick, and the smoke configs
LM_SHAPES = [(2081, 64), (32768, 64), (20, 8), (16, 4), (1333, 6)]


def _check_qgemm_schedule(m, n, k, n_sm=N_SM):
    bm, splits, k_chunk = qgemm_schedule(m, n, k, n_sm)
    assert bm == (TILE_M[0] if m <= TILE_M[0] else TILE_M[1])
    assert k_chunk % BK == 0 and k_chunk > 0 and splits >= 1
    # the splits cover K exactly, none empty
    assert splits * k_chunk >= k
    assert splits == 1 or (splits - 1) * k_chunk < k
    tiles = -(-m // bm) * -(-n // BN)
    if splits > 1:
        assert tiles * splits <= n_sm               # at most one wave
        assert splits * tiles * bm * BN * 4 <= WORKSPACE_MAX
        assert k_chunk >= MIN_SPLIT_STEPS * BK
    else:
        # unsplit: the grid already fills half a wave, or K is too short
        # for two splits
        assert tiles * 2 > n_sm or k < 2 * MIN_SPLIT_STEPS * BK
    return bm, splits, k_chunk


@pytest.mark.parametrize("m,k,n", CNN_SHAPES)
def test_qgemm_schedule_on_path(m, k, n):
    bm, splits, _ = _check_qgemm_schedule(m, n, k)
    if m <= 16 and k >= 960:
        assert splits > 1           # a classifier shard uses many SMs


@pytest.mark.parametrize("n", [1, 3, 64, 130, 1000])
@pytest.mark.parametrize("k", [0, 1, 16, 27, 64, 65, 960, 1281, 5000])
@pytest.mark.parametrize("m", [1, 16, 17, 64, 128, 4096, 35840])
def test_qgemm_schedule_sweep(m, k, n):
    _check_qgemm_schedule(m, n, k)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 50000), st.integers(0, 8192), st.integers(1, 4096),
       st.integers(1, 264))
def test_qgemm_schedule_property(m, k, n, n_sm):
    _check_qgemm_schedule(m, n, k, n_sm)


def _check_decode_schedule(s, bk, n_sm=N_SM):
    n_split, chunk = decode_schedule(s, bk, n_sm)
    assert chunk % TILE_S == 0 and 0 < chunk <= MAX_CHUNK_TILES * TILE_S
    # the chunks cover S, none past it
    assert n_split * chunk >= s
    assert n_split == 1 or (n_split - 1) * chunk < s
    return n_split, chunk


@pytest.mark.parametrize("s,bk", LM_SHAPES)
def test_decode_schedule_on_path(s, bk):
    n_split, chunk = _check_decode_schedule(s, bk)
    if s >= 2048:
        assert bk * n_split >= N_SM           # every SM gets work
    # a chunk is empty exactly when it starts at or past the length
    for length in {1, min(chunk, s), min(chunk + 1, s), s}:
        used = [j for j in range(n_split)
                if not chunk_is_empty(j, chunk, length)]
        assert used == list(range(-(-length // chunk)))


@pytest.mark.parametrize("bk", [1, 6, 64, 512])
@pytest.mark.parametrize("s", [0, 1, 63, 64, 65, 2081, 32768, 131072])
def test_decode_schedule_sweep(s, bk):
    _check_decode_schedule(s, bk)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 600000), st.integers(1, 4096), st.integers(1, 264))
def test_decode_schedule_property(s, bk, n_sm):
    _check_decode_schedule(s, bk, n_sm)


# -- the split algorithms, emulated ------------------------------------------

def qgemm_split_emulated(x, w, scale, bias, *, activation, out_scale):
    """qgemm as the kernel splits it: an int32 partial per K split, their
    sum, then the epilogue once."""
    m, k = x.shape
    n = w.shape[1]
    _, splits, k_chunk = qgemm_schedule(m, n, k, N_SM)
    parts = [(x[:, z * k_chunk:(z + 1) * k_chunk].to(torch.int64)
              @ w[z * k_chunk:(z + 1) * k_chunk].to(torch.int64))
             .to(torch.int32) for z in range(splits)]
    acc = torch.stack(parts).sum(0, dtype=torch.int32)
    return epilogue(acc, scale, bias, activation, out_scale), splits


@pytest.mark.parametrize("m,k,n", [(8, 1280, 130), (1, 1280, 78),
                                   (128, 960, 40), (17, 1281, 130),
                                   (128, 320, 160), (16, 27, 5)])
def test_qgemm_split_k_vs_pallas(m, k, n):
    rng = np.random.default_rng(m * 31 + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, n) / (127 * 127 * np.sqrt(k))).astype(
        np.float32)
    b = rng.integers(-3000, 3000, n).astype(np.int32)
    got, splits = qgemm_split_emulated(
        *(torch.from_numpy(a) for a in (x, w, s, b)), activation="relu6",
        out_scale=0.05)
    if k >= 960:
        assert splits > 1
    exp = jax_qgemm(x, w, s, b, activation="relu6", out_scale=0.05,
                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # the int32 sum of the partials is the whole product
    ones, zeros = torch.ones(n), torch.zeros(n, dtype=torch.int32)
    acc, _ = qgemm_split_emulated(torch.from_numpy(x), torch.from_numpy(w),
                                  ones, zeros, activation=None,
                                  out_scale=None)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  x.astype(np.int64) @ w.astype(np.int64))


def decode_split_emulated(q, k, v, lengths):
    """Flash-decode as the kernel splits it.  q (B, K, G, hd), k, v
    (B, K, S, hd) float32.  Chunk j of ``decode_schedule`` gives a partial
    (m, l, acc) by an online softmax over tiles of ``TILE_S`` slots (p cast
    to v's dtype before p V, l from the unrounded p); a chunk at or past the
    length is empty (l = 0) and skipped; the merge weighs each partial by
    exp(m - max m)."""
    b, kh, g, hd = q.shape
    s = k.shape[2]
    n_split, chunk = decode_schedule(s, b * kh, N_SM)
    scale = softmax_scale(hd)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for bi in range(b):
        length = int(lengths[bi])
        for ki in range(kh):
            parts = []
            for j in range(n_split):
                if chunk_is_empty(j, chunk, length):
                    continue
                m = torch.full((g,), -torch.inf)
                lsum = torch.zeros(g)
                acc = torch.zeros(g, hd)
                end = min(j * chunk + chunk, length)
                for t0 in range(j * chunk, end, TILE_S):
                    t1 = min(t0 + TILE_S, end)
                    logits = (q[bi, ki] @ k[bi, ki, t0:t1].T) * scale
                    m_new = torch.maximum(m, logits.amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(logits - m_new[:, None])
                    lsum = lsum * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p.to(v.dtype).float() @ \
                        v[bi, ki, t0:t1].float()
                    m = m_new
                parts.append((m, lsum, acc))
            if not parts:
                continue
            mx = torch.stack([p[0] for p in parts]).amax(0)
            lsum = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
            acc = sum(p[2] * torch.exp(p[0] - mx)[:, None] for p in parts)
            out[bi, ki] = acc / lsum[:, None]
    return out, n_split, chunk


@pytest.mark.parametrize("b,kh,g,hd,s,lens", [
    (3, 2, 5, 32, 1333, (1, 1333, 100)),      # one slot; whole chunks empty
    (2, 1, 8, 16, 700, (700, 65)),
    (1, 2, 1, 64, 130, (64,)),                 # a chunk boundary
    (2, 4, 16, 8, 2081, (2080, 2081)),
])
def test_decode_split_vs_pallas(b, kh, g, hd, s, lens):
    rng = np.random.default_rng(b * s + g)
    q = rng.standard_normal((b, 1, kh, g, hd)).astype(np.float32)
    ck = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    lengths = np.array(lens, np.int32)
    got, n_split, chunk = decode_split_emulated(
        torch.from_numpy(q[:, 0]), torch.from_numpy(ck).transpose(1, 2),
        torch.from_numpy(cv).transpose(1, 2), torch.from_numpy(lengths))
    assert n_split > 1
    if min(lens) < s - chunk:
        assert chunk_is_empty(n_split - 1, chunk, min(lens))
    exp = np.asarray(jax_flash_decode(q, ck, cv, lengths, block_s=64))
    np.testing.assert_allclose(got.numpy()[:, None], exp, rtol=1e-5,
                               atol=1e-5)
    # lengths = 1: the output is slot 0's v
    if 1 in lens:
        i = lens.index(1)
        np.testing.assert_allclose(got.numpy()[i],
                                   np.broadcast_to(cv[i, 0][:, None],
                                                   (kh, g, hd)),
                                   rtol=1e-6, atol=1e-6)


# -- the depthwise schedule and tile walk -------------------------------------

DW_RATINGS = [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]


@pytest.fixture(scope="module")
def paper_plans():
    """The main path's plans of paper MobileNetV2 on 8 workers."""
    from repro_torch.models import mobilenet_v2_paper
    model = mobilenet_v2_paper(seed=0)
    return model, {mode: T.split_model(model, DW_RATINGS, mode=mode)
                   for mode in ("kernel", "neuron", "spatial")}


def _table_rows(shards):
    """(c_lo, c_hi inclusive, start, stop) -> the table's rows."""
    return dw.shard_table(shards).rows


def _cut(c, hw, cuts, whole_channels):
    """Shards of a (c, hw) layer cut at the fractions ``cuts``: at channel
    boundaries (kernel mode) or at any position (neuron mode)."""
    n = c * hw
    bounds = sorted({0, n, *(int(f * n) for f in cuts)})
    if whole_channels:
        bounds = sorted({-(-b // hw) * hw for b in bounds})
    return [(a // hw, (b - 1) // hw, a, b) for a, b in zip(bounds, bounds[1:])
            if b > a]


def _check_dwconv_schedule(nb, rows, h, w, stride, pad, n_sm=N_SM):
    """Properties of one launch's schedule over the shard table ``rows``:
    shared memory within the budget and holding every staged run, every
    (shard, channel, output row) computed by exactly one CTA, no CTA
    across two shards, every output position stored once, and a card
    filled unless no CTA can be cut further."""
    spans = [c_hi - c_lo for c_lo, c_hi, *_ in rows]
    sched = dw.dwconv_schedule(nb, spans, h, w, stride, pad, n_sm)
    oh, ow = dw.out_size(h, w, stride, pad)
    hw = oh * ow
    assert sched.smem <= dw.SMEM_BUDGET
    assert sched.smem == dw.smem_bytes(sched.c_tile, sched.slab)
    run = min((sched.rows_tile - 1) * stride + 3, h) * w
    assert sched.slab >= 16 * -(-(run + 15) // 16)
    tiles = list(dw.cta_tiles(sched, rows, oh))
    assert [t[0] for t in tiles] == list(range(sched.tiles))
    assert sched.grid == nb * sched.tiles
    seen = {}
    stored = np.zeros(max(r[4] + r[3] - r[2] for r in rows), np.int64)
    for _, z, c0, nc, r0, nr in tiles:
        c_lo, c_hi, start, stop, dst = rows[z]
        assert c_lo <= c0 and c0 + nc <= c_hi and nc >= 1     # one shard
        assert 0 <= r0 and r0 + nr <= oh and nr >= 1
        for c in range(c0, c0 + nc):
            for r in range(r0, r0 + nr):
                seen[z, c, r] = seen.get((z, c, r), 0) + 1
                p = np.arange(c * hw + r * ow, c * hw + (r + 1) * ow)
                p = p[(p >= start) & (p < stop)]
                stored[dst + p - start] += 1
    assert set(seen.values()) == {1}
    assert len(seen) == sum(spans) * oh
    assert (stored == 1).all()
    n_seg = -(-ow // dw.VEC)
    if sched.grid < n_sm:
        # nothing left to cut: halving channels or rows would drop a CTA
        # below MIN_ITEMS segments
        assert (sched.c_tile == 1 or -(-sched.c_tile // 2) * sched.rows_tile
                * n_seg < dw.MIN_ITEMS)
        assert (sched.rows_tile == 1 or sched.c_tile * -(-sched.rows_tile
                                                         // 2) * n_seg
                < dw.MIN_ITEMS)
    return sched


@pytest.mark.parametrize("mode", ["kernel", "neuron", "spatial"])
def test_dwconv_schedule_on_path(paper_plans, mode):
    """Every depthwise launch of the paper model's plans at batch 8."""
    model, plans = paper_plans
    plan = plans[mode]
    n = 0
    if mode == "spatial":
        eng = T.CompiledSplitExecutor(plan, device="cpu")
        for idxs in plan.block_groups:
            if plan.splits[idxs[0]].mode != "spatial":
                continue
            bb = eng._banded_block(idxs)
            for st in bb.stages:
                layer = model.layers[st.index]
                if layer.kind != "dwconv":
                    continue
                c, _, w = layer.in_shape
                r = int(st.src_rows.shape[1])
                oh, ow = dw.out_size(r, w, layer.stride[0], (0, 1))
                rows = _table_rows([(0, c - 1, 0, c * oh * ow)])
                _check_dwconv_schedule(8 * len(bb.bands), rows, r, w,
                                       layer.stride[0], (0, 1))
                n += 1
    else:
        for i, layer in enumerate(model.layers):
            if layer.kind != "dwconv":
                continue
            geoms = [g for g in T.compile_shard_geometry(layer,
                                                         plan.splits[i])
                     if g is not None]
            rows = _table_rows([(g.c_lo, g.c_hi, g.start, g.stop)
                                for g in geoms])
            c, h, w = layer.in_shape
            sched = _check_dwconv_schedule(8, rows, h, w, layer.stride[0],
                                           (1, 1))
            if h == 56:
                # 56x56 planes of 3-19 channels a shard fill the card
                assert sched.grid >= N_SM
            n += 1
    assert n == 17


@pytest.mark.parametrize("nb,c,hw", [(8, 960, 2), (1, 960, 2), (8, 960, 4)])
def test_dwconv_schedule_fills_small_planes(nb, c, hw):
    """960 channels of 2x2 or 4x4 planes, cut across 8 workers, still give
    at least one CTA an SM at batch 8."""
    rows = _table_rows(_cut(c, hw * hw, np.arange(1, 8) / 8, False))
    sched = _check_dwconv_schedule(nb, rows, hw, hw, 1, (1, 1))
    if nb == 8:
        assert sched.grid >= N_SM


@pytest.mark.parametrize("cut", ["one", "kernel", "neuron"])
@pytest.mark.parametrize("pad", [(1, 1), (0, 1), (0, 0)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (3, 5), (4, 4), (7, 7),
                                 (14, 29), (56, 56), (11, 58), (3, 500)])
@pytest.mark.parametrize("nb,c", [(1, 3), (8, 13), (64, 96), (8, 960)])
def test_dwconv_schedule_sweep(nb, c, h, w, stride, pad, cut):
    oh, ow = dw.out_size(h, w, stride, pad)
    if oh < 1 or ow < 1:
        return
    fracs = {"one": [], "kernel": [0.3, 0.5, 0.9],
             "neuron": [0.13, 0.3, 0.31, 0.77]}[cut]
    rows = _table_rows(_cut(c, oh * ow, fracs, cut == "kernel"))
    _check_dwconv_schedule(nb, rows, h, w, stride, pad)


def _word(mem, a):
    """The little-endian 32-bit word at byte ``a`` of ``mem``."""
    return int.from_bytes(bytes(mem[a:a + 4]), "little")


def _funnel(lo, hi, n):
    """``__funnelshift_r``: the low 32 bits of (hi:lo) >> n."""
    return ((hi << 32 | lo) >> n) & 0xFFFFFFFF


def _dp4a(a, b, c):
    """``__dp4a``: c + the sum of the 4 signed byte products of a and b."""
    def sb(v, k):
        return ((v >> 8 * k & 0xFF) ^ 0x80) - 0x80
    return c + sum(sb(a, k) * sb(b, k) for k in range(4))


def _bytes_below(n):
    return 0 if n <= 0 else 0xFFFFFFFF if n >= 4 else (1 << 8 * n) - 1


def dwconv_tile_walk_emulated(x, rows, w, scale, bias, *, stride, pad,
                              activation, out_scale, base=0, seed=0):
    """The depthwise kernel's work, CTA by CTA, as ``csrc/dwconv.cu`` does
    it.  ``x`` (NB, C, H, W) int8 lies in device memory at byte ``base``
    past a 16-byte boundary.  Each CTA of ``dwconv_schedule`` finds its
    shard from the shards' first tiles, stages per channel the 16-byte
    chunks that hold its input rows' run (a chunk past the run reads
    nothing) into shared memory that starts out as garbage, and keeps the
    run's offset.  A thread takes ``VEC`` adjacent outputs of a row: per
    input row 3 aligned words, funnel-shifted to the window, the bytes of
    columns outside the input masked off, a row outside the input read as
    row ``lo`` with zero taps, then one dp4a per output against the row's
    packed taps.  Only the shard's own positions are stored.  Returns
    (NB, positions) as the table lays them out."""
    rng = np.random.default_rng(seed)
    nb_, c_, h, wd = x.shape
    ph, pw = pad
    oh, ow = dw.out_size(h, wd, stride, pad)
    hw = oh * ow
    vec = dw.VEC
    mem = np.zeros(base + x.numel() + 32, np.uint8)
    mem[base:base + x.numel()] = x.reshape(-1).numpy().view(np.uint8)
    sched = dw.dwconv_schedule(nb_, [r[1] - r[0] for r in rows], h, wd,
                               stride, pad, N_SM)
    n_rt = -(-oh // sched.rows_tile)
    tile0 = [int(v) for v in np.cumsum(
        [0] + [-(-(r[1] - r[0]) // sched.c_tile) * n_rt for r in rows])]
    assert tile0[-1] == sched.tiles
    taps = [[int.from_bytes(bytes(w[c, i].numpy().view(np.uint8)) + b"\0",
                            "little") for i in range(3)] for c in range(c_)]
    out = torch.zeros((nb_, sum(r[3] - r[2] for r in rows)),
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    written = torch.zeros(out.shape, dtype=torch.int32)
    pad_b = 16
    for nb in range(nb_):
        for t in range(sched.tiles):
            z = int(np.searchsorted(tile0, t, side="right")) - 1
            c_lo, c_hi, start, stop, dst = rows[z]
            tt = t - tile0[z]
            ct = tt // n_rt
            c0 = c_lo + ct * sched.c_tile
            nc = min(sched.c_tile, c_hi - c0)
            r0 = (tt - ct * n_rt) * sched.rows_tile
            nr = min(sched.rows_tile, oh - r0)
            if ((c0 + nc - 1) * hw + (r0 + nr) * ow <= start
                    or c0 * hw + r0 * ow >= stop):
                continue
            lo = max(r0 * stride - ph, 0)
            hi = min((r0 + nr - 1) * stride - ph + 2, h - 1)
            run = (hi - lo + 1) * wd
            src0 = base + ((nb * c_ + c0) * h + lo) * wd
            smem = rng.integers(0, 256, dw.smem_bytes(sched.c_tile,
                                                      sched.slab),
                                dtype=np.uint8)
            for c in range(nc):
                off = (src0 + c * h * wd) % 16
                for k in range(sched.slab // 16):
                    left = off + run - 16 * k
                    n = max(0, min(16, left))
                    a = src0 + c * h * wd - off + 16 * k
                    d = pad_b + c * sched.slab + 16 * k
                    smem[d:d + 16] = 0
                    smem[d:d + n] = mem[a:a + n]
            for c in range(nc):
                cc = c0 + c
                for rr in range(nr):
                    r = r0 + rr
                    for q0 in range(0, ow, vec):
                        pos0 = cc * hw + r * ow + q0
                        if pos0 >= stop or pos0 + vec <= start:
                            continue
                        col0 = q0 * stride - pw
                        mask = [_bytes_below(wd - col0 - 4 * k)
                                & ~_bytes_below(-col0 - 4 * k) & 0xFFFFFFFF
                                for k in range(3)]
                        b0 = (pad_b + c * sched.slab
                              + (src0 + c * h * wd) % 16 + col0 - lo * wd)
                        acc = [0] * vec
                        for i in range(3):
                            ri = r * stride - ph + i
                            ok = 0 <= ri < h
                            a = b0 + (ri if ok else lo) * wd
                            w0, w1, w2 = (_word(smem, (a & ~3) + 4 * k)
                                          for k in range(3))
                            sh = (a & 3) * 8
                            u0 = _funnel(w0, w1, sh) & mask[0]
                            u1 = _funnel(w1, w2, sh) & mask[1]
                            u2 = (w2 >> sh) & mask[2]
                            tap = taps[cc][i] if ok else 0
                            win = (u0, u1, u2, 0)
                            for u in range(vec):
                                b = u * stride
                                word = _funnel(win[b // 4], win[b // 4 + 1],
                                               8 * (b % 4))
                                acc[u] = _dp4a(word, tap, acc[u])
                        y = epilogue(torch.tensor(acc, dtype=torch.int32),
                                     scale[cc], bias[cc], activation,
                                     out_scale)
                        for u in range(vec):
                            p = pos0 + u
                            if q0 + u < ow and start <= p < stop:
                                out[nb, dst + p - start] = y[u]
                                written[nb, dst + p - start] += 1
    assert (written == 1).all()
    return out


def _dw_operands(rng, c, int_bias):
    w = rng.integers(-127, 128, (c, 3, 3)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, c) / (127 * 127 * 3)).astype(np.float32)
    b = (rng.integers(-3000, 3000, c).astype(np.int32) if int_bias
         else rng.uniform(-1, 1, c).astype(np.float32))
    return w, s, b


@pytest.mark.parametrize("base", [0, 5, 13])
@pytest.mark.parametrize("c,h,w,stride,cuts", [
    (5, 6, 6, 1, (0.15, 0.5, 0.52)),      # 36-byte planes, split channels
    (7, 9, 3, 2, (0.4,)),
    (3, 14, 29, 2, ()),
    (4, 7, 14, 1, (0.6,)),
])
def test_dwconv_shard_walk_vs_pallas(c, h, w, stride, cuts, base):
    """The flat form (border made in the kernel, shards in one launch)
    against the reference's per-shard Pallas loop."""
    rng = np.random.default_rng(c * h + w + base)
    nb = 2
    x = rng.integers(-127, 128, (nb, c, h, w)).astype(np.int8)
    wt, s, b = _dw_operands(rng, c, True)
    oh, ow = dw.out_size(h, w, stride, (1, 1))
    shards = _cut(c, oh * ow, cuts, False)
    got = dwconv_tile_walk_emulated(
        torch.from_numpy(x), _table_rows(shards), torch.from_numpy(wt),
        torch.from_numpy(s), torch.from_numpy(b), stride=stride, pad=(1, 1),
        activation="relu6", out_scale=0.05, base=base)
    for n in range(nb):
        parts = []
        for c_lo, c_hi, start, stop in shards:
            span = slice(c_lo, c_hi + 1)
            y = np.asarray(jax_dwconv(x[n, span], wt[span], s[span], b[span],
                                      stride=stride, activation="relu6",
                                      out_scale=0.05, interpret=True))
            off = start - c_lo * oh * ow
            parts.append(y.reshape(-1)[off:off + stop - start])
        np.testing.assert_array_equal(got[n].numpy(), np.concatenate(parts))


@pytest.mark.parametrize("int_bias", [True, False])
@pytest.mark.parametrize("pad", [(0, 1), (0, 0)])
@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_band_walk_vs_pallas(stride, pad, int_bias):
    """The band forms (width padded in the kernel, or already padded)
    against the Pallas band kernel on the padded stack, with a float bias
    and float32 output as well."""
    rng = np.random.default_rng(stride * 7 + pad[1])
    nb, c, r, w = 3, 6, 7, 11
    x = rng.integers(-127, 128, (nb, c, r, w)).astype(np.int8)
    wt, s, b = _dw_operands(rng, c, int_bias)
    oh, ow = dw.out_size(r, w, stride, pad)
    out_scale = 0.05 if int_bias else None
    got = dwconv_tile_walk_emulated(
        torch.from_numpy(x), _table_rows([(0, c - 1, 0, c * oh * ow)]),
        torch.from_numpy(wt), torch.from_numpy(s), torch.from_numpy(b),
        stride=stride, pad=pad, activation="relu", out_scale=out_scale,
        base=7)
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (pad[1], pad[1])))
    exp = np.asarray(jax_dwconv_bands(xp, wt, s, b, stride=stride,
                                      activation="relu",
                                      out_scale=out_scale, interpret=True))
    got = got.numpy().reshape(exp.shape)
    if int_bias:
        np.testing.assert_array_equal(got, exp)
    else:
        # XLA may contract the float bias's mul+add into an FMA: one
        # rounding of difference
        np.testing.assert_allclose(got, exp, rtol=1e-6,
                                   atol=1e-6 * np.abs(exp).max())
