"""The split schedules of the port's two redesigned CUDA kernels, on the CPU.

``qgemm_schedule`` (tile height and split over K) and ``decode_schedule``
(split over the cache) are plain Python that the wrappers call; here they
are checked over the shapes the main paths launch and over sweeps.  Each
split algorithm is then emulated in plain torch, exactly as the kernel
splits the work, and held against the reference's Pallas kernel run in
interpret mode: int32 split-K partials summed, then the epilogue,
``array_equal``; per-chunk float32 flash-decode partials (m, l, acc) merged
by their maxima, at 1e-5.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attn.ops import flash_decode as jax_flash_decode
from repro.kernels.qgemm.ops import qgemm_padded as jax_qgemm

from repro_torch.core.quantize import epilogue
from repro_torch.kernels.decode_attn.decode_attn import (
    MAX_CHUNK_TILES, TILE_S, chunk_is_empty, decode_schedule)
from repro_torch.kernels.decode_attn.ref import softmax_scale
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
