// GQA flash-decode for Hopper (sm_90a), split over the cache
// (flash-decoding): one query token per (batch row, kv head) group of G
// query heads against that row's KV cache.
//
// Replaces the TPU kernel `decode_attn` of
// src/repro/kernels/decode_attn/decode_attn.py (:63, body
// `_decode_attn_kernel` :26).  It computes the same function:
//   logits[g, s] = (q[g] . k[s]) * (1 / sqrt(hd))     in float32,
//   slots s >= lengths[b] masked out,
//   out[g] = sum_s softmax(logits[g])[s] * v[s]        in q's dtype,
// with an online softmax in float32 (m, l, acc) and p cast to the cache's
// dtype before the PV product, as `p.astype(v.dtype)` does there.  Types
// (q, cache): (f32, f32), (bf16, bf16), (f32, bf16).
//
// What bounds it on the H100: every cache byte up to lengths[b] is read
// once and used for 2 * G multiply-adds, far below the ~295 operations per
// byte where the card's arithmetic would matter, so it is bound by the
// bytes of K and V it reads (at 3.35 TB/s).  Reaching that rate takes
// every SM and enough bytes in flight on each.
//
// Design.  Two kernels per call.
// * decode_attn_split_*: grid (B*K, n_split).  CTA (bk, j) owns the
//   contiguous slots [j*chunk, (j+1)*chunk) of row bk; n_split and chunk
//   come from the host (`decode_schedule` in decode_attn.py, from S, B*K
//   and the SM count only, never from lengths).  A CTA whose chunk starts
//   at or past lengths[b] writes an empty partial (l = 0) and reads no
//   cache.  The others stream their chunk through shared memory in tiles
//   of slots, with 16-byte cp.async into a ring of 2-3 stages, so the next
//   tiles load while one is used, and write a float32 partial (m, l,
//   acc[G][hd]) to a workspace.  The cache is read in the model's
//   (B, S, K, hd) layout through strides (no transpose copy); slots past
//   lengths[b] or S are zero-filled, not read, and masked.
//   - bf16 cache, hd a multiple of 16 (the decode path): tensor cores.  The
//     G query rows are padded to 16 and held as mma A fragments; each warp
//     takes 16 slots of a 64-slot tile: logits = q K^T by
//     mma.sync.m16n8k16 (bf16 in, float32 sums, K fragments by ldmatrix),
//     the online softmax on the float32 fragments (each logit and each exp
//     computed once per (slot, query head), by one lane), p rounded to
//     bf16 in registers and acc += p V by mma (V fragments by ldmatrix
//     .trans).  Each warp keeps its own (m, l, acc); the four merge through
//     shared memory at the end.  A float32 q is split into bf16 hi + lo
//     (q - hi) and both are multiplied, so its logits keep ~16 bits more
//     than bf16 q would.
//   - float32 cache, or hd 8: CUDA cores in float32 (no TF32).  In a tile
//     of 32 slots a lane owns a slot (its logit for the warp's query rows,
//     then the warp's max, exp and sum by shuffles), and for p V a thread
//     owns 4 elements of hd for every query row.
// * decode_attn_merge_kernel: grid (B*K); combines the non-empty partials
//   of each (b, kv head), weighted by exp(m - max m) / sum l (computed once
//   per query row), and writes q's dtype.
// The tile over S is this kernel's own: the `block_s` of the TPU kernel's
// contract is validated by the wrapper and not used here.
//
// Contract: lengths[b] in [1, S].  The kernel clamps it to [0, S]; at 0 it
// writes zeros (the TPU kernel and its reference disagree there: both
// average v over all slots, padded or not).
//
// Log-sum-exp output (optional, a null `lse` leaves it off): the merge
// kernel writes the output in float32 instead of q's dtype, and each
// (b, kv head, query row)'s log-sum-exp of its logits in float32.  A rank
// that holds one slice of a cache split along S attends its slice with
// its own lengths (0 where it holds no valid slot: output 0, lse -inf), and
// the ranks' outputs are merged by exp(lse - max lse) weights
// (models/lm.py); a bf16 output would round before that merge.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

using namespace tile_copy;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MMA_TS = 64;        // slots per tile, tensor-core kernel
constexpr int SIMT_TS = 32;       // slots per tile, CUDA-core kernel
constexpr int SIMT_STAGES = 2;
// tensor-core kernel: 3 stages of 64 slots (104 KB at hd 128, so two CTAs
// share an SM), 2 at hd 256 to fit
constexpr int MMA_STAGES = 3;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return -INFINITY; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to the cache's dtype, as p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float p) {
  return to_float(from_float<T>(p));
}

// 4 consecutive cache elements in shared memory, as float32
__device__ __forceinline__ void load4(const char* p, const float*,
                                      float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load4(const char* p, const bf16*,
                                      float (&f)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the upper half of a float32; element 2i is the low half
  f[0] = __uint_as_float(a.x << 16);
  f[1] = __uint_as_float(a.x & 0xffff0000u);
  f[2] = __uint_as_float(a.y << 16);
  f[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Rows [s0, s0 + rows) of one (b, kv head)'s K or V, each `row_bytes`
// long, into shared memory at `pitch` bytes a row; rows at or past `end`
// are zero-filled and not read.
__device__ __forceinline__ void load_rows(char* dst, const char* base,
                                          long long row_stride_bytes, int s0,
                                          int rows, int end, int row_bytes,
                                          int pitch) {
  const int chunks = row_bytes >> 4;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = i - r * chunks;
    const int s = s0 + r;
    const bool ok = s < end;
    const char* src = ok ? base + s * row_stride_bytes + c * 16 : base;
    cp_async16(dst + r * pitch + c * 16, src, ok ? 16 : 0);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* ws_acc;   // (B*K, n_split, G, hd)
  float* ws_m;     // (B*K, n_split, G)
  float* ws_l;     // (B*K, n_split, G)
  int K, G, S, hd, chunk, n_split;
  long long kb, ks, kk, vb, vs, vk;   // element strides of k and v
  float scale;
};

// Writes an empty partial and returns true when CTA (bk, split) owns no
// valid slot; else sets [s_begin, s_end).
__device__ __forceinline__ bool empty_chunk(const Args& a, int& s_begin,
                                            int& s_end) {
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / a.K;
  const int len = min(max(a.lengths[b], 0), a.S);
  s_begin = split * a.chunk;
  s_end = min(s_begin + a.chunk, len);
  if (s_begin < s_end) return false;
  const long long p = (static_cast<long long>(bk) * a.n_split + split) * a.G;
  for (int g = threadIdx.x; g < a.G; g += THREADS) {
    a.ws_m[p + g] = neg_inf();
    a.ws_l[p + g] = 0.f;
  }
  return true;
}

// ---------------------------------------------------------------------------
// tensor cores: bf16 cache, hd a multiple of 16
template <typename QT, int HD, int STAGES>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_mma(Args a) {
  constexpr int PITCH = HD * 2 + 16;   // bytes; 16 of padding keep ldmatrix
                                       // rows on distinct banks
  constexpr int TILE_BYTES = MMA_TS * PITCH;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;
  constexpr bool QSPLIT = sizeof(QT) == 4;
  extern __shared__ __align__(16) char smem[];

  int s_begin, s_end;
  if (empty_chunk(a, s_begin, s_end)) return;
  const int bk = blockIdx.x;
  const int b = bk / a.K, kh = bk - b * a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.G;

  // q as A fragments: rows gid and gid + 8, padded with zeros past G
  const QT* qp = static_cast<const QT*>(a.q) + static_cast<long long>(bk) * G * HD;
  uint32_t qa[KSTEPS][4];
  uint32_t ql[QSPLIT ? KSTEPS : 1][4];
#pragma unroll
  for (int kq = 0; kq < KSTEPS; ++kq) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = gid + (j & 1) * 8;
      const int col = kq * 16 + (j >> 1) * 8 + 2 * tig;
      float x0 = 0.f, x1 = 0.f;
      if (row < G) {
        x0 = to_float(qp[row * HD + col]);
        x1 = to_float(qp[row * HD + col + 1]);
      }
      qa[kq][j] = pack_bf16(x0, x1);
      if (QSPLIT) {
        const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
        ql[QSPLIT ? kq : 0][j] = pack_bf16(x0 - h0, x1 - h1);
      }
    }
  }

  const char* kp = reinterpret_cast<const char*>(
      static_cast<const bf16*>(a.k) + b * a.kb + kh * a.kk);
  const char* vp = reinterpret_cast<const char*>(
      static_cast<const bf16*>(a.v) + b * a.vb + kh * a.vk);
  const long long ksb = a.ks * 2, vsb = a.vs * 2;
  const int n_tiles = (s_end - s_begin + MMA_TS - 1) / MMA_TS;
  auto load_tile = [&](int t) {
    char* st = smem + (t % STAGES) * 2 * TILE_BYTES;
    const int s0 = s_begin + t * MMA_TS;
    load_rows(st, kp, ksb, s0, MMA_TS, s_end, HD * 2, PITCH);
    load_rows(st + TILE_BYTES, vp, vsb, s0, MMA_TS, s_end, HD * 2, PITCH);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_commit();
  }

  float m_r[2] = {neg_inf(), neg_inf()}, l_r[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_commit();
    const char* kt = smem + (t % STAGES) * 2 * TILE_BYTES;
    const char* vt = kt + TILE_BYTES;
    const int r0 = warp * 16;                       // this warp's rows
    const int s0 = s_begin + t * MMA_TS + r0;

    // logits (16 query rows x 16 slots): two n8 tiles of slots
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kq = 0; kq < KSTEPS; ++kq) {
      uint32_t r[4];
      const int mi = lane >> 3;
      ldsm_x4(r, kt + (r0 + (mi >> 1) * 8 + (lane & 7)) * PITCH
                     + (kq * 16 + (mi & 1) * 8) * 2);
      mma_bf16(sc[0], qa[kq], r[0], r[1]);
      mma_bf16(sc[1], qa[kq], r[2], r[3]);
      if (QSPLIT) {
        mma_bf16(sc[0], ql[QSPLIT ? kq : 0], r[0], r[1]);
        mma_bf16(sc[1], ql[QSPLIT ? kq : 0], r[2], r[3]);
      }
    }
    // sc[n][0..1]: row gid, slots s0 + 8n + 2 tig + {0, 1}; [2..3]: gid + 8
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + n * 8 + 2 * tig + (j & 1);
        const float x = s < s_end ? sc[n][j] * a.scale : neg_inf();
        sc[n][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      // a row that has seen only masked slots keeps m = -inf and p = 0
      m_use[h] = m_new == neg_inf() ? 0.f : m_new;
      const float corr = expf(m_r[h] - m_use[h]);
      m_r[h] = m_new;
      l_r[h] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[n][j] - m_use[j >> 1]);
        l_r[j >> 1] += p;
        sc[n][j] = p;
      }
    // p (rounded to bf16) as the A fragment of p V: k = the 16 slots
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t r[4];
      const int mi = lane >> 3;
      ldsm_x4_trans(r, vt + (r0 + (mi & 1) * 8 + (lane & 7)) * PITCH
                           + (n * 8 + (mi >> 1) * 8) * 2);
      mma_bf16(o[n], pa, r[0], r[1]);
      mma_bf16(o[n + 1], pa, r[2], r[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // merge the four warps' (m, l, acc) through shared memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(FULL, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(FULL, l_r[h], 2);
  }
  float* red_o = reinterpret_cast<float*>(smem);          // [WARPS][16][HD]
  float* red_m = red_o + WARPS * 16 * HD;                  // [WARPS][16]
  float* red_l = red_m + WARPS * 16;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * tig;
    float* row0 = red_o + (warp * 16 + gid) * HD + col;
    row0[0] = o[n][0];
    row0[1] = o[n][1];
    row0[8 * HD] = o[n][2];
    row0[8 * HD + 1] = o[n][3];
  }
  if (tig == 0) {
    red_m[warp * 16 + gid] = m_r[0];
    red_m[warp * 16 + gid + 8] = m_r[1];
    red_l[warp * 16 + gid] = l_r[0];
    red_l[warp * 16 + gid + 8] = l_r[1];
  }
  __syncthreads();
  const long long p = static_cast<long long>(bk) * a.n_split + blockIdx.y;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, e = i - g * HD;
    // warp 0 saw slot s_begin, so mx is finite
    float mx = red_m[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * 16 + g]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(red_m[w * 16 + g] - mx);
      lsum += red_l[w * 16 + g] * c;
      acc += red_o[(w * 16 + g) * HD + e] * c;
    }
    a.ws_acc[p * G * HD + i] = acc;
    if (e == 0) {
      a.ws_m[p * G + g] = mx;
      a.ws_l[p * G + g] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: float32 cache (float32 arithmetic throughout), or hd 8.
// GM: the largest G this instantiation serves; warp w owns query rows
// w, w + 4, ... (GM / 4 of them).
template <typename QT, typename KT, int GM>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_simt(Args a) {
  constexpr int GPW = GM / WARPS;
  extern __shared__ __align__(16) char smem[];
  __shared__ float ml_s[2][GM];
  __shared__ float corr_s[GM];

  int s_begin, s_end;
  if (empty_chunk(a, s_begin, s_end)) return;
  const int bk = blockIdx.x;
  const int b = bk / a.K, kh = bk - b * a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.G, hd = a.hd;
  const int row_bytes = hd * static_cast<int>(sizeof(KT));
  const int pitch = row_bytes + 16;
  const int tile_bytes = SIMT_TS * pitch;
  float* qs = reinterpret_cast<float*>(smem + SIMT_STAGES * 2 * tile_bytes);
  float* ps = qs + GM * hd;                                   // [GM][TS]

  const QT* qp = static_cast<const QT*>(a.q) + static_cast<long long>(bk) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) qs[i] = to_float(qp[i]);

  const char* kp = reinterpret_cast<const char*>(
      static_cast<const KT*>(a.k) + b * a.kb + kh * a.kk);
  const char* vp = reinterpret_cast<const char*>(
      static_cast<const KT*>(a.v) + b * a.vb + kh * a.vk);
  const long long ksb = a.ks * sizeof(KT), vsb = a.vs * sizeof(KT);
  const int n_tiles = (s_end - s_begin + SIMT_TS - 1) / SIMT_TS;
  auto load_tile = [&](int t) {
    char* st = smem + (t % SIMT_STAGES) * 2 * tile_bytes;
    const int s0 = s_begin + t * SIMT_TS;
    load_rows(st, kp, ksb, s0, SIMT_TS, s_end, row_bytes, pitch);
    load_rows(st + tile_bytes, vp, vsb, s0, SIMT_TS, s_end, row_bytes, pitch);
  };
  load_tile(0);
  cp_commit();

  // p V: this thread's 4 elements of hd (chunk c) for slots r, r + R, ...
  const int CH = hd / 4;
  const int c = threadIdx.x % CH, r = threadIdx.x / CH, R = THREADS / CH;
  float m_r[GPW], l_r[GPW], acc[GM][4];
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    m_r[j] = neg_inf();
    l_r[j] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<0>();
    __syncthreads();   // tile t landed; tile t - 1 and ps are free
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_commit();
    const char* kt = smem + (t % SIMT_STAGES) * 2 * tile_bytes;
    const char* vt = kt + tile_bytes;
    const int s = s_begin + t * SIMT_TS + lane;
    const bool ok = s < s_end;
    // logits: lane = slot, the warp's query rows
#pragma unroll
    for (int j = 0; j < GPW; ++j) {
      const int g = warp + WARPS * j;
      if (g < G) {   // uniform across the warp
        const char* krow = kt + lane * pitch;
        const float* qrow = qs + g * hd;
        float d = 0.f;
        for (int e = 0; e < hd; e += 4) {
          float kf[4];
          load4(krow + e * sizeof(KT), static_cast<const KT*>(nullptr), kf);
          const float4 qv = *reinterpret_cast<const float4*>(qrow + e);
          d = fmaf(qv.x, kf[0], d);
          d = fmaf(qv.y, kf[1], d);
          d = fmaf(qv.z, kf[2], d);
          d = fmaf(qv.w, kf[3], d);
        }
        const float x = ok ? d * a.scale : neg_inf();
        const float m_new = fmaxf(m_r[j], warp_max(x));
        const float m_use = m_new == neg_inf() ? 0.f : m_new;
        const float corr = expf(m_r[j] - m_use);
        const float p = expf(x - m_use);
        l_r[j] = l_r[j] * corr + warp_sum(p);
        m_r[j] = m_new;
        ps[g * SIMT_TS + lane] = round_to<KT>(p);
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float corr = corr_s[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] *= corr;
      }
    }
    const int valid = s_end - (s_begin + t * SIMT_TS);
    for (int sl = r; sl < SIMT_TS && sl < valid; sl += R) {
      float vf[4];
      load4(vt + sl * pitch + c * 4 * sizeof(KT),
            static_cast<const KT*>(nullptr), vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pg = ps[g * SIMT_TS + sl];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(pg, vf[i], acc[g][i]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // sum the R slot phases through shared memory
  float* red = reinterpret_cast<float*>(smem);              // [R][G][hd]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < 4; ++i) red[(r * G + g) * hd + c * 4 + i] = acc[g][i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < GPW; ++j) {
      const int g = warp + WARPS * j;
      if (g < G) {
        ml_s[0][g] = m_r[j];
        ml_s[1][g] = l_r[j];
      }
    }
  }
  __syncthreads();
  const long long p = static_cast<long long>(bk) * a.n_split + blockIdx.y;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    float sum = 0.f;
    for (int rr = 0; rr < R; ++rr) sum += red[rr * G * hd + i];
    a.ws_acc[p * G * hd + i] = sum;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    a.ws_m[p * G + g] = ml_s[0][g];
    a.ws_l[p * G + g] = ml_s[1][g];
  }
}

// ---------------------------------------------------------------------------
// combine the partials of each (b, kv head); a chunk at or past lengths[b]
// is empty and skipped.  Each partial's weight exp(m - max m) / sum l is
// computed once per query row into shared memory (n_split * G floats);
// then every output element sums its partials, four loads in flight.
// With `lse` (the caller then passes QT = float), it also writes each query
// row's log-sum-exp, max m + log(sum l), for a merge across ranks that
// hold other slots of the same cache; a row with no valid slot gets output
// 0 and lse -inf.
template <typename QT>
__global__ void __launch_bounds__(THREADS)
decode_attn_merge_kernel(Args a, QT* __restrict__ out,
                         float* __restrict__ lse) {
  extern __shared__ float wgt[];   // [n_split][G]
  const int bk = blockIdx.x;
  const int b = bk / a.K;
  const int len = min(max(a.lengths[b], 0), a.S);
  const int used = min(a.n_split, (len + a.chunk - 1) / a.chunk);
  const int G = a.G, hd = a.hd;
  const long long p0 = static_cast<long long>(bk) * a.n_split;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float mx = neg_inf();
    for (int j = 0; j < used; ++j) mx = fmaxf(mx, a.ws_m[(p0 + j) * G + g]);
    float lsum = 0.f;
    for (int j = 0; j < used; ++j) {
      const float c = expf(a.ws_m[(p0 + j) * G + g] - mx);
      wgt[j * G + g] = c;
      lsum += a.ws_l[(p0 + j) * G + g] * c;
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int j = 0; j < used; ++j) wgt[j * G + g] *= inv;
    if (lse != nullptr)
      lse[static_cast<long long>(bk) * G + g] =
          lsum > 0.f ? mx + logf(lsum) : neg_inf();
  }
  __syncthreads();
  const float* acc0 = a.ws_acc + p0 * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < used; ++j)
      acc = fmaf(acc0[static_cast<long long>(j) * G * hd + i], wgt[j * G + g],
                 acc);
    out[static_cast<long long>(bk) * G * hd + i] = from_float<QT>(acc);
  }
}

// dynamic shared memory of each split kernel
template <int HD, int STAGES>
constexpr int mma_smem() {
  return (STAGES * 2 * MMA_TS * (HD * 2 + 16)) > (WARPS * 16 * (HD + 2) * 4)
             ? STAGES * 2 * MMA_TS * (HD * 2 + 16)
             : WARPS * 16 * (HD + 2) * 4;
}

int simt_smem(int hd, int kt_size, int gm) {
  const int pipe = SIMT_STAGES * 2 * SIMT_TS * (hd * kt_size + 16) +
                   gm * hd * 4 + gm * SIMT_TS * 4;
  const int red = (THREADS / (hd / 4)) * gm * hd * 4;
  return pipe > red ? pipe : red;
}

template <typename K>
cudaError_t launch_split(K kernel, dim3 grid, int smem, const Args& a,
                         cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename QT, int HD>
cudaError_t split_mma(dim3 grid, const Args& a, cudaStream_t st) {
  constexpr int STAGES = HD > 128 ? 2 : MMA_STAGES;
  return launch_split(decode_attn_split_mma<QT, HD, STAGES>, grid,
                      mma_smem<HD, STAGES>(), a, st);
}

template <typename QT>
cudaError_t split_mma_hd(dim3 grid, const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 16: return split_mma<QT, 16>(grid, a, st);
    case 32: return split_mma<QT, 32>(grid, a, st);
    case 64: return split_mma<QT, 64>(grid, a, st);
    case 128: return split_mma<QT, 128>(grid, a, st);
    default: return split_mma<QT, 256>(grid, a, st);
  }
}

template <typename QT, typename KT>
cudaError_t split_simt(dim3 grid, const Args& a, cudaStream_t st) {
  const int ks = static_cast<int>(sizeof(KT));
  if (a.G <= 4)
    return launch_split(decode_attn_split_simt<QT, KT, 4>, grid,
                        simt_smem(a.hd, ks, 4), a, st);
  if (a.G <= 8)
    return launch_split(decode_attn_split_simt<QT, KT, 8>, grid,
                        simt_smem(a.hd, ks, 8), a, st);
  return launch_split(decode_attn_split_simt<QT, KT, 16>, grid,
                      simt_smem(a.hd, ks, 16), a, st);
}

}  // namespace

// q: (B, K, G, hd) contiguous; k, v: element (b, kh, s, e) at
// b*kb + kh*kk + s*ks + e (unit stride over hd, every stride a multiple of
// 16 bytes); lengths: (B,) int32; out: (B, K, G, hd) in q's dtype, or in
// float32 when lse is not null; lse: null, or (B, K, G) float32; ws:
// float32 workspace of B*K*n_split*G*(hd + 2) elements.  n_split * chunk
// >= S, chunk > 0, n_split * G <= 12288 (the merge's shared memory; the
// host's schedule gives n_split <= 2 x the SM count).  Requires hd in {8, 16, 32, 64, 128, 256} and G <= 16
// (the wrapper checks).  Launches the split kernel and the merge kernel on
// `stream`; returns the first launch error, or 0.
extern "C" int decode_attn_launch(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, void* ws, int B, int K, int G,
                                  int S, int hd, long long kb, long long ks,
                                  long long kk, long long vb, long long vs,
                                  long long vk, int q_bf16, int kv_bf16,
                                  float scale, int n_split, int chunk,
                                  void* lse, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long parts = static_cast<long long>(B) * K * n_split * G;
  float* w = static_cast<float*>(ws);
  const Args a{q, k, v, static_cast<const int*>(lengths), w, w + parts * hd,
               w + parts * (hd + 1), K, G, S, hd, chunk, n_split,
               kb, ks, kk, vb, vs, vk, scale};
  const dim3 grid(B * K, n_split);
  cudaError_t e;
  if (kv_bf16 && hd % 16 == 0)
    e = q_bf16 ? split_mma_hd<bf16>(grid, a, st)
               : split_mma_hd<float>(grid, a, st);
  else if (kv_bf16)
    e = q_bf16 ? split_simt<bf16, bf16>(grid, a, st)
               : split_simt<float, bf16>(grid, a, st);
  else
    e = split_simt<float, float>(grid, a, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int merge_smem = n_split * G * static_cast<int>(sizeof(float));
  if (q_bf16 && lse == nullptr)
    decode_attn_merge_kernel<bf16><<<B * K, THREADS, merge_smem, st>>>(
        a, static_cast<bf16*>(out), nullptr);
  else
    decode_attn_merge_kernel<float><<<B * K, THREADS, merge_smem, st>>>(
        a, static_cast<float*>(out), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
