// GQA flash-decode for Hopper (sm_90a): one query token per (batch row,
// kv head) group of G query heads against that row's KV cache.
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
// bytes of K and V it reads (at 3.35 TB/s).
//
// Design.  The cache is read in the model's (B, S, K, hd) layout through
// strides (k[b, kh, s, :] at b*kb + kh*kk + s*ks), so no transpose copies
// the cache, and ragged S is masked here instead of padded.  One CTA of 8
// warps owns one (b, kv head); it never reads a slot at or past
// lengths[b] (a masked slot adds exactly zero in the reference too).  A
// cache row of hd elements is read by hd/8 lanes, 8 consecutive elements
// (16 bytes in bf16) each, so a warp reads 256/hd rows per step, and
// every lane holds the G query rows' float32 accumulator for its 8
// elements; q sits in shared memory as float32.  The tiles of K and V go
// from device memory straight to the registers of the lanes that use them:
// every element is used by exactly one lane (for all G query rows), so
// staging a tile in shared memory would add a copy and a barrier and save
// no read.  Each warp streams its own
// rows with its own (m, l, acc) per lane group, U steps of loads in flight
// at once, with no barrier in the loop; the partial states are merged with
// shuffles inside the warp and through shared memory across warps at the
// end.  The tile over S is this kernel's own: the `block_s` of the TPU
// kernel's contract is validated by the wrapper and not used here.
//
// Known weakness: B*K CTAs (64 for qwen3-14b at batch 8) fill under half of
// the 132 SMs; splitting S across CTAs (flash-decoding with a second merge
// pass) is later work.
//
// Contract: lengths[b] in [1, S].  The kernel clamps it to [0, S]; at 0 it
// writes zeros (the TPU kernel and its reference disagree there: both
// average v over all slots, padded or not).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int EPL = 8;             // cache elements a lane reads per row
constexpr int MAX_QELEMS = 2048;   // G * hd held in shared memory
constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

// 8 consecutive cache elements of one row, as loaded, and as float32
template <typename T> struct Row;

template <> struct Row<float> {
  float4 a, b;
  __device__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void get(float (&f)[EPL]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <> struct Row<__nv_bfloat16> {
  uint4 a;
  __device__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ void get(float (&f)[EPL]) const {
    // a bf16 is the upper half of a float32; element 2i is the low half
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to the cache's dtype, as p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float p) {
  return to_float(from_float<T>(p));
}

// GM: the largest G this instantiation serves (registers hold GM rows);
// U: steps of rows each warp keeps in flight.
template <typename QT, typename KT, int GM, int U>
__global__ void __launch_bounds__(THREADS, 1)
decode_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int* __restrict__ lengths,
                   QT* __restrict__ out, int K, int G, int S, int hd,
                   int lps_log2, long long kb, long long ks, long long kk,
                   long long vb, long long vs, long long vk, float scale) {
  __shared__ __align__(16) float qs[MAX_QELEMS];
  __shared__ float acc_s[WARPS][MAX_HD];
  __shared__ float m_s[WARPS], l_s[WARPS];

  const int b = blockIdx.x / K;
  const int kh = blockIdx.x - b * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lps = 1 << lps_log2;   // lanes that read one cache row
  const int rows = 32 >> lps_log2; // rows a warp reads per step
  const int grp = lane >> lps_log2;
  const int e0 = (lane & (lps - 1)) * EPL;
  const int len = min(max(lengths[b], 0), S);

  const long long qoff = (static_cast<long long>(b) * K + kh) * G * hd;
  for (int e = threadIdx.x; e < G * hd; e += THREADS)
    qs[e] = to_float(q[qoff + e]);
  __syncthreads();

  const KT* kp = k + b * kb + kh * kk + e0;
  const KT* vp = v + b * vb + kh * vk + e0;

  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const int round_rows = U * WARPS * rows;
  for (int base = 0; base < len; base += round_rows) {
    Row<KT> kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + (u * WARPS + warp) * rows + grp;
      ok[u] = s < len;
      if (ok[u]) {
        kr[u].load(kp + s * ks);
        vr[u].load(vp + s * vs);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    // logits of this round's rows; every lane of a row's group gets the sum
    float lg[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      kr[u].get(kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        lg[u][g] = NEG_INF;
        if (g < G) {  // uniform across the CTA
          const float4* qv = reinterpret_cast<const float4*>(qs + g * hd + e0);
          const float4 q0 = qv[0], q1 = qv[1];
          float d = q0.x * kf[0];
          d = fmaf(q0.y, kf[1], d);
          d = fmaf(q0.z, kf[2], d);
          d = fmaf(q0.w, kf[3], d);
          d = fmaf(q1.x, kf[4], d);
          d = fmaf(q1.y, kf[5], d);
          d = fmaf(q1.z, kf[6], d);
          d = fmaf(q1.w, kf[7], d);
          for (int off = lps >> 1; off > 0; off >>= 1)
            d += __shfl_xor_sync(FULL, d, off);
          if (ok[u]) lg[u][g] = d * scale;
        }
      }
    }
    // online softmax: rescale once per round, then add the round's rows
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float mx = lg[0][g];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, lg[u][g]);
        const float mn = fmaxf(m[g], mx);
        const float corr = expf(m[g] - mn);
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= corr;
        m[g] = mn;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) {
        float vf[EPL];
        vr[u].get(vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = expf(lg[u][g] - m[g]);
            l[g] += p;
            const float pc = round_to<KT>(p);
#pragma unroll
            for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(pc, vf[i], acc[g][i]);
          }
        }
      }
    }
  }

  // merge the row groups of this warp (lanes lps, 2*lps, ... apart)
  for (int off = lps; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(FULL, m[g], off);
        const float lo = __shfl_xor_sync(FULL, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float a = expf(m[g] - mn), c = expf(mo - mn);
        l[g] = l[g] * a + lo * c;
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          acc[g][i] = acc[g][i] * a + __shfl_xor_sync(FULL, acc[g][i], off) * c;
        m[g] = mn;
      }
    }
  }

  // merge the warps through shared memory, one query row at a time
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      if (lane < lps) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc_s[warp][e0 + i] = acc[g][i];
      }
      if (lane == 0) {
        m_s[warp] = m[g];
        l_s[warp] = l[g];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < hd; e += THREADS) {
        float mx = m_s[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_s[w]);
        float lsum = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float c = expf(m_s[w] - mx);
          lsum += l_s[w] * c;
          a += acc_s[w][e] * c;
        }
        out[qoff + g * hd + e] = from_float<QT>(a / fmaxf(lsum, 1e-30f));
      }
      __syncthreads();
    }
  }
}

template <typename QT, typename KT, int GM, int U>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, int B, int K, int G, int S, int hd, int lps_log2,
            long long kb, long long ks, long long kk, long long vb,
            long long vs, long long vk, float scale, cudaStream_t stream) {
  decode_attn_kernel<QT, KT, GM, U><<<B * K, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<QT*>(out), K, G, S, hd, lps_log2, kb, ks, kk, vb, vs, vk,
      scale);
}

template <typename QT, typename KT>
void launch_g(const void* q, const void* k, const void* v,
              const void* lengths, void* out, int B, int K, int G, int S,
              int hd, int lps_log2, long long kb, long long ks, long long kk,
              long long vb, long long vs, long long vk, float scale,
              cudaStream_t st) {
  if (G <= 4)
    launch<QT, KT, 4, 4>(q, k, v, lengths, out, B, K, G, S, hd, lps_log2, kb,
                         ks, kk, vb, vs, vk, scale, st);
  else if (G <= 8)
    launch<QT, KT, 8, 4>(q, k, v, lengths, out, B, K, G, S, hd, lps_log2, kb,
                         ks, kk, vb, vs, vk, scale, st);
  else
    launch<QT, KT, 16, 2>(q, k, v, lengths, out, B, K, G, S, hd, lps_log2,
                          kb, ks, kk, vb, vs, vk, scale, st);
}

}  // namespace

// q: (B, K, G, hd) contiguous; k, v: element (b, kh, s, e) at
// b*kb + kh*kk + s*ks + e (unit stride over hd, every stride a multiple of
// 16 bytes); lengths: (B,) int32; out: (B, K, G, hd) in q's dtype.
// Requires hd in {8, 16, 32, 64, 128, 256}, G <= 16 and G * hd <= 2048
// (the wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_launch(const void* q, const void* k,
                                  const void* v, const void* lengths,
                                  void* out, int B, int K, int G, int S,
                                  int hd, long long kb, long long ks,
                                  long long kk, long long vb, long long vs,
                                  long long vk, int q_bf16, int kv_bf16,
                                  float scale, void* stream) {
  int lps_log2 = 0;  // log2 of the hd / 8 lanes that read one row
  while ((EPL << lps_log2) < hd) ++lps_log2;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    launch_g<__nv_bfloat16, __nv_bfloat16>(q, k, v, lengths, out, B, K, G, S,
                                           hd, lps_log2, kb, ks, kk, vb, vs,
                                           vk, scale, st);
  else if (kv_bf16)
    launch_g<float, __nv_bfloat16>(q, k, v, lengths, out, B, K, G, S, hd,
                                   lps_log2, kb, ks, kk, vb, vs, vk, scale,
                                   st);
  else
    launch_g<float, float>(q, k, v, lengths, out, B, K, G, S, hd, lps_log2,
                           kb, ks, kk, vb, vs, vk, scale, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
