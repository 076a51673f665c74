// int8 x int8 -> int32 GEMM with the fused W8A8 epilogue, for Hopper (sm_90a),
// on the int8 tensor cores and split over K where the M x N grid is small.
//
// Replaces the TPU kernel `qgemm` (src/repro/kernels/qgemm/qgemm.py:63, body
// `_qgemm_kernel`): out[M,N] = epilogue(x[M,K] @ w[K,N]) where the epilogue is
// either the bit-exact int path
//     y = f32(acc + b_q) * scale[n]                 (int32 bias, multiply only)
// or the real-domain path y = f32(acc) * scale[n] + bias[n], then relu/relu6
// (or swish / sigmoid, formed with the accurate expf: core/quantize.py)
// and optionally q = clip(rint(y * inv_out_scale), -127, 127) as int8.
//
// What bounds it on the H100: the main path's shapes are 1x1 convs and
// im2col'd 3x3 convs with K between 16 and 1280 and N between 3 and 1280,
// i.e. about 2*K*N/(K+N) int8 operations per byte moved — below the ~590
// op/byte where 1979 TOP/s of int8 tensor cores meet 3.35 TB/s, so every
// shape of the path is bound by memory traffic; most of them move under
// 2 MB, so in practice by how many SMs take part and by the launch itself.
//
// Design.  A CTA of 4 warps owns a BM x 64 output tile (BM = 16 for
// M <= 16, else 64; the host picks it) and the K range of its split
// (blockIdx.z).  K is walked in steps of 64 bytes through a ring of 3
// shared-memory stages filled by 16-byte cp.async (zero fill past the
// split's K range and the M and N edges), so the next steps load while one
// is used.  The weight is read as w[n * ldw + k], K contiguous (the (N, K)
// layout the engine uploads), so both operands are rows of k and feed
// ldmatrix and mma.sync.m16n8k32.s8 directly: exact int32 sums on the
// tensor cores.  Operands not 16-byte aligned (K = 27 rows, say) are staged
// byte by byte instead of by cp.async, into the same layout.  Shared rows
// are 80 bytes apart, so ldmatrix's 8 rows fall on distinct banks.
//
// Split K: where the tiles of M x N fill less than one wave of the SMs,
// the host gives each tile `splits` CTAs over disjoint K ranges (a multiple
// of 64 each).  Each writes its int32 sums to a workspace; the last CTA of
// a tile to arrive (an atomic counter per tile, which that CTA sets back to
// 0 for the next launch) adds up every split's sums and runs the
// epilogue.  Integer addition is exact in any order, so the result is
// bit-exact by construction.  The counters assume the launches that share
// them run in order (one stream).
//
// The epilogue runs once on the whole int32 sum, in registers, and writes
// each output once (int8 through shared memory, so that whole rows of the
// tile go out together): the int32 bias, __fmul_rn (never contracted into an
// FMA), rintf (half to even, as torch.round and jnp.round) and the clip to
// +-127.
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

using namespace tile_copy;

constexpr int BN = 64;
constexpr int BK = 64;              // bytes of K per pipeline step
constexpr int PITCH = BK + 16;
constexpr int STAGES = 3;
constexpr int THREADS = 128;

enum Activation { kNone = 0, kRelu = 1, kRelu6 = 2, kSwish = 3,
                  kSigmoid = 4 };

struct Args {
  const int8_t* x;      // x[m * ldx + k]
  const int8_t* w;      // w[n * ldw + k]
  const float* scale;
  const void* bias;
  void* out;            // out[m * ldo + n]
  int* ws;              // split partials
  unsigned* counters;   // one per tile, 0 between launches
  int M, N, K;
  long long ldx, ldw, ldo;
  int k_chunk, act;
  float inv_out_scale;
};

// rows [r0, r0 + ROWS) x k [k0, k0 + BK) of a K-contiguous operand into
// shared memory; zero past `rows_end` and `k_end`
template <int ROWS, bool ALIGNED>
__device__ __forceinline__ void stage_rows(int8_t (*dst)[PITCH],
                                           const int8_t* src, long long ld,
                                           long long r0, long long rows_end,
                                           int k0, int k_end) {
  for (int i = threadIdx.x; i < ROWS * (BK / 16); i += THREADS) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const long long gr = r0 + r;
    const int gk = k0 + c;
    if (ALIGNED) {
      const int n = gr < rows_end ? max(0, min(16, k_end - gk)) : 0;
      cp_async16(&dst[r][c], n > 0 ? src + gr * ld + gk : src, n);
    } else {
      const int8_t* row = src + gr * ld;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[r][c + j] = (gr < rows_end && gk + j < k_end) ? row[gk + j]
                                                          : int8_t(0);
    }
  }
}

// EXP: the epilogue may apply swish or sigmoid (an instance of its own,
// so the relu and relu6 instances carry no expf code)
template <int BM, bool ALIGNED, bool INT_BIAS, bool OUT_I8, bool EXP>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(Args a) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M;       // 16 or 32
  constexpr int WN = BN / WARPS_N;       // 16 or 32
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  __shared__ __align__(128) int8_t sa[STAGES][BM][PITCH];
  __shared__ __align__(128) int8_t sb[STAGES][BN][PITCH];
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * a.k_chunk;
  const int ke = min(a.K, kb + a.k_chunk);
  const int n_steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  auto load = [&](int step) {
    const int s = step % STAGES, k0 = kb + step * BK;
    stage_rows<BM, ALIGNED>(sa[s], a.x, a.ldx, m0, a.M, k0, ke);
    stage_rows<BN, ALIGNED>(sb[s], a.w, a.ldw, n0, a.N, k0, ke);
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_steps) load(st);
    cp_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // step landed; every warp is done with step - 1
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1);
    cp_commit();
    const int s = step % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], &sa[s][wm * WM + i * 16 + (lane & 15)]
                          [kk + (lane >> 4) * 16]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, &sb[s][wn * WN + j * 8 + (lane >> 4) * 8 + (lane & 7)]
                      [kk + ((lane >> 3) & 1) * 16]);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_wait<0>();

  if (gridDim.z > 1) {
    // split K: publish this CTA's sums; the tile's last CTA adds them all
    constexpr int ACC = MT * NT * 4;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const long long tiles = static_cast<long long>(gridDim.x) * gridDim.y;
    int* mine = a.ws + (blockIdx.z * tiles + tile) * (ACC * THREADS) + tid;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((i * NT + j) * 4 + e) * THREADS] =
            acc[i][j][e];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(&a.counters[tile], 1u) == gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // every split's sums, this CTA's own included, four splits in flight
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll 4
    for (unsigned z = 0; z < gridDim.z; ++z) {
      const int* part = a.ws + (z * tiles + tile) * (ACC * THREADS) + tid;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += __ldcg(part + ((i * NT + j) * 4 + e) * THREADS);
    }
    if (tid == 0) a.counters[tile] = 0u;   // ready for the next launch
  }
  // int8 output is staged in shared memory (stage 0 of sa) and written
  // in whole rows, 16 bytes a thread where the tile is full and aligned
  int8_t (*ot)[PITCH] = sa[0];
  if (OUT_I8) __syncthreads();   // every warp is done with sa

  // acc[i][j][e]: row gid + 8 * (e / 2), column 2 * tig + e % 2 of the
  // (i, j) 16 x 8 fragment
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int gn = n0 + wn * WN + j * 8 + 2 * tig + e2;
      if (gn >= a.N) continue;
      const float s = a.scale[gn];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long gm = m0 + wm * WM + i * 16 + gid + 8 * h;
          if (gm >= a.M) continue;
          const int v = acc[i][j][2 * h + e2];
          float y;
          if (INT_BIAS) {
            // b_q added in exact int32; every float step a single rounded
            // multiply (__fmul_rn is never contracted into an FMA)
            y = __fmul_rn(__int2float_rn(v + static_cast<const int*>(a.bias)[gn]),
                          s);
          } else {
            y = __fadd_rn(__fmul_rn(__int2float_rn(v), s),
                          static_cast<const float*>(a.bias)[gn]);
          }
          if (a.act == kRelu) {
            y = fmaxf(y, 0.f);
          } else if (a.act == kRelu6) {
            y = fminf(fmaxf(y, 0.f), 6.f);
          } else if (EXP && a.act >= kSwish) {
            // sigmoid(y) = 1 / (1 + expf(-y)): the accurate expf (no
            // fast-math intrinsic), a correctly rounded add and division;
            // swish multiplies y by it once (core/fusion.py: sigmoid)
            const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y)));
            y = a.act == kSwish ? __fmul_rn(y, sg) : sg;
          }
          if (OUT_I8) {
            // rintf rounds half to even, as torch.round and jnp.round do
            const float q = fminf(fmaxf(rintf(__fmul_rn(y, a.inv_out_scale)),
                                        -127.f), 127.f);
            ot[gm - m0][gn - n0] = static_cast<int8_t>(static_cast<int>(q));
          } else {
            static_cast<float*>(a.out)[gm * a.ldo + gn] = y;
          }
        }
      }
    }
  }
  if (OUT_I8) {
    __syncthreads();
    int8_t* out = static_cast<int8_t*>(a.out);
    const int rows = static_cast<int>(min(static_cast<long long>(BM), a.M - m0));
    const int cols = min(BN, a.N - n0);
    if (cols == BN && a.ldo % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      for (int i = tid; i < rows * (BN / 16); i += THREADS) {
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        *reinterpret_cast<uint4*>(out + (m0 + r) * a.ldo + n0 + c) =
            *reinterpret_cast<const uint4*>(&ot[r][c]);
      }
    } else {
      for (int i = tid; i < rows * cols; i += THREADS) {
        const int r = i / cols, c = i - r * cols;
        out[(m0 + r) * a.ldo + n0 + c] = ot[r][c];
      }
    }
  }
}

template <int BM, bool ALIGNED, bool INT_BIAS, bool OUT_I8, bool EXP>
void launch(const Args& a, int splits, cudaStream_t st) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, splits);
  qgemm_kernel<BM, ALIGNED, INT_BIAS, OUT_I8, EXP>
      <<<grid, THREADS, 0, st>>>(a);
}

template <int BM, bool ALIGNED, bool EXP>
void launch_epilogue(const Args& a, int splits, bool int_bias, bool out_i8,
                     cudaStream_t st) {
  if (int_bias && out_i8)
    launch<BM, ALIGNED, true, true, EXP>(a, splits, st);
  else if (int_bias)
    launch<BM, ALIGNED, true, false, EXP>(a, splits, st);
  else if (out_i8)
    launch<BM, ALIGNED, false, true, EXP>(a, splits, st);
  else
    launch<BM, ALIGNED, false, false, EXP>(a, splits, st);
}

template <int BM, bool ALIGNED>
void launch_act(const Args& a, int splits, bool int_bias, bool out_i8,
                cudaStream_t st) {
  if (a.act >= kSwish)
    launch_epilogue<BM, ALIGNED, true>(a, splits, int_bias, out_i8, st);
  else
    launch_epilogue<BM, ALIGNED, false>(a, splits, int_bias, out_i8, st);
}

}  // namespace

// x: x[m * ldx + k]; w: the (K, N) weight read as w[n * ldw + k] (K
// contiguous); scale (N,) f32; bias (N,) int32 or f32; out (M, N) row
// pitch ldo.  bm in {16, 64}; splits >= 1 CTAs over K per tile, each
// k_chunk bytes of K (a multiple of 64).  With splits > 1, ws holds
// splits * tiles * bm * 64 int32 and counters one zeroed uint32 per tile
// (tiles = ceil(M/bm) * ceil(N/64)).  aligned: x, w, ldx and ldw are
// multiples of 16 bytes.  Returns cudaGetLastError() after the launch.
extern "C" int qgemm_s8(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, void* ws, void* counters,
                        int M, int N, int K, long long ldx, long long ldw,
                        long long ldo, int bm, int splits, int k_chunk,
                        int aligned, int int_bias, int out_i8, int act,
                        float inv_out_scale, void* stream) {
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), bias, out,
               static_cast<int*>(ws), static_cast<unsigned*>(counters),
               M, N, K, ldx, ldw, ldo, k_chunk, act, inv_out_scale};
  auto st = static_cast<cudaStream_t>(stream);
  const bool ib = int_bias != 0, o8 = out_i8 != 0;
  if (bm == 16)
    aligned ? launch_act<16, true>(a, splits, ib, o8, st)
            : launch_act<16, false>(a, splits, ib, o8, st);
  else
    aligned ? launch_act<64, true>(a, splits, ib, o8, st)
            : launch_act<64, false>(a, splits, ib, o8, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qgemm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
