// int8 x int8 -> int32 GEMM with the fused W8A8 epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `qgemm` (src/repro/kernels/qgemm/qgemm.py:63, body
// `_qgemm_kernel`): out[M,N] = epilogue(x[M,K] @ w[K,N]) where the epilogue is
// either the bit-exact int path
//     y = f32(acc + b_q) * scale[n]                 (int32 bias, multiply only)
// or the real-domain path y = f32(acc) * scale[n] + bias[n], then relu/relu6
// and optionally q = clip(rint(y * inv_out_scale), -127, 127) as int8.
//
// What bounds it on the H100: the main path's shapes are 1x1 convs and
// im2col'd 3x3 convs with K between 16 and 1280 and N between 16 and 1280,
// i.e. about 2*K*N/(K+N) int8 operations per byte moved — below the ~590
// op/byte where 1979 TOP/s of int8 tensor cores meet 3.35 TB/s, so every
// shape of the path is bound by memory traffic, not by arithmetic.
//
// Design: one CTA of 256 threads owns a 64x64 output tile and walks K in
// steps of 32.  Each step stages the x tile (row-major, k contiguous) and
// the w tile transposed (k contiguous per column) in shared memory, so every
// thread forms its 4x4 outputs from packed 4-byte k-runs with __dp4a: exact
// int32 accumulation, no float in the loop.  __dp4a runs on the CUDA cores
// (some 130 TOP/s on the whole card, not the tensor cores' 1979), so on the
// wide shapes this kernel, not the card's memory, sets the pace.  The row
// pitch of 36 bytes (9 words) keeps the 16 distinct column reads of a warp
// on 16 banks.  The ragged M, N and K edges are masked while staging (zero
// fill), so the host
// never pads; the epilogue runs on the accumulators in registers and writes
// each output once.  A simple kernel that is right comes first: mma.sync or
// wgmma tensor-core tiles and cp.async/TMA staging are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int PITCH = BK + 4;
constexpr int THREADS = 256;

enum Activation { kNone = 0, kRelu = 1, kRelu6 = 2 };

template <bool INT_BIAS, bool OUT_I8>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, const void* __restrict__ bias,
             void* __restrict__ out, int M, int N, int K, long long ldx,
             long long ldw, long long ldo, int act, float inv_out_scale) {
  __shared__ __align__(16) int8_t xs[BM][PITCH];
  __shared__ __align__(16) int8_t ws[BN][PITCH];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[gm * ldx + gk] : int8_t(0);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[nn][kk] = (gk < K && gn < N)
                       ? w[static_cast<long long>(gk) * ldw + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&xs[ty + 16 * i][4 * kq]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][4 * kq]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      float y;
      if (INT_BIAS) {
        // b_q added in exact int32; every float step a single rounded
        // multiply (__fmul_rn is never contracted into an FMA)
        y = __fmul_rn(__int2float_rn(acc[i][j] +
                                     static_cast<const int*>(bias)[gn]), s);
      } else {
        y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s),
                      static_cast<const float*>(bias)[gn]);
      }
      if (act == kRelu) {
        y = fmaxf(y, 0.f);
      } else if (act == kRelu6) {
        y = fminf(fmaxf(y, 0.f), 6.f);
      }
      if (OUT_I8) {
        // rintf rounds half to even, as torch.round and jnp.round do
        const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv_out_scale)),
                                    -127.f), 127.f);
        static_cast<int8_t*>(out)[gm * ldo + gn] =
            static_cast<int8_t>(static_cast<int>(q));
      } else {
        static_cast<float*>(out)[gm * ldo + gn] = y;
      }
    }
  }
}

template <bool INT_BIAS, bool OUT_I8>
void launch(const int8_t* x, const int8_t* w, const float* scale,
            const void* bias, void* out, int M, int N, int K, long long ldx,
            long long ldw, long long ldo, int act, float inv_out_scale,
            cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  qgemm_kernel<INT_BIAS, OUT_I8><<<grid, THREADS, 0, stream>>>(
      x, w, scale, bias, out, M, N, K, ldx, ldw, ldo, act, inv_out_scale);
}

}  // namespace

extern "C" int qgemm_s8(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int M, int N, int K,
                        long long ldx, long long ldw, long long ldo,
                        int int_bias, int out_i8, int act, float inv_out_scale,
                        void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (int_bias && out_i8)
    launch<true, true>(xp, wp, sp, bias, out, M, N, K, ldx, ldw, ldo, act,
                       inv_out_scale, st);
  else if (int_bias)
    launch<true, false>(xp, wp, sp, bias, out, M, N, K, ldx, ldw, ldo, act,
                        inv_out_scale, st);
  else if (out_i8)
    launch<false, true>(xp, wp, sp, bias, out, M, N, K, ldx, ldw, ldo, act,
                        inv_out_scale, st);
  else
    launch<false, false>(xp, wp, sp, bias, out, M, N, K, ldx, ldw, ldo, act,
                         inv_out_scale, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qgemm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
