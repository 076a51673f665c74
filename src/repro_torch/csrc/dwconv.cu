// int8 3x3 depthwise convolution with the fused W8A8 epilogue, for Hopper
// (sm_90a).
//
// Replaces both TPU kernels of src/repro/kernels/dwconv/dwconv.py:
// `dwconv3x3_bands` (:133, body `_dwconv_bands_kernel`) and `dwconv3x3`
// (:96, body `_dwconv_kernel`), with `_accum3x3` and `_epilogue`.  One kernel
// serves both: its input is a stack x[NB, C, R, Wp] of pre-padded windows,
// the band windows of a fused spatial block (NB = batch * bands) or whole
// padded samples (NB = batch).  out[nb, c, r, q] is the sum over the 3x3
// taps of x[nb, c, r*s + i, q*s + j] * w[c, i, j] in exact int32, then the
// same epilogue as qgemm: int32 b_q added exactly and multiplies only (or a
// real-domain float bias), relu/relu6, and optionally
// clip(rint(y * inv_out_scale), -127, 127) as int8.
//
// What bounds it on the H100: 18 operations per output against at least
// one input byte and one output byte each — far below the ~590 op/byte
// where the card's arithmetic would matter — so it is bound by memory
// traffic: each input byte should be read from device memory once.
//
// Design: a CTA owns (window nb, a tile of c_tile channels, a tile of
// rows_tile output rows).  It stages the input rows that tile needs, for all
// its channels, in shared memory with coalesced byte loads (the rows of a
// window are contiguous, so a channel's slab is one contiguous run), plus
// the channels' 9 taps; then each thread computes outputs from shared
// memory, so the 3x3 overlap (up to 9 reads of an input byte) never goes
// back to device memory.  The host picks the tiles so that a CTA stages at
// most 16 KB and owns about a thousand outputs: planes as small as 4x4 with
// 960 channels and as large as 56x56 with 32 channels both fill CTAs.
// Channel and row edges are masked in the kernel; the host pads nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum Activation { kNone = 0, kRelu = 1, kRelu6 = 2 };

template <bool INT_BIAS, bool OUT_I8>
__global__ void __launch_bounds__(THREADS)
dwconv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const void* __restrict__ bias, void* __restrict__ out, int C,
                 int R, int Wp, int oh, int ow, int stride, int rows_tile,
                 int c_tile, int act, float inv_out_scale) {
  extern __shared__ __align__(16) int8_t smem[];
  const int n_ct = (C + c_tile - 1) / c_tile;
  const long long nb = blockIdx.x / n_ct;
  const int c0 = (blockIdx.x % n_ct) * c_tile;
  const int nc = min(c_tile, C - c0);
  const int r0 = blockIdx.y * rows_tile;
  const int nr = min(rows_tile, oh - r0);
  const int rows_in = (nr - 1) * stride + 3;
  const int slab = rows_in * Wp;  // one channel's staged rows
  int8_t* xs = smem;
  int8_t* ws = smem + c_tile * ((rows_tile - 1) * stride + 3) * Wp;

  const int8_t* src = x + ((nb * C + c0) * R + static_cast<long long>(r0) *
                           stride) * Wp;
  for (int e = threadIdx.x; e < nc * slab; e += THREADS) {
    const int c = e / slab;
    xs[e] = src[static_cast<long long>(c) * R * Wp + (e - c * slab)];
  }
  for (int e = threadIdx.x; e < nc * 9; e += THREADS) ws[e] = w[c0 * 9 + e];
  __syncthreads();

  const int per_c = nr * ow;
  for (int e = threadIdx.x; e < nc * per_c; e += THREADS) {
    const int c = e / per_c;
    const int rem = e - c * per_c;
    const int r = rem / ow;
    const int q = rem - r * ow;
    const int8_t* p = xs + c * slab + r * stride * Wp + q * stride;
    const int8_t* t = ws + c * 9;
    int acc = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        acc += static_cast<int>(p[i * Wp + j]) * static_cast<int>(t[i * 3 + j]);
    const int cc = c0 + c;
    float y;
    if (INT_BIAS) {
      // b_q added in exact int32; every float step a single rounded multiply
      y = __fmul_rn(__int2float_rn(acc + static_cast<const int*>(bias)[cc]),
                    scale[cc]);
    } else {
      y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[cc]),
                    static_cast<const float*>(bias)[cc]);
    }
    if (act == kRelu) {
      y = fmaxf(y, 0.f);
    } else if (act == kRelu6) {
      y = fminf(fmaxf(y, 0.f), 6.f);
    }
    const long long o = ((nb * C + cc) * oh + r0 + r) * ow + q;
    if (OUT_I8) {
      // rintf rounds half to even, as torch.round and jnp.round do
      const float v = fminf(fmaxf(rintf(__fmul_rn(y, inv_out_scale)), -127.f),
                            127.f);
      static_cast<int8_t*>(out)[o] = static_cast<int8_t>(static_cast<int>(v));
    } else {
      static_cast<float*>(out)[o] = y;
    }
  }
}

template <bool INT_BIAS, bool OUT_I8>
void launch(const int8_t* x, const int8_t* w, const float* scale,
            const void* bias, void* out, int NB, int C, int R, int Wp, int oh,
            int ow, int stride, int rows_tile, int c_tile, int act,
            float inv_out_scale, cudaStream_t stream) {
  const int n_ct = (C + c_tile - 1) / c_tile;
  const dim3 grid(NB * n_ct, (oh + rows_tile - 1) / rows_tile);
  const size_t smem =
      static_cast<size_t>(c_tile) * ((rows_tile - 1) * stride + 3) * Wp +
      static_cast<size_t>(c_tile) * 9;
  dwconv3x3_kernel<INT_BIAS, OUT_I8><<<grid, THREADS, smem, stream>>>(
      x, w, scale, bias, out, C, R, Wp, oh, ow, stride, rows_tile, c_tile,
      act, inv_out_scale);
}

}  // namespace

extern "C" int dwconv3x3_s8(const void* x, const void* w, const void* scale,
                            const void* bias, void* out, int NB, int C, int R,
                            int Wp, int oh, int ow, int stride, int rows_tile,
                            int c_tile, int int_bias, int out_i8, int act,
                            float inv_out_scale, void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (int_bias && out_i8)
    launch<true, true>(xp, wp, sp, bias, out, NB, C, R, Wp, oh, ow, stride,
                       rows_tile, c_tile, act, inv_out_scale, st);
  else if (int_bias)
    launch<true, false>(xp, wp, sp, bias, out, NB, C, R, Wp, oh, ow, stride,
                        rows_tile, c_tile, act, inv_out_scale, st);
  else if (out_i8)
    launch<false, true>(xp, wp, sp, bias, out, NB, C, R, Wp, oh, ow, stride,
                        rows_tile, c_tile, act, inv_out_scale, st);
  else
    launch<false, false>(xp, wp, sp, bias, out, NB, C, R, Wp, oh, ow, stride,
                         rows_tile, c_tile, act, inv_out_scale, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dwconv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
