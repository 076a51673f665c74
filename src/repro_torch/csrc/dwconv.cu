// int8 3x3 depthwise convolution with the fused W8A8 epilogue, for Hopper
// (sm_90a).
//
// Replaces both TPU kernels of src/repro/kernels/dwconv/dwconv.py:
// `dwconv3x3_bands` (:133, body `_dwconv_bands_kernel`) and `dwconv3x3`
// (:96, body `_dwconv_kernel`), with `_accum3x3` and `_epilogue`.  One kernel
// serves both.  Its input is a stack x[NB, C, H, W] of unpadded windows: band
// windows of a fused spatial block (NB = batch * bands), whole samples
// (NB = batch), or already padded ones (pad 0).  The kernel reads a zero
// border of ph rows and pw columns on each side itself.  out[nb, c, r, q] is
// the sum over the 3x3 taps of x[nb, c, r*s + i - ph, q*s + j - pw] *
// w[c, i, j] in exact int32, then the same epilogue as qgemm: int32 b_q
// added exactly and multiplies only (or a real-domain float bias),
// relu/relu6, and optionally clip(rint(y * inv_out_scale), -127, 127) as
// int8.
//
// A shard table (optional) runs a whole flat layer over all of its worker
// shards in one launch: shard z holds channels [c_lo, c_hi) and owns the
// flat output positions [start, stop) of the layer's (C, oh, ow) output,
// which land at dst.. of each window's output row.  Every CTA belongs to
// one shard, reads only its channels and stores only its positions, so a
// neuron shard that starts inside a channel computes that channel's rows
// and keeps its own part.  Without a table one shard spans everything.
// The table (at most MAX_SHARDS rows) travels in the kernel's parameters,
// so finding a CTA's shard reads no device memory.  A layer of more shards
// is several launches of consecutive rows; each keeps its rows' dst and the
// whole layer's out_stride, so it writes its own slice of one output.
//
// What bounds it on the H100: 18 operations per output against at least one
// input byte and one output byte each, far below the ~590 op/byte where the
// card's arithmetic would matter, so it is bound by bytes: each input byte
// should come from device memory once, and few instructions should stand
// between the bytes and the stores.  The design:
// - staging: a CTA owns (window, c_tile channels of one shard, rows_tile
//   output rows).  Each channel's input rows are one contiguous run at any
//   byte offset; the CTA copies the 16-byte-aligned chunks that hold the
//   run with cp.async (no division per byte or per chunk) and keeps the
//   run's offset in its slab.  The border is never staged: a tap outside
//   the input reads 0.  Taps, scale and bias are staged once.
// - register reuse: a thread computes VEC = 4 adjacent outputs of a row.
//   The (VEC-1)*s + 3 input bytes of each of the 3 rows are loaded once as
//   3 aligned 32-bit words, shifted into place, and the taps outside the
//   input are masked off as whole bytes; each output is then one __dp4a of
//   its 3 bytes (a word shifted by 8*q*s bits) against the row's 3 taps
//   packed in a word.  For stride 2 the window is consecutive bytes too, so
//   no even/odd split is needed.  A row outside the input is read as a
//   staged row with zero taps, so the loop has no branch.
// - few instructions: at the main path's sizes (under 4 MB a launch) the
//   H100 spends a launch's time on instructions and latency, not on bytes.
//   So no integer division runs per item or per chunk (the divisors are
//   launch constants, divided by multiply-high with magic numbers set up
//   on the host), the activation is a clamp, and a CTA finds its shard from
//   per-shard first tiles the host computes.
// - stores: 4 int8 outputs as one 32-bit store, 4 float outputs as one
//   16-byte store, wherever the 4 are owned and aligned; else one by one.
// The host picks the tiles (kernels/dwconv/dwconv.py: dwconv_schedule).
//
// The same body serves the 5x5 depthwise convs of EfficientNet
// (dwconv5x5_kernel, K = 5, pad 2): each row's 5 taps are packed in two
// words, taps 0..3 and tap 4 alone, so an output is two __dp4a a row, the
// second against the window's byte 4 (the other three bytes meet zero
// taps).  Its window is 8 bytes at stride 1 and 11 at stride 2, still read
// as aligned words from the staged run.  It keeps 4 CTAs an SM (64
// registers), the 3x3 kernel 8.
//
// Activations: relu and relu6 are the clamp; swish and sigmoid (ACT =
// kSwish, kSigmoid) follow the epilogue's multiply with
// s = __fdiv_rn(1, __fadd_rn(1, expf(-v))) and, for swish, __fmul_rn(v, s):
// the accurate expf (no fast-math intrinsic; the build passes no
// --use_fast_math), a correctly rounded add and division, one rounded
// multiply.  The plain version (core/fusion.py: sigmoid) forms the same
// expression with torch.exp, so on the card both round alike wherever
// torch's exp and expf agree.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_CTAS_PER_SM = 8;  // caps registers at 32 a thread
constexpr int VEC = 4;
constexpr int MAX_SHARDS = 64;
constexpr int PAD = 16;  // bytes before and after the slabs (word reads)

enum Activation { kNone = 0, kRelu = 1, kRelu6 = 2, kSwish = 3,
                  kSigmoid = 4 };
// how an epilogue applies its activation: the clamp (none, relu, relu6),
// or one of the two functions of expf
enum ActForm { kClamp = 0, kSwishForm = 1, kSigmoidForm = 2 };

// n / d for 0 <= n < 2^31 by multiply-high (the Granlund-Montgomery magic
// number, as CUTLASS's FastDivmod computes it); set up on the host
struct FastDiv {
  int d;
  unsigned m;
  int s;
  void init(int div) {
    d = div;
    int lg = 0;
    while ((1ll << lg) < div) ++lg;  // ceil(log2(div))
    const int p = 31 + lg;
    m = div == 1 ? 0u
                 : static_cast<unsigned>(((1ull << p) + div - 1) / div);
    s = p - 32;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n), m) >>
                                     s);
  }
};

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const int* bias;     // int32 b_q, or the bits of a float32 bias
  void* out;
  int n_shards, C, H, W, ph, pw, oh, ow, n_seg, plane16;
  int c_tile, rows_tile, slab, n_rt;
  FastDiv by_seg, by_rows, by_chunks, by_rt;
  long long out_stride;  // outputs of one window
  float act_lo, act_hi;  // the activation as a clamp (-inf/inf: none)
  float inv_out_scale;
  // c_lo, c_hi, start, stop, dst of each shard; its first tile
  int shards[MAX_SHARDS * 5];
  int tile0[MAX_SHARDS + 1];
};

// the low n bytes of a word set (n clipped to 0..4)
__device__ __forceinline__ uint32_t bytes_below(int n) {
  return n <= 0 ? 0u : n >= 4 ? 0xffffffffu : (1u << (8 * n)) - 1u;
}

template <int ACT>
__device__ __forceinline__ float activate(float v, const Params& p) {
  if (ACT == kClamp) return fminf(fmaxf(v, p.act_lo), p.act_hi);
  // accurate expf, correctly rounded add and division (see the header)
  const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  return ACT == kSwishForm ? __fmul_rn(v, sg) : sg;
}

template <int K, int S, bool INT_BIAS, bool OUT_I8, int ACT>
__device__ __forceinline__ void dwconv_tile(const Params& p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int nb = blockIdx.y;
  int t = blockIdx.x;
  const int hw = p.oh * p.ow;

  // the CTA's shard: tiles run shard by shard (cta_tiles on the host)
  int c_lo = 0, c_hi = p.C, start = 0, stop = p.C * hw, dst = 0;
  if (p.n_shards > 0) {
    int z = 0;
    while (z + 1 < p.n_shards && t >= p.tile0[z + 1]) ++z;
    t -= p.tile0[z];
    c_lo = p.shards[5 * z];
    c_hi = p.shards[5 * z + 1];
    start = p.shards[5 * z + 2];
    stop = p.shards[5 * z + 3];
    dst = p.shards[5 * z + 4];
  }
  const int ct = p.by_rt(t);
  const int c0 = c_lo + ct * p.c_tile;
  const int nc = min(p.c_tile, c_hi - c0);
  const int r0 = (t - ct * p.n_rt) * p.rows_tile;
  const int nr = min(p.rows_tile, p.oh - r0);
  // a tile none of whose outputs the shard owns does nothing
  if ((c0 + nc - 1) * hw + (r0 + nr) * p.ow <= start ||
      c0 * hw + r0 * p.ow >= stop)
    return;

  // input rows lo..hi (inclusive) of the tile, clipped to the input
  const int lo = max(r0 * S - p.ph, 0);
  const int hi = min((r0 + nr - 1) * S - p.ph + K - 1, p.H - 1);
  const int run = (hi - lo + 1) * p.W;
  const long long plane = static_cast<long long>(p.H) * p.W;
  const int8_t* src0 =
      p.x + (static_cast<long long>(nb) * p.C + c0) * plane +
      static_cast<long long>(lo) * p.W;
  // byte offset of channel c's run past a 16-byte boundary:
  // (off0 + c * plane16) & 15
  const int off0 = static_cast<int>(reinterpret_cast<uintptr_t>(src0) & 15);
  int8_t* xs = smem + PAD;
  float* ss = reinterpret_cast<float*>(xs + p.c_tile * p.slab + PAD);
  int* bs = reinterpret_cast<int*>(ss + p.c_tile);
  uint32_t* wk = reinterpret_cast<uint32_t*>(bs + p.c_tile);

  const int n_chunks = p.slab / 16;
  for (int e = threadIdx.x; e < nc * n_chunks; e += THREADS) {
    const int c = p.by_chunks(e);
    const int k = e - c * n_chunks;
    const int off = (off0 + c * p.plane16) & 15;
    const int8_t* src = src0 + c * plane - off;
    // bytes of this chunk that belong to the aligned run; a chunk past its
    // end reads nothing (and points at the run's first chunk)
    const int left = off + run - k * 16;
    tile_copy::cp_async16(xs + c * p.slab + k * 16,
                          src + (left > 0 ? k * 16 : 0),
                          left >= 16 ? 16 : (left > 0 ? left : 0));
  }
  tile_copy::cp_commit();
  // each row's taps packed in tap_words<K>() words: the low 3 bytes of one
  // (K = 3), or 4 bytes and then the fifth alone (K = 5)
  for (int e = threadIdx.x; e < nc * K; e += THREADS) {
    const int8_t* g = p.w + c0 * K * K + e * K;
    uint32_t lo = static_cast<uint8_t>(g[0]) |
                  static_cast<uint32_t>(static_cast<uint8_t>(g[1])) << 8 |
                  static_cast<uint32_t>(static_cast<uint8_t>(g[2])) << 16;
    if (K == 3) {
      wk[e] = lo;
    } else {
      lo |= static_cast<uint32_t>(static_cast<uint8_t>(g[3])) << 24;
      wk[2 * e] = lo;
      wk[2 * e + 1] = static_cast<uint8_t>(g[4]);
    }
  }
  for (int e = threadIdx.x; e < nc; e += THREADS) {
    ss[e] = p.scale[c0 + e];
    bs[e] = p.bias[c0 + e];
  }
  tile_copy::cp_wait<0>();
  __syncthreads();

  const int items = nc * p.rows_tile * p.n_seg;
  for (int e = threadIdx.x; e < items; e += THREADS) {
    const int cr = p.by_seg(e);
    const int q0 = (e - cr * p.n_seg) * VEC;
    const int c = p.by_rows(cr);
    const int rr = cr - c * p.rows_tile;
    if (rr >= nr) continue;
    const int r = r0 + rr;
    const int pos0 = (c0 + c) * hw + r * p.ow + q0;
    if (pos0 >= stop || pos0 + VEC <= start) continue;
    // window column j is input column col0 + j; only 0 <= col < W is read
    const int col0 = q0 * S - p.pw;
    const int j_lo = -col0, j_hi = p.W - col0;
    uint32_t mask[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      mask[k] = bytes_below(j_hi - 4 * k) & ~bytes_below(j_lo - 4 * k);
    // smem offset of window column 0 in input row lo
    const int base = PAD + c * p.slab + ((off0 + c * p.plane16) & 15) +
                     col0 - lo * p.W;
    int acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      // a row outside the input adds nothing: its taps are zeroed and a
      // staged row is read in its place (no branch, so the masks above are
      // computed once)
      const int ri = r * S - p.ph + i;
      const bool row_ok = ri >= 0 && ri < p.H;
      const int a = base + (row_ok ? ri : lo) * p.W;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(smem + (a & ~3));
      const int sh = (a & 3) * 8;
      const uint32_t w0 = wp[0], w1 = wp[1], w2 = wp[2];
      // the window's bytes 0..11, taps outside the input zeroed
      const uint32_t u0 = __funnelshift_r(w0, w1, sh) & mask[0];
      const uint32_t u1 = __funnelshift_r(w1, w2, sh) & mask[1];
      if (K == 5) {
        // output u reads bytes b..b+4, b = u * S: taps 0..3 against the
        // word at b, tap 4 against the low byte of the word at b + 4
        const int ta = row_ok ? static_cast<int>(wk[(c * 5 + i) * 2]) : 0;
        const int tb = row_ok ? static_cast<int>(wk[(c * 5 + i) * 2 + 1]) : 0;
        if (S == 1) {
          acc[0] = __dp4a(static_cast<int>(u0), ta, acc[0]);
          acc[0] = __dp4a(static_cast<int>(u1), tb, acc[0]);
          acc[1] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 8)), ta,
                          acc[1]);
          acc[1] = __dp4a(static_cast<int>(u1 >> 8), tb, acc[1]);
          acc[2] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 16)), ta,
                          acc[2]);
          acc[2] = __dp4a(static_cast<int>(u1 >> 16), tb, acc[2]);
          acc[3] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 24)), ta,
                          acc[3]);
          acc[3] = __dp4a(static_cast<int>(u1 >> 24), tb, acc[3]);
        } else {
          const uint32_t u2 = __funnelshift_r(w2, wp[3], sh) & mask[2];
          acc[0] = __dp4a(static_cast<int>(u0), ta, acc[0]);
          acc[0] = __dp4a(static_cast<int>(u1), tb, acc[0]);
          acc[1] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 16)), ta,
                          acc[1]);
          acc[1] = __dp4a(static_cast<int>(u1 >> 16), tb, acc[1]);
          acc[2] = __dp4a(static_cast<int>(u1), ta, acc[2]);
          acc[2] = __dp4a(static_cast<int>(u2), tb, acc[2]);
          acc[3] = __dp4a(static_cast<int>(__funnelshift_r(u1, u2, 16)), ta,
                          acc[3]);
          acc[3] = __dp4a(static_cast<int>(u2 >> 16), tb, acc[3]);
        }
        continue;
      }
      const int tap = row_ok ? static_cast<int>(wk[c * 3 + i]) : 0;
      if (S == 1) {
        acc[0] = __dp4a(static_cast<int>(u0), tap, acc[0]);
        acc[1] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 8)), tap,
                        acc[1]);
        acc[2] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 16)), tap,
                        acc[2]);
        acc[3] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 24)), tap,
                        acc[3]);
      } else {
        const uint32_t u2 = (w2 >> sh) & mask[2];  // byte 8 is in w2
        acc[0] = __dp4a(static_cast<int>(u0), tap, acc[0]);
        acc[1] = __dp4a(static_cast<int>(__funnelshift_r(u0, u1, 16)), tap,
                        acc[1]);
        acc[2] = __dp4a(static_cast<int>(u1), tap, acc[2]);
        acc[3] = __dp4a(static_cast<int>(__funnelshift_r(u1, u2, 16)), tap,
                        acc[3]);
      }
    }
    const float sc = ss[c];
    const int bq = bs[c];
    float y[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      float v;
      if (INT_BIAS) {
        // b_q added in exact int32; every float step a single rounded
        // multiply
        v = __fmul_rn(__int2float_rn(acc[u] + bq), sc);
      } else {
        v = __fadd_rn(__fmul_rn(__int2float_rn(acc[u]), sc),
                      __int_as_float(bq));
      }
      y[u] = activate<ACT>(v, p);
    }
    const long long o = static_cast<long long>(nb) * p.out_stride + dst +
                        (pos0 - start);
    const bool whole = q0 + VEC <= p.ow && pos0 >= start &&
                       pos0 + VEC <= stop && (o & 3) == 0;
    if (OUT_I8) {
      int8_t* out = static_cast<int8_t*>(p.out);
      uint32_t packed = 0;
      int8_t q8[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        // rounded half to even, as torch.round and jnp.round do, then
        // clipped (a float past the int range saturates, then clips too)
        const int v = __float2int_rn(__fmul_rn(y[u], p.inv_out_scale));
        q8[u] = static_cast<int8_t>(min(max(v, -127), 127));
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(q8[u])) << (8 * u);
      }
      if (whole) {
        *reinterpret_cast<uint32_t*>(out + o) = packed;
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          if (q0 + u < p.ow && pos0 + u >= start && pos0 + u < stop)
            out[o + u] = q8[u];
      }
    } else {
      float* out = static_cast<float*>(p.out);
      if (whole) {
        *reinterpret_cast<float4*>(out + o) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          if (q0 + u < p.ow && pos0 + u >= start && pos0 + u < stop)
            out[o + u] = y[u];
      }
    }
  }
}

template <int S, bool INT_BIAS, bool OUT_I8, int ACT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS_PER_SM)
    dwconv3x3_kernel(const __grid_constant__ Params p) {
  dwconv_tile<3, S, INT_BIAS, OUT_I8, ACT>(p);
}

template <int S, bool INT_BIAS, bool OUT_I8, int ACT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS_PER_SM / 2)
    dwconv5x5_kernel(const __grid_constant__ Params p) {
  dwconv_tile<5, S, INT_BIAS, OUT_I8, ACT>(p);
}

template <int K, int S, bool INT_BIAS, bool OUT_I8, int ACT>
cudaError_t launch(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  void (*kernel)(const Params);
  if constexpr (K == 3)
    kernel = dwconv3x3_kernel<S, INT_BIAS, OUT_I8, ACT>;
  else
    kernel = dwconv5x5_kernel<S, INT_BIAS, OUT_I8, ACT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int K, int S, int ACT>
cudaError_t dispatch_epilogue(const Params& p, int int_bias, int out_i8,
                              dim3 grid, int smem, cudaStream_t st) {
  if (int_bias && out_i8)
    return launch<K, S, true, true, ACT>(p, grid, smem, st);
  if (int_bias) return launch<K, S, true, false, ACT>(p, grid, smem, st);
  if (out_i8) return launch<K, S, false, true, ACT>(p, grid, smem, st);
  return launch<K, S, false, false, ACT>(p, grid, smem, st);
}

template <int K, int S>
cudaError_t dispatch(const Params& p, int int_bias, int out_i8, int act,
                     dim3 grid, int smem, cudaStream_t st) {
  if (act == kSwish)
    return dispatch_epilogue<K, S, kSwishForm>(p, int_bias, out_i8, grid,
                                               smem, st);
  if (act == kSigmoid)
    return dispatch_epilogue<K, S, kSigmoidForm>(p, int_bias, out_i8, grid,
                                                 smem, st);
  return dispatch_epilogue<K, S, kClamp>(p, int_bias, out_i8, grid, smem, st);
}

}  // namespace

// The shared memory a launch of a KxK kernel needs: PAD, c_tile slabs,
// PAD, then each channel's scale, bias and K rows of packed tap words.
extern "C" int dwconv_smem_bytes_k(int c_tile, int slab, int k) {
  return 2 * PAD + c_tile * (slab + 4 + 4 + 4 * k * (k == 3 ? 1 : 2));
}

extern "C" int dwconv_smem_bytes(int c_tile, int slab) {
  return dwconv_smem_bytes_k(c_tile, slab, 3);
}

// One launch of the KxK kernel (k 3 or 5).
extern "C" int dwconv_s8(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, const int* shards,
                         int n_shards, int NB, int C, int H, int W, int ph,
                         int pw, int k, int stride, int c_tile, int rows_tile,
                         int slab, int tiles, long long out_stride,
                         int int_bias, int out_i8, int act,
                         float inv_out_scale, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const int*>(bias);
  p.out = out;
  p.C = C;
  p.H = H;
  p.W = W;
  p.ph = ph;
  p.pw = pw;
  p.oh = (H + 2 * ph - k) / stride + 1;
  p.ow = (W + 2 * pw - k) / stride + 1;
  p.n_seg = (p.ow + VEC - 1) / VEC;
  p.plane16 = static_cast<int>((static_cast<long long>(H) * W) & 15);
  p.c_tile = c_tile;
  p.rows_tile = rows_tile;
  p.slab = slab;
  p.n_rt = (p.oh + rows_tile - 1) / rows_tile;
  p.by_seg.init(p.n_seg);
  p.by_rows.init(rows_tile);
  p.by_chunks.init(slab / 16);
  p.by_rt.init(p.n_rt);
  p.out_stride = out_stride;
  p.act_lo = act == kRelu || act == kRelu6 ? 0.f : -INFINITY;
  p.act_hi = act == kRelu6 ? 6.f : INFINITY;
  p.inv_out_scale = inv_out_scale;
  p.n_shards = shards == nullptr ? 0 : n_shards;
  if (p.n_shards > MAX_SHARDS || slab % 16 != 0 || NB > 65535 ||
      (k != 3 && k != 5))
    return cudaErrorInvalidValue;
  int n_tiles = p.n_shards == 0 ? (C + c_tile - 1) / c_tile * p.n_rt : 0;
  for (int z = 0; z < p.n_shards; ++z) {
    for (int k = 0; k < 5; ++k) p.shards[5 * z + k] = shards[5 * z + k];
    p.tile0[z] = n_tiles;
    n_tiles += (shards[5 * z + 1] - shards[5 * z] + c_tile - 1) / c_tile *
               p.n_rt;
  }
  p.tile0[p.n_shards] = n_tiles;
  if (n_tiles != tiles) return cudaErrorInvalidValue;
  const dim3 grid(tiles, NB);
  const int smem = dwconv_smem_bytes_k(c_tile, slab, k);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 3)
    err = stride == 1 ? dispatch<3, 1>(p, int_bias, out_i8, act, grid, smem, st)
                      : dispatch<3, 2>(p, int_bias, out_i8, act, grid, smem, st);
  else
    err = stride == 1 ? dispatch<5, 1>(p, int_bias, out_i8, act, grid, smem, st)
                      : dispatch<5, 2>(p, int_bias, out_i8, act, grid, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* dwconv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
