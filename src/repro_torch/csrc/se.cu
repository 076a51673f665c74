// int8 squeeze-and-excitation kernels of EfficientNet's MBConv blocks, for
// Hopper (sm_90a): the global pool over a stack of spatial bands, and the
// gate multiply.
//
// se_pool_kernel: x is a stack x[NB, C, R, W] of band windows, NB = batch *
// bands (bands = 1: whole samples, R = H).  Band b of sample s owns its
// first valid[b] bytes of each (window, channel) plane (its own output rows;
// the rows below them are the fill that equalizes band heights).  out[s, c]
// is clip(rint(f32(sum) * factor), -127, 127), the sum over every band's
// own rows of channel c in exact int32: each row is counted once, whatever
// the bands.  A CTA owns one sample and c_tile channels, walks the bands
// one after another, and reduces the bands' partial sums in shared memory.
//
// se_gate_kernel: out = clip(rint(f32(x * g) * factor), -127, 127) for
// every byte of x[NB, C, R, W], g[s, c] the gate code of the window's
// sample and channel: the int8 x int8 product in exact int32, then one
// float32 requantizing multiply (factor = s_x * s_g / s_out, rounded once
// on the host).
//
// What bounds them on the H100: a few operations per byte, so bytes.  Both
// read the stack as aligned 16-byte chunks; a chunk inside one plane (and,
// for the pool, inside its band's own rows) takes the fast path: one gate
// code, or one channel's sum of 16 bytes by four __dp4a.  A chunk across
// planes (small late-stage planes, and every plane's edges) goes byte by
// byte.  The divisions by the plane size, C and the bands are multiply-high
// by magic numbers set up on the host.  The pool keeps a thread's running
// sum in a register while its channel stays the same and adds it to the
// channel's shared-memory sum when the channel changes.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BANDS = 64;
constexpr int MAX_C_TILE = 2048;

// n / d for 0 <= n < 2^31 by multiply-high (as in dwconv.cu)
struct FastDiv {
  int d;
  unsigned m;
  int s;
  void init(int div) {
    d = div;
    int lg = 0;
    while ((1ll << lg) < div) ++lg;
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

__device__ __forceinline__ int8_t requant(int v, float factor) {
  // rounded half to even, as torch.round, then clipped
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(v), factor));
  return static_cast<int8_t>(min(max(q, -127), 127));
}

struct PoolParams {
  const int8_t* x;
  int8_t* out;
  int bands, C, c_tile, n_ct, plane;
  FastDiv by_plane;
  float factor;
  int valid[MAX_BANDS];  // bytes of a plane each band owns
};

__global__ void __launch_bounds__(THREADS)
    se_pool_kernel(const __grid_constant__ PoolParams p) {
  __shared__ int sums[MAX_C_TILE];
  const int s = blockIdx.x / p.n_ct;
  const int c0 = (blockIdx.x - s * p.n_ct) * p.c_tile;
  const int nc = min(p.c_tile, p.C - c0);
  for (int i = threadIdx.x; i < nc; i += THREADS) sums[i] = 0;
  __syncthreads();
  const int n = nc * p.plane;  // bytes of the CTA's channels in one window
  int cur = -1, acc = 0;
  auto add = [&](int c, int v) {
    if (c != cur) {
      if (cur >= 0) atomicAdd(&sums[cur], acc);
      cur = c;
      acc = 0;
    }
    acc += v;
  };
  for (int b = 0; b < p.bands; ++b) {
    const int8_t* base = p.x + (static_cast<long long>(s * p.bands + b) *
                                    p.C + c0) * static_cast<long long>(p.plane);
    const int valid = p.valid[b];
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(base) & 15);
    const int8_t* a0 = base - head;
    const int n_chunks = (head + n + 15) / 16;
    for (int k = threadIdx.x; k < n_chunks; k += THREADS) {
      const int off0 = k * 16 - head;
      const uint4 v = *reinterpret_cast<const uint4*>(a0 + k * 16);
      if (off0 >= 0 && off0 + 16 <= n) {
        const int c = p.by_plane(off0);
        if (off0 - c * p.plane + 16 <= valid) {
          int sum = __dp4a(static_cast<int>(v.x), 0x01010101, 0);
          sum = __dp4a(static_cast<int>(v.y), 0x01010101, sum);
          sum = __dp4a(static_cast<int>(v.z), 0x01010101, sum);
          sum = __dp4a(static_cast<int>(v.w), 0x01010101, sum);
          add(c, sum);
          continue;
        }
      }
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int off = off0 + u;
        if (off < 0 || off >= n) continue;
        const int c = p.by_plane(off);
        if (off - c * p.plane < valid)
          add(c, static_cast<int8_t>(words[u >> 2] >> (8 * (u & 3))));
      }
    }
  }
  if (cur >= 0) atomicAdd(&sums[cur], acc);
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += THREADS)
    p.out[s * p.C + c0 + i] = requant(sums[i], p.factor);
}

struct GateParams {
  const int8_t* x;
  const int8_t* g;
  int8_t* out;
  int n, C;
  FastDiv by_plane, by_c, by_bands;
  float factor;
};

// the gate code of plane p = (s * bands + b) * C + c
__device__ __forceinline__ int gate_of(const GateParams& p, int plane) {
  const int q = p.by_c(plane);
  const int c = plane - q * p.C;
  return p.g[p.by_bands(q) * p.C + c];
}

__global__ void __launch_bounds__(THREADS)
    se_gate_kernel(const __grid_constant__ GateParams p) {
  const int n_chunks = (p.n + 15) / 16;
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < n_chunks;
       k += gridDim.x * THREADS) {
    const int off0 = k * 16;
    if (off0 + 16 <= p.n) {
      const uint4 v = *reinterpret_cast<const uint4*>(p.x + off0);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      const int pl0 = p.by_plane(off0);
      const bool one = p.by_plane(off0 + 15) == pl0;
      const int g0 = gate_of(p, pl0);
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t packed = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gu = one ? g0 : gate_of(p, p.by_plane(off0 + 4 * j + u));
          const int xv = static_cast<int8_t>(in[j] >> (8 * u));
          packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                        requant(xv * gu, p.factor)))
                    << (8 * u);
        }
        o[j] = packed;
      }
      *reinterpret_cast<uint4*>(p.out + off0) = make_uint4(o[0], o[1], o[2],
                                                           o[3]);
    } else {
      for (int off = off0; off < p.n; ++off)
        p.out[off] = requant(p.x[off] * gate_of(p, p.by_plane(off)), p.factor);
    }
  }
}

}  // namespace

// x: (bsz * bands, C, R, W) int8; out (bsz, C) int8; valid[b]: the bytes
// of a plane (R * W) band b owns.  A CTA takes c_tile channels of one
// sample: bsz * ceil(C / c_tile) CTAs.
extern "C" int se_pool_s8(const void* x, void* out, const int* valid,
                          int bsz, int bands, int C, int plane, int c_tile,
                          float factor, void* stream) {
  PoolParams p;
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.bands = bands;
  p.C = C;
  p.c_tile = c_tile;
  p.n_ct = (C + c_tile - 1) / c_tile;
  p.plane = plane;
  p.by_plane.init(plane);
  p.factor = factor;
  if (bands < 1 || bands > MAX_BANDS || c_tile < 1 || c_tile > MAX_C_TILE ||
      plane < 1 || static_cast<long long>(c_tile) * plane >= (1ll << 31))
    return cudaErrorInvalidValue;
  for (int b = 0; b < bands; ++b) p.valid[b] = valid[b];
  se_pool_kernel<<<bsz * p.n_ct, THREADS, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n bytes of (bsz * bands, C, plane) int8, 16-byte aligned; g:
// (bsz, C) int8.
extern "C" int se_gate_s8(const void* x, const void* g, void* out, int n,
                          int plane, int C, int bands, float factor, int grid,
                          void* stream) {
  GateParams p;
  p.x = static_cast<const int8_t*>(x);
  p.g = static_cast<const int8_t*>(g);
  p.out = static_cast<int8_t*>(out);
  p.n = n;
  p.C = C;
  p.by_plane.init(plane);
  p.by_c.init(C);
  p.by_bands.init(bands);
  p.factor = factor;
  if (n < 1 || plane < 1 || C < 1 || bands < 1 || grid < 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  se_gate_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* se_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
