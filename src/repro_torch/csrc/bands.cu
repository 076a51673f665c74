// Band staging of the port's spatial split, for Hopper (sm_90a): the one
// pass at each stage boundary of a fused spatial block that writes the
// window stack the stage's compute kernel reads, and the one pass at the
// block's exit that writes its output rows.
//
// Replaces no TPU kernel: the reference gathers its band windows with XLA
// ops inside its jitted block.  On the card those were PyTorch's gather,
// where, copy and index_select kernels, several passes a stage, an int64
// index read for every int8 moved.
//
// Both kernels copy rows of images by a row map and may change the layout
// on the way.  An output image n = s * nbo + b (sample s, band b) has R rows
// of Wo columns (W source columns and pw zero columns on each side) and C
// channels; map[b * R + t] says where its row t comes from: -1 a row of
// zeros, else q = i * Hs + r, row r of image s * nbs + b * band_step + i of
// the source (Hs rows of W columns, C channels).
//
//   band_windows_kernel: the stage's windows.  The source is the block's
//     input (nbs 1, band_step 0, rows global), or the previous stage's stack
//     (nbs = bands, band_step 1, rows band-local); map is the stage's row
//     table.  The output is NCHW (depthwise and kxk stages, pw zero columns
//     written in) or NHWC ((N * R * W, C): a 1x1 conv's GEMM operand).
//   band_take_kernel: the block's output (nbo 1, R = H_out rows) from its
//     last stack (nbs = bands, map = each output row's band * r + row),
//     NCHW; with a residual, the int8 add of the stashed activation as its
//     epilogue: clip(x + rint(f32(res) * ratio), -127, 127), the one float
//     multiply rounded once, as the executor's _residual_add_int8.
//
// Sources are NCHW (the block's input, depthwise and gate stacks) or NHWC
// (a qgemm output).  Elements are 1 byte (int8) or 4 (float32).
//
// What bounds them on the H100: bytes, a read and a write of each element.
// A CTA takes one output image, TILE_P consecutive positions (row, column)
// of it and 64 bytes of channels, and goes through a tile in shared memory:
// the read runs along the source's contiguous axis (columns of an NCHW row,
// channels of an NHWC position), the write along the output's, so both are
// coalesced whatever the layouts.  The NHWC side moves VB bytes a thread (16,
// 8 or 4, as the channel bytes and the pointers allow; else 1).  The NCHW
// side of int8 moves a 4 x 4 block a thread where rows and planes allow
// (4 positions of one row x 4 channels: a word a channel, transposed by
// byte permutes into a word a position), else one element a thread and
// channel.  Each position's source offset is looked up once a tile.  The
// tile's pitch is 68 bytes (17 words): a column of it falls in 32 banks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_P = 64;        // positions of a tile
constexpr int TILE_B = 64;        // channel bytes of a tile
constexpr int PITCH = TILE_B + 4;  // bytes of a position's tile row

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

struct Params {
  const unsigned char* src;
  unsigned char* out;
  const int* map;
  const int8_t* res;  // residual in the output's layout, or null
  float ratio;
  int nbo, R, Wo, pw;            // output
  int nbs, band_step, Hs, W, C;  // source
  int pos_tiles;                 // ceil(R * Wo / TILE_P)
  FastDiv by_wo, by_hs, by_nbo, by_tiles;
};

// VB bytes at g (VB-aligned) as words (VB 1: one byte in the low bits)
template <int VB>
__device__ __forceinline__ void load_vec(const unsigned char* g,
                                         uint32_t (&w)[(VB + 3) / 4]) {
  if constexpr (VB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(g);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(g);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(g);
  } else {
    w[0] = *g;
  }
}

template <int VB>
__device__ __forceinline__ void store_vec(unsigned char* g,
                                          const uint32_t (&w)[(VB + 3) / 4]) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(g) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(g) = make_uint2(w[0], w[1]);
  } else if constexpr (VB == 4) {
    *reinterpret_cast<uint32_t*>(g) = w[0];
  } else {
    *g = static_cast<unsigned char>(w[0]);
  }
}

// tile bytes are 4-aligned at a position's row and at every VB >= 4 chunk
template <int VB>
__device__ __forceinline__ void tile_store(unsigned char* t,
                                           const uint32_t (&w)[(VB + 3) / 4]) {
  if constexpr (VB >= 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) reinterpret_cast<uint32_t*>(t)[i] = w[i];
  } else {
    *t = static_cast<unsigned char>(w[0]);
  }
}

template <int VB>
__device__ __forceinline__ void tile_load(const unsigned char* t,
                                          uint32_t (&w)[(VB + 3) / 4]) {
  if constexpr (VB >= 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i)
      w[i] = reinterpret_cast<const uint32_t*>(t)[i];
  } else {
    w[0] = *t;
  }
}

// a 4 x 4 block of bytes transposed: w[i] byte j -> w[j] byte i
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// the residual epilogue of one int8 code: rint(f32(r) * ratio) added in
// int32, clipped (rounded half to even, as torch.round)
__device__ __forceinline__ int add_residual(int v, int r, float ratio) {
  const int a = __float2int_rn(__fmul_rn(static_cast<float>(r), ratio));
  return min(max(v + a, -127), 127);
}

// four codes packed in a word, each plus its residual code in res
__device__ __forceinline__ uint32_t add_residual4(uint32_t v, uint32_t res,
                                                  float ratio) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = static_cast<int8_t>(v >> (8 * k));
    const int r = static_cast<int8_t>(res >> (8 * k));
    out |= static_cast<uint32_t>(static_cast<uint8_t>(
               add_residual(x, r, ratio)))
           << (8 * k);
  }
  return out;
}

template <typename T, bool SRC_NHWC, bool OUT_NHWC, int VB>
__device__ __forceinline__ void copy_tile(const Params& p) {
  constexpr int ES = sizeof(T);
  constexpr int TC = TILE_B / ES;  // channels of a tile
  constexpr int V = VB / ES;       // elements of a vector access
  constexpr int QUADS = TILE_P / 4;
  static_assert(THREADS % TILE_P == 0 && THREADS == QUADS * (TILE_B / 4),
                "a thread keeps one position, or one 4 x 4 byte block");
  __shared__ long long pos_src[TILE_P];
  __shared__ __align__(16) unsigned char tile[TILE_P * PITCH];

  const int n = p.by_tiles(blockIdx.x);
  const int p0 = (blockIdx.x - n * p.pos_tiles) * TILE_P;
  const int s = p.by_nbo(n);
  const int b = n - s * p.nbo;
  const int c0 = blockIdx.y * TC;
  const int nc = min(TC, p.C - c0);
  const int plane = p.R * p.Wo;
  const int np = min(TILE_P, plane - p0);

  // the source offset of each position of the tile at channel 0, -1 for a
  // zero (a masked row or a pad column)
  if (threadIdx.x < TILE_P) {
    const int pl = threadIdx.x;
    long long off = -1;
    if (pl < np) {
      const int pos = p0 + pl;
      const int t = p.by_wo(pos);
      const int col = pos - t * p.Wo - p.pw;
      const int q = p.map[b * p.R + t];
      if (q >= 0 && col >= 0 && col < p.W) {
        const int k = p.by_hs(q);
        const long long img = static_cast<long long>(s) * p.nbs +
                              static_cast<long long>(b) * p.band_step + k;
        const long long row = q - k * p.Hs;
        off = SRC_NHWC ? ((img * p.Hs + row) * p.W + col) * p.C
                       : (img * p.C * p.Hs + row) * p.W + col;
      }
    }
    pos_src[pl] = off;
  }
  __syncthreads();

  // read: along the source's contiguous axis
  if constexpr (SRC_NHWC) {
    const int kc = nc / V;  // vectors of a position
    for (int e = threadIdx.x; e < np * kc; e += THREADS) {
      const int pl = e / kc;
      const int k = e - pl * kc;
      uint32_t w[(VB + 3) / 4] = {};
      const long long o = pos_src[pl];
      if (o >= 0) load_vec<VB>(p.src + (o + c0 + k * V) * ES, w);
      tile_store<VB>(tile + pl * PITCH + k * VB, w);
    }
  } else {
    const long long cs = static_cast<long long>(p.Hs) * p.W;  // channel
    bool quads = false;
    if constexpr (ES == 1)
      quads = p.W % 4 == 0 && p.pw % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(p.src) & 3) == 0;
    if (quads) {
      // 4 positions (one row, all valid or all zero) x 4 channels a
      // thread: a word a channel, transposed into a word a position
      const int pl = (threadIdx.x % QUADS) * 4;
      const int cl = (threadIdx.x / QUADS) * 4;
      if (pl < np && cl < nc) {
        const long long o = pos_src[pl];
        uint32_t w[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o >= 0 && cl + i < nc)
            w[i] = *reinterpret_cast<const uint32_t*>(p.src + o +
                                                      (c0 + cl + i) * cs);
        transpose4(w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(tile + (pl + j) * PITCH + cl) = w[j];
      }
    } else {
      // one element a thread and channel; a thread keeps its position
      const int pl = threadIdx.x % TILE_P;
      const long long o = pos_src[pl];
      if (pl < np) {
        for (int cl = threadIdx.x / TILE_P; cl < nc;
             cl += THREADS / TILE_P) {
          T v = T(0);
          if (o >= 0) v = reinterpret_cast<const T*>(p.src)[o + (c0 + cl) * cs];
          *reinterpret_cast<T*>(tile + pl * PITCH + cl * ES) = v;
        }
      }
    }
  }
  __syncthreads();

  // write: along the output's contiguous axis
  if constexpr (OUT_NHWC) {
    const int kc = nc / V;
    for (int e = threadIdx.x; e < np * kc; e += THREADS) {
      const int pl = e / kc;
      const int k = e - pl * kc;
      uint32_t w[(VB + 3) / 4];
      tile_load<VB>(tile + pl * PITCH + k * VB, w);
      const long long o =
          (static_cast<long long>(n) * plane + p0 + pl) * p.C + c0 + k * V;
      store_vec<VB>(p.out + o * ES, w);
    }
  } else {
    const long long first =
        (static_cast<long long>(n) * p.C + c0) * plane + p0;
    bool quads = false;
    if constexpr (ES == 1)
      quads = plane % 4 == 0 &&
              ((reinterpret_cast<uintptr_t>(p.out) |
                reinterpret_cast<uintptr_t>(p.res)) & 3) == 0;
    if (quads) {
      const int pl = (threadIdx.x % QUADS) * 4;
      const int cl = (threadIdx.x / QUADS) * 4;
      if (pl < np && cl < nc) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const uint32_t*>(tile + (pl + j) * PITCH +
                                                    cl);
        transpose4(w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cl + i >= nc) break;
          const long long o = first + static_cast<long long>(cl + i) * plane +
                              pl;
          uint32_t v = w[i];
          if (p.res != nullptr)
            v = add_residual4(
                v, *reinterpret_cast<const uint32_t*>(p.res + o), p.ratio);
          *reinterpret_cast<uint32_t*>(p.out + o) = v;
        }
      }
    } else {
      const int pl = threadIdx.x % TILE_P;
      if (pl < np) {
        for (int cl = threadIdx.x / TILE_P; cl < nc;
             cl += THREADS / TILE_P) {
          T v = *reinterpret_cast<const T*>(tile + pl * PITCH + cl * ES);
          const long long o = first + static_cast<long long>(cl) * plane + pl;
          if constexpr (ES == 1) {
            if (p.res != nullptr)
              v = static_cast<T>(add_residual(v, p.res[o], p.ratio));
          }
          reinterpret_cast<T*>(p.out)[o] = v;
        }
      }
    }
  }
}

template <typename T, bool SRC_NHWC, bool OUT_NHWC, int VB>
__global__ void __launch_bounds__(THREADS)
    band_windows_kernel(const __grid_constant__ Params p) {
  copy_tile<T, SRC_NHWC, OUT_NHWC, VB>(p);
}

template <typename T, bool SRC_NHWC, int VB>
__global__ void __launch_bounds__(THREADS)
    band_take_kernel(const __grid_constant__ Params p) {
  copy_tile<T, SRC_NHWC, false, VB>(p);
}

template <typename T, bool TAKE, bool SN, bool ON, int VB>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  if constexpr (TAKE)
    band_take_kernel<T, SN, VB><<<grid, THREADS, 0, stream>>>(p);
  else
    band_windows_kernel<T, SN, ON, VB><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TAKE, bool SN, bool ON>
int by_vec(int vb, const Params& p, dim3 grid, cudaStream_t stream) {
  if constexpr (!SN && !ON) {
    // both sides one element at a time
    return launch<T, TAKE, false, false, 4>(p, grid, stream);
  } else {
    switch (vb) {
      case 16:
        return launch<T, TAKE, SN, ON, 16>(p, grid, stream);
      case 8:
        return launch<T, TAKE, SN, ON, 8>(p, grid, stream);
      case 4:
        return launch<T, TAKE, SN, ON, 4>(p, grid, stream);
      case 1:
        if constexpr (sizeof(T) == 1)
          return launch<T, TAKE, SN, ON, 1>(p, grid, stream);
        break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool TAKE>
int by_layout(int src_nhwc, int out_nhwc, int vb, const Params& p, dim3 grid,
              cudaStream_t stream) {
  if constexpr (TAKE) {
    // the take writes NCHW
    return src_nhwc ? by_vec<T, true, true, false>(vb, p, grid, stream)
                    : by_vec<T, true, false, false>(vb, p, grid, stream);
  } else {
    if (src_nhwc)
      return out_nhwc ? by_vec<T, false, true, true>(vb, p, grid, stream)
                      : by_vec<T, false, true, false>(vb, p, grid, stream);
    return out_nhwc ? by_vec<T, false, false, true>(vb, p, grid, stream)
                    : by_vec<T, false, false, false>(vb, p, grid, stream);
  }
}

}  // namespace

// One staging pass (take 0: band_windows_kernel, 1: band_take_kernel) of
// elem_bytes-byte elements (1 or 4).  src: nbs images a sample of (C, Hs, W)
// (NCHW) or (Hs, W, C) (NHWC); out: n_out = bsz * nbo images of (C, R, Wo)
// or (R, Wo, C); map: (nbo, R) int32, -1 or image * Hs + row; res: the
// take's int8 residual (the output's shape) or null.  vb: the bytes an NHWC
// side moves at a time (16, 8, 4, or 1 for int8), dividing C * elem_bytes,
// the NHWC pointers aligned to it.
extern "C" int bands_copy(int take, int elem_bytes, const void* src,
                          void* out, const int* map, const void* res,
                          float ratio, int n_out, int nbo, int R, int Wo,
                          int pw, int nbs, int band_step, int Hs, int W, int C,
                          int src_nhwc, int out_nhwc, int vb, void* stream) {
  Params p;
  p.src = static_cast<const unsigned char*>(src);
  p.out = static_cast<unsigned char*>(out);
  p.map = map;
  p.res = static_cast<const int8_t*>(res);
  p.ratio = ratio;
  p.nbo = nbo;
  p.R = R;
  p.Wo = Wo;
  p.pw = pw;
  p.nbs = nbs;
  p.band_step = band_step;
  p.Hs = Hs;
  p.W = W;
  p.C = C;
  const long long plane = static_cast<long long>(R) * Wo;
  const int tc = 64 / (elem_bytes > 0 ? elem_bytes : 1);
  if ((elem_bytes != 1 && elem_bytes != 4) || n_out < 1 || nbo < 1 ||
      n_out % nbo || R < 1 || W < 1 || pw < 0 || Wo != W + 2 * pw ||
      nbs < 1 || Hs < 1 || C < 1 || plane >= (1ll << 31) ||
      static_cast<long long>(nbs) * Hs >= (1ll << 31) ||
      (out_nhwc && pw) || (res && (!take || elem_bytes != 1 || out_nhwc)) ||
      (take && out_nhwc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (src_nhwc || out_nhwc) {
    const uintptr_t a = (src_nhwc ? reinterpret_cast<uintptr_t>(src) : 0) |
                        (out_nhwc ? reinterpret_cast<uintptr_t>(out) : 0);
    if ((vb != 16 && vb != 8 && vb != 4 && vb != 1) || vb < elem_bytes ||
        (C * elem_bytes) % vb || (a % vb))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.pos_tiles = static_cast<int>((plane + TILE_P - 1) / TILE_P);
  const long long ctas = static_cast<long long>(p.pos_tiles) * n_out;
  const int c_tiles = (C + tc - 1) / tc;
  if (ctas >= (1ll << 31) || c_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.by_wo.init(Wo);
  p.by_hs.init(Hs);
  p.by_nbo.init(nbo);
  p.by_tiles.init(p.pos_tiles);
  const dim3 grid(static_cast<unsigned>(ctas), c_tiles);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return take ? by_layout<int8_t, true>(src_nhwc, 0, vb, p, grid, st)
                : by_layout<int8_t, false>(src_nhwc, out_nhwc, vb, p, grid,
                                           st);
  return take ? by_layout<float, true>(src_nhwc, 0, vb, p, grid, st)
              : by_layout<float, false>(src_nhwc, out_nhwc, vb, p, grid, st);
}

extern "C" const char* bands_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
