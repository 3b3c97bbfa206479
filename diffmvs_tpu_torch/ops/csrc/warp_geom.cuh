// Shared by the warp kernels: plane-sweep coordinates, bilinear corners,
// fractions and zero-padding validity, the channel loads, and the
// block-tiled warp + group correlation forward that K1 (warp_corr.cu) and
// K3 (warp_corr_pre.cu) both instantiate.
//
// The forward (warp_corr.cu) and the backward (warp_corr_bwd.cu) both call
// locate() on the same inputs, so the backward samples at bit for bit the
// coordinates the forward sampled at (a 1-ulp change in a coordinate moves
// a correlation by up to ~4e-5 at the model's feature scales). K3's operand
// kernel (warp_corr_pre.cu) splits the same sweep_xy() coordinates.
//
// All three compute each (plane, pixel) sample once per block and keep it
// in shared memory as a SampleRec (pack / unpack), which the threads that
// share a pixel read back.
//
// Rounding: explicit round-to-nearest intrinsics in the plain path's
// operation order (geometry/warp.py); the coordinates' last step is the one
// fused multiply-add that plane_sweep_coords and the JAX reference take.
// Do not build with --use_fast_math (approximate division, flushed
// denormals).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_geom {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bf16 in 8 bytes; a bf16 is the high half of its f32
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// top = v00 + (v01 - v00) * wx; bot likewise; top + (bot - top) * wy
__device__ __forceinline__ float bilerp(float v00, float v01, float v10,
                                        float v11, float wx, float wy) {
  const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), wx));
  const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), wx));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy));
}

// fma(m0 * x + m1 * y + m2, dep, t): the sum rounds after each
// operation, the last step is one fused multiply-add
__device__ __forceinline__ float project(const float* m, float t, float xg,
                                         float yg, float dep) {
  const float lin =
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], xg), __fmul_rn(m[1], yg)), m[2]);
  return __fmaf_rn(lin, dep, t);
}

// m: the 12 projection scalars of one sample (rot row-major, then trans);
// (xg, yg): the ref pixel; dep: its hypothesis depth. The source
// coordinates (px / pz, py / pz), pz == 0 taken as 1e-8.
__device__ __forceinline__ float2 sweep_xy(const float* m, float xg, float yg,
                                           float dep) {
  const float px = project(m + 0, m[9], xg, yg, dep);
  const float py = project(m + 3, m[10], xg, yg, dep);
  float pz = project(m + 6, m[11], xg, yg, dep);
  if (pz == 0.0f) pz = 1e-8f;
  return make_float2(__fdiv_rn(px, pz), __fdiv_rn(py, pz));
}

// some corner of the sample whose first corner is (x0f, y0f) = the floors
// of its coordinates lies in the image: x0 in [-1, Ws-1], y0 in [-1, Hs-1]
// (false for NaN and +-inf, so validity is decided before any integer
// conversion)
__device__ __forceinline__ bool in_reach(float x0f, float y0f, int Hs,
                                         int Ws) {
  return x0f >= -1.0f && x0f <= static_cast<float>(Ws - 1) &&
         y0f >= -1.0f && y0f <= static_cast<float>(Hs - 1);
}

// Where one (plane, ref pixel) sample lands in the source image.
struct Sample {
  bool inside;                 // some corner lies in the image
  float wx, wy;                // bilinear fractions
  bool v00, v01, v10, v11;     // corner validity (zero padding, corner-wise)
  int i00, i01, i10, i11;      // corner pixel indices y * Ws + x, clamped
                               // into the image: read only when valid
};

// The sample of the ref pixel (xg, yg) at depth dep; m as for sweep_xy.
// (int)floorf() is only evaluated on in-range values.
__device__ __forceinline__ Sample locate(const float* m, float xg, float yg,
                                         float dep, int Hs, int Ws) {
  Sample s;
  const float2 sxy = sweep_xy(m, xg, yg, dep);
  const float x0f = floorf(sxy.x);
  const float y0f = floorf(sxy.y);
  s.inside = in_reach(x0f, y0f, Hs, Ws);
  if (!s.inside) {
    s.wx = s.wy = 0.0f;
    s.v00 = s.v01 = s.v10 = s.v11 = false;
    s.i00 = s.i01 = s.i10 = s.i11 = 0;
    return s;
  }
  s.wx = __fsub_rn(sxy.x, x0f);
  s.wy = __fsub_rn(sxy.y, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Ws - 1;
  const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Hs - 1;
  s.v00 = vy0 && vx0;
  s.v01 = vy0 && vx1;
  s.v10 = vy1 && vx0;
  s.v11 = vy1 && vx1;
  const int xa = max(x0, 0), xb = min(x0 + 1, Ws - 1);
  const int ya = max(y0, 0), yb = min(y0 + 1, Hs - 1);
  s.i00 = ya * Ws + xa;
  s.i01 = ya * Ws + xb;
  s.i10 = yb * Ws + xa;
  s.i11 = yb * Ws + xb;
  return s;
}

// A Sample in 16 bytes, for a block that computes each (plane, pixel)
// sample once into shared memory and reads it from several threads: the
// fractions, the first corner (xa, ya) and, in yf's top 7 bits, inside,
// the four validities and the steps to the second column and row (0 or 1).
struct SampleRec {
  float wx, wy;
  int xa;
  unsigned yf;                 // ya | flags << 25
};

constexpr unsigned kRecInside = 1u, kRecV00 = 2u, kRecV01 = 4u,
                   kRecV10 = 8u, kRecV11 = 16u, kRecDx = 32u, kRecDy = 64u;

__device__ __forceinline__ SampleRec pack(const Sample& s, int Ws) {
  SampleRec r;
  r.wx = s.wx;
  r.wy = s.wy;
  if (!s.inside) {
    r.xa = 0;
    r.yf = 0;
    return r;
  }
  const int ya = s.i00 / Ws;
  r.xa = s.i00 - ya * Ws;
  const unsigned f = kRecInside | (s.v00 ? kRecV00 : 0u) |
                     (s.v01 ? kRecV01 : 0u) | (s.v10 ? kRecV10 : 0u) |
                     (s.v11 ? kRecV11 : 0u) |
                     (s.i01 != s.i00 ? kRecDx : 0u) |
                     (s.i10 != s.i00 ? kRecDy : 0u);
  r.yf = static_cast<unsigned>(ya) | f << 25;
  return r;
}

__device__ __forceinline__ unsigned rec_flags(const SampleRec& r) {
  return r.yf >> 25;
}

__device__ __forceinline__ int rec_ya(const SampleRec& r) {
  return static_cast<int>(r.yf & 0x1ffffffu);
}

// the Sample that pack() was given
__device__ __forceinline__ Sample unpack(const SampleRec& r, int Ws) {
  Sample s;
  const unsigned f = rec_flags(r);
  s.inside = f & kRecInside;
  s.wx = r.wx;
  s.wy = r.wy;
  s.v00 = f & kRecV00;
  s.v01 = f & kRecV01;
  s.v10 = f & kRecV10;
  s.v11 = f & kRecV11;
  const int dx = (f & kRecDx) ? 1 : 0;
  s.i00 = rec_ya(r) * Ws + r.xa;
  s.i01 = s.i00 + dx;
  s.i10 = s.i00 + ((f & kRecDy) ? Ws : 0);
  s.i11 = s.i10 + dx;
  return s;
}

// ---------------------------------------------------------------------------
// Channel loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// K consecutive channels from p into f[0..K): f32 as float4 (K % 4 == 0)
// or scalars; bf16 as a uint4 (K = 8), uint2 (4), uint32 (2) or scalar
template <int K>
__device__ __forceinline__ void load_k(const float* p, float* f) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) f[i] = p[i];
  }
}

template <int K>
__device__ __forceinline__ void load_k(const __nv_bfloat16* p, float* f) {
  if constexpr (K == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    f[0] = bf_lo(u.x);
    f[1] = bf_hi(u.x);
    f[2] = bf_lo(u.y);
    f[3] = bf_hi(u.y);
    f[4] = bf_lo(u.z);
    f[5] = bf_hi(u.z);
    f[6] = bf_lo(u.w);
    f[7] = bf_hi(u.w);
  } else if constexpr (K == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    f[0] = bf_lo(u.x);
    f[1] = bf_hi(u.x);
    f[2] = bf_lo(u.y);
    f[3] = bf_hi(u.y);
  } else if constexpr (K == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    f[0] = bf_lo(u);
    f[1] = bf_hi(u);
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int K, typename T>
__device__ __forceinline__ void load_or_zero(bool valid, const T* p,
                                             float* f) {
  if (valid) {
    load_k<K>(p, f);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) f[i] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The warp + group correlation forward of K1 and K3
// ---------------------------------------------------------------------------
//
//   out[n, g, d, y, x] = mean over the C/G channels c of group g of
//                        w[c] * ref[n, y, x, c],
//   w[c] the bilinear sample of src[n, :, :, c] at the (plane d, pixel
//   (y, x)) sample, each corner outside the image reading zero, and zero
//   where no corner is inside.
//
// src [N, Hs, Ws, C] and ref [N, H, W, C] channels-last (f32, or bf16
// upcast on load), out [N, G, D, H, W] f32. Where the samples come from
// and how they are interpolated is the kernel's Op:
//   Op::Block block(int n, int d0, int D, int hw) const
//       -- what a block reads its samples from: sample n, planes d0 on,
//          set up once per block (pointers, scalars in registers);
//   SampleRec Op::Block::rec(int dd, int x, int y, int W, int Hs,
//                            int Ws) const
//       -- the sample of plane d0 + dd at ref pixel (x, y), packed;
//   static float Op::lerp(float v00, float v01, float v10, float v11,
//                         float wx, float wy)
//       -- the value from the four corners (v01: row y0, column x1);
//   static constexpr int Op::kBf16Groups4
//       -- adjacent groups a thread owns for bf16 features at C/G = 4
//          (2 or 4: one or two 16-byte loads a corner).
// K1's Op computes the sample from depth and the 12 projection scalars and
// interpolates x first; K3's reads precomputed corners, fractions and
// validity and interpolates y first (the TPU kernel's order).
//
// Design (measured on K1 against one thread per (plane, pixel)):
//   * a block owns a 2-D tile of ref pixels and a chunk of planes; G / GPT
//     neighbouring threads share a pixel, GPT channel groups each (GPT =
//     2 where a group has at most 4 channels, else 1; a G above 256 is
//     taken in launches of 256 / GPT threads per pixel). The threads of a
//     pixel read each corner's channel row together, in one contiguous
//     run (16-byte loads: float4, or 8 bf16 as a uint4; 8- and 4-byte
//     bf16 loads and scalar loads where C/G or the bases do not allow
//     them), so a warp touches 8 rows per load, not 32. bf16 at C/G = 4
//     or 12: a thread owns Op::kBf16Groups4 (2 or 4) or two adjacent
//     groups, so its uint4 loads run across them instead of narrower loads
//     per group;
//   * each thread holds its groups' ref channels in registers for all the
//     block's planes (16 channels; a wider group is taken 16 channels at a
//     time, still exact) and loops over the planes: ref is read once per
//     chunk, not once per plane;
//   * each (plane, pixel) sample is made once per block, by all threads
//     side by side with coalesced loads, into shared memory (a 16-byte
//     SampleRec), which the threads of a pixel read back;
//   * outputs are staged in shared memory as [G][planes][tile] and
//     written out as contiguous tile rows;
//   * the planes are split over blocks (grid.y) when the tiles alone would
//     leave the card's SMs short of blocks (N = 1 at the sweep).
// The whole source image is read in place: no window, no miss guard, no
// fallback. Each group sums its channels in channel order, in f32; the
// mean multiplies by 1 / (C/G).

constexpr int kBlock = 256;      // threads per block at most: P x G / GPT
constexpr int kMaxCh = 16;       // ref channels a thread holds in registers
constexpr int kMaxPlanes = 16;   // planes per block (samples and sums
                                 // staged in shared memory)
constexpr size_t kSmemBytes = 48 * 1024;
constexpr int kTargetBlocks = 132 * 12;   // ~12 blocks per SM of an H100

// One block: a tile of P = 1 << p_log2 ref pixels, tw = 1 << tw_log2
// wide, of sample blockIdx.z, planes [blockIdx.y * dch, + dch), groups
// [g_off, g_off + gs) of the G. L = gs / GPT threads share a pixel: thread
// = pixel * L + l, owning the GPT groups g_off + l, + L, ... K channels per
// load; K divides C / G. PCG > 0 (bf16, C / G = PCG, GPT * PCG a multiple
// of 8): thread l owns the adjacent groups g_off + GPT l, + 1, ... instead.
template <class Op, typename T, int K, int GPT, int PCG>
__global__ void __launch_bounds__(kBlock)
corr_kernel(const T* __restrict__ src, const T* __restrict__ ref, const Op op,
            float* __restrict__ out, int D, int H, int W, int Hs, int Ws,
            int C, int G, int g_off, int gs, int p_log2, int tw_log2,
            int tiles_x, int dch) {
  constexpr int kCh = kMaxCh / GPT;       // channels of a group in registers
  // shared: the block's samples [dch][P], then its sums [gs][dch][P]
  extern __shared__ float4 smem[];
  SampleRec* recs = reinterpret_cast<SampleRec*>(smem);
  const int P = 1 << p_log2;
  const int tw = 1 << tw_log2;
  float* stage = reinterpret_cast<float*>(recs + dch * P);
  const int tid = threadIdx.x;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * (P >> tw_log2);
  const int n = blockIdx.z;
  const int d0 = blockIdx.y * dch;
  const int nd = min(dch, D - d0);
  const int hw = H * W;
  const int cg = C / G;
  const float inv_cg = 1.0f / static_cast<float>(cg);

  // every (plane, pixel) sample of the block, once
  const typename Op::Block samples = op.block(n, d0, D, hw);
  for (int j = tid; j < nd * P; j += blockDim.x) {
    const int p = j & (P - 1);
    const int x = x0 + (p & (tw - 1));
    const int y = y0 + (p >> tw_log2);
    recs[j] = (x < W && y < H) ? samples.rec(j >> p_log2, x, y, W, Hs, Ws)
                               : SampleRec{0.0f, 0.0f, 0, 0u};
  }
  __syncthreads();

  const int L = gs / GPT;
  const int pl = tid / L;                 // pixel of the tile
  const int l = tid - pl * L;
  const int xi = x0 + (pl & (tw - 1));
  const int yi = y0 + (pl >> tw_log2);
  const bool in_image = xi < W && yi < H;
  if constexpr (PCG > 0) {
    // bf16 at C/G = PCG: the thread's GPT groups, g_off + GPT l on, are
    // adjacent, so its 16-byte loads of 8 channels run across them
    constexpr int kRun = GPT * PCG;
    static_assert(kRun % 8 == 0, "runs of whole 16-byte loads");
    if (in_image) {
      const T* s_img = src + static_cast<size_t>(n) * Hs * Ws * C;
      const int c0 = (g_off + GPT * l) * PCG;
      const T* r_p =
          ref + (static_cast<size_t>(n) * hw + yi * W + xi) * C + c0;
      float r[kRun];
#pragma unroll
      for (int j = 0; j < kRun; j += 8) load_k<8>(r_p + j, r + j);
      for (int dd = 0; dd < nd; ++dd) {
        const Sample s = unpack(recs[dd * P + pl], Ws);
        float acc[GPT];
#pragma unroll
        for (int i = 0; i < GPT; ++i) acc[i] = 0.0f;
        if (s.inside) {
          const T* p00 = s_img + static_cast<size_t>(s.i00) * C + c0;
          const T* p01 = s_img + static_cast<size_t>(s.i01) * C + c0;
          const T* p10 = s_img + static_cast<size_t>(s.i10) * C + c0;
          const T* p11 = s_img + static_cast<size_t>(s.i11) * C + c0;
#pragma unroll
          for (int j = 0; j < kRun; j += 8) {
            float a[8], b[8], e[8], f[8];
            load_or_zero<8>(s.v00, p00 + j, a);
            load_or_zero<8>(s.v01, p01 + j, b);
            load_or_zero<8>(s.v10, p10 + j, e);
            load_or_zero<8>(s.v11, p11 + j, f);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc[(j + k) / PCG] +=
                  Op::lerp(a[k], b[k], e[k], f[k], s.wx, s.wy) * r[j + k];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          stage[(static_cast<size_t>(GPT * l + i) * dch + dd) * P + pl] =
              acc[i];
        }
      }
    }
  } else if (in_image) {
    const T* s_img = src + static_cast<size_t>(n) * Hs * Ws * C;
    const T* r_p = ref + (static_cast<size_t>(n) * hw + yi * W + xi) * C;

    // a group wider than kCh is taken kCh channels at a time; the slices'
    // partial sums meet in the staging buffer
    for (int cs = 0; cs < cg; cs += kCh) {
      const int len = min(kCh, cg - cs);
      float r[GPT][kCh];
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
#pragma unroll
        for (int j = 0; j < kCh; j += K) {
          if (j < len) {
            load_k<K>(r_p + (g_off + l + L * i) * cg + cs + j, r[i] + j);
          }
        }
      }
      for (int dd = 0; dd < nd; ++dd) {
        const Sample s = unpack(recs[dd * P + pl], Ws);
        float acc[GPT];
#pragma unroll
        for (int i = 0; i < GPT; ++i) acc[i] = 0.0f;
        if (s.inside) {
          const T* p00 = s_img + static_cast<size_t>(s.i00) * C + cs;
          const T* p01 = s_img + static_cast<size_t>(s.i01) * C + cs;
          const T* p10 = s_img + static_cast<size_t>(s.i10) * C + cs;
          const T* p11 = s_img + static_cast<size_t>(s.i11) * C + cs;
#pragma unroll
          for (int i = 0; i < GPT; ++i) {
            const int off = (g_off + l + L * i) * cg;
#pragma unroll
            for (int j = 0; j < kCh; j += K) {
              if (j < len) {
                float a[K], b[K], e[K], f[K];
                load_or_zero<K>(s.v00, p00 + off + j, a);
                load_or_zero<K>(s.v01, p01 + off + j, b);
                load_or_zero<K>(s.v10, p10 + off + j, e);
                load_or_zero<K>(s.v11, p11 + off + j, f);
#pragma unroll
                for (int k = 0; k < K; ++k) {
                  acc[i] += Op::lerp(a[k], b[k], e[k], f[k], s.wx, s.wy) *
                            r[i][j + k];
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          float* st = stage + (static_cast<size_t>(l + L * i) * dch + dd) * P +
                      pl;
          *st = (cs == 0) ? acc[i] : *st + acc[i];
        }
      }
    }
  }
  __syncthreads();

  // the staged sums out, one plane per step: element e = group * P +
  // pixel, so a warp writes 32 consecutive pixels of the tile (rows of tw)
  for (int e = tid; e < gs * P; e += blockDim.x) {
    const int gg = e >> p_log2;
    const int p = e & (P - 1);
    const int x = x0 + (p & (tw - 1));
    const int y = y0 + (p >> tw_log2);
    if (x < W && y < H) {
      const size_t plane0 = (static_cast<size_t>(n) * G + g_off + gg) * D + d0;
      float* o = out + plane0 * hw + static_cast<size_t>(y) * W + x;
      const float* sp = stage + static_cast<size_t>(gg) * dch * P + p;
      for (int dd = 0; dd < nd; ++dd) {
        o[static_cast<size_t>(dd) * hw] = sp[dd * P] * inv_cg;
      }
    }
  }
}

// one launch for groups [g_off, g_off + gs) of the g, gs / GPT <= kBlock
template <class Op, typename T, int K, int GPT, int PCG>
int launch_k(const void* src, const void* ref, const Op& op, float* out,
             int n, int d, int h, int w, int hs, int ws, int c, int g,
             int g_off, int gs, cudaStream_t stream) {
  // P: the largest power of two with P * gs / GPT <= kBlock; tile tw x th
  // = P, tw >= th (16 x 4 at the sweep's G = 4, GPT = 1; 1 x 1 at 256
  // threads per pixel)
  const int lanes = gs / GPT;
  int p_log2 = 0;
  while ((2 << p_log2) * lanes <= kBlock) ++p_log2;
  const int tw_log2 = min(p_log2, (p_log2 + 2) / 2);
  const int tw = 1 << tw_log2;
  const int th = 1 << (p_log2 - tw_log2);
  const int tiles_x = (w + tw - 1) / tw;
  const long long tiles =
      static_cast<long long>(tiles_x) * ((h + th - 1) / th);
  if (tiles > 0x7fffffffLL || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // split the planes over blocks until the grid has ~kTargetBlocks; at
  // most kMaxPlanes, and what the shared memory holds, per block
  const size_t per_plane = (sizeof(SampleRec) + sizeof(float) * gs)
                           << p_log2;
  const int max_planes =
      min(kMaxPlanes, static_cast<int>(kSmemBytes / per_plane));
  const long long per_chunk = tiles * n;
  int chunks = static_cast<int>(
      (kTargetBlocks + per_chunk - 1) / per_chunk);
  chunks = max(chunks, (d + max_planes - 1) / max_planes);
  chunks = min(chunks, d);
  const int dch = (d + chunks - 1) / chunks;
  chunks = (d + dch - 1) / dch;
  const dim3 grid(static_cast<unsigned>(tiles), chunks, n);
  corr_kernel<Op, T, K, GPT, PCG>
      <<<grid, lanes << p_log2, per_plane * dch, stream>>>(
          static_cast<const T*>(src), static_cast<const T*>(ref), op, out, d,
          h, w, hs, ws, c, g, g_off, gs, p_log2, tw_log2, tiles_x, dch);
  return static_cast<int>(cudaGetLastError());
}

// every group: launches of at most kBlock * GPT groups each (one launch
// unless G > 256, fewer than one group per thread)
template <class Op, typename T, int K, int GPT, int PCG = 0>
int launch_groups(const void* src, const void* ref, const Op& op, float* out,
                  int n, int d, int h, int w, int hs, int ws, int c, int g,
                  cudaStream_t stream) {
  for (int g_off = 0; g_off < g; g_off += kBlock * GPT) {
    const int err = launch_k<Op, T, K, GPT, PCG>(
        src, ref, op, out, n, d, h, w, hs, ws, c, g, g_off,
        min(kBlock * GPT, g - g_off), stream);
    if (err != 0) return err;
  }
  return 0;
}

// groups per thread: two where a group has at most 4 channels (stage 3's
// C/G = 4), so that a thread has 8 channels' work per sample to set
// against the sample's unpacking and its output store; one otherwise
template <class Op, typename T, int K>
int launch_gpt(const void* src, const void* ref, const Op& op, float* out,
               int n, int d, int h, int w, int hs, int ws, int c, int g,
               cudaStream_t stream) {
  if constexpr (K <= 4) {
    if (g % 2 == 0 && c / g <= 4) {
      return launch_groups<Op, T, K, 2>(src, ref, op, out, n, d, h, w, hs,
                                        ws, c, g, stream);
    }
  }
  return launch_groups<Op, T, K, 1>(src, ref, op, out, n, d, h, w, hs, ws,
                                    c, g, stream);
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The forward for every C/G, G and alignment: dtype 0 = float32 features,
// 1 = bfloat16. Returns the cudaError_t of the launches (0 = ok).
template <class Op>
int corr_forward(int dtype, const void* src, const void* ref, const Op& op,
                 float* out, int n, int d, int h, int w, int hs, int ws,
                 int c, int g, cudaStream_t st) {
  if (n == 0 || d == 0 || h == 0 || w == 0) return 0;
  if (g <= 0 || c % g != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = c / g;
  if (dtype == 0) {
    if (cg % 4 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch_gpt<Op, float, 4>(src, ref, op, out, n, d, h, w, hs, ws,
                                      c, g, st);
    }
    return launch_gpt<Op, float, 1>(src, ref, op, out, n, d, h, w, hs, ws,
                                    c, g, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (cg % 8 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch_gpt<Op, bf, 8>(src, ref, op, out, n, d, h, w, hs, ws, c,
                                   g, st);
    }
    // adjacent groups per thread, so that 16-byte loads run across them:
    // Op::kBf16Groups4 at C/G = 4, two at C/G = 12 (three loads a corner)
    constexpr int kG4 = Op::kBf16Groups4;
    if (cg == 4 && g % kG4 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch_groups<Op, bf, 8, kG4, 4>(src, ref, op, out, n, d, h, w,
                                              hs, ws, c, g, st);
    }
    if (cg == 12 && g % 2 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch_groups<Op, bf, 8, 2, 12>(src, ref, op, out, n, d, h, w,
                                             hs, ws, c, g, st);
    }
    if (cg % 4 == 0 && aligned(src, 8) && aligned(ref, 8)) {
      return launch_gpt<Op, bf, 4>(src, ref, op, out, n, d, h, w, hs, ws, c,
                                   g, st);
    }
    if (cg % 2 == 0 && aligned(src, 4) && aligned(ref, 4)) {
      return launch_gpt<Op, bf, 2>(src, ref, op, out, n, d, h, w, hs, ws, c,
                                   g, st);
    }
    return launch_gpt<Op, bf, 1>(src, ref, op, out, n, d, h, w, hs, ws, c,
                                 g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace warp_geom
