// Fused plane-sweep warp + group correlation, forward, for Hopper (sm_90a).
//
// Replaces diffmvs_tpu/ops/pallas/warp_corr.py:210 `_corr_kernel_rowbatch`
// (the TPU kernel reached through warp_corr_pallas). It computes the same
// function as the plain PyTorch path in ops/correlation.py
// (warp_and_correlate_plain):
//
//   for sample n, plane d, ref pixel p = (y, x):
//     (px, py, pz) = (R [x, y, 1]^T) * depth[n, d, y, x] + t     (R, t: rt[n])
//     pz == 0 -> 1e-8;  (sx, sy) = (px / pz, py / pz)
//     w[c]  = bilinear sample of src[n, :, :, c] at (sx, sy), each of the
//             four corners contributing zero outside the image
//     out[n, g, d, y, x] = mean over the C/G channels c of group g of
//                          w[c] * ref[n, y, x, c]
//
// Layouts: src [N, Hs, Ws, C] and ref [N, H, W, C] channels-last (f32 or
// bf16, upcast on load), depth [N, D, H, W] f32, rt [N, 12] f32
// (rot row-major, then trans), out [N, G, D, H, W] f32 -- the NCDHW layout
// the 3D convs and the g*D + d refinement cost read without a copy.
//
// What bounds it on an H100: bytes. Per (plane, pixel) it does ~3C
// multiply-adds of interpolation and C of correlation against 16 bytes of
// depth + output and 4 corner reads of C channels, so it sits far below
// the card's ridge point (~20 FLOP/byte in f32). The least traffic is each
// input read once and the output written once (output + ref + src +
// depth). Design, simple first:
//   * one thread per (n, d, pixel); neighbouring threads take neighbouring
//     pixels of one plane, so depth loads and the per-group output stores
//     are coalesced, and the four corner reads of neighbouring pixels hit
//     the same or adjacent source rows (L1/L2 reuse);
//   * the coordinates are computed in the kernel from depth and the 12
//     projection scalars: no coordinate or corner arrays in memory;
//   * corners are read as C contiguous channels, 16-byte vector loads for
//     f32 (8-byte for bf16) when C/G % 4 == 0 and the bases are aligned;
//   * f32 accumulation per group, one store per group; the ref features
//     are re-read per plane from cache rather than held in registers.
// The TPU kernel's windows, bands and DMA ring exist only because Mosaic
// cannot gather from HBM; this kernel reads the whole source image, so it
// is exact everywhere and needs no miss guard.
//
// Rounding: the coordinate and interpolation arithmetic uses explicit
// round-to-nearest intrinsics in the plain path's operation order (the
// coordinates' last step is the one fused multiply-add that
// plane_sweep_coords and the JAX reference also take), so the
// coordinates agree with plane_sweep_coords bit for bit and the only
// differences left are in the channel sum order. Do not build with
// --use_fast_math (approximate division, flushed denormals).
//
// Validity is decided in float before any integer conversion: a NaN or
// huge coordinate fails the test and contributes zero, and (int)floorf()
// is only evaluated on in-range values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
warp_corr_kernel(const T* __restrict__ src, const T* __restrict__ ref,
                 const float* __restrict__ depth,
                 const float* __restrict__ rt, float* __restrict__ out,
                 int D, int H, int W, int Hs, int Ws, int C, int G) {
  const int hw = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int d = blockIdx.y;
  const int n = blockIdx.z;
  const int yi = pix / W;
  const int xi = pix - yi * W;
  const float xg = static_cast<float>(xi);
  const float yg = static_cast<float>(yi);

  const float* m = rt + static_cast<size_t>(n) * 12;
  const float dep = depth[(static_cast<size_t>(n) * D + d) * hw + pix];
  const float px = project(m + 0, m[9], xg, yg, dep);
  const float py = project(m + 3, m[10], xg, yg, dep);
  float pz = project(m + 6, m[11], xg, yg, dep);
  if (pz == 0.0f) pz = 1e-8f;
  const float sx = __fdiv_rn(px, pz);
  const float sy = __fdiv_rn(py, pz);

  const int cg = C / G;
  const float inv_cg = 1.0f / static_cast<float>(cg);
  float* out_p = out + (static_cast<size_t>(n) * G * D + d) *
                           static_cast<size_t>(hw) + pix;
  const size_t g_stride = static_cast<size_t>(D) * hw;

  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  // some corner inside: x0 in [-1, Ws-1] and y0 in [-1, Hs-1]
  // (false for NaN and +-inf)
  const bool inside = x0f >= -1.0f && x0f <= static_cast<float>(Ws - 1) &&
                      y0f >= -1.0f && y0f <= static_cast<float>(Hs - 1);
  if (!inside) {
    for (int g = 0; g < G; ++g) out_p[g * g_stride] = 0.0f;
    return;
  }
  const float wx = __fsub_rn(sx, x0f);
  const float wy = __fsub_rn(sy, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Ws - 1;
  const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Hs - 1;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  // clamped corner indices: only dereferenced when valid
  const int xa = max(x0, 0), xb = min(x0 + 1, Ws - 1);
  const int ya = max(y0, 0), yb = min(y0 + 1, Hs - 1);
  const T* s_img = src + static_cast<size_t>(n) * Hs * Ws * C;
  const T* p00 = s_img + (static_cast<size_t>(ya) * Ws + xa) * C;
  const T* p01 = s_img + (static_cast<size_t>(ya) * Ws + xb) * C;
  const T* p10 = s_img + (static_cast<size_t>(yb) * Ws + xa) * C;
  const T* p11 = s_img + (static_cast<size_t>(yb) * Ws + xb) * C;
  const T* r_p = ref + (static_cast<size_t>(n) * hw + pix) * C;

  for (int g = 0; g < G; ++g) {
    float acc = 0.0f;
    const int c_end = (g + 1) * cg;
    if constexpr (VEC) {
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = g * cg; c < c_end; c += 4) {
        const float4 a = v00 ? load4(p00 + c) : z4;
        const float4 b = v01 ? load4(p01 + c) : z4;
        const float4 e = v10 ? load4(p10 + c) : z4;
        const float4 f = v11 ? load4(p11 + c) : z4;
        const float4 r = load4(r_p + c);
        acc += bilerp(a.x, b.x, e.x, f.x, wx, wy) * r.x;
        acc += bilerp(a.y, b.y, e.y, f.y, wx, wy) * r.y;
        acc += bilerp(a.z, b.z, e.z, f.z, wx, wy) * r.z;
        acc += bilerp(a.w, b.w, e.w, f.w, wx, wy) * r.w;
      }
    } else {
      for (int c = g * cg; c < c_end; ++c) {
        const float a = v00 ? load1(p00 + c) : 0.0f;
        const float b = v01 ? load1(p01 + c) : 0.0f;
        const float e = v10 ? load1(p10 + c) : 0.0f;
        const float f = v11 ? load1(p11 + c) : 0.0f;
        acc += bilerp(a, b, e, f, wx, wy) * load1(r_p + c);
      }
    }
    out_p[g * g_stride] = acc * inv_cg;
  }
}

template <typename T>
int launch(const void* src, const void* ref, const float* depth,
           const float* rt, float* out, int n, int d, int h, int w, int hs,
           int ws, int c, int g, cudaStream_t stream) {
  const int hw = h * w;
  const dim3 grid((hw + kThreads - 1) / kThreads, d, n);
  const size_t align = 4 * sizeof(T);
  const bool vec = (c / g) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % align == 0 &&
                   reinterpret_cast<uintptr_t>(ref) % align == 0;
  const T* s = static_cast<const T*>(src);
  const T* r = static_cast<const T*>(ref);
  if (vec) {
    warp_corr_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        s, r, depth, rt, out, d, h, w, hs, ws, c, g);
  } else {
    warp_corr_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        s, r, depth, rt, out, d, h, w, hs, ws, c, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32 features,
// 1 = bfloat16 features. Returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_corr_forward(int dtype, const void* src, const void* ref,
                                 const void* depth, const void* rt, void* out,
                                 int n, int d, int h, int w, int hs, int ws,
                                 int c, int g, void* stream) {
  if (n == 0 || d == 0 || h == 0 || w == 0) return 0;
  const float* dp = static_cast<const float*>(depth);
  const float* rp = static_cast<const float*>(rt);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c, g, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c,
                                 g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
