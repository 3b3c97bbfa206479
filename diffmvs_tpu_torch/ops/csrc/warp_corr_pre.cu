// Warp + group correlation from precomputed corner operands (K3), forward,
// for Hopper (sm_90a).
//
// Replaces diffmvs_tpu/ops/pallas/warp_corr.py:55 `_corr_kernel` (the TPU
// kernel reached through warp_corr_pallas(..., batch_rows=False)). It
// computes the same function as the plain PyTorch path in
// ops/correlation.py (corner_correlate_plain):
//
//   for sample n, plane d, ref pixel p:
//     (xi, yi) = the integer corners of the sample into the 1-padded source
//                (original x0 = xi - 1, x1 = xi; y likewise), (fx, fy) its
//                bilinear fractions, valid whether some corner is in the image
//     w[c] = valid ? x-lerp of two y-lerps of src[n, :, :, c]
//                    (left = (1 - fy) * s[y0, x0] + fy * s[y1, x0]; right the
//                     same at x1; w = left + (right - left) * fx) : 0,
//            each corner outside [0, Ws) x [0, Hs) reading zero
//     out[n, g, d, p] = sum over the C/G channels c of group g of
//                       w[c] * ref[n, p, c], divided by C/G
//
// The TPU kernel interpolates in that order (y first, then x: its band rows
// are summed with the weights (1 - fy, fy) before the x-lerp), and so does
// this kernel, with explicit round-to-nearest intrinsics; K1 (warp_corr.cu)
// interpolates x first. bf16 features take the TPU kernel's packed path:
// channel pairs are read as one 32-bit word, unpacked to f32, and each
// group's sum is (sum over its even channels) + (sum over its odd ones).
//
// Layouts: src [N, Hs, Ws, C], ref [N, H, W, C] channels-last (f32, or
// bf16 upcast on load), xi/yi int32, fx/fy f32 and valid uint8 (0/1), each
// [N, D, H, W]; out [N, G, D, H, W] f32, returned by the wrapper as a
// [N, D, H, W, G] view (K1's layout).
//
// What bounds it on an H100: bytes. Per (plane, pixel) it reads 17 bytes of
// operands (K1 reads 4 bytes of depth instead and computes the rest) and
// writes 4 G bytes, with ~11 operations per channel against 4 corner reads
// of C channels that hit L1/L2. Design, simple first: one thread per
// (n, d, pixel), neighbouring threads on neighbouring pixels of one plane,
// so the five operand loads and the output stores are coalesced; corners
// are read as C contiguous channels, 16-byte vector loads for f32 (8-byte,
// two bf16 pairs, for bf16) when C/G allows and the bases are aligned; f32
// group sums. The source's zero padding is virtual (each corner is checked
// against the image), so no padded copy of the source is made.
// The TPU kernel zeroes samples outside its DMA windows and row bands; this
// kernel reads the whole source image and needs no window, band or guard.
//
// Do not build with --use_fast_math (approximate division).

#include "warp_geom.cuh"

namespace {

using warp_geom::load1;
using warp_geom::load4;

constexpr int kThreads = 128;

// (1 - fy) * top + fy * bot, with gy = 1 - fy
__device__ __forceinline__ float lerp_y(float top, float bot, float fy,
                                        float gy) {
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// the TPU kernel's order: the two y-lerps, then left + (right - left) * fx
__device__ __forceinline__ float interp(float v00, float v01, float v10,
                                        float v11, float fx, float fy,
                                        float gy) {
  const float left = lerp_y(v00, v10, fy, gy);
  const float right = lerp_y(v01, v11, fy, gy);
  return __fadd_rn(left, __fmul_rn(__fsub_rn(right, left), fx));
}

// one bf16 channel pair from a 32-bit word: (even, odd) channel as f32
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// The corners of one sample: source pointers and their validity.
template <typename T>
struct Corners {
  const T *p00, *p01, *p10, *p11;
  bool v00, v01, v10, v11;
};

template <typename T>
__device__ __forceinline__ Corners<T> corners(const T* s_img, int xi, int yi,
                                              int Hs, int Ws, int C) {
  // padded corner index xi is the original x1; x0 = xi - 1
  const int x0 = xi - 1, x1 = xi, y0 = yi - 1, y1 = yi;
  const bool vx0 = x0 >= 0 && x0 <= Ws - 1, vx1 = x1 >= 0 && x1 <= Ws - 1;
  const bool vy0 = y0 >= 0 && y0 <= Hs - 1, vy1 = y1 >= 0 && y1 <= Hs - 1;
  const int xa = min(max(x0, 0), Ws - 1), xb = min(max(x1, 0), Ws - 1);
  const int ya = min(max(y0, 0), Hs - 1), yb = min(max(y1, 0), Hs - 1);
  Corners<T> k;
  k.p00 = s_img + (static_cast<size_t>(ya) * Ws + xa) * C;
  k.p01 = s_img + (static_cast<size_t>(ya) * Ws + xb) * C;
  k.p10 = s_img + (static_cast<size_t>(yb) * Ws + xa) * C;
  k.p11 = s_img + (static_cast<size_t>(yb) * Ws + xb) * C;
  k.v00 = vy0 && vx0;
  k.v01 = vy0 && vx1;
  k.v10 = vy1 && vx0;
  k.v11 = vy1 && vx1;
  return k;
}

// VEC = 4: float4 loads (C/G % 4 == 0, 16-byte aligned); VEC = 1: scalar
template <int VEC>
__global__ void __launch_bounds__(kThreads)
k3_f32(const float* __restrict__ src, const float* __restrict__ ref,
       const int* __restrict__ xi, const int* __restrict__ yi,
       const float* __restrict__ fx, const float* __restrict__ fy,
       const uint8_t* __restrict__ valid, float* __restrict__ out, int D,
       int H, int W, int Hs, int Ws, int C, int G) {
  const int hw = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int d = blockIdx.y;
  const int n = blockIdx.z;
  const size_t op = (static_cast<size_t>(n) * D + d) * hw + pix;
  float* out_p = out + (static_cast<size_t>(n) * G * D + d) *
                           static_cast<size_t>(hw) + pix;
  const size_t g_stride = static_cast<size_t>(D) * hw;
  if (!valid[op]) {
    for (int g = 0; g < G; ++g) out_p[g * g_stride] = 0.0f;
    return;
  }
  const float wx = fx[op], wy = fy[op];
  const float gy = __fsub_rn(1.0f, wy);
  const Corners<float> k = corners(
      src + static_cast<size_t>(n) * Hs * Ws * C, xi[op], yi[op], Hs, Ws, C);
  const float* r_p = ref + (static_cast<size_t>(n) * hw + pix) * C;
  const int cg = C / G;
  const float fcg = static_cast<float>(cg);

  for (int g = 0; g < G; ++g) {
    float acc = 0.0f;
    const int c_end = (g + 1) * cg;
    if constexpr (VEC == 4) {
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = g * cg; c < c_end; c += 4) {
        const float4 a = k.v00 ? load4(k.p00 + c) : z4;
        const float4 b = k.v01 ? load4(k.p01 + c) : z4;
        const float4 e = k.v10 ? load4(k.p10 + c) : z4;
        const float4 f = k.v11 ? load4(k.p11 + c) : z4;
        const float4 r = load4(r_p + c);
        acc += interp(a.x, b.x, e.x, f.x, wx, wy, gy) * r.x;
        acc += interp(a.y, b.y, e.y, f.y, wx, wy, gy) * r.y;
        acc += interp(a.z, b.z, e.z, f.z, wx, wy, gy) * r.z;
        acc += interp(a.w, b.w, e.w, f.w, wx, wy, gy) * r.w;
      }
    } else {
      for (int c = g * cg; c < c_end; ++c) {
        const float a = k.v00 ? load1(k.p00 + c) : 0.0f;
        const float b = k.v01 ? load1(k.p01 + c) : 0.0f;
        const float e = k.v10 ? load1(k.p10 + c) : 0.0f;
        const float f = k.v11 ? load1(k.p11 + c) : 0.0f;
        acc += interp(a, b, e, f, wx, wy, gy) * load1(r_p + c);
      }
    }
    out_p[g * g_stride] = __fdiv_rn(acc, fcg);
  }
}

// bf16 channel pairs: VEC = 4 reads two pairs (8 bytes) per corner and
// step (C/G % 4 == 0, 8-byte aligned), VEC = 2 one pair (4 bytes)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
k3_bf16(const __nv_bfloat16* __restrict__ src,
        const __nv_bfloat16* __restrict__ ref, const int* __restrict__ xi,
        const int* __restrict__ yi, const float* __restrict__ fx,
        const float* __restrict__ fy, const uint8_t* __restrict__ valid,
        float* __restrict__ out, int D, int H, int W, int Hs, int Ws, int C,
        int G) {
  const int hw = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int d = blockIdx.y;
  const int n = blockIdx.z;
  const size_t op = (static_cast<size_t>(n) * D + d) * hw + pix;
  float* out_p = out + (static_cast<size_t>(n) * G * D + d) *
                           static_cast<size_t>(hw) + pix;
  const size_t g_stride = static_cast<size_t>(D) * hw;
  if (!valid[op]) {
    for (int g = 0; g < G; ++g) out_p[g * g_stride] = 0.0f;
    return;
  }
  const float wx = fx[op], wy = fy[op];
  const float gy = __fsub_rn(1.0f, wy);
  const Corners<__nv_bfloat16> k =
      corners(src + static_cast<size_t>(n) * Hs * Ws * C, xi[op], yi[op], Hs,
              Ws, C);
  const __nv_bfloat16* r_p = ref + (static_cast<size_t>(n) * hw + pix) * C;
  const int cg = C / G;
  const float fcg = static_cast<float>(cg);

  for (int g = 0; g < G; ++g) {
    float even = 0.0f, odd = 0.0f;
    const int c_end = (g + 1) * cg;
    if constexpr (VEC == 4) {
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = g * cg; c < c_end; c += 4) {
        // load4 of bf16 gives (even, odd, even, odd)
        const float4 a = k.v00 ? load4(k.p00 + c) : z4;
        const float4 b = k.v01 ? load4(k.p01 + c) : z4;
        const float4 e = k.v10 ? load4(k.p10 + c) : z4;
        const float4 f = k.v11 ? load4(k.p11 + c) : z4;
        const float4 r = load4(r_p + c);
        even += interp(a.x, b.x, e.x, f.x, wx, wy, gy) * r.x;
        odd += interp(a.y, b.y, e.y, f.y, wx, wy, gy) * r.y;
        even += interp(a.z, b.z, e.z, f.z, wx, wy, gy) * r.z;
        odd += interp(a.w, b.w, e.w, f.w, wx, wy, gy) * r.w;
      }
    } else {
      const float2 z2 = make_float2(0.f, 0.f);
      for (int c = g * cg; c < c_end; c += 2) {
        const float2 a = k.v00 ? load_pair(k.p00 + c) : z2;
        const float2 b = k.v01 ? load_pair(k.p01 + c) : z2;
        const float2 e = k.v10 ? load_pair(k.p10 + c) : z2;
        const float2 f = k.v11 ? load_pair(k.p11 + c) : z2;
        const float2 r = load_pair(r_p + c);
        even += interp(a.x, b.x, e.x, f.x, wx, wy, gy) * r.x;
        odd += interp(a.y, b.y, e.y, f.y, wx, wy, gy) * r.y;
      }
    }
    out_p[g * g_stride] = __fdiv_rn(__fadd_rn(even, odd), fcg);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32 features,
// 1 = bfloat16 features (packed channel pairs: C/G even, 4-byte aligned
// bases). Returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_corr_pre_forward(int dtype, const void* src,
                                     const void* ref, const void* xi,
                                     const void* yi, const void* fx,
                                     const void* fy, const void* valid,
                                     void* out, int n, int d, int h, int w,
                                     int hs, int ws, int c, int g,
                                     void* stream) {
  if (n == 0 || d == 0 || h == 0 || w == 0) return 0;
  const int hw = h * w;
  const dim3 grid((hw + kThreads - 1) / kThreads, d, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* xp = static_cast<const int*>(xi);
  const int* yp = static_cast<const int*>(yi);
  const float* fxp = static_cast<const float*>(fx);
  const float* fyp = static_cast<const float*>(fy);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  float* op = static_cast<float*>(out);
  const int cg = c / g;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t ra = reinterpret_cast<uintptr_t>(ref);
  if (dtype == 0) {
    const float* s = static_cast<const float*>(src);
    const float* r = static_cast<const float*>(ref);
    if (cg % 4 == 0 && sa % 16 == 0 && ra % 16 == 0) {
      k3_f32<4><<<grid, kThreads, 0, st>>>(s, r, xp, yp, fxp, fyp, vp, op,
                                           d, h, w, hs, ws, c, g);
    } else {
      k3_f32<1><<<grid, kThreads, 0, st>>>(s, r, xp, yp, fxp, fyp, vp, op,
                                           d, h, w, hs, ws, c, g);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    if (cg % 2 != 0 || sa % 4 != 0 || ra % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
    const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(ref);
    if (cg % 4 == 0 && sa % 8 == 0 && ra % 8 == 0) {
      k3_bf16<4><<<grid, kThreads, 0, st>>>(s, r, xp, yp, fxp, fyp, vp, op,
                                            d, h, w, hs, ws, c, g);
    } else {
      k3_bf16<2><<<grid, kThreads, 0, st>>>(s, r, xp, yp, fxp, fyp, vp, op,
                                            d, h, w, hs, ws, c, g);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
