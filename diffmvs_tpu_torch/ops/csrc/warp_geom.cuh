// Geometry shared by the warp kernels: plane-sweep coordinates, bilinear
// corners, fractions and zero-padding validity, and the channel loads.
//
// The forward (warp_corr.cu) and the backward (warp_corr_bwd.cu) both call
// locate() on the same inputs, so the backward samples at bit for bit the
// coordinates the forward sampled at (a 1-ulp change in a coordinate moves
// a correlation by up to ~4e-5 at the model's feature scales).
//
// Both compute each (plane, pixel) sample once per block and keep it in
// shared memory as a SampleRec (pack / unpack), which the threads that
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

// Where one (plane, ref pixel) sample lands in the source image.
struct Sample {
  bool inside;                 // some corner lies in the image
  float wx, wy;                // bilinear fractions
  bool v00, v01, v10, v11;     // corner validity (zero padding, corner-wise)
  int i00, i01, i10, i11;      // corner pixel indices y * Ws + x, clamped
                               // into the image: read only when valid
};

// m: the 12 projection scalars of one sample (rot row-major, then trans);
// (xg, yg): the ref pixel; dep: its hypothesis depth.
//
// Validity is decided in float before any integer conversion: a NaN or
// huge coordinate fails the test, and (int)floorf() is only evaluated on
// in-range values.
__device__ __forceinline__ Sample locate(const float* m, float xg, float yg,
                                         float dep, int Hs, int Ws) {
  Sample s;
  const float px = project(m + 0, m[9], xg, yg, dep);
  const float py = project(m + 3, m[10], xg, yg, dep);
  float pz = project(m + 6, m[11], xg, yg, dep);
  if (pz == 0.0f) pz = 1e-8f;
  const float sx = __fdiv_rn(px, pz);
  const float sy = __fdiv_rn(py, pz);

  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  // some corner inside: x0 in [-1, Ws-1] and y0 in [-1, Hs-1]
  // (false for NaN and +-inf)
  s.inside = x0f >= -1.0f && x0f <= static_cast<float>(Ws - 1) &&
             y0f >= -1.0f && y0f <= static_cast<float>(Hs - 1);
  if (!s.inside) {
    s.wx = s.wy = 0.0f;
    s.v00 = s.v01 = s.v10 = s.v11 = false;
    s.i00 = s.i01 = s.i10 = s.i11 = 0;
    return s;
  }
  s.wx = __fsub_rn(sx, x0f);
  s.wy = __fsub_rn(sy, y0f);
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

}  // namespace warp_geom
