// Backward of the fused plane-sweep warp + group correlation, for Hopper
// (sm_90a).
//
// Replaces diffmvs_tpu/ops/pallas/warp_corr_bwd.py:61 `_bwd_kernel` (the
// TPU kernel reached through warp_corr_backward_pallas). It computes the
// gradient of the exact zero-padded forward (warp_corr.cu, and
// warp_and_correlate_plain in ops/correlation.py), which is what autograd
// of the plain version gives: with g the cotangent of the forward's output
// and Cg = C / G,
//
//   d_ref[n, p, c] = sum_d g[n, grp(c), d, p] / Cg * warped[n, d, p, c]
//   d_src[n, q, c] = sum_{d, p} w_q(d, p) * g[n, grp(c), d, p] / Cg
//                                         * ref[n, p, c]
//
// where warped is the forward's bilinear sample and w_q(d, p) the bilinear
// weight of source pixel q in the sample of (plane d, ref pixel p): zero
// unless q is one of its four corners and lies in the image. The
// projections and the depths get no gradient (the coordinates are
// stop-gradient'ed, as the reference computes them under no_grad).
//
// Layouts: src [N, Hs, Ws, C], ref [N, H, W, C] f32 channels-last; depth
// [N, D, H, W] f32; rt [N, 12] f32; g [N, G, D, H, W] f32 (the buffer order
// of the forward's output); d_src [N, Hs, Ws, C] f32, zero-filled by the
// caller; d_ref [N, H, W, C] f32, written whole here.
//
// The TPU kernel's band/window geometry and one-hot MXU scatter exist only
// because Mosaic has no lane scatter; on Hopper d_src is a direct scatter.
//
// What bounds it on an H100: the atomics. Per (plane, pixel) sample it
// re-samples the 4 corners (C channels each) for d_ref and adds C values
// into each in-image corner of d_src, against 4 bytes of g; the compulsory
// traffic (each input read once, each output written once) is far below
// what the corner reads and the atomic adds move through L2. Design,
// simple and right first:
//   * one thread per (n, ref pixel, 4 channels) -- or per channel when
//     C/G % 4 != 0 or a base is not 16-byte aligned; it loops over the D
//     planes. Neighbouring threads take neighbouring channels of one pixel,
//     so ref, the corners and the d_src adds are contiguous across a warp;
//   * coordinates, corners and validity from warp_geom.cuh, the same code
//     as the forward, so both sample at the same coordinates bit for bit;
//   * d_ref: gathered in registers over the planes and written once, no
//     atomics, deterministic;
//   * d_src: f32 atomicAdd into each in-image corner (corners in the
//     padding get nothing), so its sums run in an order that changes from
//     run to run.
// Later work: a deterministic d_src (a source-tile pass with shared-memory
// accumulation) and red.global.add.v4.f32.

#include "warp_geom.cuh"

namespace {

using warp_geom::bilerp;
using warp_geom::load1;
using warp_geom::load4;

constexpr int kThreads = 128;

template <int K>
struct Vec {
  float v[K];
};

template <int K>
__device__ __forceinline__ Vec<K> load_k(const float* p) {
  Vec<K> out;
  if constexpr (K == 4) {
    const float4 a = load4(p);
    out.v[0] = a.x;
    out.v[1] = a.y;
    out.v[2] = a.z;
    out.v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out.v[k] = load1(p + k);
  }
  return out;
}

template <int K>
__device__ __forceinline__ Vec<K> load_or_zero(bool valid, const float* p) {
  if (valid) return load_k<K>(p);
  Vec<K> z;
#pragma unroll
  for (int k = 0; k < K; ++k) z.v[k] = 0.0f;
  return z;
}

// K channels per thread: 4 (16-byte loads) or 1
template <int K>
__global__ void __launch_bounds__(kThreads)
warp_corr_bwd_kernel(const float* __restrict__ src,
                     const float* __restrict__ ref,
                     const float* __restrict__ depth,
                     const float* __restrict__ rt,
                     const float* __restrict__ g, float* __restrict__ d_src,
                     float* __restrict__ d_ref, int N, int D, int H, int W,
                     int Hs, int Ws, int C, int G) {
  const int lanes = C / K;                          // threads per pixel
  const int hw = H * W;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= static_cast<long long>(N) * hw * lanes) return;
  const int lane = static_cast<int>(tid % lanes);
  const long long np = tid / lanes;                 // n * hw + pix
  const int n = static_cast<int>(np / hw);
  const int pix = static_cast<int>(np - static_cast<long long>(n) * hw);
  const int yi = pix / W;
  const int xi = pix - yi * W;
  const float xg = static_cast<float>(xi);
  const float yg = static_cast<float>(yi);

  const int c0 = lane * K;
  const int cg = C / G;
  const int grp = c0 / cg;              // K divides cg: one group per thread
  const float inv_cg = 1.0f / static_cast<float>(cg);

  const float* m = rt + static_cast<size_t>(n) * 12;
  const float* dep_p = depth + static_cast<size_t>(n) * D * hw + pix;
  const float* g_p =
      g + (static_cast<size_t>(n) * G + grp) * D * static_cast<size_t>(hw) +
      pix;
  const size_t img = static_cast<size_t>(n) * Hs * Ws * C + c0;
  const float* s_img = src + img;
  float* ds_img = d_src + img;
  const size_t ref_off = static_cast<size_t>(np) * C + c0;
  const Vec<K> r = load_k<K>(ref + ref_off);

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int d = 0; d < D; ++d) {
    const warp_geom::Sample s =
        warp_geom::locate(m, xg, yg, dep_p[static_cast<size_t>(d) * hw], Hs,
                          Ws);
    if (!s.inside) continue;
    const float gd = g_p[static_cast<size_t>(d) * hw] * inv_cg;
    const float* p00 = s_img + static_cast<size_t>(s.i00) * C;
    const float* p01 = s_img + static_cast<size_t>(s.i01) * C;
    const float* p10 = s_img + static_cast<size_t>(s.i10) * C;
    const float* p11 = s_img + static_cast<size_t>(s.i11) * C;

    // d_ref: the forward's sample, re-read
    const Vec<K> a = load_or_zero<K>(s.v00, p00);
    const Vec<K> b = load_or_zero<K>(s.v01, p01);
    const Vec<K> e = load_or_zero<K>(s.v10, p10);
    const Vec<K> f = load_or_zero<K>(s.v11, p11);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] += gd * bilerp(a.v[k], b.v[k], e.v[k], f.v[k], s.wx, s.wy);
    }

    // d_src: scatter into the in-image corners
    const float ux = 1.0f - s.wx, uy = 1.0f - s.wy;
    const float w00 = ux * uy, w01 = s.wx * uy;
    const float w10 = ux * s.wy, w11 = s.wx * s.wy;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = gd * r.v[k];
      if (s.v00) atomicAdd(ds_img + static_cast<size_t>(s.i00) * C + k,
                           w00 * t);
      if (s.v01) atomicAdd(ds_img + static_cast<size_t>(s.i01) * C + k,
                           w01 * t);
      if (s.v10) atomicAdd(ds_img + static_cast<size_t>(s.i10) * C + k,
                           w10 * t);
      if (s.v11) atomicAdd(ds_img + static_cast<size_t>(s.i11) * C + k,
                           w11 * t);
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) d_ref[ref_off + k] = acc[k];
}

template <int K>
int launch(const float* src, const float* ref, const float* depth,
           const float* rt, const float* g, float* d_src, float* d_ref,
           int n, int d, int h, int w, int hs, int ws, int c, int groups,
           cudaStream_t stream) {
  const long long threads = static_cast<long long>(n) * h * w * (c / K);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  warp_corr_bwd_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(src, ref, depth, rt, g, d_src, d_ref,
                                      n, d, h, w, hs, ws, c, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes), float32 only. d_src must be
// zero-filled. Returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_corr_backward(const void* src, const void* ref,
                                  const void* depth, const void* rt,
                                  const void* g, void* d_src, void* d_ref,
                                  int n, int d, int h, int w, int hs, int ws,
                                  int c, int groups, void* stream) {
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  const float* s = static_cast<const float*>(src);
  const float* r = static_cast<const float*>(ref);
  float* ds = static_cast<float*>(d_src);
  float* dr = static_cast<float*>(d_ref);
  const bool vec = (c / groups) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ds) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dr) % 16 == 0;
  const float* dp = static_cast<const float*>(depth);
  const float* rp = static_cast<const float*>(rt);
  const float* gp = static_cast<const float*>(g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch<4>(s, r, dp, rp, gp, ds, dr, n, d, h, w, hs, ws, c, groups,
                     st);
  }
  return launch<1>(s, r, dp, rp, gp, ds, dr, n, d, h, w, hs, ws, c, groups,
                   st);
}
