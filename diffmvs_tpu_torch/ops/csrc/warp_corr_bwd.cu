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
// because Mosaic has no lane scatter; on Hopper d_src is a scatter.
//
// What bounds it on an H100: the scatter into d_src. Every in-image corner
// of every sample adds C values (109.3 M at the training sweep, B = 4,
// 64x80, D = 48, C = 48), against a compulsory traffic (each input read
// once, each output written once) of ~35 MB. The kernel before this design
// sent them as scalar f32 atomics, resolved one by one in L2. Design:
//   * a block owns a 2-D tile of ref pixels and walks the D planes; C/K
//     neighbouring threads share a pixel, K channels each (K = 4: float4
//     loads; K = 1 where C/G % 4 != 0 or a base is not 16-byte aligned),
//     so ref, the corners and the d_src adds are contiguous across a warp
//     (a C / K above 256 is taken in launches of 256 lanes' channels);
//   * the block computes each (plane, pixel) sample once, a batch of planes
//     at a time, into shared memory (warp_geom's SampleRec); the C/K
//     threads of a pixel read it back instead of each computing it;
//   * d_src: each thread holds, per corner slot (00, 01, 10, 11), the sum
//     of its weighted cotangents in registers while its pixel's sample
//     stays on the same source pixel from plane to plane (the D = 4
//     refinement hypotheses lie within a few percent of one depth; a sweep
//     plane moves the sample ~0.3 px at the training shape), and sends it
//     with one 128-bit global atomic (atomicAdd on float4, sm_90: RED.F32x4)
//     when the slot moves on: 9.1 M vector atomics at the training sweep
//     instead of 109.3 M scalar ones. (A shared-memory window of the tile's
//     source box, flushed once with vector atomics, was slower: on sm_90 a
//     shared-memory f32 atomicAdd compiles to a compare-and-swap loop,
//     ATOMS.CAST.SPIN.) Corners in the padding get nothing;
//   * d_ref: gathered in registers over the planes and written once, no
//     atomics, deterministic; so the planes are not split over blocks:
//     the channel lanes give the grid C/K threads per pixel (245 k at
//     the training sweep) instead;
//   * coordinates, corners and validity from warp_geom.cuh, the same code
//     as the forward, so both sample at the same coordinates bit for bit.
// What bounds it now: the vector atomics and the latency of each plane's
// dependent loads (sample, cotangent, corners). d_src's sums still run in
// an order that changes from run to run.
// Later work: a deterministic d_src needs the samples binned by source
// tile; the refinement stages' per-pixel depths have no inverse warp, so
// that binning costs extra passes.

#include "warp_geom.cuh"

namespace {

using warp_geom::bilerp;
using warp_geom::load1;
using warp_geom::load4;

constexpr int kThreads = 256;          // threads per block at most
constexpr int kMinBlocks = 4;          // resident blocks per SM (registers)
constexpr size_t kRecBytes = 24 * 1024;  // the samples of a batch of planes

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

// K values into global memory: one 128-bit atomic (K = 4) or K scalar ones
template <int K>
__device__ __forceinline__ void global_add(float* p, const float* v) {
  if constexpr (K == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) atomicAdd(p + k, v[k]);
  }
}

// One block: a tile of P = 1 << p_log2 ref pixels, tw = 1 << tw_log2
// wide, of sample blockIdx.y, all D planes, their samples computed db
// planes at a time, channels [c_off, c_off + cs) of the C; thread = pixel *
// (cs / K) + lane, lane owning channels [c_off + lane * K, + K).
template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_corr_bwd_kernel(const float* __restrict__ src,
                     const float* __restrict__ ref,
                     const float* __restrict__ depth,
                     const float* __restrict__ rt,
                     const float* __restrict__ g, float* __restrict__ d_src,
                     float* __restrict__ d_ref, int D, int H, int W, int Hs,
                     int Ws, int C, int G, int c_off, int cs, int p_log2,
                     int tw_log2, int tiles_x, int db) {
  extern __shared__ float4 smem[];        // the samples of db planes [db][P]
  warp_geom::SampleRec* recs = reinterpret_cast<warp_geom::SampleRec*>(smem);
  const int P = 1 << p_log2;
  const int tw = 1 << tw_log2;
  const int lanes = cs / K;
  const int tid = threadIdx.x;
  const int pl = tid / lanes;
  const int lane = tid - pl * lanes;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * (P >> tw_log2);
  const int xi = x0 + (pl & (tw - 1));
  const int yi = y0 + (pl >> tw_log2);
  const int n = blockIdx.y;
  const bool live = xi < W && yi < H;
  const int hw = H * W;
  const int pix = live ? yi * W + xi : 0;

  const int c0 = c_off + lane * K;
  const int cg = C / G;
  const int grp = c0 / cg;              // K divides cg: one group per thread
  const float inv_cg = 1.0f / static_cast<float>(cg);

  const float* m = rt + static_cast<size_t>(n) * 12;
  const float* dep_n = depth + static_cast<size_t>(n) * D * hw;
  const float* g_p =
      g + (static_cast<size_t>(n) * G + grp) * D * static_cast<size_t>(hw) +
      pix;
  const size_t img = static_cast<size_t>(n) * Hs * Ws * C + c0;
  const float* s_img = src + img;
  float* ds_img = d_src + img;
  const size_t ref_off = (static_cast<size_t>(n) * hw + pix) * C + c0;
  Vec<K> r;
  if (live) {
    r = load_k<K>(ref + ref_off);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) r.v[k] = 0.0f;
  }
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  // each corner slot's d_src sum is held in registers while the sample
  // stays on the same source pixel from plane to plane (hk: that pixel,
  // -1 for none), and added to d_src when it moves on
  int hk[4] = {-1, -1, -1, -1};
  float hv[4][K];

  for (int d0 = 0; d0 < D; d0 += db) {
    const int nb = min(db, D - d0);
    if (d0 > 0) __syncthreads();          // the last batch's samples are read
    for (int j = tid; j < nb * P; j += blockDim.x) {
      const int p = j & (P - 1);
      const int x = x0 + (p & (tw - 1));
      const int y = y0 + (p >> tw_log2);
      recs[j] = (x < W && y < H)
                    ? warp_geom::pack(
                          warp_geom::locate(
                              m, static_cast<float>(x),
                              static_cast<float>(y),
                              dep_n[static_cast<size_t>(d0 + (j >> p_log2)) *
                                        hw +
                                    y * W + x],
                              Hs, Ws),
                          Ws)
                    : warp_geom::SampleRec{0.0f, 0.0f, 0, 0u};
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < nb; ++k) {
      const warp_geom::Sample s = warp_geom::unpack(recs[k * P + pl], Ws);
      if (!s.inside) continue;
      const float gd = g_p[static_cast<size_t>(d0 + k) * hw] * inv_cg;

      // d_ref: the forward's sample, re-read
      const Vec<K> a = load_or_zero<K>(s.v00, s_img + size_t(s.i00) * C);
      const Vec<K> b = load_or_zero<K>(s.v01, s_img + size_t(s.i01) * C);
      const Vec<K> e = load_or_zero<K>(s.v10, s_img + size_t(s.i10) * C);
      const Vec<K> f = load_or_zero<K>(s.v11, s_img + size_t(s.i11) * C);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        acc[q] += gd * bilerp(a.v[q], b.v[q], e.v[q], f.v[q], s.wx, s.wy);
      }

      // d_src: the weighted cotangent into the in-image corners
      const float ux = 1.0f - s.wx, uy = 1.0f - s.wy;
      const float wq[4] = {ux * uy, s.wx * uy, ux * s.wy, s.wx * s.wy};
      const bool vq[4] = {s.v00, s.v01, s.v10, s.v11};
      const int iq[4] = {s.i00, s.i01, s.i10, s.i11};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!vq[q]) continue;
        if (iq[q] != hk[q]) {
          if (hk[q] >= 0) {
            global_add<K>(ds_img + static_cast<size_t>(hk[q]) * C, hv[q]);
          }
          hk[q] = iq[q];
#pragma unroll
          for (int k2 = 0; k2 < K; ++k2) hv[q][k2] = 0.0f;
        }
#pragma unroll
        for (int k2 = 0; k2 < K; ++k2) hv[q][k2] += wq[q] * (gd * r.v[k2]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (hk[q] >= 0) {
        global_add<K>(ds_img + static_cast<size_t>(hk[q]) * C, hv[q]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) d_ref[ref_off + k] = acc[k];
  }
}

// one launch for channels [c_off, c_off + cs) of the c, cs / K <= kThreads
template <int K>
int launch_k(const float* src, const float* ref, const float* depth,
             const float* rt, const float* g, float* d_src, float* d_ref,
             int n, int d, int h, int w, int hs, int ws, int c, int groups,
             int c_off, int cs, cudaStream_t stream) {
  const int lanes = cs / K;
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // P: the largest power of two with P * lanes <= kThreads; tile tw x th
  int p_log2 = 0;
  while ((2 << p_log2) * lanes <= kThreads) ++p_log2;
  const int tw_log2 = (p_log2 + 1) / 2;
  const int tw = 1 << tw_log2;
  const int th = 1 << (p_log2 - tw_log2);
  const int tiles_x = (w + tw - 1) / tw;
  const long long tiles =
      static_cast<long long>(tiles_x) * ((h + th - 1) / th);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // planes per batch: their samples take at most kRecBytes
  const size_t rec = sizeof(warp_geom::SampleRec) << p_log2;
  const int db = max(1, min(d, static_cast<int>(kRecBytes / rec)));
  const dim3 grid(static_cast<unsigned>(tiles), n);
  warp_corr_bwd_kernel<K><<<grid, (1 << p_log2) * lanes, rec * db,
                            stream>>>(src, ref, depth, rt, g, d_src, d_ref,
                                      d, h, w, hs, ws, c, groups, c_off, cs,
                                      p_log2, tw_log2, tiles_x, db);
  return static_cast<int>(cudaGetLastError());
}

// every channel: launches of at most kThreads * K channels each (one
// launch unless C / K > 256, fewer than one pixel per block)
template <int K>
int launch(const float* src, const float* ref, const float* depth,
           const float* rt, const float* g, float* d_src, float* d_ref,
           int n, int d, int h, int w, int hs, int ws, int c, int groups,
           cudaStream_t stream) {
  for (int c_off = 0; c_off < c; c_off += kThreads * K) {
    const int err = launch_k<K>(src, ref, depth, rt, g, d_src, d_ref, n, d,
                                h, w, hs, ws, c, groups, c_off,
                                min(kThreads * K, c - c_off), stream);
    if (err != 0) return err;
  }
  return 0;
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
