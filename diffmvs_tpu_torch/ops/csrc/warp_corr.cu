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
// Width shards (parallel/spatial.py): ref, depth and out hold a shard's
// columns, and x_off is the global column of its first one; ref pixel x
// projects from column x + x_off (exact in f32 below 2^24), and src is the
// full-width source, wider than ref. x_off = 0 is the unsharded map.
//
// What bounds it on an H100. Compulsory HBM bytes are small (each input
// read once, the output written once: 38.7 MB at the DTU sweep, D = 48,
// C = 48, 144x200, f32), but every (plane, pixel) sample reads 4 corners
// x C channels (~1.06 GB there) through L1, at ~128 B per clock per SM: a
// floor of ~0.03 ms. The kernel before this design took each sample on
// one thread, so a warp's 16-byte load touched 32 channel rows, and it
// reread ref at every plane. Design: the block-tiled forward of
// warp_geom.cuh (corr_kernel), shared with K3, whose notes give it; here
// its samples are computed in the kernel from depth and the 12 projection
// scalars (no coordinate arrays in memory).
// What bounds it now, from times on the card (the profiler's counters are
// not available there): not HBM (L2-cold times within a few percent of
// warm ones), not bytes (bf16 features, half the bytes, are ~2 % faster
// than f32 at the sweep), not the FP32 pipes (half the FP work per channel
// gained ~4 %), not the tiles' L2 refetch (8x8 or 32x2 tiles within 2 %),
// not the block count (4x more blocks, planes split finer: slower). Left
// is the latency of each plane's dependent chain (sample, corner loads,
// sums) at 3-4 resident blocks per SM; so the source footprint is not
// staged in shared memory.
// The whole source image is read in place, so the kernel is exact
// everywhere: no window, no miss guard, no fallback.
//
// Coordinates, corners and validity come from warp_geom.cuh, which the
// backward kernel (warp_corr_bwd.cu) shares, so the two sample at the same
// coordinates bit for bit; they agree with plane_sweep_coords too, and the
// only differences left are in the channel sum order.

#include "warp_geom.cuh"

namespace {

// K1's samples: computed from depth [N, D, H, W] and the 12 projection
// scalars of each sample, rt [N, 12]; interpolated x first
struct SweepSamples {
  const float* depth;
  const float* rt;
  int x_off;            // the global column of the shard's first column

  struct Block {
    const float* m;       // the sample's 12 projection scalars
    const float* dep;     // its depths from plane d0 on
    int hw;
    int x_off;

    __device__ __forceinline__ warp_geom::SampleRec rec(int dd, int x, int y,
                                                        int W, int Hs,
                                                        int Ws) const {
      return warp_geom::pack(
          warp_geom::locate(m, static_cast<float>(x + x_off),
                            static_cast<float>(y),
                            dep[static_cast<size_t>(dd) * hw + y * W + x],
                            Hs, Ws),
          Ws);
    }
  };

  // the scalars stay in memory (L1) rather than in registers: held in 12
  // registers they pushed the float4 and uint4 instantiations from 64 to
  // 74-78 registers, 3 resident blocks per SM instead of 4
  __device__ __forceinline__ Block block(int n, int d0, int D,
                                         int hw) const {
    return Block{rt + static_cast<size_t>(n) * 12,
                 depth + (static_cast<size_t>(n) * D + d0) * hw, hw, x_off};
  }

  // bf16 at C/G = 4: two adjacent groups a thread (four timed slower at
  // stage 3 with per-pixel random depths)
  static constexpr int kBf16Groups4 = 2;

  static __device__ __forceinline__ float lerp(float v00, float v01,
                                               float v10, float v11,
                                               float wx, float wy) {
    return warp_geom::bilerp(v00, v01, v10, v11, wx, wy);
  }
};

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32 features,
// 1 = bfloat16 features; x_off: the column offset of a width shard (0 for
// a whole map). Returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_corr_forward(int dtype, const void* src, const void* ref,
                                 const void* depth, const void* rt, void* out,
                                 int n, int d, int h, int w, int hs, int ws,
                                 int c, int g, int x_off, void* stream) {
  return warp_geom::corr_forward(
      dtype, src, ref,
      SweepSamples{static_cast<const float*>(depth),
                   static_cast<const float*>(rt), x_off},
      static_cast<float*>(out), n, d, h, w, hs, ws, c, g,
      static_cast<cudaStream_t>(stream));
}
