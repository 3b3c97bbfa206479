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
// What bounds it on an H100. Compulsory HBM bytes are small (each input
// read once, the output written once: 38.7 MB at the DTU sweep, D = 48,
// C = 48, 144x200, f32), but every (plane, pixel) sample reads 4 corners
// x C channels (~1.06 GB there) through L1, at ~128 B per clock per SM: a
// floor of ~0.03 ms. The kernel before this design took each sample on
// one thread, so a warp's 16-byte load touched 32 channel rows, and it
// reread ref at every plane. Design:
//   * a block owns a 2-D tile of ref pixels and a chunk of planes; G / GPT
//     neighbouring threads share a pixel, GPT channel groups each (GPT =
//     2 where a group has at most 4 channels, else 1; a G above 256 is
//     taken in launches of 256 / GPT threads per pixel). The threads of a
//     pixel read each corner's channel row together, in one contiguous
//     run (16-byte loads: float4, or 8 bf16 as a uint4; 8- and 4-byte
//     bf16 loads and scalar loads where C/G or the bases do not allow
//     them), so a warp touches 8 rows per load, not 32. bf16 at C/G = 4
//     or 12 (stage 3, the sweep): a thread owns two adjacent groups, so
//     its uint4 loads run across both instead of narrower loads per group;
//   * each thread holds its groups' ref channels in registers for all the
//     block's planes (16 channels; a wider group is taken 16 channels at a
//     time, still exact) and loops over the planes: ref is read once per
//     chunk, not once per plane;
//   * the coordinates are computed in the kernel from depth and the 12
//     projection scalars (no coordinate arrays in memory), each (plane,
//     pixel) sample once per block, by all threads side by side, into
//     shared memory (warp_geom's 16-byte SampleRec), which the threads of
//     a pixel read back instead of each computing it;
//   * outputs are staged in shared memory as [G][planes][tile] and
//     written out as contiguous tile rows;
//   * the planes are split over blocks (grid.y) when the tiles alone would
//     leave the card's SMs short of blocks (N = 1 at the sweep, the
//     training sweep's small images).
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

using warp_geom::bilerp;

constexpr int kBlock = 256;      // threads per block at most: P x G / GPT
constexpr int kMaxCh = 16;       // ref channels a thread holds in registers
constexpr int kMaxPlanes = 16;   // planes per block (samples and sums
                                 // staged in shared memory)
constexpr size_t kSmemBytes = 48 * 1024;
constexpr int kTargetBlocks = 132 * 12;   // ~12 blocks per SM of an H100

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

// One block: a tile of P = 1 << p_log2 ref pixels, tw = 1 << tw_log2
// wide, of sample blockIdx.z, planes [blockIdx.y * dch, + dch), groups
// [g_off, g_off + gs) of the G. L = gs / GPT threads share a pixel: thread
// = pixel * L + l, owning the GPT groups g_off + l, + L, ... K channels per
// load; K divides C / G. PCG > 0 (bf16, GPT = 2, C / G = PCG): thread l owns
// the adjacent groups g_off + 2 l and + 1 instead.
template <typename T, int K, int GPT, int PCG>
__global__ void __launch_bounds__(kBlock)
warp_corr_kernel(const T* __restrict__ src, const T* __restrict__ ref,
                 const float* __restrict__ depth,
                 const float* __restrict__ rt, float* __restrict__ out,
                 int D, int H, int W, int Hs, int Ws, int C, int G,
                 int g_off, int gs, int p_log2, int tw_log2, int tiles_x,
                 int dch) {
  constexpr int kCh = kMaxCh / GPT;       // channels of a group in registers
  // shared: the block's samples [dch][P], then its sums [gs][dch][P]
  extern __shared__ float4 smem[];
  warp_geom::SampleRec* recs = reinterpret_cast<warp_geom::SampleRec*>(smem);
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
  const float* m = rt + static_cast<size_t>(n) * 12;

  // every (plane, pixel) sample of the block, once
  const float* dep_n = depth + (static_cast<size_t>(n) * D + d0) * hw;
  for (int j = tid; j < nd * P; j += blockDim.x) {
    const int p = j & (P - 1);
    const int x = x0 + (p & (tw - 1));
    const int y = y0 + (p >> tw_log2);
    recs[j] = (x < W && y < H)
                  ? warp_geom::pack(
                        warp_geom::locate(
                            m, static_cast<float>(x), static_cast<float>(y),
                            dep_n[static_cast<size_t>(j >> p_log2) * hw +
                                  y * W + x],
                            Hs, Ws),
                        Ws)
                  : warp_geom::SampleRec{0.0f, 0.0f, 0, 0u};
  }
  __syncthreads();

  const int L = gs / GPT;
  const int pl = tid / L;                 // pixel of the tile
  const int l = tid - pl * L;
  const int xi = x0 + (pl & (tw - 1));
  const int yi = y0 + (pl >> tw_log2);
  if (xi < W && yi < H && PCG > 0) {
    // bf16 at C/G = PCG: the thread's two groups, g_off + 2 l and + 1, are
    // adjacent, so its 16-byte loads of 8 channels run across both
    constexpr int kPcg = PCG > 0 ? PCG : 4;
    constexpr int kRun = 2 * kPcg;
    const T* s_img = src + static_cast<size_t>(n) * Hs * Ws * C;
    const int c0 = (g_off + 2 * l) * kPcg;
    const T* r_p = ref + (static_cast<size_t>(n) * hw + yi * W + xi) * C + c0;
    float r[kRun];
#pragma unroll
    for (int j = 0; j < kRun; j += 8) load_k<8>(r_p + j, r + j);
    for (int dd = 0; dd < nd; ++dd) {
      const warp_geom::Sample s = warp_geom::unpack(recs[dd * P + pl], Ws);
      float acc[2] = {0.0f, 0.0f};
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
            acc[(j + k) / kPcg] +=
                bilerp(a[k], b[k], e[k], f[k], s.wx, s.wy) * r[j + k];
          }
        }
      }
      stage[(static_cast<size_t>(2 * l) * dch + dd) * P + pl] = acc[0];
      stage[(static_cast<size_t>(2 * l + 1) * dch + dd) * P + pl] = acc[1];
    }
  } else if (xi < W && yi < H) {
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
        const warp_geom::Sample s = warp_geom::unpack(recs[dd * P + pl], Ws);
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
                  acc[i] += bilerp(a[k], b[k], e[k], f[k], s.wx, s.wy) *
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
template <typename T, int K, int GPT, int PCG>
int launch_k(const void* src, const void* ref, const float* depth,
             const float* rt, float* out, int n, int d, int h, int w, int hs,
             int ws, int c, int g, int g_off, int gs, cudaStream_t stream) {
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
  const size_t per_plane =
      (sizeof(warp_geom::SampleRec) + sizeof(float) * gs) << p_log2;
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
  warp_corr_kernel<T, K, GPT, PCG>
      <<<grid, lanes << p_log2, per_plane * dch, stream>>>(
          static_cast<const T*>(src), static_cast<const T*>(ref), depth, rt,
          out, d, h, w, hs, ws, c, g, g_off, gs, p_log2, tw_log2, tiles_x,
          dch);
  return static_cast<int>(cudaGetLastError());
}

// every group: launches of at most kBlock * GPT groups each (one launch
// unless G > 256, fewer than one group per thread)
template <typename T, int K, int GPT, int PCG = 0>
int launch_groups(const void* src, const void* ref, const float* depth,
                  const float* rt, float* out, int n, int d, int h, int w,
                  int hs, int ws, int c, int g, cudaStream_t stream) {
  for (int g_off = 0; g_off < g; g_off += kBlock * GPT) {
    const int err = launch_k<T, K, GPT, PCG>(
        src, ref, depth, rt, out, n, d, h, w, hs, ws, c, g, g_off,
        min(kBlock * GPT, g - g_off), stream);
    if (err != 0) return err;
  }
  return 0;
}

// groups per thread: two where a group has at most 4 channels (stage 3's
// C/G = 4), so that a thread has 8 channels' work per sample to set
// against the sample's unpacking and its output store; one otherwise
template <typename T, int K>
int launch(const void* src, const void* ref, const float* depth,
           const float* rt, float* out, int n, int d, int h, int w, int hs,
           int ws, int c, int g, cudaStream_t stream) {
  if constexpr (K <= 4) {
    if (g % 2 == 0 && c / g <= 4) {
      return launch_groups<T, K, 2>(src, ref, depth, rt, out, n, d, h, w, hs,
                                    ws, c, g, stream);
    }
  }
  return launch_groups<T, K, 1>(src, ref, depth, rt, out, n, d, h, w, hs, ws,
                                c, g, stream);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32 features,
// 1 = bfloat16 features. Returns the cudaError_t of the launch (0 = ok).
extern "C" int warp_corr_forward(int dtype, const void* src, const void* ref,
                                 const void* depth, const void* rt, void* out,
                                 int n, int d, int h, int w, int hs, int ws,
                                 int c, int g, void* stream) {
  if (n == 0 || d == 0 || h == 0 || w == 0) return 0;
  if (g <= 0 || c % g != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dp = static_cast<const float*>(depth);
  const float* rp = static_cast<const float*>(rt);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cg = c / g;
  if (dtype == 0) {
    if (cg % 4 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch<float, 4>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c,
                                g, st);
    }
    return launch<float, 1>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c,
                              g, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (cg % 8 == 0 && aligned(src, 16) && aligned(ref, 16)) {
      return launch<bf, 8>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c, g,
                             st);
    }
    // C/G = 4 or 12: two adjacent groups per thread, 16-byte loads
    if ((cg == 4 || cg == 12) && g % 2 == 0 && aligned(src, 16) &&
        aligned(ref, 16)) {
      return cg == 4 ? launch_groups<bf, 8, 2, 4>(src, ref, dp, rp, op, n, d,
                                                  h, w, hs, ws, c, g, st)
                     : launch_groups<bf, 8, 2, 12>(src, ref, dp, rp, op, n,
                                                   d, h, w, hs, ws, c, g, st);
    }
    if (cg % 4 == 0 && aligned(src, 8) && aligned(ref, 8)) {
      return launch<bf, 4>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c, g,
                             st);
    }
    if (cg % 2 == 0 && aligned(src, 4) && aligned(ref, 4)) {
      return launch<bf, 2>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c, g,
                             st);
    }
    return launch<bf, 1>(src, ref, dp, rp, op, n, d, h, w, hs, ws, c, g,
                           st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
