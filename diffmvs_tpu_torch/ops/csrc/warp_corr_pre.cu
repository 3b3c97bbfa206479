// Warp + group correlation from precomputed corner operands (K3), forward,
// and the kernel that computes those operands, for Hopper (sm_90a).
//
// K3 replaces diffmvs_tpu/ops/pallas/warp_corr.py:55 `_corr_kernel` (the
// TPU kernel reached through warp_corr_pallas(..., batch_rows=False)). It
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
//     out[n, g, d, p] = sum over the C/G channels c of group g, in channel
//                       order, of w[c] * ref[n, p, c], times 1 / (C/G)
//
// The TPU kernel interpolates in that order (y first, then x: its band rows
// are summed with the weights (1 - fy, fy) before the x-lerp), and so does
// this kernel, with explicit round-to-nearest intrinsics; K1 (warp_corr.cu)
// interpolates x first. bf16 features are upcast on load and summed like
// f32 ones, at every C/G, as the TPU kernel's default (unpacked) mode does.
//
// Layouts: src [N, Hs, Ws, C], ref [N, H, W, C] channels-last (f32 or
// bf16), xi/yi int32, fx/fy f32 and valid uint8 (0/1), each [N, D, H, W];
// out [N, G, D, H, W] f32, returned by the wrapper as a [N, D, H, W, G]
// view (K1's layout).
//
// What bounds it on an H100: as K1, the ~1 GB of corner requests through
// L1/L2 at the sweep, not its compulsory bytes (the output once, src, ref
// and 17 bytes of operands per (plane, pixel) once). Design: the block-tiled
// forward of warp_geom.cuh (corr_kernel), which K1 instantiates too: the
// threads of a pixel read each corner's channel row together, ref stays in
// registers across the block's planes, outputs are staged and written as
// tile rows. Each (plane, pixel) operand set is loaded once per block,
// coalesced, into a 16-byte SampleRec in shared memory (CornerSamples
// below). The source's zero padding is virtual (each corner is checked
// against the image), so no padded copy is made, and the whole source is
// read in place: no window, band or guard.
//
// The operand kernel (warp_corr_operands) writes (xi, yi, fx, fy, valid)
// from the depths and the 12 projection scalars of each sample, with
// warp_geom's sweep_xy (the coordinates K1 and K2 sample at) and the
// semantics of ops/warp_corr.corner_split: validity decided in float
// before any integer cast, invalid samples carrying zeros. Bytes bound it:
// 4 read and 17 written per (plane, pixel), one thread each, every load
// and store coalesced.
//
// Do not build with --use_fast_math (approximate division).

#include "warp_geom.cuh"

namespace {

// K3's samples: read from the operands [N, D, H, W]; interpolated y first
struct CornerSamples {
  const int* xi;
  const int* yi;
  const float* fx;
  const float* fy;
  const uint8_t* valid;

  struct Block {         // the operands of one sample from plane d0 on
    const int* xi;
    const int* yi;
    const float* fx;
    const float* fy;
    const uint8_t* valid;
    int hw;

    __device__ __forceinline__ warp_geom::SampleRec rec(int dd, int x, int y,
                                                        int W, int Hs,
                                                        int Ws) const {
      using namespace warp_geom;
      const size_t o = static_cast<size_t>(dd) * hw + y * W + x;
      if (!__ldg(valid + o)) return SampleRec{0.0f, 0.0f, 0, 0u};
      // padded corner index xi is the original x1; x0 = xi - 1. Each
      // corner is checked against the image, so any operands read safely.
      const int x1 = __ldg(xi + o), y1 = __ldg(yi + o);
      const int x0 = x1 - 1, y0 = y1 - 1;
      const bool vx0 = x0 >= 0 && x0 <= Ws - 1;
      const bool vx1 = x1 >= 0 && x1 <= Ws - 1;
      const bool vy0 = y0 >= 0 && y0 <= Hs - 1;
      const bool vy1 = y1 >= 0 && y1 <= Hs - 1;
      const int xa = min(max(x0, 0), Ws - 1), xb = min(max(x1, 0), Ws - 1);
      const int ya = min(max(y0, 0), Hs - 1), yb = min(max(y1, 0), Hs - 1);
      const unsigned f = kRecInside | (vy0 && vx0 ? kRecV00 : 0u) |
                         (vy0 && vx1 ? kRecV01 : 0u) |
                         (vy1 && vx0 ? kRecV10 : 0u) |
                         (vy1 && vx1 ? kRecV11 : 0u) |
                         (xb != xa ? kRecDx : 0u) | (yb != ya ? kRecDy : 0u);
      return SampleRec{__ldg(fx + o), __ldg(fy + o), xa,
                       static_cast<unsigned>(ya) | f << 25};
    }
  };

  __device__ __forceinline__ Block block(int n, int d0, int D,
                                         int hw) const {
    const size_t o = (static_cast<size_t>(n) * D + d0) * hw;
    return Block{xi + o, yi + o, fx + o, fy + o, valid + o, hw};
  }

  // bf16 at C/G = 4: four adjacent groups a thread, two 16-byte loads a
  // corner (timed faster than two at stage 3 with smooth depths)
  static constexpr int kBf16Groups4 = 4;

  // the TPU kernel's order: the two y-lerps (1 - fy) * top + fy * bottom,
  // then left + (right - left) * fx
  static __device__ __forceinline__ float lerp(float v00, float v01,
                                               float v10, float v11,
                                               float fx, float fy) {
    const float gy = __fsub_rn(1.0f, fy);
    const float left = __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy));
    const float right = __fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy));
    return __fadd_rn(left, __fmul_rn(__fsub_rn(right, left), fx));
  }
};

// ---- the projection src <- ref of each sample: rt [N, 12] (rot row-major,
// then trans) as geometry/transforms.relative_projection computes it, op
// by op, on the card. Its matrix products are _mm's chain: the first
// product rounded to f32, then each step f32(f64(a b) + f64(acc)), the
// product exact in f64 (the float64 emulation of a fused multiply-add
// that the plain code runs, with the same double rounding).

__device__ __forceinline__ float mm_step(float acc, float a, float b) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(acc)));
}

// out = a @ b by _mm's chain over the inner index in ascending order
template <int I, int K, int J>
__device__ __forceinline__ void mm(const float (&a)[I][K],
                                   const float (&b)[K][J],
                                   float (&out)[I][J]) {
#pragma unroll
  for (int i = 0; i < I; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float acc = __double2float_rn(__dmul_rn(static_cast<double>(a[i][0]),
                                              static_cast<double>(b[0][j])));
#pragma unroll
      for (int k = 1; k < K; ++k) acc = mm_step(acc, a[i][k], b[k][j]);
      out[i][j] = acc;
    }
  }
}

// one thread per sample; pairs [N, 2, 4, 4] f32 (extrinsic, intrinsic)
__global__ void projection_kernel(const float* __restrict__ src_pair,
                                  const float* __restrict__ ref_pair,
                                  float* __restrict__ rt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* sp = src_pair + static_cast<size_t>(i) * 32;
  const float* rp = ref_pair + static_cast<size_t>(i) * 32;
  float e_src[4][4], k_src[3][3], r_t[3][3], t_ref[3][1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) e_src[r][c] = sp[r * 4 + c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      k_src[r][c] = sp[16 + r * 4 + c];
      r_t[r][c] = rp[c * 4 + r];          // the ref rotation, transposed
    }
    t_ref[r][0] = rp[r * 4 + 3];
  }
  // invert_rigid(e_ref) = [[R^T, -R^T t], [0, 0, 0, 1]]
  float r_t_t[3][1];
  mm(r_t, t_ref, r_t_t);
  float inv[4][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) inv[r][c] = r_t[r][c];
    inv[r][3] = -r_t_t[r][0];
  }
  inv[3][0] = inv[3][1] = inv[3][2] = 0.0f;
  inv[3][3] = 1.0f;
  float e_rel[4][4];
  mm(e_src, inv, e_rel);
  float rel_r[3][3], rel_t[3][1];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rel_r[r][c] = e_rel[r][c];
    rel_t[r][0] = e_rel[r][3];
  }
  // invert_intrinsics(k_ref): 1 / f as reciprocal(f) * 1.0, then the
  // products in the plain code's order
  const float fx = rp[16], s = rp[17], cx = rp[18], fy = rp[21], cy = rp[22];
  const float inv_fx = __fmul_rn(__fdiv_rn(1.0f, fx), 1.0f);
  const float inv_fy = __fmul_rn(__fdiv_rn(1.0f, fy), 1.0f);
  const float k_inv[3][3] = {
      {inv_fx, __fmul_rn(__fmul_rn(-s, inv_fx), inv_fy),
       __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(s, cy), __fmul_rn(cx, fy)),
                           inv_fx),
                 inv_fy)},
      {0.0f, inv_fy, __fmul_rn(-cy, inv_fy)},
      {0.0f, 0.0f, 1.0f}};
  float k_r[3][3], rot[3][3], trans[3][1];
  mm(k_src, rel_r, k_r);
  mm(k_r, k_inv, rot);
  mm(k_src, rel_t, trans);
  float* out = rt + static_cast<size_t>(i) * 12;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r * 3 + c] = rot[r][c];
    out[9 + r] = trans[r][0];
  }
}

constexpr int kOpThreads = 256;

// one thread per (n, d, pixel): grid (pixel blocks, D, N)
__global__ void __launch_bounds__(kOpThreads)
operands_kernel(const float* __restrict__ depth, const float* __restrict__ rt,
                int* __restrict__ xi, int* __restrict__ yi,
                float* __restrict__ fx, float* __restrict__ fy,
                uint8_t* __restrict__ valid, int D, int H, int W, int Hs,
                int Ws) {
  const int hw = H * W;
  const int pix = blockIdx.x * kOpThreads + threadIdx.x;
  if (pix >= hw) return;
  const int n = blockIdx.z;
  const size_t o = (static_cast<size_t>(n) * D + blockIdx.y) * hw + pix;
  const int y = pix / W;
  const int x = pix - y * W;
  const float2 s =
      warp_geom::sweep_xy(rt + static_cast<size_t>(n) * 12,
                          static_cast<float>(x), static_cast<float>(y),
                          depth[o]);
  const float x0f = floorf(s.x);
  const float y0f = floorf(s.y);
  const bool ok = warp_geom::in_reach(x0f, y0f, Hs, Ws);
  xi[o] = ok ? static_cast<int>(x0f) + 1 : 0;
  yi[o] = ok ? static_cast<int>(y0f) + 1 : 0;
  fx[o] = ok ? __fsub_rn(s.x, x0f) : 0.0f;
  fy[o] = ok ? __fsub_rn(s.y, y0f) : 0.0f;
  valid[o] = ok;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32 features,
// 1 = bfloat16 features (any C/G, any alignment). Returns the cudaError_t
// of the launch (0 = ok).
extern "C" int warp_corr_pre_forward(int dtype, const void* src,
                                     const void* ref, const void* xi,
                                     const void* yi, const void* fx,
                                     const void* fy, const void* valid,
                                     void* out, int n, int d, int h, int w,
                                     int hs, int ws, int c, int g,
                                     void* stream) {
  return warp_geom::corr_forward(
      dtype, src, ref,
      CornerSamples{static_cast<const int*>(xi), static_cast<const int*>(yi),
                    static_cast<const float*>(fx),
                    static_cast<const float*>(fy),
                    static_cast<const uint8_t*>(valid)},
      static_cast<float*>(out), n, d, h, w, hs, ws, c, g,
      static_cast<cudaStream_t>(stream));
}

// (xi, yi, fx, fy, valid), each [N, D, H, W], from depth [N, D, H, W] and
// rt [N, 12] for a source image of hs x ws.
extern "C" int warp_corr_operands(const void* depth, const void* rt,
                                  void* xi, void* yi, void* fx, void* fy,
                                  void* valid, int n, int d, int h, int w,
                                  int hs, int ws, void* stream) {
  if (n == 0 || d == 0 || h == 0 || w == 0) return 0;
  if (n > 65535 || d > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hw = h * w;
  const dim3 grid((hw + kOpThreads - 1) / kOpThreads, d, n);
  operands_kernel<<<grid, kOpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(rt),
      static_cast<int*>(xi), static_cast<int*>(yi), static_cast<float*>(fx),
      static_cast<float*>(fy), static_cast<uint8_t*>(valid), d, h, w, hs, ws);
  return static_cast<int>(cudaGetLastError());
}

// rt [N, 12] from src_pair, ref_pair [N, 2, 4, 4], contiguous f32.
extern "C" int warp_corr_projection(const void* src_pair, const void* ref_pair,
                                    void* rt, int n, void* stream) {
  if (n == 0) return 0;
  constexpr int kThreads = 128;
  projection_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src_pair), static_cast<const float*>(ref_pair),
      static_cast<float*>(rt), n);
  return static_cast<int>(cudaGetLastError());
}
