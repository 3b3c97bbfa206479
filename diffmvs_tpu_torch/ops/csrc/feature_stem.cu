// FeatureNet's full-resolution stem in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves FeatureNet's convolutions
// to XLA (diffmvs_tpu/nn/feature.py, its plain branch), and the port ran
// the stem as ten launches of cuDNN convolutions, eval BatchNorms, ReLUs
// and the image's cast, each a pass over device memory. It computes, for
// each image x [H, W, 3] of the batch (channels last, float32),
//
//   a0  = relu(bn0(conv(bf16(x), w0)))    3x3, 3 -> 8, padding 1
//   c0  = relu(bn1(conv(a0, w1)))         3x3, 8 -> 8, padding 1
//   out = relu(bn2(conv(c0, w2)))         5x5, 8 -> 16, stride 2, padding 2
//
// FeatureNet's conv0[0], conv0[1] and conv1[0] at inference: each bn is
// BatchNorm in eval form from the module's running statistics,
// (v - mean) / sqrt(var + eps) * gamma + beta, and each conv's padding is
// zeros in its own input at the image border (so a0 and c0 are zero
// outside the image, not computed from a padded image). Precision: the
// module's bf16 policy. The image and the weights are rounded to bf16 as
// the module casts them (round to nearest even), the products are summed
// in float32 on the tensor cores, BatchNorm and ReLU are applied to the
// float32 sum, and each layer's result is rounded once to bf16 (the module
// rounds twice: the conv's output, then BatchNorm's). out is [H', W', 16]
// bf16, channels last, H' = ceil(H / 2), W' = ceil(W / 2).
//
// What bounds it on an H100. The three layers are 3184 FLOP a full-res
// pixel on tensor cores (0.47 TFLOP for 80 images of 1152 x 1600: 0.47 ms
// at 989 TFLOP/s), against 12 bytes read and 8 written a pixel: 2.95 GB,
// 0.88 ms at 3.35 TB/s. So bytes bound it, and the design keeps the two
// 8-channel full-resolution maps out of device memory:
//   * one block owns an output tile of kTY x kTX half-res pixels of one
//     image (the last row and column of tiles masked), and loops over the
//     tiles of the batch (a persistent grid of as many blocks as fit the
//     card), so the weights are staged once a block, and the next tile's
//     image patch is loaded into registers while this one is computed;
//   * the patch, (2 kTY + 7) x (2 kTX + 7) pixels, rounded to bf16, sits
//     in shared memory as 4 channels (the 4th zero: 8 bytes a pixel);
//   * conv0[0] on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums): M
//     = 16 pixels of the flattened a0 tile, one k16 step a kernel row (K
//     = 4 columns x 4 channels, the 4th of each zero), N = 8; A is read
//     as 32-bit words (2 channels) at fixed offsets from each row's pixel;
//     a0 is stored as 8 bf16 channels (16 bytes) a pixel;
//   * conv0[1]: K = 9 taps x 8 channels (4 k16 steps and one k8), A by
//     ldmatrix straight from a0 (one 16-byte row a pixel and tap); c0 is
//     stored with its even and odd columns in two planes, so that the
//     stride-2 taps of the next conv read 8 consecutive 16-byte rows;
//   * conv1[0]: each warp 4 tiles of 16 output pixels, N = 16 (two n8
//     tiles), K = 25 taps x 8 channels (12 k16 steps and one k8), the
//     weights' fragments read once a k step for the four tiles; the
//     result goes through shared memory to 16-byte stores of whole
//     pixels (32 bytes each);
//   * the two full-res convs are bound by the instructions around their
//     MMAs, not by the MMAs: each warp works on two m16 tiles at once,
//     BatchNorm's scale and shift are one FMA, ReLU and the rounding one
//     cvt, and only tiles that reach the image's border test which pixels
//     lie outside it;
//   * the patch shares its shared memory with c0, the output staging
//     with a0: ~88 KB a block, 2 blocks an SM (128 registers a thread).
// wgmma does not pay at N = 8 / 16; mma.sync is the tool here. On an H100
// (SXM, 700 W) at 80 images of 1152 x 1600: 3.55 ms (25 % of the bytes
// bound); without the interior path and the one-cvt epilogue 4.2 ms, with
// one m16 tile a warp and no prefetch 4.5 ms. Taking a phase out at a
// time: conv0[0] ~1.5 ms, conv0[1] ~1.5, conv1[0] ~0.6, the loads and
// stores alone 1.1 (timed before the interior path).
//
// Rounding: the products of bf16 values are exact in float32 and summed in
// another order than cuDNN's, and one rounding a layer replaces two, so
// results differ from the module's bf16 path by bf16 rounding only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTY = 16;                    // output tile rows (half res)
constexpr int kTX = 32;                    // output tile columns
constexpr int kC0H = 2 * kTY + 3;          // c0 tile: 35 x 67
constexpr int kC0W = 2 * kTX + 3;
constexpr int kA0H = kC0H + 2;             // a0 tile: 37 x 69
constexpr int kA0W = kC0W + 2;
constexpr int kImH = kA0H + 2;             // image patch: 39 x 71
constexpr int kImW = kA0W + 2;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kA0Pix = kA0H * kA0W;
constexpr int kC0Pix = kC0H * kC0W;
constexpr int kImPix = kImH * kImW;
constexpr int kA0Tiles = (kA0Pix + 15) / 16;   // m16 tiles of conv0[0]
constexpr int kC0Tiles = (kC0Pix + 15) / 16;   // m16 tiles of conv0[1]
constexpr int kImIters = (kImPix + kThreads - 1) / kThreads;
constexpr int kIlp = 2;                    // m16 tiles a warp works on at
                                           // once in conv0[0] and conv0[1]
// a c0 row: its even columns, then its odd ones, each plane kPlane
// entries of 16 bytes (34 used); 36 puts the two planes 16 banks apart
constexpr int kPlane = 36;
constexpr int kC0Row = 2 * kPlane;
static_assert(kTY == 2 * kWarps, "conv1[0]: each warp takes two rows");
static_assert(kTX == 32, "conv1[0]: two m16 tiles a row");
static_assert((kC0W + 1) / 2 <= kPlane, "c0 plane too narrow");
// k steps of the three convs
constexpr int kK0 = 3;                     // conv0[0]: 3 x k16 (12 taps)
constexpr int kK1 = 5;                     // conv0[1]: 4 x k16 + 1 x k8
constexpr int kK2 = 13;                    // conv1[0]: 12 x k16 + 1 x k8
// shared memory, bytes: a0 (the output staging aliases it), c0 (the
// image patch aliases it), the weights' fragments ([step][lane] uint2 for
// conv0[0] and conv0[1], [step][n tile][lane] for conv1[0]) and the
// BatchNorms' scale and shift ([32] float2: 8 + 8 + 16 channels)
constexpr int kA0Bytes = kA0Pix * 16;
constexpr int kC0Bytes = kC0H * kC0Row * 16;
// the patch and one zero pixel past it (the last pixel's 4th kernel
// column, whose weights are zero, reads it)
constexpr int kImBytes = (kImPix + 1) * 8;
constexpr int kOutBytes = kTY * kTX * 32;
constexpr int kC0Region = kC0Bytes > kImBytes ? kC0Bytes : kImBytes;
constexpr int kW0Off = kA0Bytes + kC0Region;
constexpr int kW1Off = kW0Off + kK0 * 32 * 8;
constexpr int kW2Off = kW1Off + kK1 * 32 * 8;
constexpr int kBnOff = kW2Off + kK2 * 2 * 32 * 8;
constexpr int kBytes = kBnOff + 32 * 8;
static_assert(kOutBytes <= kA0Bytes, "output staging exceeds a0");
static_assert(kA0Bytes % 16 == 0 && kC0Region % 16 == 0, "alignment");

struct Args {
  const float* x;                          // [N, H, W, 3]
  const float* wt[3];                      // [8,3,3,3] [8,8,3,3] [16,8,5,5]
  const float* mean[3];
  const float* var[3];
  const float* gamma[3];
  const float* beta[3];
  float eps[3];
  __nv_bfloat16* out;                      // [N, H', W', 16]
  int n, h, w, ho, wo, tiles_x, tiles_y;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// BatchNorm (scale, shift) of two channels, ReLU and bf16 in one
// conversion (cvt .relu: negatives to 0, NaN kept), as a pair
__device__ __forceinline__ uint32_t bn_relu_bf16(float v0, float v1,
                                                 float2 b0, float2 b1) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n"
      : "=r"(r)
      : "f"(fmaf(v1, b1.x, b1.y)), "f"(fmaf(v0, b0.x, b0.y)));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma1688(float* c, const uint32_t* a,
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// one bf16 pair of a weight fragment: w[(co * ci_n + ci) * taps + tap] for
// ci and ci + 1, zero past the channels or the taps (torch's [co][ci][kh]
// [kw], tap = kh * k + kw)
__device__ __forceinline__ uint32_t weight_pair(const float* w, int co,
                                                int ci, int ci_n, int tap,
                                                int taps) {
  float v0 = 0.f, v1 = 0.f;
  if (tap < taps) {
    if (ci < ci_n) v0 = w[(co * ci_n + ci) * taps + tap];
    if (ci + 1 < ci_n) v1 = w[(co * ci_n + ci + 1) * taps + tap];
  }
  return pack_bf16(v0, v1);
}

template <bool B>
struct Edge {                              // a tile that reaches the border
  static constexpr bool value = B;
};

__global__ void __launch_bounds__(kThreads, 2)
feature_stem_conv_kernel(Args a) {
  extern __shared__ uint4 smem4[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(smem4);
  uint32_t* const a0_w = reinterpret_cast<uint32_t*>(smem);
  uint32_t* const c0_w = reinterpret_cast<uint32_t*>(smem + kA0Bytes);
  uint2* const im_s = reinterpret_cast<uint2*>(smem + kA0Bytes);
  uint2* const w0_s = reinterpret_cast<uint2*>(smem + kW0Off);
  uint2* const w1_s = reinterpret_cast<uint2*>(smem + kW1Off);
  uint2* const w2_s = reinterpret_cast<uint2*>(smem + kW2Off);
  float2* const bn_s = reinterpret_cast<float2*>(smem + kBnOff);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // mma fragment row / column
  const int t = lane & 3;                  // mma fragment pair
  const int H = a.h, W = a.w;

  // ---- the weights' fragments and the BatchNorms, once a block -------
  // B fragment of an m16n8k16 step: b.x = rows 2t, 2t+1 (K) of column g
  // (N), b.y = rows 2t + 8, 2t + 9; of a k8 step b.x only
  for (int i = tid; i < kK0 * 32; i += kThreads) {
    // conv0[0]: step s = kernel row; K = column * 4 + channel, 4 columns
    // (3 real) x 4 channels (3 real)
    const int s = i >> 5, l = i & 31, gl = l >> 2, tl = l & 3;
    const int c = 2 * (tl & 1);
    w0_s[i] = make_uint2(
        weight_pair(a.wt[0], gl, c, 3, 3 * s + (tl >> 1), 9),
        tl < 2 ? weight_pair(a.wt[0], gl, c, 3, 3 * s + 2, 9) : 0u);
  }
  for (int i = tid; i < kK1 * 32; i += kThreads) {
    // conv0[1]: K = tap * 8 + channel; step s holds taps 2s and 2s + 1
    const int s = i >> 5, l = i & 31, gl = l >> 2, tl = l & 3;
    w1_s[i] = make_uint2(weight_pair(a.wt[1], gl, 2 * tl, 8, 2 * s, 9),
                         weight_pair(a.wt[1], gl, 2 * tl, 8, 2 * s + 1, 9));
  }
  for (int i = tid; i < kK2 * 64; i += kThreads) {
    // conv1[0]: K = tap * 8 + channel, 25 taps; n tile q: channels 8q ..
    const int s = i >> 6, q = (i >> 5) & 1, l = i & 31, gl = l >> 2,
              tl = l & 3;
    w2_s[i] = make_uint2(
        weight_pair(a.wt[2], 8 * q + gl, 2 * tl, 8, 2 * s, 25),
        weight_pair(a.wt[2], 8 * q + gl, 2 * tl, 8, 2 * s + 1, 25));
  }
  if (tid < 32) {
    const int layer = tid < 8 ? 0 : tid < 16 ? 1 : 2;
    const int c = tid < 16 ? tid & 7 : tid - 16;
    const float scale =
        a.gamma[layer][c] / sqrtf(a.var[layer][c] + a.eps[layer]);
    bn_s[tid] =
        make_float2(scale, a.beta[layer][c] - a.mean[layer][c] * scale);
  }
  // (the barrier after the first patch orders these stores)

  // ldmatrix rows: lane -> row (lane & 7) + 8 ((lane >> 3) & 1) of the
  // m16 tile, k half (lane >> 4) (the tap of the pair)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  const uint32_t a0_base = smem_addr(smem);
  const uint32_t c0_base = smem_addr(smem + kA0Bytes);

  const int tiles_img = a.tiles_x * a.tiles_y;
  const int total = a.n * tiles_img;
  // the image patch of a tile, in registers: 3 channels of kImIters
  // pixels a thread, zeros outside the image (conv0[0]'s padding); the
  // next tile's is loaded while this one is computed
  float v[kImIters][3];
  auto fetch = [&](int tile) {
    const int n = tile / tiles_img;
    const int rem = tile - n * tiles_img;
    const int imy = (rem / a.tiles_x) * kTY * 2 - 4;
    const int imx = (rem % a.tiles_x) * kTX * 2 - 4;
    const float* const img = a.x + static_cast<size_t>(n) * H * W * 3;
#pragma unroll
    for (int k = 0; k < kImIters; ++k) {
      const int i = tid + k * kThreads;
      const int y = i / kImW, x = i - (i / kImW) * kImW;
      const int Y = imy + y, X = imx + x;
      v[k][0] = v[k][1] = v[k][2] = 0.f;
      if (i < kImPix && static_cast<unsigned>(Y) < static_cast<unsigned>(H)
          && static_cast<unsigned>(X) < static_cast<unsigned>(W)) {
        const float* const p = img + (static_cast<size_t>(Y) * W + X) * 3;
        v[k][0] = __ldg(p);
        v[k][1] = __ldg(p + 1);
        v[k][2] = __ldg(p + 2);
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < total) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int n = tile / tiles_img;
    const int rem = tile - n * tiles_img;
    const int oy0 = (rem / a.tiles_x) * kTY;
    const int ox0 = (rem % a.tiles_x) * kTX;
    const int c0y = 2 * oy0 - 2, c0x = 2 * ox0 - 2;   // tiles' origins
    const int a0y = c0y - 1, a0x = c0x - 1;
    // whether the a0 tile (and so the c0 tile) reaches past the image:
    // only then are values outside it zeroed
    const bool edge = a0y < 0 || a0x < 0 || a0y + kA0H > H ||
                      a0x + kA0W > W;

    // ---- the image patch, bf16, 4 channels (the last zero) -----------
#pragma unroll
    for (int k = 0; k < kImIters; ++k) {
      const int i = tid + k * kThreads;
      if (i < kImPix) {
        im_s[i] = make_uint2(pack_bf16(v[k][0], v[k][1]),
                             pack_bf16(v[k][2], 0.f));
      }
    }
    if (tid == 0) im_s[kImPix] = make_uint2(0u, 0u);
    __syncthreads();

    // ---- conv0[0] -> a0 ----------------------------------------------
    auto conv00 = [&](auto edge_tag) {
      constexpr bool kEdge = decltype(edge_tag)::value;
      uint2 bw[kK0];
#pragma unroll
      for (int s = 0; s < kK0; ++s) bw[s] = w0_s[s * 32 + lane];
      const float2 ba = bn_s[2 * t], bb = bn_s[2 * t + 1];
      const uint32_t* const im_w = reinterpret_cast<const uint32_t*>(im_s);
      // kIlp m16 tiles a step, kWarps apart (past the end: clamped reads,
      // no stores)
      for (int mt = warp; mt < kA0Tiles; mt += kIlp * kWarps) {
        int p[kIlp][2], y[kIlp][2], x[kIlp][2];
        float acc[kIlp][4];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            p[u][hh] = (mt + u * kWarps) * 16 + g + 8 * hh;
            const int q = min(p[u][hh], kA0Pix - 1);
            y[u][hh] = q / kA0W;
            x[u][hh] = q - y[u][hh] * kA0W;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          // A of kernel row s: k 2t, 2t + 1 are column t / 2, channels
          // 2 (t & 1) ..: word 2 (pixel + t / 2) + (t & 1) = 2 pixel + t;
          // k 2t + 8 .. two columns on
          const uint32_t* const r0 =
              im_w + 2 * (y[u][0] * kImW + x[u][0]) + t;
          const uint32_t* const r1 =
              im_w + 2 * (y[u][1] * kImW + x[u][1]) + t;
#pragma unroll
          for (int s = 0; s < kK0; ++s) {
            const uint32_t af[4] = {r0[2 * s * kImW], r1[2 * s * kImW],
                                    r0[2 * s * kImW + 4],
                                    r1[2 * s * kImW + 4]};
            mma16816(acc[u], af, bw[s].x, bw[s].y);
          }
        }
        // BatchNorm, ReLU, bf16; zero outside the image (conv0[1]'s
        // padding)
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t o = bn_relu_bf16(acc[u][2 * hh], acc[u][2 * hh + 1],
                                      ba, bb);
            if (kEdge && !(static_cast<unsigned>(a0y + y[u][hh]) <
                               static_cast<unsigned>(H) &&
                           static_cast<unsigned>(a0x + x[u][hh]) <
                               static_cast<unsigned>(W))) {
              o = 0u;
            }
            if (p[u][hh] < kA0Pix) a0_w[p[u][hh] * 4 + t] = o;
          }
        }
      }
    };
    if (edge) {
      conv00(Edge<true>{});
    } else {
      conv00(Edge<false>{});
    }
    __syncthreads();
    // the next tile's patch, in flight through conv0[1] and conv1[0]
    if (tile + static_cast<int>(gridDim.x) < total) fetch(tile + gridDim.x);

    // ---- conv0[1] -> c0 (even / odd column planes) --------------------
    auto conv01 = [&](auto edge_tag) {
      constexpr bool kEdge = decltype(edge_tag)::value;
      uint2 bw[kK1];
      uint32_t aoff[kK1];                  // a0 pixels of the taps, x 16 B
#pragma unroll
      for (int s = 0; s < kK1; ++s) {
        bw[s] = w1_s[s * 32 + lane];
        const int tap = s < 4 ? 2 * s + khalf : 8;
        aoff[s] = ((tap / 3) * kA0W + tap % 3) * 16;
      }
      const float2 ba = bn_s[8 + 2 * t], bb = bn_s[8 + 2 * t + 1];
      for (int mt = warp; mt < kC0Tiles; mt += kIlp * kWarps) {
        uint32_t rb[kIlp];
        float acc[kIlp][4];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int pr = min((mt + u * kWarps) * 16 + lrow, kC0Pix - 1);
          const int yr = pr / kC0W, xr = pr - yr * kC0W;
          rb[u] = a0_base + (yr * kA0W + xr) * 16;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[u][r] = 0.f;
        }
#pragma unroll
        for (int s = 0; s < kK1; ++s) {
#pragma unroll
          for (int u = 0; u < kIlp; ++u) {
            uint32_t af[4];
            if (s < 4) {
              ldsm_x4(af, rb[u] + aoff[s]);
              mma16816(acc[u], af, bw[s].x, bw[s].y);
            } else {
              ldsm_x2(af, rb[u] + aoff[s]);
              mma1688(acc[u], af, bw[s].x);
            }
          }
        }
        // BatchNorm, ReLU, bf16; zero outside the image (conv1[0]'s
        // padding)
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = (mt + u * kWarps) * 16 + g + 8 * hh;
            if (p < kC0Pix) {
              const int y = p / kC0W, x = p - (p / kC0W) * kC0W;
              uint32_t o = bn_relu_bf16(acc[u][2 * hh], acc[u][2 * hh + 1],
                                        ba, bb);
              if (kEdge &&
                  !(static_cast<unsigned>(c0y + y) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(c0x + x) < static_cast<unsigned>(W))) {
                o = 0u;
              }
              c0_w[(y * kC0Row + (x & 1) * kPlane + (x >> 1)) * 4 + t] = o;
            }
          }
        }
      }
    };
    if (edge) {
      conv01(Edge<true>{});
    } else {
      conv01(Edge<false>{});
    }
    __syncthreads();

    // ---- conv1[0]: output rows 2 warp, 2 warp + 1, two m16 tiles each -
    {
      uint32_t rb[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int ly = 2 * warp + (mi >> 1), lx = 16 * (mi & 1) + lrow;
        rb[mi] = c0_base + (2 * ly * kC0Row + lx) * 16;
      }
      float acc[4][2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][q][r] = 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < kK2; ++s) {
        const uint2 b0 = w2_s[(2 * s) * 32 + lane];
        const uint2 b1 = w2_s[(2 * s + 1) * 32 + lane];
        // this lane's tap: 2s + khalf (24 in the k8 step); c0 row 2 ly +
        // dy, column 2 lx + dx: plane dx & 1, entry lx + dx / 2
        const int ta = 2 * s, tb = s < 12 ? 2 * s + 1 : 2 * s;
        const int offa = ((ta / 5) * kC0Row + ((ta % 5) & 1) * kPlane +
                          ((ta % 5) >> 1)) * 16;
        const int offb = ((tb / 5) * kC0Row + ((tb % 5) & 1) * kPlane +
                          ((tb % 5) >> 1)) * 16;
        const uint32_t off = khalf ? offb : offa;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t af[4];
          if (s < 12) {
            ldsm_x4(af, rb[mi] + off);
            mma16816(acc[mi][0], af, b0.x, b0.y);
            mma16816(acc[mi][1], af, b1.x, b1.y);
          } else {
            ldsm_x2(af, rb[mi] + off);
            mma1688(acc[mi][0], af, b0.x);
            mma1688(acc[mi][1], af, b1.x);
          }
        }
      }
      // BatchNorm, ReLU, bf16 into the staging tile [kTY][kTX][16]
      // (32 bytes a pixel; its two 16-byte halves swapped on pixels with
      // bit 2 of the column set, so a warp's stores hit 32 banks)
      uint32_t* const st = a0_w;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 ba = bn_s[16 + 8 * q + 2 * t];
        const float2 bb = bn_s[16 + 8 * q + 2 * t + 1];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int ly = 2 * warp + (mi >> 1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int lx = 16 * (mi & 1) + g + 8 * hh;
            st[(ly * kTX + lx) * 8 + (q ^ ((lx >> 2) & 1)) * 4 + t] =
                bn_relu_bf16(acc[mi][q][2 * hh], acc[mi][q][2 * hh + 1],
                             ba, bb);
          }
        }
      }
    }
    __syncthreads();

    // ---- the output tile: 16-byte stores, masked at the edges ---------
    {
      const uint4* const st4 = reinterpret_cast<const uint4*>(smem);
      uint4* const out4 = reinterpret_cast<uint4*>(a.out) +
                          static_cast<size_t>(n) * a.ho * a.wo * 2;
#pragma unroll
      for (int k = 0; k < kTY * kTX * 2 / kThreads; ++k) {
        const int i = tid + k * kThreads;
        const int ly = i / (2 * kTX), lx = (i >> 1) % kTX, half = i & 1;
        const int oy = oy0 + ly, ox = ox0 + lx;
        if (oy < a.ho && ox < a.wo) {
          out4[(static_cast<size_t>(oy) * a.wo + ox) * 2 + half] =
              st4[(ly * kTX + lx) * 2 + (half ^ ((lx >> 2) & 1))];
        }
      }
    }
    // the next tile's patch overwrites c0, its conv0[0] the staging: the
    // barrier after the patch's stores orders both
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). x [n, h, w, 3] float32 (the
// channels-last [n, 3, h, w] images); w0 [8, 3, 3, 3], w1 [8, 8, 3, 3],
// w2 [16, 8, 5, 5] float32 (rounded to bf16 here); bn: for each of the
// three layers its running mean, running var, gamma, beta ([8], [8],
// [16]: 12 pointers, layer by layer) and eps; out [n, ceil(h/2),
// ceil(w/2), 16] bfloat16. Returns the cudaError_t of the launch (0 = ok).
extern "C" int feature_stem_forward(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* m0, const void* v0, const void* g0, const void* b0,
    const void* m1, const void* v1, const void* g1, const void* b1,
    const void* m2, const void* v2, const void* g2, const void* b2,
    float eps0, float eps1, float eps2, void* out, int n, int h, int w,
    void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.wt[0] = static_cast<const float*>(w0);
  a.wt[1] = static_cast<const float*>(w1);
  a.wt[2] = static_cast<const float*>(w2);
  const void* bn[3][4] = {{m0, v0, g0, b0}, {m1, v1, g1, b1},
                          {m2, v2, g2, b2}};
  for (int l = 0; l < 3; ++l) {
    a.mean[l] = static_cast<const float*>(bn[l][0]);
    a.var[l] = static_cast<const float*>(bn[l][1]);
    a.gamma[l] = static_cast<const float*>(bn[l][2]);
    a.beta[l] = static_cast<const float*>(bn[l][3]);
  }
  a.eps[0] = eps0;
  a.eps[1] = eps1;
  a.eps[2] = eps2;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n = n;
  a.h = h;
  a.w = w;
  a.ho = (h + 1) / 2;
  a.wo = (w + 1) / 2;
  a.tiles_y = (a.ho + kTY - 1) / kTY;
  a.tiles_x = (a.wo + kTX - 1) / kTX;
  if (n < 1 || h < 1 || w < 1 ||
      static_cast<long long>(n) * a.tiles_x * a.tiles_y >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB of shared memory: set on each call, for the current device
  cudaError_t err = cudaFuncSetAttribute(
      feature_stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, feature_stem_conv_kernel, kThreads, kBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(n) * a.tiles_x * a.tiles_y;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  feature_stem_conv_kernel<<<grid, kThreads, kBytes,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
