// PixelViewWeight's conv stack in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves PixelViewWeight
// (diffmvs_tpu/nn/costreg.py) to XLA's convolutions, and the port ran it as
// cuDNN's float32 3D convs with a pass over a float32 volume for each of the
// cast, BatchNorm, ReLU, sigmoid and max around them. It computes, for each
// source view's correlation volume cor [D, H, W, G] of each sample,
//
//   c1  = relu(bn(conv3d(cor, w1)))      3x3x3, G -> 8, zero padding 1, no
//                                        bias; bn in eval form:
//                                        ((x - mean) * rsqrt(var + eps))
//                                        * gamma + beta, from the module's
//                                        own buffers, read here
//   l   = conv3d(c1, w2) + b2            3x3x3, 8 -> 1, zero padding 1
//   out = sigmoid(max over D of l)       [H, W]
//
// sigmoid is monotone, so the max of the logits and one sigmoid a pixel is
// max over D of sigmoid(l), the module's order. Everything is float32:
// bf16 inputs are widened exactly, the weights are the module's float32
// parameters, every product and sum a float32 FMA on the CUDA cores (no
// tensor cores, so no TF32), c1 is kept in float32 in shared memory.
//
// Layouts: cor [N, D, H, W, G] contiguous, N = views x samples (the stacked
// volume of InitialStage, channels last: 8 or 16 bytes a voxel at G = 4),
// f32 or bf16; w1 [8, G, 3, 3, 3], w2 [1, 8, 3, 3, 3], b2 [1], the BatchNorm
// buffers and affine terms [8], all float32; out [N, H, W] float32.
//
// What bounds it on an H100. 2 * 27 * (8 G + 8) = 2160 FLOP a voxel at G =
// 4 against 8 bytes read: the FP32 pipes (67 TFLOP/s: 2.86 ms for the 191
// GFLOP of B = 16, four views, at 144x200x48), not HBM (0.71 GB, 0.21 ms).
// So the design keeps the FMAs fed from registers and shared memory and
// everything between the two convs on chip:
//   * one block owns one sample's column of 18 x 30 output pixels and
//     walks D; a warp's 32 lanes are the 32 columns of the conv1 tile (the
//     output tile and a one-pixel halo each side), and the 4 warps take 5
//     of its 20 rows each;
//   * the input planes z-1, z, z+1 sit in a ring of three shared-memory
//     slots (22 x 34 voxels, float32); the next plane's loads are
//     issued a plane ahead into registers, so their latency hides behind a
//     plane's arithmetic;
//   * conv1 of plane z: each lane holds 8 channels x 5 rows of sums and
//     reuses each input voxel it loads for the three dy taps, and each pair
//     of weight loads (uniform addresses: broadcasts) for 40 FMAs; conv1
//     is recomputed on the one-pixel H / W halo (20 x 32 for 18 x 30:
//     1.19x), never along D;
//   * conv2 never waits for three conv1 planes: plane z of c1 (one
//     shared-memory slot) is added into the sums of output planes z-1, z
//     and z+1 held in registers, split by dx, so each lane loads its own
//     column once and two warp shuffles give each output its neighbours'
//     columns; output plane z-1 is then complete and only its max is kept,
//     in registers. Nothing between the two convs goes to device memory,
//     and no reduction crosses blocks.
// The tile was chosen by time on an H100 (SXM, 700 W) among 6 warps x 3
// rows (16 x 30, 2 or 3 blocks an SM), 5 x 4 and 8 x 2 (18 x 30, 14 x 30):
// 4 x 5 (168 registers, 3 blocks an SM) was the fastest, 5.99 ms at B = 16
// (6.81 for 6 x 3), 47.7 % of the FFMA bound; what it leaves is the FMAs
// spent on the halo, the partial last wave (3584 blocks on 396 slots) and
// the two block-wide barriers a plane.
//
// Rounding: the sums run in another order than cuDNN's (each conv1 value a
// sum of 27 G products, each logit of 216), so results differ from the
// module's path by rounding only (~1e-6 of the [0, 1] weights). Do not
// build with --use_fast_math (approximate exp and division).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;          // conv1 tile columns: a warp's lanes
constexpr int kTileW = kCols - 2;  // output tile columns
constexpr int kInCols = kCols + 2; // input tile columns
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* cor;
  const float* w1;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
  const float* w2;
  const float* b2;
  float* out;
  int d, h, w;
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// one voxel's G channels as raw 32-bit words: kWords of them
template <typename T, int G>
struct Voxel {
  static constexpr int kWords = G * static_cast<int>(sizeof(T)) / 4;
  uint32_t u[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) u[i] = 0u;
  }

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords == 2) {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      u[0] = a.x;
      u[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; i += 4) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[i / 4];
        u[i] = a.x;
        u[i + 1] = a.y;
        u[i + 2] = a.z;
        u[i + 3] = a.w;
      }
    }
  }

  // channels 4q .. 4q + 3 in float32 (a bf16 is the high half of its f32)
  __device__ __forceinline__ float4 quad(int q) const {
    if constexpr (sizeof(T) == 2) {
      const uint32_t a = u[2 * q], b = u[2 * q + 1];
      return make_float4(__uint_as_float(a << 16),
                         __uint_as_float(a & 0xffff0000u),
                         __uint_as_float(b << 16),
                         __uint_as_float(b & 0xffff0000u));
    } else {
      return make_float4(__uint_as_float(u[4 * q]),
                         __uint_as_float(u[4 * q + 1]),
                         __uint_as_float(u[4 * q + 2]),
                         __uint_as_float(u[4 * q + 3]));
    }
  }
};

// The tile geometry of NW warps of P rows each: the conv1 tile is NW * P
// rows, the output tile two fewer.
template <int G, int NW = 4, int P = 5>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kRows = NW * P;             // conv1 tile rows
  static constexpr int kOutRows = kRows - 2;       // output tile rows
  static constexpr int kInRows = kRows + 2;        // input tile rows
  static constexpr int kC1Rows = kRows + 2;        // + 2 zero rows, read
                                                   // by the last warp's
                                                   // discarded outputs
  static constexpr int kQuads = G / 4;
  static constexpr int kInVoxels = kInRows * kInCols;
  static constexpr int kStaged = (kInVoxels + kThreads - 1) / kThreads;
  // shared memory, in floats: [slot][quad][row][col][4] inputs,
  // [half][row][col][4] conv1, [tap][ci][co] w1, [tap][ci] w2, and the
  // BatchNorm's mean, invstd, gamma, beta [4][8]
  static constexpr int kInSlot = kQuads * kInVoxels * 4;
  static constexpr int kC1 = 2 * kC1Rows * kCols * 4;
  static constexpr int kW1 = 27 * G * 8;
  static constexpr int kW2 = 27 * 8;
  static constexpr int kFloats = 3 * kInSlot + kC1 + kW1 + kW2 + 32;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int G>
__global__ void __launch_bounds__(Tile<G>::kThreads, 2)
pvw_conv3d_kernel(Args a) {
  using Geo = Tile<G>;
  constexpr int NW = Geo::kThreads / 32;
  constexpr int P = Geo::kRows / NW;
  constexpr int NT = Geo::kThreads;
  constexpr int Q = Geo::kQuads;
  constexpr int IR = Geo::kInRows;
  constexpr int C1R = Geo::kC1Rows;

  extern __shared__ float4 smem4[];
  float* const in_s = reinterpret_cast<float*>(smem4);
  float* const c1_s = in_s + 3 * Geo::kInSlot;
  float* const w1_s = c1_s + Geo::kC1;
  float* const w2_s = w1_s + Geo::kW1;
  float* const bn_s = w2_s + Geo::kW2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * Geo::kOutRows;
  const int tx0 = blockIdx.x * kTileW;
  const int D = a.d, H = a.h, W = a.w;
  const size_t plane_elems = static_cast<size_t>(H) * W * G;
  const T* const cor =
      static_cast<const T*>(a.cor) + static_cast<size_t>(n) * D * plane_elems;

  // weights into [dz][dy][dx][ci][co] and [dz][dy][dx][ci] (torch's
  // [co][ci][kd][kh][kw]: kd along D, kh along H, kw along W)
  for (int i = tid; i < Geo::kW1; i += NT) {
    const int co = i / (G * 27), rem = i % (G * 27);
    const int ci = rem / 27, tap = rem % 27;
    w1_s[(tap * G + ci) * 8 + co] = a.w1[i];
  }
  for (int i = tid; i < Geo::kW2; i += NT) {
    w2_s[(i % 27) * 8 + i / 27] = a.w2[i];
  }
  if (tid < 8) {
    bn_s[tid] = a.mean[tid];
    bn_s[8 + tid] = rsqrtf(a.var[tid] + a.eps);
    bn_s[16 + tid] = a.gamma[tid];
    bn_s[24 + tid] = a.beta[tid];
  }
  const float bias = a.b2[0];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // plane -1 (slot 2) and conv1's two padding rows read as zeros
  for (int i = tid; i < Geo::kInSlot / 4; i += NT) {
    smem4[(2 * Geo::kInSlot) / 4 + i] = zero4;
  }
  for (int i = tid; i < Geo::kC1 / 4; i += NT) {
    reinterpret_cast<float4*>(c1_s)[i] = zero4;
  }

  // the input tile of one plane: rows ty0 - 2 .., columns tx0 - 2 ..;
  // zeros outside the volume (the convolution's zero padding)
  Voxel<T, G> staged[Geo::kStaged];
  auto fetch = [&](int z) {
#pragma unroll
    for (int k = 0; k < Geo::kStaged; ++k) {
      staged[k].zero();
      const int i = tid + k * NT;
      if (z < D && i < Geo::kInVoxels) {
        const int y = ty0 - 2 + i / kInCols, x = tx0 - 2 + i % kInCols;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          staged[k].load(cor + static_cast<size_t>(z) * plane_elems +
                         (static_cast<size_t>(y) * W + x) * G);
        }
      }
    }
  };
  auto store = [&](int slot) {
    float* const dst = in_s + slot * Geo::kInSlot;
#pragma unroll
    for (int k = 0; k < Geo::kStaged; ++k) {
      const int i = tid + k * NT;
      if (i < Geo::kInVoxels) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          reinterpret_cast<float4*>(dst)[q * Geo::kInVoxels + i] =
              staged[k].quad(q);
        }
      }
    }
  };
  fetch(0);
  store(0);
  fetch(1);

  // conv2's sums: [k][dx][p] for output plane z - 1 + k, split by the
  // column offset dx of the c1 values they hold; the running max
  float s[3][3][P];
  float best[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = -__int_as_float(0x7f800000);   // -inf
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) s[k][dx][p] = 0.f;
    }
  }
  // output plane z - 1 + 0 complete: its logits, and their max
  auto finish = [&]() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float l = s[0][0][p] + __shfl_down_sync(kFull, s[0][1][p], 1) +
                      __shfl_down_sync(kFull, s[0][2][p], 2) + bias;
      best[p] = (l > best[p] || l != l) ? l : best[p];   // NaN propagates
    }
  };

  const float* const in_lane = in_s + (warp * P * kInCols + lane) * 4;
  const float* const c1_lane = c1_s + (warp * P * kCols + lane) * 4;

  for (int z = 0; z < D; ++z) {
    store((z + 1) % 3);        // plane z + 1 (zeros past the last)
    fetch(z + 2);              // lands while this plane is computed
    __syncthreads();

    // ---- conv1 of plane z, this lane's column, rows warp * P + p -------
    float acc[P][8];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int co = 0; co < 8; ++co) acc[p][co] = 0.f;
    }
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
      const float* const ip = in_lane + ((z + 2 + dz) % 3) * Geo::kInSlot;
      const float* const wp = w1_s + dz * 9 * G * 8;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float4 v[P + 2][Q];
#pragma unroll
        for (int j = 0; j < P + 2; ++j) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            v[j][q] = *reinterpret_cast<const float4*>(
                ip + ((q * IR + j) * kInCols + dx) * 4);
          }
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int ci = 0; ci < G; ++ci) {
            const float* const wc = wp + ((dy * 3 + dx) * G + ci) * 8;
            const float4 wa = *reinterpret_cast<const float4*>(wc);
            const float4 wb = *reinterpret_cast<const float4*>(wc + 4);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const float x = lane_of(v[p + dy][ci >> 2], ci & 3);
              acc[p][0] = fmaf(wa.x, x, acc[p][0]);
              acc[p][1] = fmaf(wa.y, x, acc[p][1]);
              acc[p][2] = fmaf(wa.z, x, acc[p][2]);
              acc[p][3] = fmaf(wa.w, x, acc[p][3]);
              acc[p][4] = fmaf(wb.x, x, acc[p][4]);
              acc[p][5] = fmaf(wb.y, x, acc[p][5]);
              acc[p][6] = fmaf(wb.z, x, acc[p][6]);
              acc[p][7] = fmaf(wb.w, x, acc[p][7]);
            }
          }
        }
      }
    }
    // BatchNorm + ReLU; zero outside the image (conv2's padding)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 mean = reinterpret_cast<const float4*>(bn_s)[half];
      const float4 inv = reinterpret_cast<const float4*>(bn_s)[2 + half];
      const float4 gam = reinterpret_cast<const float4*>(bn_s)[4 + half];
      const float4 bet = reinterpret_cast<const float4*>(bn_s)[6 + half];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = warp * P + p;
        const int y = ty0 - 1 + r, x = tx0 - 1 + lane;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t = fmaf((acc[p][4 * half + c] - lane_of(mean, c)) *
                                   lane_of(inv, c),
                               lane_of(gam, c), lane_of(bet, c));
          o[c] = inside ? (t < 0.f ? 0.f : t) : 0.f;
        }
        reinterpret_cast<float4*>(c1_s)[(half * C1R + r) * kCols + lane] =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // ---- conv2: c1 plane z into output planes z + 1 - dz ---------------
    float4 u[P + 2][2];
#pragma unroll
    for (int j = 0; j < P + 2; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        u[j][half] = *reinterpret_cast<const float4*>(
            c1_lane + ((half * C1R + j) * kCols) * 4);
      }
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* const wc = w2_s + ((dz * 3 + dy) * 3 + dx) * 8;
          const float4 wa = *reinterpret_cast<const float4*>(wc);
          const float4 wb = *reinterpret_cast<const float4*>(wc + 4);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float4 lo = u[p + dy][0], hi = u[p + dy][1];
            float t = s[2 - dz][dx][p];
            t = fmaf(wa.x, lo.x, t);
            t = fmaf(wa.y, lo.y, t);
            t = fmaf(wa.z, lo.z, t);
            t = fmaf(wa.w, lo.w, t);
            t = fmaf(wb.x, hi.x, t);
            t = fmaf(wb.y, hi.y, t);
            t = fmaf(wb.z, hi.z, t);
            t = fmaf(wb.w, hi.w, t);
            s[2 - dz][dx][p] = t;
          }
        }
      }
    }
    if (z >= 1) finish();      // output plane z - 1
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        s[0][dx][p] = s[1][dx][p];
        s[1][dx][p] = s[2][dx][p];
        s[2][dx][p] = 0.f;
      }
    }
  }
  finish();                    // output plane D - 1 (c1 plane D is zero)

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int o = warp * P + p;
    const int y = ty0 + o, x = tx0 + lane;
    if (o < Geo::kOutRows && lane < kTileW && y < H && x < W) {
      a.out[(static_cast<size_t>(n) * H + y) * W + x] =
          1.0f / (1.0f + expf(-best[p]));
    }
  }
}

template <typename T, int G>
int launch(const Args& a, int n, cudaStream_t stream) {
  using Geo = Tile<G>;
  auto kernel = pvw_conv3d_kernel<T, G>;
  // above 48 KB of shared memory: set on each call, for the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Geo::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.w + kTileW - 1) / kTileW,
                  (a.h + Geo::kOutRows - 1) / Geo::kOutRows, n);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<grid, Geo::kThreads, Geo::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16
// correlation volume; g: 4 or 8 groups; n: the volumes (views x samples)
// of cor [n, d, h, w, g]; out [n, h, w]. Returns the cudaError_t of the
// launch (0 = ok).
extern "C" int pixel_view_weight_forward(
    int dtype, int g, const void* cor, const void* w1,
    const void* mean, const void* var, const void* gamma, const void* beta,
    float eps, const void* w2, const void* b2, void* out, int n, int d,
    int h, int w, void* stream) {
  const Args a{cor,
               static_cast<const float*>(w1),
               static_cast<const float*>(mean),
               static_cast<const float*>(var),
               static_cast<const float*>(gamma),
               static_cast<const float*>(beta),
               eps,
               static_cast<const float*>(w2),
               static_cast<const float*>(b2),
               static_cast<float*>(out),
               d, h, w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && g == 4) return launch<float, 4>(a, n, s);
  if (dtype == 0 && g == 8) return launch<float, 8>(a, n, s);
  if (dtype == 1 && g == 4) return launch<__nv_bfloat16, 4>(a, n, s);
  if (dtype == 1 && g == 8) return launch<__nv_bfloat16, 8>(a, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
