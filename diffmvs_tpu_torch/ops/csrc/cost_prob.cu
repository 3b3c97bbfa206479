// CostRegNet's last layer, the 8 -> 1 3x3x3 convolution `prob`, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves CostRegNet
// (diffmvs_tpu/nn/costreg.py) to XLA's convolutions, and the port ran the
// layer as one cuDNN launch, which has no tensor-core engine for a single
// output channel and falls back to a generic implicit-GEMM kernel. It
// computes, for each sample's 8-channel volume x [D, H, W, 8],
//
//   out[z, y, x] = sum over dz, dy, dx in 0..2 and c in 0..7 of
//                  w[c, dz, dy, dx] * x[z + dz - 1, y + dy - 1, x + dx - 1, c]
//
// with zero padding 1 on D, H and W and no bias. The weights are the
// module's float32 parameters, rounded here to the compute dtype as the
// module's cast rounds them; every product and sum is a float32 FMA on the
// CUDA cores (no tensor cores, so no TF32; a bf16 x bf16 product is exact
// in float32), and the sum is rounded once to the compute dtype. So the
// result differs from the module's only by the order of the 216-term sum.
// Do not build with --use_fast_math.
//
// Layouts: x [B, D, H, W, 8] contiguous (the channels-last [B, 8, D, H, W]
// that CostRegNet's convolutions hand the layer), float32 or bfloat16,
// 16-byte aligned; w [1, 8, 3, 3, 3] float32; out [B, D, H, W] in x's
// dtype.
//
// What bounds it on an H100. 2 * 27 * 8 = 432 FLOP a voxel against 18
// bytes (bf16: 16 read, 2 written): at B = 16 and 48 x 144 x 200 that is
// 9.55 GFLOP, 0.143 ms on the FP32 pipes (67 TFLOP/s), and 398 MB, 0.119
// ms at 3.35 TB/s. Both are near, so the design streams the input through
// shared memory once and keeps the FMAs fed from registers:
//   * one block owns one sample's column of NW * P output rows x 30 output
//     columns and walks D; a warp's 32 lanes are the 32 input columns of
//     the tile (the 30 outputs and a one-column halo each side), and each
//     warp takes P of its rows;
//   * the input planes go through a ring of shared-memory slots by
//     cp.async, in the input's dtype (16 bytes an 8-channel bf16 voxel),
//     issued kStages - 1 planes ahead, with no register staging; a plane
//     of the tile is NW * P + 2 rows of 32 voxels, read from device memory
//     once;
//   * each input plane z is added into the sums of output planes z - 1, z
//     and z + 1, held in registers and split by the column offset dx, so
//     each lane loads its own column once a plane (P + 2 rows of 8
//     channels) and two warp shuffles give each output its neighbours'
//     columns when the plane completes; the 8 x 27 weights are uniform
//     shared-memory broadcasts, each pair of loads feeding 8 P FMAs.
// The tile was chosen by time on an H100 (SXM, 700 W) among 2 to 8 warps
// of 2 to 8 rows: 4 warps x 4 rows (16 x 30 outputs, 127 registers, 4
// blocks an SM) was the fastest at B = 16 bf16, 0.360 ms (8 x 2: 0.362,
// 2 x 6: 0.392, 4 x 6: 0.395, 4 x 8: 0.536), 39.6 % of the FFMA bound, 62x
// under cuDNN's 22.3 ms. What it leaves: 2 of 32 lanes compute halo sums,
// the loads and bf16 widening of 6 rows for 4 rows of outputs, and the
// block-wide barrier a plane. Cutting D into chunks (a block each, two
// planes of halo) gained nothing at B = 16 and 0.04 ms at B = 1 (0.072 ->
// 0.035 ms, in a request of ~100 ms), so a block walks the whole of D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cost_prob {

constexpr int kCols = 32;          // input tile columns: a warp's lanes
constexpr int kTileW = kCols - 2;  // output tile columns
constexpr int kChannels = 8;
constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* x;
  const float* weight;
  void* out;
  int d, h, w;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T cast_out(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// 16 bytes of a voxel in shared memory: 8 bf16 or 4 float32 channels, into
// f[0 .. 16 / sizeof(T)) (a bf16 is the high half of its float32)
template <typename T>
__device__ __forceinline__ void widen(const uint4 v, float* f) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
}

// The tile of NW warps of P rows each, over a ring of kStages planes.
template <typename T, int NW, int P>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kRows = NW * P;                  // output rows
  static constexpr int kInRows = kRows + 2;             // input rows
  static constexpr int kParts = kChannels * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kPerPart = 16 / static_cast<int>(sizeof(T));
  // a slot: [part][row][col] of 16 bytes; lanes read consecutive columns,
  // 16 bytes apart, without bank conflicts
  static constexpr int kChunks = kParts * kInRows * kCols;
  static constexpr int kSlotBytes = kChunks * 16;
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr size_t kBytes =
      static_cast<size_t>(kStages) * kSlotBytes + sizeof(float) * kTaps * 8;
};

template <typename T, int NW, int P>
__global__ void __launch_bounds__(32 * NW)
prob_conv3d_kernel(Args a) {
  using Geo = Tile<T, NW, P>;
  constexpr int NT = Geo::kThreads;
  constexpr int S = Geo::kStages;
  constexpr int IR = Geo::kInRows;

  extern __shared__ uint4 smem16[];
  uint8_t* const ring = reinterpret_cast<uint8_t*>(smem16);
  float* const w_s =
      reinterpret_cast<float*>(ring + static_cast<size_t>(S) * Geo::kSlotBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * Geo::kRows;
  const int tx0 = blockIdx.x * kTileW;
  const int D = a.d, H = a.h, W = a.w;
  const size_t plane_bytes =
      static_cast<size_t>(H) * W * kChannels * sizeof(T);
  const uint8_t* const xs = static_cast<const uint8_t*>(a.x) +
                            static_cast<size_t>(n) * D * plane_bytes;

  // weights into [dz][dy][dx][c], rounded to the compute dtype (torch's
  // [1][c][kd][kh][kw]: kd along D, kh along H, kw along W)
  for (int i = tid; i < kTaps * kChannels; i += NT) {
    const int c = i / kTaps, tap = i % kTaps;
    w_s[tap * kChannels + c] = round_to<T>(a.weight[i]);
  }

  // plane z's tile into slot `slot`: rows ty0 - 1 .., columns tx0 - 1 ..;
  // zeros outside the image (the convolution's zero padding)
  auto issue = [&](int z, int slot) {
    const uint8_t* const plane = xs + static_cast<size_t>(z) * plane_bytes;
    uint8_t* const dst = ring + static_cast<size_t>(slot) * Geo::kSlotBytes;
    for (int i = tid; i < Geo::kChunks; i += NT) {
      const int part = i % Geo::kParts, v = i / Geo::kParts;
      const int r = v / kCols, c = v % kCols;
      const int y = ty0 - 1 + r, x = tx0 - 1 + c;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const uint8_t* src =
          inside ? plane + (static_cast<size_t>(y) * W + x) *
                               (kChannels * sizeof(T)) + part * 16
                 : plane;
      cp_async16(dst + ((part * IR + r) * kCols + c) * 16, src,
                 inside ? 16 : 0);
    }
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < D) issue(k, k);
    cp_async_commit();
  }

  // the sums s[k][dx][p] of output plane z - 1 + k, split by the column
  // offset dx of the input column they hold
  float s[3][3][P];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int p = 0; p < P; ++p) s[k][dx][p] = 0.f;
    }
  }
  T* const out = static_cast<T*>(a.out);
  const int xo = tx0 + lane;

  for (int z = 0; z <= D; ++z) {
    cp_async_wait<S - 2>();    // plane z has landed, for this thread
    __syncthreads();           // for every thread; slot (z - 1) % S is free
    if (z + S - 1 < D) issue(z + S - 1, (z + S - 1) % S);
    cp_async_commit();

    if (z < D) {
      // this lane's column of the plane, rows warp * P .. + P + 1
      const uint8_t* const col =
          ring + static_cast<size_t>(z % S) * Geo::kSlotBytes +
          (warp * P * kCols + lane) * 16;
      float u[P + 2][kChannels];
#pragma unroll
      for (int j = 0; j < P + 2; ++j) {
#pragma unroll
        for (int part = 0; part < Geo::kParts; ++part) {
          widen<T>(*reinterpret_cast<const uint4*>(
                       col + ((part * IR + j) * kCols) * 16),
                   &u[j][part * Geo::kPerPart]);
        }
      }
      // input plane z into output planes z + 1 - dz
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* const wc = w_s + ((dz * 3 + dy) * 3 + dx) * kChannels;
            const float4 wa = *reinterpret_cast<const float4*>(wc);
            const float4 wb = *reinterpret_cast<const float4*>(wc + 4);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              float t = s[2 - dz][dx][p];
              t = fmaf(wa.x, u[p + dy][0], t);
              t = fmaf(wa.y, u[p + dy][1], t);
              t = fmaf(wa.z, u[p + dy][2], t);
              t = fmaf(wa.w, u[p + dy][3], t);
              t = fmaf(wb.x, u[p + dy][4], t);
              t = fmaf(wb.y, u[p + dy][5], t);
              t = fmaf(wb.z, u[p + dy][6], t);
              t = fmaf(wb.w, u[p + dy][7], t);
              s[2 - dz][dx][p] = t;
            }
          }
        }
      }
    }
    // output plane z - 1 is complete: output column lane sums input
    // columns lane, lane + 1 and lane + 2
    if (z >= 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float l = s[0][0][p] + __shfl_down_sync(kFull, s[0][1][p], 1) +
                        __shfl_down_sync(kFull, s[0][2][p], 2);
        const int y = ty0 + warp * P + p;
        if (lane < kTileW && y < H && xo < W) {
          out[((static_cast<size_t>(n) * D + (z - 1)) * H + y) * W + xo] =
              cast_out<T>(l);
        }
      }
    }
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
  cp_async_wait<0>();
}

template <typename T, int NW, int P>
int launch(const Args& a, int n, cudaStream_t stream) {
  using Geo = Tile<T, NW, P>;
  static_assert(Geo::kBytes <= 48 * 1024, "dynamic shared memory over 48 KB "
                "needs cudaFuncSetAttribute");
  const dim3 grid((a.w + kTileW - 1) / kTileW,
                  (a.h + Geo::kRows - 1) / Geo::kRows, n);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  prob_conv3d_kernel<T, NW, P><<<grid, Geo::kThreads, Geo::kBytes, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// The tile: kWarps warps of kTileRows rows (chosen by time, see the
// header note)
constexpr int kWarps = 4;
constexpr int kTileRows = 4;

}  // namespace cost_prob

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16
// x [n, d, h, w, 8] and out [n, d, h, w]; w [1, 8, 3, 3, 3] float32.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int cost_prob_forward(int dtype, const void* x, const void* w,
                                 void* out, int n, int d, int h, int wd,
                                 void* stream) {
  using namespace cost_prob;
  const Args a{x, static_cast<const float*>(w), out, d, h, wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kWarps, kTileRows>(a, n, s);
  if (dtype == 1) return launch<__nv_bfloat16, kWarps, kTileRows>(a, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
