// Whole-encoder eval kernel: conv1..conv4 (matmul, folded BN, ReLU, round
// to the matmul type) and the conv5 matmul for one tile of points, then the
// running max and min of the raw conv5 output over the tile's valid points.
//
// Replaces: pointnet_autoencoder_tpu/ops/fused_encoder.py:_eval_kernel
// (launched by fused_encoder_eval). What it computes is the same; the TPU
// tiling is not carried over. The caller applies the last folded affine and
// ReLU to the extremum picked by the sign of its scale, as the reference
// does outside its kernel (fused_encoder.py:173-176).
//
// Bound: operations. At B=32, N=2048 the chain is 2*B*N*147,648 = 19.4
// GFLOP on under 2 MB of input, so the FP32 pipes are the limit (this first
// kernel runs on CUDA cores, also in bf16 mode; wgmma is later work). The
// design keeps every activation on chip: a block owns 64 points, the
// activations ping-pong between two shared-memory buffers laid out
// channel-major [C][68], and the weights (66 KB for conv1..4, 512 KB for
// conv5 in f32) stream from L2. Each thread holds a register tile of 4
// channels by PPT points, so one weight load and PPT/4 float4 shared loads
// feed 4*PPT FMAs; the row stride 68 (= 4 mod 32) makes the float4 stores
// of neighbouring channels conflict-free. No (B*N, F) activation ever
// reaches device memory; only (B, tiles, 1024) partial extrema do, and a
// second small kernel reduces them over the tiles.
//
// Ragged N: rows past N in the last tile are zero-filled and excluded from
// the max/min (a zero point is a real point at the origin).
//
// Types follow the reference kernel (fused_encoder.py:72-80): points and
// weights in the matmul type T (float or bf16), f32 accumulation, the inner
// affine and ReLU in f32, each inner activation rounded to T before the
// next layer. bf16 products are exact in f32, so bf16 mode is bf16 inputs
// with f32 arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;           // points per block
constexpr int kStride = kTileN + 4;  // floats per channel row in shared memory
constexpr int kC0 = 3, kF1 = 64, kF2 = 64, kF3 = 64, kF4 = 128, kF5 = 1024;
constexpr int kBufFloats = kF4 * kStride;  // widest inner activation
constexpr int kSmemBytes = 2 * kBufFloats * static_cast<int>(sizeof(float));
// conv5: 64 threads along channels (4 channels each per pass), 4 along
// points (16 points each), 4 passes over the 1024 channels.
constexpr int kLanes5 = 64, kGroups5 = kThreads / kLanes5;
constexpr int kPpt5 = kTileN / kGroups5;
constexpr int kPasses5 = kF5 / (4 * kLanes5);
static_assert(2 * kGroups5 * kF5 <= kBufFloats, "extrema scratch fits");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[i][j] = sum_c in[c][g*PPT + j] * w[c*LD + q + i*LANES] for the
// thread's 4 channels (q + i*LANES) and PPT points (g*PPT + j).
template <typename T, int C, int LD, int LANES, int PPT>
__device__ __forceinline__ void tile_matmul(const float* in,
                                            const T* __restrict__ w, int q,
                                            int g, float (&acc)[4][PPT]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = to_f(w[c * LD + q + i * LANES]);
    float xv[PPT];
    const float4* row = reinterpret_cast<const float4*>(in + c * kStride + g * PPT);
#pragma unroll
    for (int j4 = 0; j4 < PPT / 4; ++j4) {
      const float4 v = row[j4];
      xv[4 * j4] = v.x;
      xv[4 * j4 + 1] = v.y;
      xv[4 * j4 + 2] = v.z;
      xv[4 * j4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PPT; ++j) acc[i][j] = fmaf(xv[j], wv[i], acc[i][j]);
  }
}

// One inner layer: out[f][p] = round_T(relu(y[f][p] * scale[f] + shift[f])).
template <typename T, int C, int F>
__device__ __forceinline__ void inner_layer(const float* in, float* out,
                                            const T* __restrict__ w,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift) {
  constexpr int kLanes = F / 4;
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kPpt = kTileN / kGroups;
  static_assert(kLanes * kGroups == kThreads && kPpt % 4 == 0, "tiling");
  const int q = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  float acc[4][kPpt];
  tile_matmul<T, C, F, kLanes, kPpt>(in, w, q, g, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = q + i * kLanes;
    const float sc = scale[f], sh = shift[f];
    float4* dst = reinterpret_cast<float4*>(out + f * kStride + g * kPpt);
#pragma unroll
    for (int j4 = 0; j4 < kPpt / 4; ++j4) {
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = round_to<T>(
            fmaxf(__fadd_rn(__fmul_rn(acc[i][4 * j4 + k], sc), sh), 0.f));
      dst[j4] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
encoder_tile_kernel(const T* __restrict__ pts, const T* __restrict__ w1,
                    const T* __restrict__ w2, const T* __restrict__ w3,
                    const T* __restrict__ w4, const T* __restrict__ w5,
                    const float* __restrict__ affine,
                    float* __restrict__ part_max,
                    float* __restrict__ part_min, int n) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);
  float* buf_b = buf_a + kBufFloats;
  const int tile = blockIdx.x, b = blockIdx.y, num_tiles = gridDim.x;
  const int n0 = tile * kTileN;
  const int valid = min(kTileN, n - n0);

  // Points of the tile, channel-major, zero past N.
  const T* src = pts + (static_cast<size_t>(b) * n + n0) * kC0;
  for (int k = threadIdx.x; k < kTileN * kC0; k += kThreads) {
    const int p = k / kC0, c = k % kC0;
    buf_b[c * kStride + p] = p < valid ? to_f(src[k]) : 0.f;
  }
  __syncthreads();
  // affine = [scale1 shift1 scale2 shift2 scale3 shift3 scale4 shift4].
  const float* a = affine;
  inner_layer<T, kC0, kF1>(buf_b, buf_a, w1, a, a + kF1);
  a += 2 * kF1;
  __syncthreads();
  inner_layer<T, kF1, kF2>(buf_a, buf_b, w2, a, a + kF2);
  a += 2 * kF2;
  __syncthreads();
  inner_layer<T, kF2, kF3>(buf_b, buf_a, w3, a, a + kF3);
  a += 2 * kF3;
  __syncthreads();
  inner_layer<T, kF3, kF4>(buf_a, buf_b, w4, a, a + kF4);
  __syncthreads();

  // conv5: raw matmul, per-thread extrema over its valid points, written
  // to buf_a as [max|min][group][channel], then reduced over the groups.
  const int q = threadIdx.x % kLanes5, g = threadIdx.x / kLanes5;
  float* red_max = buf_a;
  float* red_min = buf_a + kGroups5 * kF5;
  for (int pass = 0; pass < kPasses5; ++pass) {
    const T* w5p = w5 + pass * 4 * kLanes5;
    float acc[4][kPpt5];
    tile_matmul<T, kF4, kF5, kLanes5, kPpt5>(buf_b, w5p, q, g, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY, mn = INFINITY;
#pragma unroll
      for (int j = 0; j < kPpt5; ++j) {
        if (g * kPpt5 + j < valid) {
          mx = fmaxf(mx, acc[i][j]);
          mn = fminf(mn, acc[i][j]);
        }
      }
      const int f = pass * 4 * kLanes5 + q + i * kLanes5;
      red_max[g * kF5 + f] = mx;
      red_min[g * kF5 + f] = mn;
    }
  }
  __syncthreads();
  const size_t out = (static_cast<size_t>(b) * num_tiles + tile) * kF5;
  for (int f = threadIdx.x; f < kF5; f += kThreads) {
    float mx = red_max[f], mn = red_min[f];
#pragma unroll
    for (int gg = 1; gg < kGroups5; ++gg) {
      mx = fmaxf(mx, red_max[gg * kF5 + f]);
      mn = fminf(mn, red_min[gg * kF5 + f]);
    }
    part_max[out + f] = mx;
    part_min[out + f] = mn;
  }
}

// (B, tiles, F) partial extrema -> (B, F).
__global__ void reduce_tiles_kernel(const float* __restrict__ part_max,
                                    const float* __restrict__ part_min,
                                    float* __restrict__ ymax,
                                    float* __restrict__ ymin, int num_tiles) {
  const int b = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const float* pm = part_max + static_cast<size_t>(b) * num_tiles * kF5 + f;
  const float* pn = part_min + static_cast<size_t>(b) * num_tiles * kF5 + f;
  float mx = -INFINITY, mn = INFINITY;
  for (int t = 0; t < num_tiles; ++t) {
    mx = fmaxf(mx, pm[static_cast<size_t>(t) * kF5]);
    mn = fminf(mn, pn[static_cast<size_t>(t) * kF5]);
  }
  ymax[static_cast<size_t>(b) * kF5 + f] = mx;
  ymin[static_cast<size_t>(b) * kF5 + f] = mn;
}

template <typename T>
int launch(const void* pts, const void* const* w, const void* affine,
           void* part_max, void* part_min, void* ymax, void* ymin, int b,
           int n, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory needs the opt-in, per device.
  cudaError_t e = cudaFuncSetAttribute(
      encoder_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int num_tiles = (n + kTileN - 1) / kTileN;
  encoder_tile_kernel<T><<<dim3(num_tiles, b), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(pts), static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]), static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]), static_cast<const T*>(w[4]),
      static_cast<const float*>(affine), static_cast<float*>(part_max),
      static_cast<float*>(part_min), n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_tiles_kernel<<<dim3(kF5 / 256, b), 256, 0, stream>>>(
      static_cast<const float*>(part_max), static_cast<const float*>(part_min),
      static_cast<float*>(ymax), static_cast<float*>(ymin), num_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcae_encoder_tile_n() { return kTileN; }

// pts (b, n, 3) in the matmul type (bf16 != 0: bfloat16, else float);
// w[0..4] the (C, F) row-major weights of conv1..conv5 in the same type,
// widths 3->64->64->64->128->1024; affine the 640 f32 folded (scale, shift)
// rows of conv1..conv4; part_max/part_min (b, ceil(n/64), 1024) f32
// scratch; ymax/ymin (b, 1024) f32 outputs. Launches the tile kernel and
// the reduction on `stream`; returns cudaGetLastError().
extern "C" int pcae_fused_encoder_eval(int bf16, const void* pts,
                                       const void* w1, const void* w2,
                                       const void* w3, const void* w4,
                                       const void* w5, const void* affine,
                                       void* part_max, void* part_min,
                                       void* ymax, void* ymin, int b, int n,
                                       void* stream) {
  const void* w[5] = {w1, w2, w3, w4, w5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(pts, w, affine, part_max, part_min,
                                      ymax, ymin, b, n, s)
              : launch<float>(pts, w, affine, part_max, part_min, ymax, ymin,
                              b, n, s);
}
