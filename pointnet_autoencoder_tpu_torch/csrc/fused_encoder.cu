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
// GFLOP on under 2 MB of input: in f32 the FP32 pipes are the limit (0.29
// ms at 67 TFLOP/s), in bf16 the tensor cores (0.020 ms at 989 TFLOP/s).
// Two routes, by type.
//
// f32 (encoder_tile_kernel<float> + reduce_tiles_kernel), on the CUDA
// cores. The design keeps every activation on chip: a block owns 64 points, the
// activations ping-pong between two shared-memory buffers laid out
// channel-major [C][68], and the weights (66 KB for conv1..4, 512 KB for
// conv5 in f32) stream from L2. Each thread holds a register tile of 4
// channels by PPT points, so one weight load and PPT/4 float4 shared loads
// feed 4*PPT FMAs; the row stride 68 (= 4 mod 32) makes the float4 stores
// of neighbouring channels conflict-free. No (B*N, F) activation ever
// reaches device memory; only (B, tiles, 1024) partial extrema do, and a
// second small kernel reduces them over the tiles. It is bit-equal to the
// plain version.
//
// bf16 (encoder_mma_kernel + reduce_tiles_kernel). On the CUDA cores bf16
// runs no faster than f32 (each weight widened, each product an f32 FMA),
// 15x its tensor-core bound. This kernel runs conv2-5
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums, ldmatrix):
// - a block owns 256 points (16 warps: 8 along points, 2 along
//   channels; each warp 32 points); its activations stay in shared memory
//   in bf16, row-major [point][channel] with rows padded by 16 bytes (144
//   and 272 bytes), so ldmatrix's 8 row addresses fall in distinct banks;
// - conv1 (K=3) stays on the CUDA cores, three fmaf per output in the f32
//   route's order, so its bf16 outputs are the template's;
// - the weights come transposed, (F, C), so one output channel's inputs
//   are contiguous and ldmatrix yields B fragments directly: w2-w4 (32
//   KB) are staged once per block, w5 (256 KB) streams in 16 slabs of 64
//   channels through a 3-stage cp.async ring, the first two slabs landing
//   while conv1-4 run. Every tile reads all of w5 from L2: 256 KB per 256
//   points, 64 MB per call at B=32, N=2048 (128-point tiles would double
//   it); 195 KB of shared memory, one block per SM;
// - inner epilogue in registers: o = max(acc*scale + shift, 0) without FMA,
//   rounded to bf16 and stored in the next layer's A layout; conv5's
//   epilogue takes the max and min of each channel over the warp's valid
//   points (shuffles over the lanes, then the 8 point warps in a fixed
//   order through shared memory) into the same (B, tiles, 1024) partial
//   extrema as f32, which reduce_tiles_kernel finishes.
// Products of bf16 values are exact in f32; only the f32 order of conv2-5's
// sums differs from the plain version (and the tensor core's within a
// k16 step), which can flip one bf16 rounding of an inner activation: the
// route is held at the bf16 tolerance, not bit-equal. No atomics: two calls
// are bit-equal.
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
#include "mma.cuh"

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

// ---- bf16 route: tensor cores ----

constexpr int kMmaThreads = 512;  // 16 warps: 8 along points x 2 along F
constexpr int kMmaTileN = 256;    // points per block
constexpr int kWarpRows = 32;     // points per warp: two m16 tiles
constexpr int kSlabF = 64;        // conv5 channels per streamed w5 slab
constexpr int kSlabs = kF5 / kSlabF;
constexpr int kStages = 3;        // w5 slabs in flight
constexpr int kP64 = kF1 + 8;     // bf16 per row of a 64-wide array
constexpr int kP128 = kF4 + 8;    // bf16 per row of a 128-wide array
static_assert(kF1 == 64 && kF2 == 64 && kF3 == 64, "64-wide inner layers");
static_assert(kMmaTileN == 8 * kWarpRows, "8 warps along points");
// Shared memory, in bf16 elements (every offset a multiple of 16 bytes):
constexpr int kOffX = 0;                           // conv1, conv3 out
constexpr int kOffZ = kOffX + kMmaTileN * kP64;    // conv2 out, conv4 out
constexpr int kOffW2 = kOffZ + kMmaTileN * kP128;  // w2 (F, C) [64][72]
constexpr int kOffW3 = kOffW2 + kF2 * kP64;        // w3 [64][72]
constexpr int kOffW4 = kOffW3 + kF3 * kP64;        // w4 [128][72]
constexpr int kSlabElems = kSlabF * kP128;         // a w5 slab [64][136]
constexpr int kOffRing = kOffW4 + kF4 * kP64;
constexpr int kOffRed = kOffRing + kStages * kSlabElems;  // f32 [2][8][64]
constexpr int kMmaSmemBytes = kOffRed * 2 + 2 * 8 * kSlabF * 4;  // 199,680

// rows x cols bf16, row-major with row stride cols in device memory, into
// shared memory rows of `pitch`, 16 bytes per cp.async.
template <int kRows, int kCols, int kPitch>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  constexpr int kPerRow = kCols / 8;
  static_assert(kRows * kPerRow % kMmaThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < kRows * kPerRow / kMmaThreads; ++it) {
    const int k = threadIdx.x + it * kMmaThreads;
    const int r = k / kPerRow, c8 = k % kPerRow;
    cp_async16(dst + r * kPitch + c8 * 8, src + r * kCols + c8 * 8, 16);
  }
}

// acc[mi][j] = the warp's rows row0 + 16mi .. +15 of a ([rows][kAP] bf16)
// times the channels n0 + 8j .. +7 of wt ([F][kBP] bf16, w transposed),
// over k in [0, K). acc[mi][j][2h + e] is row row0 + 16mi + 8h + g, channel
// n0 + 8j + 2t + e (lane 4g + t).
template <int K, int NT, int kAP, int kBP>
__device__ __forceinline__ void warp_mma(const __nv_bfloat16* a,
                                         const __nv_bfloat16* wt, int row0,
                                         int n0, float (&acc)[2][NT][4]) {
  static_assert(NT % 2 == 0, "one ldmatrix.x4 feeds two channel blocks");
  const int lane = threadIdx.x % 32, q = lane / 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], a + (row0 + 16 * mi + lane % 16) * kAP + 16 * ks +
                              (lane / 16) * 8);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      // Matrices (channels 0-7, k 0-7), (0-7, k 8-15), (8-15, k 0-7),
      // (8-15, k 8-15) of this pair of blocks: b0, b1 of block 2jj, then
      // of block 2jj + 1.
      unsigned bf[4];
      ldmatrix_x4(bf, wt + (n0 + 16 * jj + (q / 2) * 8 + lane % 8) * kBP +
                          16 * ks + (q % 2) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * jj], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * jj + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// out[row][f] = bf16(max(acc * scale[f] + shift[f], 0)) for warp_mma's rows
// and channels; out rows of kOP bf16.
template <int NT, int kOP>
__device__ __forceinline__ void warp_store(const float (&acc)[2][NT][4],
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift,
                                           __nv_bfloat16* out, int row0,
                                           int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int f = n0 + 8 * j + 2 * t;
    const float s0 = scale[f], s1 = scale[f + 1];
    const float h0 = shift[f], h1 = shift[f + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float o0 =
            fmaxf(__fadd_rn(__fmul_rn(acc[mi][j][2 * h], s0), h0), 0.f);
        const float o1 =
            fmaxf(__fadd_rn(__fmul_rn(acc[mi][j][2 * h + 1], s1), h1), 0.f);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (row0 + 16 * mi + 8 * h + g) * kOP + f) =
            __floats2bfloat162_rn(o0, o1);
      }
  }
}

// One block per (256-point tile, batch element); grid (ceil(n/256), b).
// pts (b, n, 3) and w1 (3, 64) bf16; w2t..w5t the weights of conv2..conv5
// transposed, (F, C) row-major bf16, 16-byte aligned; affine as the f32
// route. Writes part_max/part_min (b, tiles, 1024).
__global__ void __launch_bounds__(kMmaThreads, 1)
encoder_mma_kernel(const __nv_bfloat16* __restrict__ pts,
                   const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2t,
                   const __nv_bfloat16* __restrict__ w3t,
                   const __nv_bfloat16* __restrict__ w4t,
                   const __nv_bfloat16* __restrict__ w5t,
                   const float* __restrict__ affine,
                   float* __restrict__ part_max,
                   float* __restrict__ part_min, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act_x = sm + kOffX;
  __nv_bfloat16* act_z = sm + kOffZ;
  __nv_bfloat16* w2s = sm + kOffW2;
  __nv_bfloat16* w3s = sm + kOffW3;
  __nv_bfloat16* w4s = sm + kOffW4;
  __nv_bfloat16* ring = sm + kOffRing;
  float* red = reinterpret_cast<float*>(sm + kOffRed);  // [max|min][8][64]
  const int tile = blockIdx.x, b = blockIdx.y, num_tiles = gridDim.x;
  const int n0 = tile * kMmaTileN;
  const int valid = min(kMmaTileN, n - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wp = warp % 8, wc = warp / 8;  // point warp, channel half
  const int row0 = wp * kWarpRows;

  // Copy group 0: w2..w4; groups 1, 2: w5's first two slabs. They land
  // while conv1 runs.
  stage_rows<kF2, kF1, kP64>(w2s, w2t);
  stage_rows<kF3, kF2, kP64>(w3s, w3t);
  stage_rows<kF4, kF3, kP64>(w4s, w4t);
  cp_async_commit();
  auto load_slab = [&](int s) {
    if (s < kSlabs)
      stage_rows<kSlabF, kF4, kP128>(ring + (s % kStages) * kSlabElems,
                                     w5t + static_cast<size_t>(s) * kSlabF * kF4);
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_slab(s);

  // conv1 on the CUDA cores: a thread per (point, 32 channels), three fmaf
  // per output in the f32 route's order; points past N are zeros.
  {
    const int p = threadIdx.x / 2, f0 = (threadIdx.x % 2) * 32;
    const __nv_bfloat16* src =
        pts + (static_cast<size_t>(b) * n + n0 + p) * kC0;
    float x[kC0];
#pragma unroll
    for (int c = 0; c < kC0; ++c) x[c] = p < valid ? to_f(src[c]) : 0.f;
#pragma unroll 4
    for (int j = 0; j < 32; j += 2) {
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f0 + j + e;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kC0; ++c) acc = fmaf(x[c], to_f(w1[c * kF1 + f]), acc);
        o[e] = fmaxf(__fadd_rn(__fmul_rn(acc, affine[f]), affine[kF1 + f]),
                     0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(act_x + p * kP64 + f0 + j) =
          __floats2bfloat162_rn(o[0], o[1]);
    }
  }
  cp_async_wait<kStages - 1>();  // group 0 (w2..w4) has landed
  __syncthreads();

  const float* a = affine + 2 * kF1;
  {
    float acc[2][4][4];
    warp_mma<kF1, 4, kP64, kP64>(act_x, w2s, row0, wc * 32, acc);
    warp_store<4, kP64>(acc, a, a + kF2, act_z, row0, wc * 32);
  }
  a += 2 * kF2;
  __syncthreads();
  {
    float acc[2][4][4];
    warp_mma<kF2, 4, kP64, kP64>(act_z, w3s, row0, wc * 32, acc);
    warp_store<4, kP64>(acc, a, a + kF3, act_x, row0, wc * 32);
  }
  a += 2 * kF3;
  __syncthreads();  // conv3 has read conv2's output, which conv4 overwrites
  {
    float acc[2][8][4];
    warp_mma<kF3, 8, kP64, kP64>(act_x, w4s, row0, wc * 64, acc);
    warp_store<8, kP128>(acc, a, a + kF4, act_z, row0, wc * 64);
  }

  // conv5, one w5 slab at a time: raw products, max and min per channel
  // over the valid points.
  const size_t out = (static_cast<size_t>(b) * num_tiles + tile) * kF5;
#pragma unroll 1
  for (int s = 0; s < kSlabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed
    __syncthreads();  // for every thread; conv4's output is complete, the
                      // oldest stage and red are free
    load_slab(s + kStages - 1);
    float acc[2][4][4];
    warp_mma<kF4, 4, kP128, kP128>(act_z, ring + (s % kStages) * kSlabElems,
                                   row0, wc * 32, acc);
    float mx[4][2], mn[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[j][e] = -INFINITY;
        mn[j][e] = INFINITY;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + 16 * mi + 8 * h + g < valid) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              mx[j][e] = fmaxf(mx[j][e], acc[mi][j][2 * h + e]);
              mn[j][e] = fminf(mn[j][e], acc[mi][j][2 * h + e]);
            }
        }
    // The 8 lanes of one t hold the same channels (xor 4, 8, 16 flip g).
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[j][e] = fmaxf(mx[j][e], __shfl_xor_sync(0xffffffffu, mx[j][e], off));
          mn[j][e] = fminf(mn[j][e], __shfl_xor_sync(0xffffffffu, mn[j][e], off));
        }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = wc * 32 + 8 * j + 2 * t + e;
          red[wp * kSlabF + ch] = mx[j][e];
          red[(8 + wp) * kSlabF + ch] = mn[j][e];
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kSlabF) {
      const int is_min = threadIdx.x / kSlabF, ch = threadIdx.x % kSlabF;
      const float* r = red + is_min * 8 * kSlabF + ch;
      float v = r[0];
#pragma unroll
      for (int i = 1; i < 8; ++i)
        v = is_min ? fminf(v, r[i * kSlabF]) : fmaxf(v, r[i * kSlabF]);
      (is_min ? part_min : part_max)[out + s * kSlabF + ch] = v;
    }
  }
}

int launch_bf16(const void* pts, const void* const* w, const void* affine,
                void* part_max, void* part_min, void* ymax, void* ymin, int b,
                int n, cudaStream_t stream) {
  // Set on every launch: the attribute belongs to the current device's
  // context, and setting it costs less than the launch.
  cudaError_t e = cudaFuncSetAttribute(
      encoder_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMmaSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int num_tiles = (n + kMmaTileN - 1) / kMmaTileN;
  using Bf = __nv_bfloat16;
  encoder_mma_kernel<<<dim3(num_tiles, b), kMmaThreads, kMmaSmemBytes,
                       stream>>>(
      static_cast<const Bf*>(pts), static_cast<const Bf*>(w[0]),
      static_cast<const Bf*>(w[1]), static_cast<const Bf*>(w[2]),
      static_cast<const Bf*>(w[3]), static_cast<const Bf*>(w[4]),
      static_cast<const float*>(affine), static_cast<float*>(part_max),
      static_cast<float*>(part_min), n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_tiles_kernel<<<dim3(kF5 / 256, b), 256, 0, stream>>>(
      static_cast<const float*>(part_max), static_cast<const float*>(part_min),
      static_cast<float*>(ymax), static_cast<float*>(ymin), num_tiles);
  return static_cast<int>(cudaGetLastError());
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

// Points per partial result of either route's (b, tiles, 1024) scratch.
extern "C" int pcae_encoder_tile_n(int bf16) {
  return bf16 ? kMmaTileN : kTileN;
}

// pts (b, n, 3) in the matmul type (bf16 != 0: bfloat16, else float),
// widths 3->64->64->64->128->1024. f32: w1..w5 the (C, F) row-major
// weights. bf16: w1 (3, 64) row-major, w2..w5 transposed, (F, C)
// row-major, all 16-byte aligned. affine the 640 f32 folded (scale, shift)
// rows of conv1..conv4; part_max/part_min (b, ceil(n/tile_n), 1024) f32
// scratch (pcae_encoder_tile_n); ymax/ymin (b, 1024) f32 outputs.
// Launches the route's tile kernel and the reduction on `stream`; returns
// cudaGetLastError().
extern "C" int pcae_fused_encoder_eval(int bf16, const void* pts,
                                       const void* w1, const void* w2,
                                       const void* w3, const void* w4,
                                       const void* w5, const void* affine,
                                       void* part_max, void* part_min,
                                       void* ymax, void* ymin, int b, int n,
                                       void* stream) {
  const void* w[5] = {w1, w2, w3, w4, w5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bf16(pts, w, affine, part_max, part_min, ymax, ymin,
                            b, n, s)
              : launch<float>(pts, w, affine, part_max, part_min, ymax, ymin,
                              b, n, s);
}
