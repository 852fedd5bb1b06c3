// Fused encoder head (conv5): Dense -> folded BN affine -> ReLU -> max and
// argmax over points (forward), and the head's backward from the one-hot
// cotangent that the max leaves (dx and dw).
//
// Replaces: pointnet_autoencoder_tpu/ops/fused_head.py:_fwd_kernel
// (launched by _forward_pallas) and :_bwd_kernel (launched by
// _backward_pallas). What they compute is the same; the TPU tiling is not
// carried over.
//
// Forward bound: operations. At B=32, N=2048, C=128, F=1024 the product is
// 2*B*N*C*F = 17.2 GFLOP on 34 MB of f32 input, so the FP32 pipes are the
// limit (0.256 ms at 67 TFLOP/s; in bf16 mode this first kernel still runs
// on CUDA cores, against a tensor-core bound of 0.017 ms: wgmma is later
// work). The design is the conv5 stage of csrc/fused_encoder.cu with x read
// from device memory: a block owns 64 points, holds them channel-major in
// shared memory ([C][68], row stride 68 = 4 mod 32), and each thread keeps a
// register tile of 4 channels by 16 points, so one weight load and four
// float4 shared loads feed 64 FMAs. The (B*N, F) activation never reaches
// device memory: each thread keeps the running max and its point index over
// its 16 points, the block reduces its 4 point groups in shared memory, and
// a second small kernel reduces the (B, tiles, F) partial results over the
// tiles. Every reduction scans in increasing point index with a strict '>',
// so the earliest point wins ties, as jnp.argmax and the TPU kernel do.
//
// Backward bound: bytes. The max makes dL/dy one-hot along points (one row
// per (b, channel)), so the work is B*F*C multiply-adds, not the dense
// product the TPU runs on its matrix unit; what must move is dx, (B, N, C),
// written once (33.5 MB in f32 at the sizes above, 0.010 ms at 3.35 TB/s).
// - dx: zero an f32 buffer, then one thread per (b, f, c) adds
//   gy[b,f]*w[c,f] into row argmax[b,f] with atomicAdd (several channels
//   can share a point). Neighbouring threads take neighbouring c, so a
//   warp's atomics land in one row. The w tile is staged through shared
//   memory so its reads are coalesced. In bf16 mode the buffer is f32
//   scratch cast to bf16 at the end, as the TPU kernel accumulates in f32.
//   The atomics' order varies from run to run, so dx does too, in the last
//   bits of each sum.
// - dw[c,f] = sum over b of x[b, argmax[b,f], c]*gy[b,f]: one thread per
//   (c, f), a loop over b in order; deterministic.
// gy is gvals rounded to the activation type first (fused_head.py:190).
//
// Types: x and w in T (float or bf16), f32 accumulation, the affine and
// ReLU in f32 without FMA contraction (__fmul_rn/__fadd_rn), as the plain
// version (ops/fused_head.py) computes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 128;              // input channels (conv4's width)
constexpr int kTileN = 64;           // points per block
constexpr int kStride = kTileN + 4;  // floats per channel row in shared memory
constexpr int kLanes = 64;           // threads along channels, 4 channels each
constexpr int kGroups = kThreads / kLanes;  // point groups
constexpr int kPpt = kTileN / kGroups;      // points per thread
constexpr int kPassF = 4 * kLanes;          // channels per pass
constexpr int kFTile = 32;                  // channels per dx block

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
head_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     float* __restrict__ part_max, int* __restrict__ part_arg,
                     int n, int f_total) {
  __shared__ __align__(16) float xs[kC * kStride];
  __shared__ float red_val[kGroups * kPassF];
  __shared__ int red_arg[kGroups * kPassF];
  const int tile = blockIdx.x, b = blockIdx.y, num_tiles = gridDim.x;
  const int n0 = tile * kTileN;
  const int valid = min(kTileN, n - n0);

  // The tile's points, channel-major, zero past N (and never picked).
  const T* src = x + (static_cast<size_t>(b) * n + n0) * kC;
  for (int k = threadIdx.x; k < kTileN * kC; k += kThreads) {
    const int p = k / kC, c = k % kC;
    xs[c * kStride + p] = p < valid ? to_f(src[k]) : 0.f;
  }
  __syncthreads();

  const int q = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  const size_t out = (static_cast<size_t>(b) * num_tiles + tile) * f_total;
  for (int f0 = 0; f0 < f_total; f0 += kPassF) {
    float acc[4][kPpt];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kPpt; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = to_f(w[static_cast<size_t>(c) * f_total + f0 + q + i * kLanes]);
      float xv[kPpt];
      const float4* row =
          reinterpret_cast<const float4*>(xs + c * kStride + g * kPpt);
#pragma unroll
      for (int j4 = 0; j4 < kPpt / 4; ++j4) {
        const float4 v = row[j4];
        xv[4 * j4] = v.x;
        xv[4 * j4 + 1] = v.y;
        xv[4 * j4 + 2] = v.z;
        xv[4 * j4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPpt; ++j) acc[i][j] = fmaf(xv[j], wv[i], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int fl = q + i * kLanes;
      const float sc = scale[f0 + fl], sh = shift[f0 + fl];
      float best = -INFINITY;
      int best_p = 0;
#pragma unroll
      for (int j = 0; j < kPpt; ++j) {
        const float o = fmaxf(__fadd_rn(__fmul_rn(acc[i][j], sc), sh), 0.f);
        if (g * kPpt + j < valid && o > best) {
          best = o;
          best_p = n0 + g * kPpt + j;
        }
      }
      red_val[g * kPassF + fl] = best;
      red_arg[g * kPassF + fl] = best_p;
    }
    __syncthreads();
    {
      // Groups in increasing point order; group 0 always holds point n0.
      const int fl = threadIdx.x;
      float best = red_val[fl];
      int best_p = red_arg[fl];
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) {
        const float v = red_val[gg * kPassF + fl];
        if (v > best) {
          best = v;
          best_p = red_arg[gg * kPassF + fl];
        }
      }
      part_max[out + f0 + fl] = best;
      part_arg[out + f0 + fl] = best_p;
    }
    __syncthreads();  // red_* are rewritten by the next pass
  }
}

// (B, tiles, F) partial (max, argmax) -> (B, F); tiles in increasing order.
__global__ void head_fwd_reduce_kernel(const float* __restrict__ part_max,
                                       const int* __restrict__ part_arg,
                                       float* __restrict__ out_max,
                                       int* __restrict__ out_arg,
                                       int num_tiles, int f_total) {
  const int b = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= f_total) return;
  const size_t base = static_cast<size_t>(b) * num_tiles * f_total + f;
  float best = part_max[base];
  int best_p = part_arg[base];
  for (int t = 1; t < num_tiles; ++t) {
    const float v = part_max[base + static_cast<size_t>(t) * f_total];
    if (v > best) {
      best = v;
      best_p = part_arg[base + static_cast<size_t>(t) * f_total];
    }
  }
  out_max[static_cast<size_t>(b) * f_total + f] = best;
  out_arg[static_cast<size_t>(b) * f_total + f] = best_p;
}

// dx32[b, argmax[b,f], c] += gy[b,f] * w[c,f] for a tile of 32 channels f.
template <typename T>
__global__ void __launch_bounds__(kThreads)
head_bwd_dx_kernel(const T* __restrict__ w, const float* __restrict__ gvals,
                   const int* __restrict__ argmax, float* __restrict__ dx32,
                   int n, int f_total) {
  __shared__ float ws[kC * (kFTile + 1)];
  __shared__ float gy[kFTile];
  __shared__ int rows[kFTile];
  const int f0 = blockIdx.x * kFTile, b = blockIdx.y;
  for (int k = threadIdx.x; k < kC * kFTile; k += kThreads) {
    const int c = k / kFTile, fl = k % kFTile;
    ws[c * (kFTile + 1) + fl] = to_f(w[static_cast<size_t>(c) * f_total + f0 + fl]);
  }
  if (threadIdx.x < kFTile) {
    const size_t o = static_cast<size_t>(b) * f_total + f0 + threadIdx.x;
    gy[threadIdx.x] = round_to<T>(gvals[o]);
    rows[threadIdx.x] = argmax[o];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kC * kFTile; k += kThreads) {
    const int fl = k / kC, c = k % kC;
    const float gv = gy[fl];
    const int p = rows[fl];
    if (gv == 0.f || p < 0 || p >= n) continue;  // nothing to add / no row
    atomicAdd(dx32 + (static_cast<size_t>(b) * n + p) * kC + c,
              __fmul_rn(gv, ws[c * (kFTile + 1) + fl]));
  }
}

// dw[c,f] = sum over b (in order) of x[b, argmax[b,f], c] * gy[b,f].
template <typename T>
__global__ void __launch_bounds__(kC)
head_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ gvals,
                   const int* __restrict__ argmax, float* __restrict__ dw,
                   int b_total, int n, int f_total) {
  const int f = blockIdx.x, c = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < b_total; ++b) {
    const size_t o = static_cast<size_t>(b) * f_total + f;
    const int p = argmax[o];
    if (p < 0 || p >= n) continue;
    const float xv = to_f(x[(static_cast<size_t>(b) * n + p) * kC + c]);
    acc = __fadd_rn(acc, __fmul_rn(xv, round_to<T>(gvals[o])));
  }
  dw[static_cast<size_t>(c) * f_total + f] = acc;
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* scale,
               const void* shift, void* part_max, void* part_arg,
               void* out_max, void* out_arg, int b, int n, int f,
               cudaStream_t stream) {
  const int num_tiles = (n + kTileN - 1) / kTileN;
  head_fwd_tile_kernel<T><<<dim3(num_tiles, b), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(part_max), static_cast<int*>(part_arg), n, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  head_fwd_reduce_kernel<<<dim3((f + 255) / 256, b), 256, 0, stream>>>(
      static_cast<const float*>(part_max), static_cast<const int*>(part_arg),
      static_cast<float*>(out_max), static_cast<int*>(out_arg), num_tiles, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* gvals,
               const void* argmax, void* dx32, void* dx, void* dw, int b,
               int n, int f, cudaStream_t stream) {
  const size_t count = static_cast<size_t>(b) * n * kC;
  cudaError_t e = cudaMemsetAsync(dx32, 0, count * sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  head_bwd_dx_kernel<T><<<dim3(f / kFTile, b), kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(gvals),
      static_cast<const int*>(argmax), static_cast<float*>(dx32), n, f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  head_bwd_dw_kernel<T><<<f, kC, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gvals),
      static_cast<const int*>(argmax), static_cast<float*>(dw), b, n, f);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == dx32) return static_cast<int>(e);
  f32_to_bf16_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                       stream>>>(static_cast<const float*>(dx32),
                                 static_cast<__nv_bfloat16*>(dx), count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcae_head_tile_n() { return kTileN; }
extern "C" int pcae_head_channels() { return kC; }
extern "C" int pcae_head_feature_multiple() { return kPassF; }

// x (b, n, 128) and w (128, f) row-major in the matmul type (bf16 != 0:
// bfloat16, else float), f a multiple of 256; scale/shift (f,) f32;
// part_max/part_arg (b, ceil(n/64), f) f32/int32 scratch; out_max (b, f)
// f32 and out_arg (b, f) int32. Launches the tile kernel and the reduction
// on `stream`; returns cudaGetLastError().
extern "C" int pcae_fused_head_fwd(int bf16, const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   void* part_max, void* part_arg,
                                   void* out_max, void* out_arg, int b, int n,
                                   int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, scale, shift, part_max,
                                          part_arg, out_max, out_arg, b, n, f,
                                          s)
              : launch_fwd<float>(x, w, scale, shift, part_max, part_arg,
                                  out_max, out_arg, b, n, f, s);
}

// x (b, n, 128) and w (128, f) in the matmul type, gvals (b, f) f32,
// argmax (b, f) int32 -> dx (b, n, 128) in the matmul type and dw (128, f)
// f32. dx32 is (b, n, 128) f32: the output itself in f32 mode (pass the same
// pointer as dx), scratch in bf16 mode. Zeroes dx32, then launches the dx,
// dw (and, in bf16 mode, cast) kernels on `stream`; returns
// cudaGetLastError().
extern "C" int pcae_fused_head_bwd(int bf16, const void* x, const void* w,
                                   const void* gvals, const void* argmax,
                                   void* dx32, void* dx, void* dw, int b,
                                   int n, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, w, gvals, argmax, dx32, dx, dw,
                                          b, n, f, s)
              : launch_bwd<float>(x, w, gvals, argmax, dx32, dx, dw, b, n, f,
                                  s);
}
