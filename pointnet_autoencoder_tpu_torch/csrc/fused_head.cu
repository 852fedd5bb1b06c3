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
// 2*B*N*C*F = 17.2 GFLOP: in f32 on 34 MB of input the FP32 pipes are the
// limit (0.256 ms at 67 TFLOP/s); in bf16 the tensor cores (0.017 ms at 989
// TFLOP/s; x is 16.8 MB, 0.005 ms at 3.35 TB/s). The (B*N, F) activation
// never reaches device memory in either route. Two routes, by type:
//
// f32 (head_fwd_tile_kernel + head_fwd_reduce_kernel): full f32, so CUDA
// cores. The conv5 stage of csrc/fused_encoder.cu with x read from device
// memory: a block owns 64 points, holds them channel-major in shared memory
// ([C][68], row stride 68 = 4 mod 32), and each thread keeps a register
// tile of 4 channels by 16 points, so one weight load and four float4
// shared loads feed 64 FMAs. Each thread keeps the running max and its
// point index over its 16 points, the block reduces its 4 point groups in
// shared memory, and a second small kernel reduces the (B, tiles, F)
// partial results over the tiles. Every reduction scans in increasing
// point index with a strict '>', so the earliest point wins ties. It
// reaches about half of its f32 bound.
//
// bf16 (head_fwd_mma_kernel): the same CUDA-core kernel ran bf16 slower
// than f32 (0.62 ms against 0.51, 36x its tensor-core bound): each weight
// was read from L2 as a scalar and widened, x widened into shared memory,
// and a second launch reduced a (B, tiles, F) scratch. This kernel puts the
// product on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulation) in one launch and no scratch:
// - a block owns one batch element and 128 output channels and loops over
//   all N points itself: 256 blocks at B=32, F=1024;
// - its w tile (128 x 128 bf16) is staged once through shared memory into
//   registers: each of the 8 warps keeps the B fragments of its 16
//   channels for all 8 k-steps (32 registers), so w is never read again;
// - x tiles of 64 points x 128 channels (16 KB) stream through a ring of
//   3 stages with cp.async (rows past N zero-filled), rows padded to 272
//   bytes so ldmatrix's 8 row addresses fall in distinct banks; each warp
//   computes all 64 points x its 16 channels per tile (4 x 2 mma per
//   k-step, 64 per tile);
// - at most 128 registers a thread, so two blocks share an SM: their
//   per-tile barriers are independent, and one block's epilogue overlaps
//   the other's products (a layout that fitted one block per SM ran its
//   8 warps' products and epilogues in lockstep, and was slower);
// - epilogue in registers: o = max(acc*scale + shift, 0) without FMA, and
//   a running max and point index per channel over the thread's rows (the
//   points of one residue mod 8) in increasing point order with a strict
//   '>'. The 8 lanes that share the channels combine by shuffles with an
//   explicit tie-break: the larger value, or at equal values the lower
//   point index. The result is the first maximum, as jnp.argmax and the
//   TPU kernel give.
// bf16 products are exact in f32, so the kernel differs from the plain
// version only in the order of the f32 sums. No atomics: two calls are
// bit-equal.
//
// Backward bound: bytes. The max makes dL/dy one-hot along points (one row
// per (b, channel)), so the work is B*F*C multiply-adds, not the dense
// product the TPU runs on its matrix unit; what must move is dx, (B, N, C),
// written once (33.5 MB in f32 at the sizes above, 0.010 ms at 3.35 TB/s).
// - dx (head_bwd_dx_kernel): every row written once, in the matmul type,
//   zeros included; no (B, N, C) scratch, no memset, no cast, no atomics
//   (the only scratch is w transposed, (F, C) in the matmul type). One block
//   per (batch element, chunk of 128 rows) reads that element's F
//   (argmax, gvals) entries and sorts the channels whose argmax row lies
//   in its chunk into one bucket per row in shared memory, by counting,
//   stable in f (per round of 256 channels, a channel goes after the same
//   row's channels of earlier rounds, warps and lanes: __match_any_sync
//   and per-warp counts). Warps then take rows one at a time from a
//   shared counter (in training a few rows can take hundreds of channels,
//   and a fixed row-to-warp map could give one warp several); for its row a
//   warp walks the bucket in ascending f, 16 weight loads in flight, and
//   each lane sums 4 of the 128 input channels: acc[c] = ((0 + p_f1) +
//   p_f2) + ... with p_f = gy_f * w[c, f], no FMA, the order in which
//   index_add_ adds on the CPU (head_bwd_plain), so dx is bit-equal to the
//   plain version there and over two calls. The lanes read one channel's
//   128 weights at once from w transposed (F, C), which
//   head_w_transpose_kernel writes first (w is (C, F): reading a column of
//   it directly would take one 32-byte sector per value). The sort takes
//   32 bytes per channel of shared memory; its phases are short and few
//   (5 barriers), since at these sizes a block's time is their latency.
// - dw[c,f] = sum over b of x[b, argmax[b,f], c]*gy[b,f]: one thread per
//   (c, f), a loop over b in order; deterministic.
// gy is gvals rounded to the activation type first (fused_head.py:190).
//
// Types: x and w in the matmul type (float or bf16; T in the backward's
// kernels), f32 accumulation, the affine and ReLU in f32 without FMA
// contraction (__fmul_rn/__fadd_rn), as the plain version
// (ops/fused_head.py) computes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 128;              // input channels (conv4's width)
constexpr int kTileN = 64;           // points per block
constexpr int kStride = kTileN + 4;  // floats per channel row in shared memory
constexpr int kLanes = 64;           // threads along channels, 4 channels each
constexpr int kGroups = kThreads / kLanes;  // point groups
constexpr int kPpt = kTileN / kGroups;      // points per thread
constexpr int kPassF = 4 * kLanes;          // channels per pass
constexpr int kDxRows = 128;                // rows of dx per block
constexpr int kDxThreads = 256;             // 8 warps; F % 256 == 0
constexpr int kDxWarps = kDxThreads / 32;
constexpr int kDxBatch = 16;                // weight loads in flight per row
constexpr int kTrTile = 32;                 // w transpose tile

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

__global__ void __launch_bounds__(kThreads, 2)
head_fwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
  const float* src = x + (static_cast<size_t>(b) * n + n0) * kC;
  for (int k = threadIdx.x; k < kTileN * kC; k += kThreads) {
    const int p = k / kC, c = k % kC;
    xs[c * kStride + p] = p < valid ? src[k] : 0.f;
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
        wv[i] = w[static_cast<size_t>(c) * f_total + f0 + q + i * kLanes];
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

// ---- bf16 route: tensor cores ----

constexpr int kMmaThreads = 256;     // 8 warps along F
constexpr int kWarpF = 16;           // output channels per warp
constexpr int kMmaTileN = 64;        // points per streamed x tile
constexpr int kMmaTileF = 128;       // output channels per block
constexpr int kMmaStages = 3;        // x tiles in flight
constexpr int kMmaKSteps = kC / 16;  // k-steps of 16 channels
constexpr int kXPitch = kC + 8;      // bf16 per x row in shared memory
constexpr int kWPitch = kMmaTileF + 8;  // bf16 per staged w row
constexpr size_t kXStageBytes = kMmaTileN * kXPitch * 2;
constexpr size_t kMmaSmemBytes = kMmaStages * kXStageBytes;  // 52,224
static_assert(kC * kWPitch * 2 <= kMmaSmemBytes, "w tile fits the ring");
static_assert(kWarpF * kMmaThreads / 32 == kMmaTileF, "warps cover F");

// (v, p) beats (best, best_p): a larger value, or the lower point index at
// an equal value.
__device__ __forceinline__ bool head_beats(float v, int p, float best,
                                           int best_p) {
  return v > best || (v == best && p < best_p);
}

// One block per (128 output channels, batch element); grid (F/128, B). x
// (b, n, 128) and w (128, F) bf16, both 16-byte aligned; writes out_max and
// out_arg (b, F) directly.
__global__ void __launch_bounds__(kMmaThreads, 2)
head_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    float* __restrict__ out_max, int* __restrict__ out_arg,
                    int n, int f_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f0 = blockIdx.x * kMmaTileF, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int fw = warp * kWarpF;  // this warp's channels: f0 + fw .. +15

  // The w tile through shared memory into this warp's B fragments: b0 of
  // (k-step ks, 8-channel group j) holds w[16ks + 2t, +1][col], b1 the
  // same 8 rows on, col = fw + 8j + g.
  {
    unsigned short* ws = reinterpret_cast<unsigned short*>(smem);
#pragma unroll
    for (int it = 0; it < kC * (kMmaTileF / 8) / kMmaThreads; ++it) {
      const int k = threadIdx.x + it * kMmaThreads;
      const int row = k / (kMmaTileF / 8), c8 = k % (kMmaTileF / 8);
      cp_async16(ws + row * kWPitch + c8 * 8,
                 w + static_cast<size_t>(row) * f_total + f0 + c8 * 8, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  unsigned bfrag[kMmaKSteps][kWarpF / 8][2];
  {
    const unsigned short* ws = reinterpret_cast<const unsigned short*>(smem);
#pragma unroll
    for (int ks = 0; ks < kMmaKSteps; ++ks)
#pragma unroll
      for (int j = 0; j < kWarpF / 8; ++j) {
        const int col = fw + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k0 = ks * 16 + h * 8 + 2 * t;
          const unsigned lo = ws[k0 * kWPitch + col];
          const unsigned hi = ws[(k0 + 1) * kWPitch + col];
          bfrag[ks][j][h] = lo | (hi << 16);
        }
      }
  }
  // This thread's channels: (j, e) is f0 + fw + 8j + 2t + e.
  float sc[kWarpF / 8][2], sh[kWarpF / 8][2], best[kWarpF / 8][2];
  int best_p[kWarpF / 8][2];
#pragma unroll
  for (int j = 0; j < kWarpF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = f0 + fw + j * 8 + 2 * t + e;
      sc[j][e] = scale[f];
      sh[j][e] = shift[f];
      best[j][e] = -INFINITY;
      best_p[j][e] = 0x7fffffff;
    }
  __syncthreads();  // the w tile's shared memory becomes the x ring

  const int num_tiles = (n + kMmaTileN - 1) / kMmaTileN;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * n * kC;
  auto load_tile = [&](int tile) {
    if (tile < num_tiles) {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
          smem + (tile % kMmaStages) * kXStageBytes);
#pragma unroll
      for (int it = 0; it < kMmaTileN * (kC / 8) / kMmaThreads; ++it) {
        const int k = threadIdx.x + it * kMmaThreads;
        const int r = k / (kC / 8), c8 = k % (kC / 8);
        const int p = tile * kMmaTileN + r;
        const bool ok = p < n;
        cp_async16(dst + r * kXPitch + c8 * 8,
                   xb + static_cast<size_t>(ok ? p : 0) * kC + c8 * 8,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) load_tile(s);

  for (int tile = 0; tile < num_tiles; ++tile) {
    cp_async_wait<kMmaStages - 2>();  // this tile's copies have landed
    __syncthreads();  // for every thread; and the oldest stage is free
    load_tile(tile + kMmaStages - 1);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + (tile % kMmaStages) * kXStageBytes);
    float acc[kMmaTileN / 16][kWarpF / 8][4];
#pragma unroll
    for (int mi = 0; mi < kMmaTileN / 16; ++mi)
#pragma unroll
      for (int j = 0; j < kWarpF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMmaKSteps; ++ks) {
#pragma unroll
      for (int mi = 0; mi < kMmaTileN / 16; ++mi) {
        unsigned a[4];
        ldmatrix_x4(a, xs + (mi * 16 + lane % 16) * kXPitch + ks * 16 +
                           (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kWarpF / 8; ++j)
          mma_bf16(acc[mi][j], a, bfrag[ks][j][0], bfrag[ks][j][1]);
      }
    }
    // acc[mi][j][2h + e] is point tile*64 + 16mi + 8h + g: the thread's
    // rows in increasing point order.
#pragma unroll
    for (int mi = 0; mi < kMmaTileN / 16; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tile * kMmaTileN + mi * 16 + h * 8 + g;
        if (p < n) {
#pragma unroll
          for (int j = 0; j < kWarpF / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float o = fmaxf(
                  __fadd_rn(__fmul_rn(acc[mi][j][2 * h + e], sc[j][e]),
                            sh[j][e]),
                  0.f);
              if (o > best[j][e]) {
                best[j][e] = o;
                best_p[j][e] = p;
              }
            }
        }
      }
  }

  // The 8 lanes of one t hold the same channels over the points of one
  // residue mod 8 each: combine them (xor 4, 8, 16 flip the bits of g).
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int j = 0; j < kWarpF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = __shfl_xor_sync(0xffffffffu, best[j][e], off);
        const int p = __shfl_xor_sync(0xffffffffu, best_p[j][e], off);
        if (head_beats(v, p, best[j][e], best_p[j][e])) {
          best[j][e] = v;
          best_p[j][e] = p;
        }
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kWarpF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t o =
            static_cast<size_t>(b) * f_total + f0 + fw + j * 8 + 2 * t + e;
        out_max[o] = best[j][e];
        out_arg[o] = best_p[j][e];
      }
  }
}

// wt (F, C) = w (C, F) transposed, through a 32 x 32 shared tile; Bits is
// an unsigned type of the matmul type's size (the values only move).
template <typename Bits>
__global__ void head_w_transpose_kernel(const Bits* __restrict__ w,
                                        Bits* __restrict__ wt, int f_total) {
  __shared__ Bits tile[kTrTile][kTrTile + 1];
  const int f0 = blockIdx.x * kTrTile, c0 = blockIdx.y * kTrTile;
  for (int i = threadIdx.y; i < kTrTile; i += blockDim.y)
    tile[i][threadIdx.x] =
        w[static_cast<size_t>(c0 + i) * f_total + f0 + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.y; i < kTrTile; i += blockDim.y)
    wt[static_cast<size_t>(f0 + i) * kC + c0 + threadIdx.x] =
        tile[threadIdx.x][i];
}

// Four consecutive values of the matmul type: loaded as they are stored
// (Raw4), widened to f32 (exactly), and stored back rounded to nearest even.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ void unpack4(float4 q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void unpack4(uint2 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x << 16);  // the lower address holds element 0
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

static_assert(kC == 4 * 32, "a lane sums 4 input channels of a row");
static_assert(kDxRows == 4 * 32, "one warp scans the rows, 4 per lane");

// Dynamic shared memory of head_bwd_dx_kernel, in 4-byte words per channel:
// its row and gy, its bucket entry (f, gy), and per round of kDxThreads
// channels a (warp, row) table of kDxWarps * kDxRows words.
constexpr int kDxWordsPerChannel = 4 + kDxWarps * kDxRows / kDxThreads;

// One block per (chunk of kDxRows rows, batch element); grid
// (ceil(n/kDxRows), b). wt (F, C) in the matmul type (w transposed), dx
// (b, n, C) in the matmul type; dynamic shared memory
// 4 * kDxWordsPerChannel * f_total bytes. dx[b, r, c] = sum over the
// channels f with argmax[b,f] == r, in ascending f, of gy[b,f] * w[c,f],
// from +0; every row of the chunk is written once.
template <typename T>
__global__ void __launch_bounds__(kDxThreads)
head_bwd_dx_kernel(const T* __restrict__ wt, const float* __restrict__ gvals,
                   const int* __restrict__ argmax, T* __restrict__ dx, int n,
                   int f_total) {
  extern __shared__ int words[];
  int* row_of = words;  // per channel: its row in the chunk, or -1
  float* gy = reinterpret_cast<float*>(row_of + f_total);
  int* bucket_f = row_of + 2 * f_total;  // by row, ascending f
  float* bucket_g = reinterpret_cast<float*>(row_of + 3 * f_total);
  // before[(round * kDxWarps + warp) * kDxRows + k]: the count of row k's
  // channels in that (round, warp), then the count before it.
  int* before = row_of + 4 * f_total;
  __shared__ int start[kDxRows + 1];  // bucket k is [start[k], start[k+1])
  __shared__ int count[kDxRows];
  __shared__ int next_row;
  const int b = blockIdx.y, r0 = blockIdx.x * kDxRows;
  const int rows = min(kDxRows, n - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rounds = f_total / kDxThreads;
  const size_t bf = static_cast<size_t>(b) * f_total;

  // Every channel's row and gy, all loads in flight at once.
#pragma unroll 4
  for (int f = threadIdx.x; f < f_total; f += kDxThreads) {
    const int k = argmax[bf + f] - r0;
    row_of[f] = k >= 0 && k < rows ? k : -1;
    gy[f] = round_to<T>(gvals[bf + f]);
  }
  for (int i = threadIdx.x; i < rounds * kDxWarps * kDxRows; i += kDxThreads)
    before[i] = 0;
  if (threadIdx.x == 0) next_row = 0;
  __syncthreads();
  // Per round and warp, each row's channel count (lanes with the same row
  // found by __match_any_sync; the lowest one writes).
  for (int r = 0; r < rounds; ++r) {
    const int k = row_of[r * kDxThreads + threadIdx.x];
    const unsigned same = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (same & ((1u << lane) - 1u)) == 0)
      before[(r * kDxWarps + warp) * kDxRows + k] = __popc(same);
  }
  __syncthreads();
  // Per row, the counts become the count before each (round, warp), in f
  // order; count[k] is the row's total.
  if (threadIdx.x < kDxRows) {
    int run = 0;
    for (int rw = 0; rw < rounds * kDxWarps; ++rw) {
      int* c = before + rw * kDxRows + threadIdx.x;
      const int here = *c;
      *c = run;
      run += here;
    }
    count[threadIdx.x] = run;
  }
  __syncthreads();
  // Bucket starts: an exclusive scan of the counts.
  if (warp == 0) {
    int c[4], sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = count[4 * lane + i];
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      start[4 * lane + i] = run;
      run += c[i];
    }
    if (lane == 31) start[kDxRows] = incl;
  }
  __syncthreads();
  // Each channel at its rank in its row's bucket: after the (round, warp)s
  // before it and the lower lanes of its own.
  for (int r = 0; r < rounds; ++r) {
    const int f = r * kDxThreads + threadIdx.x;
    const int k = row_of[f];
    const unsigned same = __match_any_sync(0xffffffffu, k);
    if (k >= 0) {
      const int at = start[k] + before[(r * kDxWarps + warp) * kDxRows + k] +
                     __popc(same & ((1u << lane) - 1u));
      bucket_f[at] = f;
      bucket_g[at] = gy[f];
    }
  }
  __syncthreads();

  // Rows one at a time to whichever warp is free; a row's bucket in
  // ascending f, kDxBatch weight loads in flight, the adds in order.
  using Raw = typename Raw4<T>::type;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&next_row, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= rows) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int end = start[k + 1];
    for (int q0 = start[k]; q0 < end; q0 += kDxBatch) {
      Raw raw[kDxBatch];
#pragma unroll
      for (int i = 0; i < kDxBatch; ++i)
        if (q0 + i < end)
          raw[i] = *reinterpret_cast<const Raw*>(
              wt + static_cast<size_t>(bucket_f[q0 + i]) * kC + 4 * lane);
#pragma unroll
      for (int i = 0; i < kDxBatch; ++i)
        if (q0 + i < end) {
          float wv[4];
          unpack4(raw[i], wv);
          const float g = bucket_g[q0 + i];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[c] = __fadd_rn(acc[c], __fmul_rn(g, wv[c]));
        }
    }
    store4(dx + (static_cast<size_t>(b) * n + r0 + k) * kC + 4 * lane, acc);
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

int launch_fwd_f32(const void* x, const void* w, const void* scale,
                   const void* shift, void* part_max, void* part_arg,
                   void* out_max, void* out_arg, int b, int n, int f,
                   cudaStream_t stream) {
  const int num_tiles = (n + kTileN - 1) / kTileN;
  head_fwd_tile_kernel<<<dim3(num_tiles, b), kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(part_max), static_cast<int*>(part_arg), n, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  head_fwd_reduce_kernel<<<dim3((f + 255) / 256, b), 256, 0, stream>>>(
      static_cast<const float*>(part_max), static_cast<const int*>(part_arg),
      static_cast<float*>(out_max), static_cast<int*>(out_arg), num_tiles, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_bf16(const void* x, const void* w, const void* scale,
                    const void* shift, void* out_max, void* out_arg, int b,
                    int n, int f, cudaStream_t stream) {
  // Set on every launch: the attribute belongs to the current device's
  // context, and setting it costs less than the launch.
  const cudaError_t set = cudaFuncSetAttribute(
      head_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  head_fwd_mma_kernel<<<dim3(f / kMmaTileF, b), kMmaThreads, kMmaSmemBytes,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out_max),
      static_cast<int*>(out_arg), n, f);
  return static_cast<int>(cudaGetLastError());
}

// Bits: an unsigned type of T's size, for the transpose.
template <typename T, typename Bits>
int launch_bwd(const void* x, const void* w, void* wt, const void* gvals,
               const void* argmax, void* dx, void* dw, int b, int n, int f,
               cudaStream_t stream) {
  static_assert(sizeof(Bits) == sizeof(T), "the transpose moves T's bits");
  head_w_transpose_kernel<Bits>
      <<<dim3(f / kTrTile, kC / kTrTile), dim3(kTrTile, 8), 0, stream>>>(
          static_cast<const Bits*>(w), static_cast<Bits*>(wt), f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // 32 KB at F = 1024; past 48 KB only with the opt-in.
  const int smem = kDxWordsPerChannel * f * static_cast<int>(sizeof(int));
  e = cudaFuncSetAttribute(head_bwd_dx_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  head_bwd_dx_kernel<T>
      <<<dim3((n + kDxRows - 1) / kDxRows, b), kDxThreads, smem, stream>>>(
          static_cast<const T*>(wt), static_cast<const float*>(gvals),
          static_cast<const int*>(argmax), static_cast<T*>(dx), n, f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  head_bwd_dw_kernel<T><<<f, kC, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gvals),
      static_cast<const int*>(argmax), static_cast<float*>(dw), b, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Points per partial result of the f32 forward's scratch.
extern "C" int pcae_head_tile_n() { return kTileN; }
extern "C" int pcae_head_channels() { return kC; }
static_assert(kPassF % kMmaTileF == 0, "one multiple for both routes");
extern "C" int pcae_head_feature_multiple() { return kPassF; }

// x (b, n, 128) and w (128, f) row-major in the matmul type, f a multiple
// of 256; scale/shift (f,) f32; out_max (b, f) f32 and out_arg (b, f)
// int32. bf16 != 0: bfloat16 x and w, both 16-byte aligned; one launch of
// the tensor-core kernel; part_max/part_arg are not used (may be null).
// Else float: part_max/part_arg (b, ceil(n/64), f) f32/int32 scratch; the
// tile kernel and the reduction. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int pcae_fused_head_fwd(int bf16, const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   void* part_max, void* part_arg,
                                   void* out_max, void* out_arg, int b, int n,
                                   int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd_bf16(x, w, scale, shift, out_max, out_arg, b, n,
                                f, s)
              : launch_fwd_f32(x, w, scale, shift, part_max, part_arg,
                               out_max, out_arg, b, n, f, s);
}

// x (b, n, 128) and w (128, f) in the matmul type, gvals (b, f) f32,
// argmax (b, f) int32 -> dx (b, n, 128) in the matmul type and dw (128, f)
// f32; f a multiple of 256. wt is (f, 128) scratch in the matmul type (w
// transposed); wt and dx 16-byte aligned. Launches the transpose, dx and
// dw kernels on `stream`; returns cudaGetLastError().
extern "C" int pcae_fused_head_bwd(int bf16, const void* x, const void* w,
                                   void* wt, const void* gvals,
                                   const void* argmax, void* dx, void* dw,
                                   int b, int n, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16, unsigned short>(
                    x, w, wt, gvals, argmax, dx, dw, b, n, f, s)
              : launch_bwd<float, unsigned>(x, w, wt, gvals, argmax, dx, dw,
                                            b, n, f, s);
}
