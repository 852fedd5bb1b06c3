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
// Types: x and w in the matmul type (float or bf16; T in the backward's
// kernels), f32 accumulation, the affine and ReLU in f32 without FMA
// contraction (__fmul_rn/__fadd_rn), as the plain version
// (ops/fused_head.py) computes them.
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 16 of a 16x16 tile at column (l / 16) * 8, which yields the A
// fragment of mma.m16n8k16 (a0 rows 0-7 / k 0-7, a1 rows 8-15, a2 k 8-15,
// a3 both).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
