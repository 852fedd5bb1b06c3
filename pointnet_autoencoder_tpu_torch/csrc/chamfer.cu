// Chamfer forward (nearest-neighbour squared distance and index) and its
// gradient, both directions in one launch each.
//
// Forward. Replaces: pointnet_autoencoder_tpu/ops/chamfer.py:_nn_direction_kernel
// (launched once per direction by _nn_one_direction_pallas). Its shape here
// is the reference CUDA op's (tf_nndistance_g.cu:5-127), not the TPU's:
// one thread per query point with its coordinates in registers, the other
// cloud streamed through shared memory in tiles.
//
// Bound: operations. The function needs each pair's d2 once (3 sub, 3 mul,
// 2 add) and one compare per direction: 10 f32 operations per pair, so at
// B=32, N=M=2048 it is 1.34e9 operations on 1.6 MB of input and output.
// This kernel computes d2 once per direction (9 operations per pair and
// direction, 18 in all): the two directions are independent passes of
// the reference's shape, so about 1.8x of the bound is this design's own.
// The candidate tile is read from shared memory as one float4 broadcast
// per pair (every thread of a warp reads the same address), which leaves
// the FP32 pipes as the limit.
//
// Numerics, held equal to the plain version (ops/chamfer.py:
// nn_distance_plain) bit for bit:
// - d2 = ((dx*dx + dy*dy) + dz*dz) in the order of the reference's
//   sqdist_matrix, with __fmul_rn/__fadd_rn so nvcc does not contract into
//   FMAs, which would round differently;
// - candidates are scanned in increasing index with a strict '<', so the
//   first minimum wins ties, as torch.min/argmin and the TPU kernel do;
// - ragged tiles are bounds-checked (no far-away padding points).
//
// Gradient. Replaces: pointnet_autoencoder_tpu/ops/chamfer.py:
// _nn_grad_direction_kernel (launched per direction by
// _nn_grad_one_direction_pallas from _nn_distance_bwd_pallas), which turns
// the segment-sum into one-hot matrix products because a scatter on the TPU
// is element-serial. Computes gx1 = t1 + segsum(-t2 by idx2) and gx2 =
// t2 + segsum(-t1 by idx1), t = (2 g) (q - r[idx]).
// Bound: bytes. Each point of either cloud has its xyz, index and
// cotangent read once and its gradient written once, 32 bytes: 4.2 MB at
// B=32, N=M=2048, about 1.3 us at 3.35 TB/s; the arithmetic is ~13
// operations per point. At that size the kernel is bound by the latency of
// a few block-wide phases and by shared-memory traffic, not by bytes.
//
// Design: a deterministic segment sum in one launch, no memset and no
// atomics on the outputs. One block per (batch element, direction, chunk
// of rows) owns those output rows (two chunks at B=32 fill 128 SMs). It
// copies its rows' points, indices and cotangents and every source's into
// its workspace with cp.async (all in flight at once; the gathers behind
// the indices then read shared memory), counts the sources that fall in
// its rows (shared-memory atomics), scans the counts, fills each row's
// bucket in any order and then writes each source's -t at its rank by
// index in its bucket, so every bucket is in ascending source order.
// Each owner writes its row once: t + ((0 + -t_a) + -t_b) + ..., in
// ascending source index, the order in which index_add_ adds on the CPU;
// two calls give the same bits. The workspace is about 7 R + 9 S + 1
// words for R rows and S sources, in shared memory up to kGradSmemBytes;
// past that one block per direction works in a scratch buffer the caller
// allocates (pcae_nn_distance_grad_scratch) with the same code. A
// bucket's ranking costs its size squared over its members' threads:
// many-to-one matches are cheap, one row matched by every source is slow
// but right.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // query points per block
constexpr int kTile = 1024;    // candidate points per shared-memory tile
constexpr int kGradThreads = 1024;
constexpr int kMinChunk = 256;  // fewest rows a gradient block owns
// Shared memory a gradient block may take for its workspace.
constexpr size_t kGradSmemBytes = 200 * 1024;

__global__ void __launch_bounds__(kThreads)
nn_distance_kernel(const float* __restrict__ xyz1,
                   const float* __restrict__ xyz2,
                   float* __restrict__ dist1, int* __restrict__ idx1,
                   float* __restrict__ dist2, int* __restrict__ idx2,
                   int n, int m) {
  __shared__ float4 tile[kTile];
  const bool rev = blockIdx.z == 1;  // 0: xyz1 -> xyz2, 1: xyz2 -> xyz1
  const int nq = rev ? m : n;
  const int nr = rev ? n : m;
  if (blockIdx.x * kThreads >= nq) return;  // uniform over the block
  const int b = blockIdx.y;
  const float* q = (rev ? xyz2 : xyz1) + static_cast<size_t>(b) * nq * 3;
  const float* r = (rev ? xyz1 : xyz2) + static_cast<size_t>(b) * nr * 3;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < nq;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = INFINITY;
  int best_j = 0;
  for (int t0 = 0; t0 < nr; t0 += kTile) {
    const int cnt = min(kTile, nr - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* p = r + 3 * static_cast<size_t>(t0 + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 c = tile[j];
      const float dx = __fsub_rn(qx, c.x);
      const float dy = __fsub_rn(qy, c.y);
      const float dz = __fsub_rn(qz, c.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_j = t0 + j;
      }
    }
  }
  if (valid) {
    const size_t o = static_cast<size_t>(b) * nq + i;
    (rev ? dist2 : dist1)[o] = best;
    (rev ? idx2 : idx1)[o] = best_j;
  }
}

// Words of one block's workspace for `r` owned rows and `s` sources, about
// 7 r + 9 s + 1: the arrays copied from device memory, each padded to 4
// words so the next starts 16-byte aligned (both clouds, 3 r and 3 s; the
// sources' indices and cotangents, s each; the owners', r each), then
// count (r), start (r + 1), the sources' slots in the unordered fill (s)
// and their -t in bucket order (3 s).
__host__ __device__ inline size_t pad4(size_t words) {
  return (words + 3) & ~static_cast<size_t>(3);
}

__host__ __device__ inline size_t grad_words(int r, int s) {
  return pad4(3 * static_cast<size_t>(r)) + pad4(3 * static_cast<size_t>(s)) +
         2 * pad4(s) + 2 * pad4(r) + 2 * static_cast<size_t>(r) + 1 +
         4 * static_cast<size_t>(s);
}

// Copies `count` 32-bit words from device memory into the workspace, the
// block's threads striding over them. Into shared memory each copy is a
// cp.async, which the thread issues without waiting for it: every copy of
// the block is in flight at once, and wait_copies() ends them. Where both
// ends are 16-byte aligned and count is a multiple of 4 (every cloud of a
// multiple of 4 points) a copy moves 16 bytes, else 4. Into the scratch
// buffer it is a plain load and store.
template <bool kGlobal>
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           int count) {
  const unsigned* from = static_cast<const unsigned*>(src);
  unsigned* to = static_cast<unsigned*>(dst);
  if (kGlobal) {
    for (int i = threadIdx.x; i < count; i += kGradThreads) to[i] = from[i];
    return;
  }
  const bool wide = ((reinterpret_cast<size_t>(from) |
                      reinterpret_cast<size_t>(to) | count * 4) & 15) == 0;
  if (wide) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * kGradThreads) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(to + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(from + i));
    }
    return;
  }
  for (int i = threadIdx.x; i < count; i += kGradThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(from + i));
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Exclusive scan of count[0, r) into start[0, r] (start[r] the total) by
// the whole block: each thread sums a contiguous run, one scan of the runs'
// sums, then each thread writes its run. A fixed order; two barriers.
__device__ void block_scan(const int* count, int* start, int r) {
  constexpr int kWarps = kGradThreads / 32;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int per = (r + kGradThreads - 1) / kGradThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, r);
  const int hi = min(lo + per, r);
  int run = 0;
  for (int i = lo; i < hi; ++i) run += count[i];
  int x = run;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int acc = (warp > 0 ? warp_sums[warp - 1] : 0) + x - run;
  for (int i = lo; i < hi; ++i) {
    start[i] = acc;
    acc += count[i];
  }
  if (threadIdx.x == 0) start[r] = warp_sums[kWarps - 1];
}

// One block per (batch element, direction, chunk of rows): blockIdx.y 0
// writes rows of gx1 (sources the xyz2 points through idx2), 1 rows of
// gx2; blockIdx.z picks rows [r0, r0 + rows) of that direction. t is
// rounded as the plain version rounds it: (2*g) exactly, then one product,
// no FMA; a row's sum starts at 0 and adds its sources' -t in ascending
// index, then its own t is added.
template <bool kGlobal>
__global__ void __launch_bounds__(kGradThreads)
nn_distance_grad_kernel(const float* __restrict__ xyz1,
                        const float* __restrict__ xyz2,
                        const int* __restrict__ idx1,
                        const int* __restrict__ idx2,
                        const float* __restrict__ g1,
                        const float* __restrict__ g2, float* __restrict__ gx1,
                        float* __restrict__ gx2, int* __restrict__ scratch,
                        size_t stride, int n, int m, int chunk) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x;
  const bool rev = blockIdx.y == 1;
  const int r = rev ? m : n;  // rows of this direction
  const int s = rev ? n : m;  // sources
  const int r0 = min(static_cast<int>(blockIdx.z) * chunk, r);
  const int rows = min(chunk, r - r0);  // this block's rows
  if (rows == 0) return;  // uniform over the block
  const size_t br = static_cast<size_t>(b) * r + r0;
  const float* own = (rev ? xyz2 : xyz1) + 3 * br;
  const float* oth = (rev ? xyz1 : xyz2) + static_cast<size_t>(b) * s * 3;
  const int* own_idx = (rev ? idx2 : idx1) + br;
  const int* src_idx = (rev ? idx1 : idx2) + static_cast<size_t>(b) * s;
  const float* own_g = (rev ? g2 : g1) + br;
  const float* src_g = (rev ? g1 : g2) + static_cast<size_t>(b) * s;
  float* out = (rev ? gx2 : gx1) + 3 * br;

  int* words =
      kGlobal ? scratch + ((static_cast<size_t>(b) * 2 + blockIdx.y) *
                               gridDim.z + blockIdx.z) * stride
              : smem;
  // The copied arrays first, each at a 16-byte boundary (see grad_words).
  float* own_s = reinterpret_cast<float*>(words);
  float* oth_s = own_s + pad4(3 * rows);
  int* key = reinterpret_cast<int*>(oth_s + pad4(3 * s));  // src_idx
  float* src_g_s = reinterpret_cast<float*>(key + pad4(s));
  int* own_j = reinterpret_cast<int*>(src_g_s + pad4(s));  // own_idx
  float* own_g_s = reinterpret_cast<float*>(own_j + pad4(rows));
  int* count = reinterpret_cast<int*>(own_g_s + pad4(rows));
  int* start = count + rows;
  int* slot = start + rows + 1;
  float* t_sorted = reinterpret_cast<float*>(slot + s);

  // Everything the block reads from device memory, copied in once,
  // coalesced: the gathers behind the indices then read the workspace.
  copy_words<kGlobal>(own_s, own, 3 * rows);
  copy_words<kGlobal>(oth_s, oth, 3 * s);
  copy_words<kGlobal>(key, src_idx, s);
  copy_words<kGlobal>(src_g_s, src_g, s);
  copy_words<kGlobal>(own_j, own_idx, rows);
  copy_words<kGlobal>(own_g_s, own_g, rows);
  for (int i = threadIdx.x; i < rows; i += kGradThreads) count[i] = 0;
  if (!kGlobal) wait_copies();
  __syncthreads();
  // Count the sources per row of this chunk; key becomes the row within
  // the chunk, or -1 (another chunk's, or none of nn_distance's indices).
  for (int u = threadIdx.x; u < s; u += kGradThreads) {
    const int k = key[u] - r0;
    if (k >= 0 && k < rows) {
      key[u] = k;
      atomicAdd(count + k, 1);
    } else {
      key[u] = -1;
    }
  }
  __syncthreads();
  block_scan(count, start, rows);
  __syncthreads();
  // Fill the buckets in any order (count runs back down to 0) ...
  for (int u = threadIdx.x; u < s; u += kGradThreads) {
    const int k = key[u];
    if (k >= 0) slot[start[k] + atomicSub(count + k, 1) - 1] = u;
  }
  __syncthreads();
  // ... then write each source's -t at its rank in its bucket by index.
  for (int u = threadIdx.x; u < s; u += kGradThreads) {
    const int k = key[u];
    if (k < 0) continue;
    const int lo = start[k], hi = start[k + 1];
    int rank = 0;
#pragma unroll 4
    for (int j = lo; j < hi; ++j) rank += slot[j] < u;
    const float g2x = __fmul_rn(2.f, src_g_s[u]);
    float* t = t_sorted + 3 * (lo + rank);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      t[c] = -__fmul_rn(g2x, __fsub_rn(oth_s[3 * u + c], own_s[3 * k + c]));
  }
  __syncthreads();
  // Each owner's row: its t + the bucket's sum from 0.
  for (int i = threadIdx.x; i < rows; i += kGradThreads) {
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int q = start[i]; q < start[i + 1]; ++q) {
      sx = __fadd_rn(sx, t_sorted[3 * q]);
      sy = __fadd_rn(sy, t_sorted[3 * q + 1]);
      sz = __fadd_rn(sz, t_sorted[3 * q + 2]);
    }
    const int j = own_j[i];
    const bool ok = j >= 0 && j < s;
    const float g2x = __fmul_rn(2.f, own_g_s[i]);
    const float sum[3] = {sx, sy, sz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = ok ? __fmul_rn(g2x, __fsub_rn(own_s[3 * i + c],
                                                     oth_s[3 * j + c]))
                         : 0.f;
      out[3 * i + c] = __fadd_rn(t, sum[c]);
    }
  }
}

// The gradient's launch shape: `chunks` blocks of `chunk` rows per (batch
// element, direction), enough blocks for every SM while a chunk keeps at
// least kMinChunk rows and its workspace fits shared memory (the direction
// with fewer rows may leave its last blocks empty), and one block's
// workspace in words, the larger of the two directions'.
struct GradShape {
  int chunks, chunk;
  size_t stride;
};

GradShape grad_shape(int b, int n, int m) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int most = n > m ? n : m;
  const int cap = (most + kMinChunk - 1) / kMinChunk;
  int chunks = sms / (2 * b);
  chunks = chunks < 1 ? 1 : (chunks > cap ? cap : chunks);
  GradShape g;
  for (;; chunks = 1) {
    g.chunk = (most + chunks - 1) / chunks;
    g.chunks = (most + g.chunk - 1) / g.chunk;
    const size_t a = grad_words(g.chunk < n ? g.chunk : n, m);
    const size_t c = grad_words(g.chunk < m ? g.chunk : m, n);
    g.stride = a > c ? a : c;
    // Past shared memory, in the scratch buffer, a chunk would copy every
    // source again: one block per direction instead.
    if (chunks == 1 || g.stride * sizeof(int) <= kGradSmemBytes) return g;
  }
}

}  // namespace

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32 -> dist1/idx1 (b, n),
// dist2/idx2 (b, m). Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int pcae_nn_distance(const void* xyz1, const void* xyz2,
                                void* dist1, void* idx1, void* dist2,
                                void* idx2, int b, int n, int m,
                                void* stream) {
  const int blocks = (max(n, m) + kThreads - 1) / kThreads;
  const dim3 grid(blocks, b, 2);
  nn_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<float*>(dist1), static_cast<int*>(idx1),
      static_cast<float*>(dist2), static_cast<int*>(idx2), n, m);
  return static_cast<int>(cudaGetLastError());
}

// Words of scratch pcae_nn_distance_grad needs for these shapes: 0 when
// each block's workspace fits its shared memory.
extern "C" long long pcae_nn_distance_grad_scratch(int b, int n, int m) {
  const GradShape g = grad_shape(b, n, m);
  if (g.stride * sizeof(int) <= kGradSmemBytes) return 0;
  return static_cast<long long>(2 * static_cast<size_t>(b) * g.chunks *
                                g.stride);
}

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32; idx1 (b, n), idx2 (b, m)
// int32 from pcae_nn_distance; g1 (b, n), g2 (b, m) f32 cotangents of the
// distances -> gx1 (b, n, 3), gx2 (b, m, 3) f32, every element written
// once. `scratch` holds pcae_nn_distance_grad_scratch(b, n, m) words (may
// be null when that is 0). Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int pcae_nn_distance_grad(const void* xyz1, const void* xyz2,
                                     const void* idx1, const void* idx2,
                                     const void* g1, const void* g2,
                                     void* gx1, void* gx2, void* scratch,
                                     int b, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradShape g = grad_shape(b, n, m);
  const size_t smem = g.stride * sizeof(int);
  const dim3 grid(b, 2, g.chunks);
  const float* x1 = static_cast<const float*>(xyz1);
  const float* x2 = static_cast<const float*>(xyz2);
  const int* i1 = static_cast<const int*>(idx1);
  const int* i2 = static_cast<const int*>(idx2);
  const float* c1 = static_cast<const float*>(g1);
  const float* c2 = static_cast<const float*>(g2);
  float* o1 = static_cast<float*>(gx1);
  float* o2 = static_cast<float*>(gx2);
  if (smem <= kGradSmemBytes) {
    static const cudaError_t set = cudaFuncSetAttribute(
        nn_distance_grad_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kGradSmemBytes));
    if (set != cudaSuccess) return static_cast<int>(set);
    nn_distance_grad_kernel<false><<<grid, kGradThreads, smem, s>>>(
        x1, x2, i1, i2, c1, c2, o1, o2, nullptr, g.stride, n, m, g.chunk);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    nn_distance_grad_kernel<true><<<grid, kGradThreads, 0, s>>>(
        x1, x2, i1, i2, c1, c2, o1, o2, static_cast<int*>(scratch), g.stride,
        n, m, g.chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
