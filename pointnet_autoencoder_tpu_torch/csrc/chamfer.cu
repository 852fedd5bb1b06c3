// Chamfer forward (nearest-neighbour squared distance and index) and its
// gradient, both directions in one launch each.
//
// Forward. Replaces: pointnet_autoencoder_tpu/ops/chamfer.py:_nn_direction_kernel
// (launched once per direction by _nn_one_direction_pallas).
//
// Bound: operations. The function needs each pair's d2 once (3 sub, 3 mul,
// 2 add) and one compare per direction: 10 f32 operations per pair, so at
// B=32, N=M=2048 it is 1.34e9 operations on 1.6 MB of input and output.
// The earlier kernel was the reference CUDA op's shape (one thread per
// query, the other cloud streamed through shared memory) run once per
// direction: every pair's d2 twice, about 25 instructions per pair.
//
// Design: both directions from one d2 per pair. A block of 8 warps owns 256
// queries of xyz1 (8 per lane, in registers: lane l holds queries l, l+32,
// ..., l+224) and every warp holds all of them; the warps split xyz2 into
// chunks of 16 candidates (warp w takes chunks w, w+8, ...), each loaded
// one chunk ahead, staged in the warp's own shared memory and read as one
// float4 broadcast per candidate. At most 128 registers a thread, so two
// blocks (16 warps) share an SM. For each pair the lane computes d2 once
// and folds it
// - into its query's running minimum (dist1/idx1: candidates in increasing
//   index, strict '<'), and
// - into the candidate's minimum over the lane's 8 queries (increasing
//   index, strict '<').
// After a chunk, a butterfly over the lanes (5 shuffle steps, 16 exchanges
// per lane) leaves lanes l and l+16 with candidate l's minimum over the
// block's 256 queries, written as a 64-bit key (bits of d2 << 32 | query
// index) to a (B, query tiles, M) scratch; a second small kernel takes
// each column's smallest key over the tiles and unpacks dist2/idx2. The
// queries' minima of the 8 warps combine the same way in shared memory.
//
// Numerics, held equal to the plain version (ops/chamfer.py:
// nn_distance_plain) bit for bit:
// - d2 = ((dx*dx + dy*dy) + dz*dz) with dx = xyz1 - xyz2, in the order of
//   the reference's sqdist_matrix, with __fmul_rn/__fadd_rn so nvcc does
//   not contract into FMAs, which would round differently; the plain
//   version's two directions read one matrix, and so does the kernel;
// - every combine of partial minima compares keys: d2 >= +0, so the bits
//   of d2 order as the values do, and at equal d2 the lower index wins:
//   the first minimum, as torch.min/argmin and the TPU kernel give;
// - rows past N and M are NaN points: their d2 is NaN, never below a
//   minimum, and NaN's bits order above every d2 (no padding points).
// Two calls give the same bits (no atomics). Shared memory: 18 KB per
// block whatever N and M; the scratch is 8 * B * ceil(N/256) * M bytes.
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

constexpr int kNnWarps = 8;
constexpr int kNnThreads = 32 * kNnWarps;
constexpr int kNnQ = 8;                // queries per lane
constexpr int kNnTileQ = 32 * kNnQ;    // queries per block
constexpr int kNnChunk = 16;           // candidates per warp step
constexpr int kNnColThreads = 256;     // column-combine threads per block
constexpr int kGradThreads = 1024;
constexpr int kMinChunk = 256;  // fewest rows a gradient block owns
// Shared memory a gradient block may take for its workspace.
constexpr size_t kGradSmemBytes = 200 * 1024;

// (d2, index) as one key whose unsigned order is (d2, index) order for
// every d2 >= +0, +inf and NaN (above all of them) included.
__device__ __forceinline__ unsigned long long nn_key(float d2, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                     unsigned long long b) {
  return b < a ? b : a;
}

// (d, i) comes before (e, k) in key order.
__device__ __forceinline__ bool nn_before(float d, int i, float e, int k) {
  const unsigned a = __float_as_uint(d), c = __float_as_uint(e);
  return a < c || (a == c && i < k);
}

// Butterfly over a warp: at step S (8, 4, 2, 1) a lane keeps the half of
// its candidates whose bit S matches its own and trades the other half
// with lane ^ S, keeping the smaller key of each pair; then lane ^ 16's
// result joins. Position 0 of lanes l and l ^ 16 ends with candidate
// l % 16's smallest key over the warp.
template <int S>
__device__ __forceinline__ void nn_butterfly(float (&cd)[kNnChunk],
                                             int (&ci)[kNnChunk], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int jj = 0; jj < S; ++jj) {
    const float keep_d = upper ? cd[jj + S] : cd[jj];
    const int keep_i = upper ? ci[jj + S] : ci[jj];
    const float got_d =
        __shfl_xor_sync(0xffffffffu, upper ? cd[jj] : cd[jj + S], S);
    const int got_i =
        __shfl_xor_sync(0xffffffffu, upper ? ci[jj] : ci[jj + S], S);
    const bool take = nn_before(got_d, got_i, keep_d, keep_i);
    cd[jj] = take ? got_d : keep_d;
    ci[jj] = take ? got_i : keep_i;
  }
  if constexpr (S > 1) {
    nn_butterfly<S / 2>(cd, ci, lane);
  } else {
    const float got_d = __shfl_xor_sync(0xffffffffu, cd[0], kNnChunk);
    const int got_i = __shfl_xor_sync(0xffffffffu, ci[0], kNnChunk);
    if (nn_before(got_d, got_i, cd[0], ci[0])) {
      cd[0] = got_d;
      ci[0] = got_i;
    }
  }
}
static_assert(2 * kNnChunk == 32, "the butterfly's last step is xor 16");

// One block per (256 queries of xyz1, batch element). Writes dist1/idx1 of
// its queries and, for every candidate j of xyz2, its minimum over these
// queries as a key at col_part[b][blockIdx.x][j].
__global__ void __launch_bounds__(kNnThreads, 2)
nn_distance_kernel(const float* __restrict__ xyz1,
                   const float* __restrict__ xyz2,
                   float* __restrict__ dist1, int* __restrict__ idx1,
                   unsigned long long* __restrict__ col_part, int n, int m) {
  __shared__ float4 cand[kNnWarps][kNnChunk];
  __shared__ unsigned long long row_key[kNnWarps][kNnTileQ];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kNnTileQ;
  const float* q = xyz1 + static_cast<size_t>(b) * n * 3;
  const float* r = xyz2 + static_cast<size_t>(b) * m * 3;
  unsigned long long* part =
      col_part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * m;

  const float kNaN = __int_as_float(0x7fffffff);
  // Query q0 + 32i + lane; NaN past N.
  float qx[kNnQ], qy[kNnQ], qz[kNnQ], best[kNnQ];
  int best_j[kNnQ];
#pragma unroll
  for (int i = 0; i < kNnQ; ++i) {
    const int p = q0 + 32 * i + lane;
    qx[i] = qy[i] = qz[i] = kNaN;
    if (p < n) {
      qx[i] = q[3 * p];
      qy[i] = q[3 * p + 1];
      qz[i] = q[3 * p + 2];
    }
    best[i] = INFINITY;
    best_j[i] = 0;
  }

  // Lane l < 16 loads candidate j0 + l of the warp's chunks, one chunk
  // ahead; NaN past M.
  auto load = [&](int j0) {
    const int j = j0 + lane;
    return lane < kNnChunk && j < m
               ? make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], 0.f)
               : make_float4(kNaN, kNaN, kNaN, 0.f);
  };
  constexpr int kStep = kNnWarps * kNnChunk;
  float4 next = load(warp * kNnChunk);
  for (int j0 = warp * kNnChunk; j0 < m; j0 += kStep) {
    __syncwarp();  // the warp is done reading its previous chunk
    if (lane < kNnChunk) cand[warp][lane] = next;
    __syncwarp();
    next = load(j0 + kStep);

    float cd[kNnChunk];  // candidate jj's minimum over the lane's queries
    int ci[kNnChunk];    // ... and its query, as i until the butterfly
#pragma unroll
    for (int jj = 0; jj < kNnChunk; ++jj) {
      const float4 p = cand[warp][jj];
      const int j = j0 + jj;
#pragma unroll
      for (int i = 0; i < kNnQ; ++i) {
        const float dx = __fsub_rn(qx[i], p.x);
        const float dy = __fsub_rn(qy[i], p.y);
        const float dz = __fsub_rn(qz[i], p.z);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
        if (d2 < best[i]) {
          best[i] = d2;
          best_j[i] = j;
        }
        if (i == 0) {
          cd[jj] = d2;
          ci[jj] = 0;
        } else if (d2 < cd[jj]) {
          cd[jj] = d2;
          ci[jj] = i;
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kNnChunk; ++jj) ci[jj] = q0 + 32 * ci[jj] + lane;
    nn_butterfly<kNnChunk / 2>(cd, ci, lane);
    if (lane < kNnChunk && j0 + lane < m)
      part[j0 + lane] = nn_key(cd[0], ci[0]);
  }

  // The queries' minima over the warps' candidates.
#pragma unroll
  for (int i = 0; i < kNnQ; ++i)
    row_key[warp][32 * i + lane] = nn_key(best[i], best_j[i]);
  __syncthreads();
  for (int k = threadIdx.x; k < kNnTileQ; k += kNnThreads) {
    const int p = q0 + k;
    if (p >= n) continue;
    unsigned long long key = row_key[0][k];
#pragma unroll
    for (int w = 1; w < kNnWarps; ++w) key = key_min(key, row_key[w][k]);
    const size_t o = static_cast<size_t>(b) * n + p;
    dist1[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
    idx1[o] = static_cast<int>(key & 0xffffffffu);
  }
}

// dist2/idx2 (b, m) from the smallest of each column's keys over the
// query tiles.
__global__ void __launch_bounds__(kNnColThreads)
nn_distance_cols_kernel(const unsigned long long* __restrict__ col_part,
                        float* __restrict__ dist2, int* __restrict__ idx2,
                        int tiles, int m) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kNnColThreads + threadIdx.x;
  if (j >= m) return;
  const unsigned long long* p =
      col_part + static_cast<size_t>(b) * tiles * m + j;
  unsigned long long key = p[0];
  for (int t = 1; t < tiles; ++t)
    key = key_min(key, p[static_cast<size_t>(t) * m]);
  const size_t o = static_cast<size_t>(b) * m + j;
  dist2[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
  idx2[o] = static_cast<int>(key & 0xffffffffu);
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

// 64-bit words of scratch pcae_nn_distance needs: b * ceil(n/256) * m.
extern "C" long long pcae_nn_distance_scratch(int b, int n, int m) {
  return static_cast<long long>(b) * ((n + kNnTileQ - 1) / kNnTileQ) * m;
}

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32 -> dist1/idx1 (b, n),
// dist2/idx2 (b, m); `scratch` holds pcae_nn_distance_scratch(b, n, m)
// 64-bit words, 8-byte aligned. Launches the pair kernel and the column
// combine on `stream`; returns cudaGetLastError().
extern "C" int pcae_nn_distance(const void* xyz1, const void* xyz2,
                                void* dist1, void* idx1, void* dist2,
                                void* idx2, void* scratch, int b, int n,
                                int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kNnTileQ - 1) / kNnTileQ;
  auto* part = static_cast<unsigned long long*>(scratch);
  nn_distance_kernel<<<dim3(tiles, b), kNnThreads, 0, s>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<float*>(dist1), static_cast<int*>(idx1), part, n, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nn_distance_cols_kernel<<<dim3((m + kNnColThreads - 1) / kNnColThreads, b),
                            kNnColThreads, 0, s>>>(
      part, static_cast<float*>(dist2), static_cast<int*>(idx2), tiles, m);
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
    // Set on every launch: the attribute belongs to the current device's
    // context.
    const cudaError_t set = cudaFuncSetAttribute(
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
