// Approximate EMD: the annealed matching of two clouds, with its transport
// cost and the cost's gradients (plan held constant) folded in as the mass
// moves, so the (B, M, N) plan is never stored.
//
// Replaces: pointnet_autoencoder_tpu/ops/emd_pallas.py:_emd_kernel
// (launched by emd_forward_pallas). Per batch element and level
// (j = 7..-2, level = -4^j, the last level 0), with K = exp(level * d2):
//   pass A  ratioL_k = remainL_k / (1e-9 + sum_l K_kl remainR_l),
//           colsum_l = sum_k K_kl ratioL_k;
//   saturation (per column)
//           sumr = colsum * remainR, ratioR = min(remainR / (sumr + 1e-9), 1)
//           * remainR, remainR = max(0, remainR - sumr);
//   pass B  w = K ratioL ratioR, remainL -= sum_l w, cost += sum w sqrt(d2),
//           grad1_k += sum_l wr (x1_k - x2_l),
//           grad2_l -= sum_k wr (x1_k - x2_l),
//           with wr = w rsqrt(max(d2, 1e-20)).
//
// Design. The TPU kernel runs one grid step per batch element and caches the
// whole (N, M) d2 in VMEM; a Hopper block has 227 KB of shared memory, so d2
// is recomputed, and the column sums, which reduce over every row of a batch
// element, would span blocks. So each pass is split by orientation (the TPU
// kernel's own scheme, emd_pallas.py:11-19) into launches over a grid of
// (point tiles, B), one thread per point:
//   rows A  one thread per xyz1 row streams (xyz2, remainR) through shared
//           memory and writes ratioL;
//   cols A  one thread per xyz2 column streams (xyz1, ratioL), sums colsum
//           and does the column's saturation in its epilogue;
//   B       rows (gridDim.z 0) stream (xyz2, ratioR) and update remainL,
//           grad1 and the row's cost; columns (gridDim.z 1) stream
//           (xyz1, ratioL) and update grad2. Neither half reads what the
//           other writes, so they share one launch.
// A last kernel sums each batch element's row costs in a fixed order. Every
// sum has one owner thread and a fixed order: there are no atomics, and two
// calls give the same bits. State is remainL, ratioL and the row cost (B, N)
// and remainR, ratioR (B, M) in a scratch buffer the caller allocates, so
// memory is O(B (N + M)) whatever N * M is, and any N, M >= 1 runs.
//
// Bound: operations. The function needs, per pair, d2 (3 sub, 3 mul,
// 2 add), sqrt(d2) and rsqrt once, and per pair and annealed level one exp2
// and 19 f32 operations (level * d2, the two matrix-vector products of
// pass A, w from pass A's K * ratioL, its row sum, wr, the cost term, and
// the three gradient terms of each side); the last level (K = 1) needs no
// exp2, no level * d2 and no K products, 16. At B=32, N=M=2048 that is
// 26.6 GFLOP (0.40 ms at 67 TFLOP/s) beside 1.48e9 exp2, sqrt and rsqrt on
// the SFUs (0.35 ms at 16 per SM per clock). The input is 1.5 MB. This
// design evaluates four exp2 and two
// rsqrt per pair and level where the function needs one and none (d2 and
// rsqrt are level-independent), and d2 four times: its SFU work is about
// 6x the bound's.
//
// Numerics: exp(level * d2) is exp2f(level2 * d2) with log2(e) folded into
// level2, as the TPU kernel evaluates it; the build has no --use_fast_math,
// so exp2f keeps denormal results (the early levels make them). d2 is
// ((dx*dx + dy*dy) + dz*dz) with __fmul_rn/__fadd_rn, the plain version's
// order, and the same in every pass.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // points per block
constexpr int kTile = 1024;    // streamed points per shared-memory tile
constexpr int kLevels = 10;    // j = 7..-2 (tf_approxmatch_g.cu:21-25)
constexpr int kSumThreads = 256;
constexpr double kLog2e = 1.4426950408889634;

// Squared distance between a point of xyz1 and a point of xyz2, in the plain
// version's rounding (no FMA contraction).
__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stages points [t0, t0 + cnt) of one cloud, each with one value of `v`,
// into `tile` as (x, y, z, value).
__device__ __forceinline__ void stage(float4* tile,
                                      const float* __restrict__ p,
                                      const float* __restrict__ v, int t0,
                                      int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
    const float* q = p + 3 * static_cast<size_t>(t0 + k);
    tile[k] = make_float4(q[0], q[1], q[2], v[t0 + k]);
  }
}

// Initial capacities; the row costs and both gradients start at 0.
__global__ void emd_init(float* __restrict__ remain_l,
                         float* __restrict__ cost_row,
                         float* __restrict__ grad1,
                         float* __restrict__ remain_r,
                         float* __restrict__ grad2, size_t bn, size_t bm,
                         float multi_l, float multi_r) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = blockIdx.x * blockDim.x + threadIdx.x; i < bn; i += stride) {
    remain_l[i] = multi_l;
    cost_row[i] = 0.f;
    grad1[3 * i] = grad1[3 * i + 1] = grad1[3 * i + 2] = 0.f;
  }
  for (size_t i = blockIdx.x * blockDim.x + threadIdx.x; i < bm; i += stride) {
    remain_r[i] = multi_r;
    grad2[3 * i] = grad2[3 * i + 1] = grad2[3 * i + 2] = 0.f;
  }
}

// Pass A, rows: ratioL_k = remainL_k / (1e-9 + sum_l K_kl remainR_l).
__global__ void __launch_bounds__(kThreads)
emd_rows_a(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
           const float* __restrict__ remain_l,
           const float* __restrict__ remain_r, float* __restrict__ ratio_l,
           int n, int m, float level2) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  const size_t o = static_cast<size_t>(b) * n + i;
  const float* x2 = xyz2 + static_cast<size_t>(b) * m * 3;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = xyz1[3 * o];
    py = xyz1[3 * o + 1];
    pz = xyz1[3 * o + 2];
  }
  float acc = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    stage(tile, x2, remain_r + static_cast<size_t>(b) * m, t0, cnt);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 c = tile[j];
      const float k = exp2f(level2 * sqdist(px, py, pz, c.x, c.y, c.z));
      acc = fmaf(k, c.w, acc);
    }
  }
  if (valid) ratio_l[o] = remain_l[o] / (acc + 1e-9f);
}

// Pass A, columns: colsum_l = sum_k K_kl ratioL_k, then the column's
// saturation, which updates remainR and writes ratioR.
__global__ void __launch_bounds__(kThreads)
emd_cols_a(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
           const float* __restrict__ ratio_l, float* __restrict__ remain_r,
           float* __restrict__ ratio_r, int n, int m, float level2) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = l < m;
  const size_t o = static_cast<size_t>(b) * m + l;
  const float* x1 = xyz1 + static_cast<size_t>(b) * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    qx = xyz2[3 * o];
    qy = xyz2[3 * o + 1];
    qz = xyz2[3 * o + 2];
  }
  float acc = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    __syncthreads();
    stage(tile, x1, ratio_l + static_cast<size_t>(b) * n, t0, cnt);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 c = tile[j];
      const float k = exp2f(level2 * sqdist(c.x, c.y, c.z, qx, qy, qz));
      acc = fmaf(k, c.w, acc);
    }
  }
  if (valid) {
    const float rem = remain_r[o];
    const float sumr = acc * rem;
    ratio_r[o] = fminf(rem / (sumr + 1e-9f), 1.f) * rem;
    remain_r[o] = fmaxf(0.f, rem - sumr);
  }
}

// Pass B. gridDim.z 0: one thread per xyz1 row, which moves its mass w =
// K ratioL ratioR, lowers remainL by it and adds the row's cost and grad1.
// gridDim.z 1: one thread per xyz2 column, which adds its grad2.
__global__ void __launch_bounds__(kThreads)
emd_pass_b(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
           const float* __restrict__ ratio_l,
           const float* __restrict__ ratio_r, float* __restrict__ remain_l,
           float* __restrict__ cost_row, float* __restrict__ grad1,
           float* __restrict__ grad2, int n, int m, float level2) {
  __shared__ float4 tile[kTile];
  const bool cols = blockIdx.z == 1;
  const int own = cols ? m : n;      // points owned by threads
  const int other = cols ? n : m;    // points streamed
  if (blockIdx.x * kThreads >= own) return;  // uniform over the block
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < own;
  const size_t o = static_cast<size_t>(b) * own + i;
  const float* mine = cols ? xyz2 : xyz1;
  const float* theirs =
      (cols ? xyz1 : xyz2) + static_cast<size_t>(b) * other * 3;
  const float* their_ratio =
      (cols ? ratio_l : ratio_r) + static_cast<size_t>(b) * other;
  float px = 0.f, py = 0.f, pz = 0.f, ratio = 0.f;
  if (valid) {
    px = mine[3 * o];
    py = mine[3 * o + 1];
    pz = mine[3 * o + 2];
    ratio = (cols ? ratio_r : ratio_l)[o];
  }
  float wsum = 0.f, cost = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  for (int t0 = 0; t0 < other; t0 += kTile) {
    const int cnt = min(kTile, other - t0);
    __syncthreads();
    stage(tile, theirs, their_ratio, t0, cnt);
    __syncthreads();
    if (!cols) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float4 c = tile[j];
        const float d2 = sqdist(px, py, pz, c.x, c.y, c.z);
        // (K * ratioL) * ratioR, the plain version's order.
        const float w = exp2f(level2 * d2) * ratio * c.w;
        const float wr = w * rsqrtf(fmaxf(d2, 1e-20f));
        wsum += w;
        cost = fmaf(wr, d2, cost);  // w * sqrt(d2), the root from rsqrt
        gx = fmaf(wr, __fsub_rn(px, c.x), gx);
        gy = fmaf(wr, __fsub_rn(py, c.y), gy);
        gz = fmaf(wr, __fsub_rn(pz, c.z), gz);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float4 c = tile[j];
        const float d2 = sqdist(c.x, c.y, c.z, px, py, pz);
        const float w = exp2f(level2 * d2) * c.w * ratio;
        const float wr = w * rsqrtf(fmaxf(d2, 1e-20f));
        gx = fmaf(wr, __fsub_rn(c.x, px), gx);
        gy = fmaf(wr, __fsub_rn(c.y, py), gy);
        gz = fmaf(wr, __fsub_rn(c.z, pz), gz);
      }
    }
  }
  if (!valid) return;
  if (!cols) {
    remain_l[o] = fmaxf(0.f, remain_l[o] - wsum);
    cost_row[o] += cost;
    grad1[3 * o] += gx;
    grad1[3 * o + 1] += gy;
    grad1[3 * o + 2] += gz;
  } else {
    grad2[3 * o] -= gx;
    grad2[3 * o + 1] -= gy;
    grad2[3 * o + 2] -= gz;
  }
}

// cost[b] = sum_k cost_row[b, k]: one block per batch element, strided
// partial sums, then a tree in shared memory; a fixed order.
__global__ void __launch_bounds__(kSumThreads)
emd_cost_sum(const float* __restrict__ cost_row, float* __restrict__ cost,
             int n) {
  __shared__ float part[kSumThreads];
  const float* row = cost_row + static_cast<size_t>(blockIdx.x) * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += row[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[blockIdx.x] = part[0];
}

}  // namespace

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32 -> cost (b), grad1 (b, n, 3),
// grad2 (b, m, 3) f32; scratch holds 3 * b * n + 2 * b * m floats. Capacities
// use integer division as the reference op (tf_approxmatch_g.cu:4-11).
// Launches the whole schedule on `stream` (2 + 3 per level), with no host
// synchronisation; returns cudaGetLastError().
extern "C" int pcae_emd_forward(const void* xyz1, const void* xyz2, void* cost,
                                void* grad1, void* grad2, void* scratch, int b,
                                int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x1 = static_cast<const float*>(xyz1);
  const float* x2 = static_cast<const float*>(xyz2);
  float* g1 = static_cast<float*>(grad1);
  float* g2 = static_cast<float*>(grad2);
  const size_t bn = static_cast<size_t>(b) * n;
  const size_t bm = static_cast<size_t>(b) * m;
  float* remain_l = static_cast<float*>(scratch);
  float* ratio_l = remain_l + bn;
  float* cost_row = ratio_l + bn;
  float* remain_r = cost_row + bn;
  float* ratio_r = remain_r + bm;
  const float multi_l = n >= m ? 1.f : static_cast<float>(m / n);
  const float multi_r = n >= m ? static_cast<float>(n / m) : 1.f;

  const size_t most = bn > bm ? bn : bm;
  const size_t init_blocks = (most + 255) / 256 < 4096 ? (most + 255) / 256
                                                       : 4096;
  emd_init<<<static_cast<unsigned>(init_blocks), 256, 0, s>>>(
      remain_l, cost_row, g1, remain_r, g2, bn, bm, multi_l, multi_r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 rows((n + kThreads - 1) / kThreads, b);
  const dim3 cols((m + kThreads - 1) / kThreads, b);
  const dim3 both(((n > m ? n : m) + kThreads - 1) / kThreads, b, 2);
  for (int li = 0; li < kLevels; ++li) {
    // level * log2(e), level = -4^(7 - li); the last level is 0.
    const float level2 =
        li == kLevels - 1
            ? 0.f
            : static_cast<float>(-kLog2e * ldexp(1.0, 2 * (7 - li)));
    emd_rows_a<<<rows, kThreads, 0, s>>>(x1, x2, remain_l, remain_r, ratio_l,
                                         n, m, level2);
    emd_cols_a<<<cols, kThreads, 0, s>>>(x1, x2, ratio_l, remain_r, ratio_r,
                                         n, m, level2);
    emd_pass_b<<<both, kThreads, 0, s>>>(x1, x2, ratio_l, ratio_r, remain_l,
                                         cost_row, g1, g2, n, m, level2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  emd_cost_sum<<<b, kSumThreads, 0, s>>>(cost_row, static_cast<float*>(cost),
                                         n);
  return static_cast<int>(cudaGetLastError());
}
