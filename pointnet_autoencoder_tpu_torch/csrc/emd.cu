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
// Bound: operations. The function needs, per pair, d2 (3 sub, 3 mul,
// 2 add), sqrt(d2) and rsqrt once, and per pair and annealed level one exp2
// and 19 f32 operations; the last level (K = 1) needs no exp2, 16. At
// B=32, N=M=2048 that is 26.6 GFLOP (0.40 ms at 67 TFLOP/s) beside 1.48e9
// exp2, sqrt and rsqrt on the SFUs (0.35 ms). The input is 1.5 MB: the
// kernel is bound by instruction issue and the SFUs, not by bytes.
//
// Design. A Hopper block cannot hold a batch element's (N, M) d2 as the TPU
// kernel holds it in VMEM, and the column sums reduce over every row, so
// each pass is split by orientation into a row kernel and a column kernel
// over a grid of (point tiles, B). Adjacent levels are fused, so each pair
// is visited twice per level (once by each orientation), not four times:
//   R(li)  per xyz1 row: pass B of level li (remainL, the row cost, grad1)
//          and rows A of level li + 1 (ratioL_{li+1} from the remainR that
//          C(li - 1) saturated), streaming (xyz2, ratioR_li, remainR);
//   C(li)  per xyz2 column: pass B of level li (grad2) and columns A of
//          level li + 1 with its saturation (ratioR_{li+1}, remainR),
//          streaming (xyz1, ratioL_li, ratioL_{li+1}).
// A prologue pair does passes A of level 0; R(9), C(9) do pass B only.
// ratioL is double-buffered by level parity; ratioR and remainR are
// updated in place by their owner after R(li) has read them all.
// Launches per call: init, 2 prologue, 2 per level, the cost sum: 24.
//
// Per pair and kernel the K values cost one exp2 at most: for li <= 7,
// level_li = 4 level_{li+1} exactly (and so is the f32 product with
// log2(e)), so K_li = (K_{li+1}^2)^2 from the K_{li+1} that pass A of the
// next level needs anyway; level 8 evaluates its own exp2 and level 9 has
// K = 1. exp2 is ex2.approx.ftz (one MUFU.EX2, no denormal fix-up): a K
// under 2^-126 flushes to 0, where it adds under 1e-38 N to a sum that
// carries +1e-9. rsqrt is rsqrt.approx.ftz on max(d2, 1e-20), a normal
// number, so the flush never applies there. dx, dy, dz of d2 are reused
// for the gradient terms, and the owned point's ratio is factored out of
// every pass-B sum. What remains per pair and level is about 41 issued
// instructions (21 in the row kernel, 20 in the column kernel) and 4 MUFU:
// the kernel is bound by instruction issue, at about 0.16 ms per level
// at B=32, N=M=2048.
//
// Each block owns kPoints points, kPerThread per thread, and splits the
// streamed cloud kSplit ways across its threads (interleaved), so one
// shared-memory load serves kPerThread pairs and 31 warps are resident per
// SM at B=32, N=2048. The kSplit partial sums are added in shared memory in
// split order. Every sum has one owner and a fixed order: no atomics, and
// two calls give the same bits. Scratch is remainL, ratioL twice and the
// row cost (B, N), remainR and ratioR (B, M): 4 B N + 2 B M floats, so
// memory is O(B (N + M)) whatever N * M is, and any N, M >= 1 runs.
//
// Numerics, each a rounding of the same class as a summation order (the
// kernel is held to the plain version by tolerance, and to float64 as
// closely as the plain f32 version): d2 is fma(dz, dz, fma(dy, dy, dx*dx)),
// the same in both orientations; the sums over the streamed cloud carry
// K times the streamed point's ratio, and the owned point's ratio
// multiplies each sum once at the end, where the plain version forms
// w = (K ratioL) ratioR per pair.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kPerThread = 2;   // owned points per thread
constexpr int kOwners = 64;     // owner lanes per block
constexpr int kSplit = 4;       // ways the streamed cloud is split
constexpr int kThreads = kOwners * kSplit;
constexpr int kPoints = kOwners * kPerThread;  // owned points per block
constexpr int kTile = 1024;     // streamed points per shared-memory tile
constexpr int kLevels = 10;     // j = 7..-2 (tf_approxmatch_g.cu:21-25)
constexpr int kSumThreads = 256;
constexpr double kLog2e = 1.4426950408889634;

// Which K values a kernel's pairs need. kcur: pass B's K of level li;
// knext: pass A's K of the next level.
enum Mode {
  kPrologue = 0,  // pass A of level 0 only: knext = (exp2(l2n d2)^2)^2
  kFused = 1,     // li <= 7: knext = exp2(l2n d2), kcur = (knext^2)^2
  kLevel8 = 2,    // kcur = exp2(l2c d2), knext = 1
  kLevel9 = 3,    // pass B only, kcur = 1
};

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

struct Args {
  const float* own_xyz;    // (b, own, 3)
  const float* other_xyz;  // (b, other, 3), streamed
  // Streamed values: vb for pass B (rows: ratioR_li; columns: ratioL_li),
  // va for pass A (rows: remainR; columns: ratioL_{li+1}).
  const float* vb;
  const float* va;
  // Owned values. Rows: ratio = ratioL_li (read), remain = remainL
  // (read, written), out = ratioL_{li+1}, cost = row cost, grad = grad1.
  // Columns: ratio = ratioR (read; written with ratioR_{li+1}), remain =
  // remainR (read, written), grad = grad2.
  const float* ratio;
  float* remain;
  float* out;
  float* cost;
  float* grad;
  int own, other;
  float l2c, l2n;  // level * log2(e) of level li and of the next level
};

// One orientation of one fused level step (see the note at the top).
template <bool kRows, int kMode>
__global__ void __launch_bounds__(kThreads, 4) emd_step(const Args a) {
  constexpr bool kPassA = kMode != kLevel9;
  constexpr bool kPassB = kMode != kPrologue;
  // Streamed points as (x, y, z, vb) and va; then the partial sums.
  __shared__ float4 tile[kTile];
  __shared__ float tile_a[kTile];
  __shared__ float part[kSplit - 1][6][kPoints];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kOwners;
  const int split = threadIdx.x / kOwners;  // uniform over a warp
  const float* other = a.other_xyz + static_cast<size_t>(b) * a.other * 3;
  const size_t base = static_cast<size_t>(b) * a.own;

  float px[kPerThread], py[kPerThread], pz[kPerThread], ratio[kPerThread];
  float acc[kPerThread], wsum[kPerThread], cost[kPerThread];
  float gx[kPerThread], gy[kPerThread], gz[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int i = blockIdx.x * kPoints + p * kOwners + lane;
    px[p] = py[p] = pz[p] = ratio[p] = 0.f;
    if (i < a.own) {
      const float* q = a.own_xyz + 3 * (base + i);
      px[p] = q[0];
      py[p] = q[1];
      pz[p] = q[2];
      if (kPassB) ratio[p] = a.ratio[base + i];
    }
    acc[p] = wsum[p] = cost[p] = gx[p] = gy[p] = gz[p] = 0.f;
  }

  for (int t0 = 0; t0 < a.other; t0 += kTile) {
    const int cnt = min(kTile, a.other - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const size_t j = static_cast<size_t>(b) * a.other + t0 + k;
      const float* q = other + 3 * static_cast<size_t>(t0 + k);
      tile[k] = make_float4(q[0], q[1], q[2], kPassB ? a.vb[j] : 0.f);
      if (kPassA) tile_a[k] = a.va[j];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = split; j < cnt; j += kSplit) {
      const float4 c = tile[j];
      const float va = kPassA ? tile_a[j] : 0.f;
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        const float dx = __fsub_rn(px[p], c.x);
        const float dy = __fsub_rn(py[p], c.y);
        const float dz = __fsub_rn(pz[p], c.z);
        const float d2 = fmaf(dz, dz, fmaf(dy, dy, __fmul_rn(dx, dx)));
        float kcur = 1.f, knext = 1.f;
        if (kMode == kPrologue) {
          const float e = ex2_ftz(a.l2n * d2);
          const float e2 = __fmul_rn(e, e);
          knext = __fmul_rn(e2, e2);
        } else if (kMode == kFused) {
          knext = ex2_ftz(a.l2n * d2);
          const float k2 = __fmul_rn(knext, knext);
          kcur = __fmul_rn(k2, k2);
        } else if (kMode == kLevel8) {
          kcur = ex2_ftz(a.l2c * d2);
        }
        if (kPassA) acc[p] = fmaf(knext, va, acc[p]);
        if (kPassB) {
          // w without the owned point's ratio, which every sum below
          // carries as a factor: it is applied once, in the epilogue.
          const float w = __fmul_rn(kcur, c.w);
          const float wr = __fmul_rn(w, rsqrt_ftz(fmaxf(d2, 1e-20f)));
          if (kRows) {
            wsum[p] = __fadd_rn(wsum[p], w);
            cost[p] = fmaf(wr, d2, cost[p]);  // w sqrt(d2)
          }
          // own - other: x1 - x2 for rows, x2 - x1 for columns, whose
          // gradient is minus the sum over x1 - x2.
          gx[p] = fmaf(wr, dx, gx[p]);
          gy[p] = fmaf(wr, dy, gy[p]);
          gz[p] = fmaf(wr, dz, gz[p]);
        }
      }
    }
  }

  // Add the kSplit partial sums in split order: splits 1.. write theirs,
  // split 0 adds them to its own and owns the epilogue.
  if (split > 0) {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int o = p * kOwners + lane;
      part[split - 1][0][o] = acc[p];
      part[split - 1][1][o] = wsum[p];
      part[split - 1][2][o] = cost[p];
      part[split - 1][3][o] = gx[p];
      part[split - 1][4][o] = gy[p];
      part[split - 1][5][o] = gz[p];
    }
  }
  __syncthreads();
  if (split > 0) return;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int o = p * kOwners + lane;
    const int i = blockIdx.x * kPoints + o;
    if (i >= a.own) continue;
#pragma unroll
    for (int s = 0; s < kSplit - 1; ++s) {
      acc[p] = __fadd_rn(acc[p], part[s][0][o]);
      wsum[p] = __fadd_rn(wsum[p], part[s][1][o]);
      cost[p] = __fadd_rn(cost[p], part[s][2][o]);
      gx[p] = __fadd_rn(gx[p], part[s][3][o]);
      gy[p] = __fadd_rn(gy[p], part[s][4][o]);
      gz[p] = __fadd_rn(gz[p], part[s][5][o]);
    }
    const size_t g = base + i;
    if (kPassB) {
      a.grad[3 * g] += gx[p] * ratio[p];
      a.grad[3 * g + 1] += gy[p] * ratio[p];
      a.grad[3 * g + 2] += gz[p] * ratio[p];
      wsum[p] *= ratio[p];
      cost[p] *= ratio[p];
    }
    if (kRows) {
      float rem = a.remain[g];
      if (kPassB) {
        rem = fmaxf(0.f, rem - wsum[p]);
        a.remain[g] = rem;
        a.cost[g] += cost[p];
      }
      if (kPassA) a.out[g] = rem / (acc[p] + 1e-9f);
    } else if (kPassA) {
      const float rem = a.remain[g];
      const float sumr = acc[p] * rem;
      a.remain[g] = fmaxf(0.f, rem - sumr);
      a.out[g] = fminf(rem / (sumr + 1e-9f), 1.f) * rem;
    }
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

// level * log2(e) in f32, level = -4^(7 - li); 0 for li = 9. For li <= 8
// the values differ by exact factors of 4.
float level2(int li) {
  return li >= kLevels - 1
             ? 0.f
             : static_cast<float>(-kLog2e * ldexp(1.0, 2 * (7 - li)));
}

template <bool kRows, int kMode>
cudaError_t launch(Args a, int b, cudaStream_t s) {
  const dim3 grid((a.own + kPoints - 1) / kPoints, b);
  emd_step<kRows, kMode><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32 -> cost (b), grad1 (b, n, 3),
// grad2 (b, m, 3) f32; scratch holds 4 * b * n + 2 * b * m floats. Capacities
// use integer division as the reference op (tf_approxmatch_g.cu:4-11).
// Launches the whole schedule on `stream` (24 launches), with no host
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
  float* ratio_l[2] = {remain_l + bn, remain_l + 2 * bn};  // by parity
  float* cost_row = remain_l + 3 * bn;
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

  // R(li) and C(li) of level li; li = -1 is the prologue (passes A of
  // level 0, whose K is computed from level 1's as in R(0) and C(0)).
  for (int li = -1; li < kLevels && e == cudaSuccess; ++li) {
    const float l2c = li < 0 ? 0.f : level2(li);
    const float l2n = li < 0 ? level2(1) : level2(li + 1);
    const float* rl_cur = li < 0 ? nullptr : ratio_l[li & 1];
    float* rl_next = ratio_l[(li + 1) & 1];
    const Args rows{x1, x2, ratio_r, remain_r, rl_cur, remain_l, rl_next,
                    cost_row, g1, n, m, l2c, l2n};
    const Args cols{x2, x1, rl_cur, rl_next, ratio_r, remain_r, ratio_r,
                    nullptr, g2, m, n, l2c, l2n};
    if (li < 0) {
      e = launch<true, kPrologue>(rows, b, s);
      if (e == cudaSuccess) e = launch<false, kPrologue>(cols, b, s);
    } else if (li < kLevels - 2) {
      e = launch<true, kFused>(rows, b, s);
      if (e == cudaSuccess) e = launch<false, kFused>(cols, b, s);
    } else if (li == kLevels - 2) {
      e = launch<true, kLevel8>(rows, b, s);
      if (e == cudaSuccess) e = launch<false, kLevel8>(cols, b, s);
    } else {
      e = launch<true, kLevel9>(rows, b, s);
      if (e == cudaSuccess) e = launch<false, kLevel9>(cols, b, s);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  emd_cost_sum<<<b, kSumThreads, 0, s>>>(cost_row, static_cast<float*>(cost),
                                         n);
  return static_cast<int>(cudaGetLastError());
}
