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
// is element-serial. Here it is the reference's own form
// (tf_nndistance_g.cu:132-157): a gather and an f32 atomicAdd scatter.
// Bound: bytes. Both clouds, both cotangents and both index vectors are read
// once and both gradients written once, 64 bytes per point: 4.2 MB at
// B=32, N=M=2048, about 1.3 us at 3.35 TB/s; the arithmetic is ~13
// operations per point.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // query points per block
constexpr int kTile = 1024;    // candidate points per shared-memory tile
constexpr int kGradThreads = 256;

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

// Gradient, one thread per query point of either direction (gridDim.z).
// The thread gathers its match j, forms t = 2*g*(q - r[j]) and adds +t to
// its own row and -t to row j of the other cloud's gradient. A row receives
// its own t and the -t of every point of the other cloud matched to it, so
// both adds are atomic; the order of the adds, and so the last bits of each
// sum, varies from run to run. t is rounded as the plain version rounds it:
// (2*g) exactly, then one product, no FMA.
__global__ void __launch_bounds__(kGradThreads)
nn_distance_grad_kernel(const float* __restrict__ xyz1,
                        const float* __restrict__ xyz2,
                        const int* __restrict__ idx1,
                        const int* __restrict__ idx2,
                        const float* __restrict__ g1,
                        const float* __restrict__ g2, float* __restrict__ gx1,
                        float* __restrict__ gx2, int n, int m) {
  const bool rev = blockIdx.z == 1;  // 0: xyz1 -> xyz2, 1: xyz2 -> xyz1
  const int nq = rev ? m : n;
  const int nr = rev ? n : m;
  const int i = blockIdx.x * kGradThreads + threadIdx.x;
  if (i >= nq) return;
  const int b = blockIdx.y;
  const size_t qi = static_cast<size_t>(b) * nq + i;
  const int j = (rev ? idx2 : idx1)[qi];
  if (j < 0 || j >= nr) return;  // not an index nn_distance returns
  const float* q = (rev ? xyz2 : xyz1) + 3 * qi;
  const float* r = (rev ? xyz1 : xyz2) + 3 * (static_cast<size_t>(b) * nr + j);
  float* gq = (rev ? gx2 : gx1) + 3 * qi;
  float* gr = (rev ? gx1 : gx2) + 3 * (static_cast<size_t>(b) * nr + j);
  const float g2x = __fmul_rn(2.f, (rev ? g2 : g1)[qi]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t = __fmul_rn(g2x, __fsub_rn(q[c], r[c]));
    atomicAdd(gq + c, t);
    atomicAdd(gr + c, -t);
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

// xyz1 (b, n, 3), xyz2 (b, m, 3) contiguous f32; idx1 (b, n), idx2 (b, m)
// int32 from pcae_nn_distance; g1 (b, n), g2 (b, m) f32 cotangents of the
// distances -> gx1 (b, n, 3), gx2 (b, m, 3) f32. Zeroes both outputs, then
// launches one kernel on `stream`; returns cudaGetLastError().
extern "C" int pcae_nn_distance_grad(const void* xyz1, const void* xyz2,
                                     const void* idx1, const void* idx2,
                                     const void* g1, const void* g2,
                                     void* gx1, void* gx2, int b, int n,
                                     int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(gx1, 0, sizeof(float) * 3 * b * n, s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(gx2, 0, sizeof(float) * 3 * b * m, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (max(n, m) + kGradThreads - 1) / kGradThreads;
  nn_distance_grad_kernel<<<dim3(blocks, b, 2), kGradThreads, 0, s>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<const int*>(idx1), static_cast<const int*>(idx2),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<float*>(gx1), static_cast<float*>(gx2), n, m);
  return static_cast<int>(cudaGetLastError());
}
