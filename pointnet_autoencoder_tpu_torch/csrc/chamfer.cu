// Chamfer forward (nearest-neighbour squared distance and index), both
// directions in one launch.
//
// Replaces: pointnet_autoencoder_tpu/ops/chamfer.py:_nn_direction_kernel
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
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // query points per block
constexpr int kTile = 1024;    // candidate points per shared-memory tile

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
