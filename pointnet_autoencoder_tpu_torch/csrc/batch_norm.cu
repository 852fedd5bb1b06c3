// Training BatchNorm with its ReLU (K7): the batch statistics, the moving
// update, the normalization and the ReLU forward, and the gradient of the
// input, gamma and beta backward, on a channels-last (rows, C) activation.
//
// Replaces no TPU kernel: the JAX package's BatchNorm
// (pointnet_autoencoder_tpu/nn/layers.py BatchNorm) is plain jnp, which XLA
// fuses into a few passes. In PyTorch the same arithmetic ran as about 55
// device operations a layer a train step (an f32 copy, its square, two
// column means, casts, multiplies and adds forward; the chain backwards),
// 16 of them over the whole (rows, C) tensor, half in f32. This kernel pair
// takes their place; ops/batch_norm.py binds it.
//
// Bound: bytes. Forward reads y and writes the output once (2 rows*C
// elements), backward reads the cotangent g and y and writes dx once (3);
// the per-channel vectors are noise. At conv4 of a B=128 step (262,144 x
// 128 bf16, 64 MB) that is 0.020 ms forward and 0.030 ms backward at
// 3.35 TB/s (utils/roofline.py kernel_bound "batch_norm_fwd" and
// "batch_norm_bwd"). The statistics have to be complete before the first
// element is normalized, so each direction is two passes over the rows,
// with a small reduction between them:
//
//   forward:  bn_stats_kernel (per-block column sums of y and y^2, f32)
//             -> bn_reduce_kernel (the blocks' partial sums in a fixed
//             order -> moments (2, C) = [E[y], E[y^2]])
//             -> [ops/batch_norm.py: the group's all-reduce mean, if any]
//             -> bn_apply_kernel (the f32 affine from the moments, gamma
//             and beta, the moving update by the blocks of the first row
//             chunk, out = relu(y * inv + shift) rounded once)
//   backward: bn_grad_stats_kernel (per-block sums of g' and g' * xhat,
//             g' the cotangent behind the ReLU mask) -> bn_reduce_kernel
//             -> [the group's all-reduce mean, if any]
//             -> bn_dx_kernel (dy = inv * (g' - S1/P - xhat * S2/P))
//
// Three launches a direction, the second pass reading y (and g) again: up
// to 1.5x (forward) and 1.67x (backward) the bound's bytes when L2 (50 MB)
// does not hold y between the passes; at B=32 every conv1-conv4 tensor
// (8-16 MB) fits. What the design does about the bound:
// - every thread moves 16 bytes a load (8 bf16 or 4 f32 channels; one
//   element where C or a pointer does not allow it), consecutive threads on
//   consecutive channels of a row, four rows in flight (two of g and two
//   of y in the backward);
// - the block shape follows C: up to 32 threads across the channels and the
//   rest of the 256 down the rows, so C = 64 bf16 puts 32 rows in a block
//   and C = 1024 splits the channels over 4 blocks of 8 rows;
// - at most 264 blocks (two an SM) write partial sums, so the reduction in
//   between reads at most 264 x 2 x C floats;
// - nothing is saved but y and the (2, C) moments: the backward recomputes
//   the affine and the ReLU mask from them with the same instructions
//   (explicitly rounded f32 operations and one fma), so the mask is the
//   forward's bit for bit.
// Every sum runs in a fixed order (per thread over its rows, then a fixed
// tree in shared memory, then the partials in index order): no atomics, so
// two calls and a graph replay give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Rows a thread has in flight: of one array (statistics, apply), of two
// (the backward's passes).
constexpr int kUnroll = 4;
constexpr int kPairs = 2;
constexpr int kStatsBlocks = 264;
constexpr int kApplyBlocks = 1056;
// bn_reduce_kernel: channels a block by lanes over the partial sums.
constexpr int kReduceChannels = 16;
constexpr int kReduceLanes = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements at p as floats: 16 bytes, or one element.
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void load(const T* p, float (&v)[1]) {
  v[0] = to_f(*p);
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}
template <typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[1]) {
  from_f(v[0], p);
}

// One channel's statistics and folded affine from the moments (2, C):
// var = max(E[y^2] - E[y]^2, 0), inv = rsqrt(var + eps) * gamma,
// shift = beta - mean * inv, the reference's arithmetic, each operation
// rounded on its own (no contraction), so every kernel that calls it gets
// the same bits. var_on: the clamp let the variance through (its gradient
// flows where E[y^2] - E[y]^2 >= 0, as torch.clamp_min's does).
struct Affine {
  float mean, var, rstd, inv, shift;
  bool var_on;
};

__device__ __forceinline__ Affine affine(const float* __restrict__ moments,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float eps, int c, int ch) {
  Affine a;
  a.mean = moments[ch];
  const float d = __fsub_rn(moments[c + ch], __fmul_rn(a.mean, a.mean));
  a.var_on = d >= 0.f;
  a.var = d < 0.f ? 0.f : d;
  a.rstd = rsqrtf(__fadd_rn(a.var, eps));
  a.inv = __fmul_rn(a.rstd, gamma[ch]);
  a.shift = __fsub_rn(beta[ch], __fmul_rn(a.mean, a.inv));
  return a;
}

// The normalized, pre-ReLU value: y * inv + shift in one rounding.
__device__ __forceinline__ float pre_act(float y, float inv, float shift) {
  return __fmaf_rn(y, inv, shift);
}

// Sums of V channels over rows, then over the block's rows in shared
// memory, written as this block's partial: partial[(block, 0 | 1, C)].
template <int V>
__device__ __forceinline__ void block_partial(float (&s)[V], float (&q)[V],
                                              float* __restrict__ partial,
                                              int c, int g, int groups) {
  __shared__ float red[2][kThreads * 8];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = blockDim.x * V;
  float* rs = red[0];
  float* rq = red[1];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    rs[ty * width + tx * V + i] = s[i];
    rq[ty * width + tx * V + i] = q[i];
  }
  __syncthreads();
  for (int half = blockDim.y / 2; half > 0; half >>= 1) {
    if (ty < half) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int at = ty * width + tx * V + i;
        rs[at] += rs[at + half * width];
        rq[at] += rq[at + half * width];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && g < groups) {
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[g * V + i] = rs[tx * V + i];
      out[c + g * V + i] = rq[tx * V + i];
    }
  }
}

// Column sums of y and y^2 over this block's rows (block rows are
// blockIdx.x * blockDim.y + threadIdx.y, striding by the grid).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ y, float* __restrict__ partial,
                    long long rows, int c) {
  const int groups = c / V;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (g < groups) {
    const T* base = y + static_cast<long long>(g) * V;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
    long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                  threadIdx.y;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load(base + (r + u * step) * c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[u][i];
          q[i] = __fmaf_rn(v[u][i], v[u][i], q[i]);
        }
      }
    }
    for (; r < rows; r += step) {
      float v[V];
      load(base + r * c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] = __fmaf_rn(v[i], v[i], q[i]);
      }
    }
  }
  block_partial<V>(s, q, partial, c, g, groups);
}

// Column sums of g' and g' * xhat (g' = g behind the ReLU mask, xhat =
// (y - mean) * rstd) over this block's rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_stats_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                         const float* __restrict__ moments,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, float eps,
                         float* __restrict__ partial, long long rows, int c,
                         int relu) {
  const int groups = c / V;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (g < groups) {
    float mean[V], rstd[V], inv[V], shift[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const Affine a = affine(moments, gamma, beta, eps, c, g * V + i);
      mean[i] = a.mean;
      rstd[i] = a.rstd;
      inv[i] = a.inv;
      shift[i] = a.shift;
    }
    const long long off = static_cast<long long>(g) * V;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
    long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                  threadIdx.y;
    auto add = [&](const float (&gv)[V], const float (&yv)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gp =
            (relu && !(pre_act(yv[i], inv[i], shift[i]) > 0.f)) ? 0.f : gv[i];
        const float xh = __fmul_rn(__fsub_rn(yv[i], mean[i]), rstd[i]);
        s[i] += gp;
        q[i] = __fmaf_rn(gp, xh, q[i]);
      }
    };
    for (; r + (kPairs - 1) * step < rows; r += kPairs * step) {
      float gv[kPairs][V], yv[kPairs][V];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        load(gy + off + (r + u * step) * c, gv[u]);
        load(y + off + (r + u * step) * c, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < kPairs; ++u) add(gv[u], yv[u]);
    }
    for (; r < rows; r += step) {
      float gv[V], yv[V];
      load(gy + off + r * c, gv);
      load(y + off + r * c, yv);
      add(gv, yv);
    }
  }
  block_partial<V>(s, q, partial, c, g, groups);
}

// partial (nb, 2, C) -> out (2, C): each channel's nb partials summed in
// index order (lane j takes j, j + 16, ...; the 16 lanes in a fixed tree),
// divided by `denom`.
__global__ void __launch_bounds__(kReduceChannels * kReduceLanes)
    bn_reduce_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, int nb, int c, float denom) {
  __shared__ float red[2][kReduceLanes][kReduceChannels + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kReduceChannels + tx;
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (int j = ty; j < nb; j += kReduceLanes) {
      s += partial[static_cast<long long>(j) * 2 * c + ch];
      q += partial[static_cast<long long>(j) * 2 * c + c + ch];
    }
  }
  red[0][ty][tx] = s;
  red[1][ty][tx] = q;
  __syncthreads();
  for (int half = kReduceLanes / 2; half > 0; half >>= 1) {
    if (ty < half) {
      red[0][ty][tx] += red[0][ty + half][tx];
      red[1][ty][tx] += red[1][ty + half][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && ch < c) {
    out[ch] = __fdiv_rn(red[0][0][tx], denom);
    out[c + ch] = __fdiv_rn(red[1][0][tx], denom);
  }
}

// out = relu(y * inv + shift) in f32, rounded once to T; the blocks of the
// first row chunk also move the moving statistics (m read on the device):
// moving = m * moving + (1 - m) * batch.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ y, T* __restrict__ out,
                    const float* __restrict__ moments,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    float* __restrict__ mov_mean, float* __restrict__ mov_var,
                    const float* __restrict__ momentum, float eps,
                    long long rows, int c, int relu) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= c / V) return;
  float inv[V], shift[V];
  const bool update = blockIdx.x == 0 && threadIdx.y == 0;
  const float m = update ? *momentum : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = g * V + i;
    const Affine a = affine(moments, gamma, beta, eps, c, ch);
    inv[i] = a.inv;
    shift[i] = a.shift;
    if (update) {
      const float om = __fsub_rn(1.f, m);
      mov_mean[ch] = __fadd_rn(__fmul_rn(mov_mean[ch], m),
                               __fmul_rn(om, a.mean));
      mov_var[ch] = __fadd_rn(__fmul_rn(mov_var[ch], m),
                              __fmul_rn(om, a.var));
    }
  }
  const long long off = static_cast<long long>(g) * V;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  auto apply = [&](float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float o = pre_act(v[i], inv[i], shift[i]);
      // ReLU that keeps a NaN, as torch.relu does.
      v[i] = (relu && o <= 0.f) ? 0.f : o;
    }
  };
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load(y + off + (r + u * step) * c, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply(v[u]);
      store(out + off + (r + u * step) * c, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[V];
    load(y + off + r * c, v);
    apply(v);
    store(out + off + r * c, v);
  }
}

// dy = inv * ((g' - S1 / P) - xhat * S2 / P), S2's term dropped where the
// variance's clamp engaged; sums = (S1, S2) over the P = rows rows (or
// their mean over a group's equal shards, which gives the same ratio).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                 const float* __restrict__ moments,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, float eps,
                 const float* __restrict__ sums, T* __restrict__ dx,
                 long long rows, int c, int relu) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= c / V) return;
  const float p = static_cast<float>(rows);
  float mean[V], rstd[V], inv[V], shift[V], b1[V], b2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = g * V + i;
    const Affine a = affine(moments, gamma, beta, eps, c, ch);
    mean[i] = a.mean;
    rstd[i] = a.rstd;
    inv[i] = a.inv;
    shift[i] = a.shift;
    b1[i] = __fdiv_rn(sums[ch], p);
    b2[i] = a.var_on ? __fdiv_rn(sums[c + ch], p) : 0.f;
  }
  const long long off = static_cast<long long>(g) * V;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  // gv becomes dx.
  auto grad = [&](float (&gv)[V], const float (&yv)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gp =
          (relu && !(pre_act(yv[i], inv[i], shift[i]) > 0.f)) ? 0.f : gv[i];
      const float xh = __fmul_rn(__fsub_rn(yv[i], mean[i]), rstd[i]);
      gv[i] = __fmul_rn(inv[i], __fsub_rn(__fsub_rn(gp, b1[i]),
                                          __fmul_rn(xh, b2[i])));
    }
  };
  for (; r + (kPairs - 1) * step < rows; r += kPairs * step) {
    float gv[kPairs][V], yv[kPairs][V];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      load(gy + off + (r + u * step) * c, gv[u]);
      load(y + off + (r + u * step) * c, yv[u]);
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      grad(gv[u], yv[u]);
      store(dx + off + (r + u * step) * c, gv[u]);
    }
  }
  for (; r < rows; r += step) {
    float gv[V], yv[V];
    load(gy + off + r * c, gv);
    load(y + off + r * c, yv);
    grad(gv, yv);
    store(dx + off + r * c, gv);
  }
}

// The block shape for C / V channel groups: tx threads across the groups
// (a power of two up to 32), 256 / tx down the rows; cgrid blocks across.
struct Layout {
  dim3 block;
  int cgrid;
};

Layout layout(int groups) {
  int tx = 1;
  while (tx < groups && tx < 32) tx <<= 1;
  return {dim3(tx, kThreads / tx), (groups + tx - 1) / tx};
}

// Row chunks: enough for kUnroll rows a thread, at most `cap` blocks in all.
int row_blocks(long long rows, const Layout& l, int cap) {
  const long long per = static_cast<long long>(l.block.y) * kUnroll;
  long long n = (rows + per - 1) / per;
  const long long most = cap / l.cgrid > 0 ? cap / l.cgrid : 1;
  if (n > most) n = most;
  return n < 1 ? 1 : static_cast<int>(n);
}

template <typename T_, int V_>
struct Tag {
  using T = T_;
  static constexpr int V = V_;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Runs f(Tag<T, V>()) with T the activation type and V = 16 bytes of it
// when C and every pointer in `ptrs` allow, else V = 1.
template <typename F>
int dispatch(int bf16, int c, const void* const* ptrs, int n, F&& f) {
  bool vec = true;
  for (int i = 0; i < n; ++i) vec = vec && aligned16(ptrs[i]);
  if (bf16) {
    if (vec && c % 8 == 0) return f(Tag<__nv_bfloat16, 8>());
    return f(Tag<__nv_bfloat16, 1>());
  }
  if (vec && c % 4 == 0) return f(Tag<float, 4>());
  return f(Tag<float, 1>());
}

int reduce(const float* partial, float* out, int nb, int c, float denom,
           cudaStream_t s) {
  bn_reduce_kernel<<<(c + kReduceChannels - 1) / kReduceChannels,
                     dim3(kReduceChannels, kReduceLanes), 0, s>>>(
      partial, out, nb, c, denom);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most row chunks that write partial sums: `partial` holds this many
// (2, C) f32 rows.
extern "C" int pcae_bn_max_partials() { return kStatsBlocks; }

// y (rows, C) contiguous, bf16 (bf16 != 0) or f32 -> moments (2, C) f32 =
// [E[y], E[y^2]] over the rows. Launches bn_stats_kernel and
// bn_reduce_kernel on `stream`; returns cudaGetLastError().
extern "C" int pcae_bn_moments(int bf16, const void* y, void* partial,
                               void* moments, long long rows, int c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {y};
  return dispatch(bf16, c, ptrs, 1, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    const Layout l = layout(c / V);
    const int nb = row_blocks(rows, l, kStatsBlocks);
    bn_stats_kernel<T, V><<<dim3(nb, l.cgrid), l.block, 0, s>>>(
        static_cast<const T*>(y), static_cast<float*>(partial), rows, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce(static_cast<const float*>(partial),
                  static_cast<float*>(moments), nb, c,
                  static_cast<float>(rows), s);
  });
}

// out = relu(y * inv + shift) (relu != 0; else without the ReLU), the
// affine from moments (2, C), gamma and beta (C,) f32; mov_mean and mov_var
// (C,) f32 move in place by the 0-dim f32 momentum. One launch.
extern "C" int pcae_bn_apply(int bf16, const void* y, void* out,
                             const void* moments, const void* gamma,
                             const void* beta, void* mov_mean, void* mov_var,
                             const void* momentum, float eps, long long rows,
                             int c, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {y, out};
  return dispatch(bf16, c, ptrs, 2, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    const Layout l = layout(c / V);
    bn_apply_kernel<T, V>
        <<<dim3(row_blocks(rows, l, kApplyBlocks), l.cgrid), l.block, 0, s>>>(
            static_cast<const T*>(y), static_cast<T*>(out),
            static_cast<const float*>(moments),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<float*>(mov_mean), static_cast<float*>(mov_var),
            static_cast<const float*>(momentum), eps, rows, c, relu);
    return static_cast<int>(cudaGetLastError());
  });
}

// g (the output's cotangent) and y (rows, C) -> sums (2, C) f32 =
// [sum g', sum g' * xhat] over the rows (dbeta and dgamma). Launches
// bn_grad_stats_kernel and bn_reduce_kernel.
extern "C" int pcae_bn_grad_sums(int bf16, const void* g, const void* y,
                                 const void* moments, const void* gamma,
                                 const void* beta, float eps, void* partial,
                                 void* sums, long long rows, int c, int relu,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {g, y};
  return dispatch(bf16, c, ptrs, 2, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    const Layout l = layout(c / V);
    const int nb = row_blocks(rows, l, kStatsBlocks);
    bn_grad_stats_kernel<T, V><<<dim3(nb, l.cgrid), l.block, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(y),
        static_cast<const float*>(moments), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), eps, static_cast<float*>(partial),
        rows, c, relu);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce(static_cast<const float*>(partial),
                  static_cast<float*>(sums), nb, c, 1.f, s);
  });
}

// dx (rows, C) in y's type from g, y, the moments and sums (2, C) of
// pcae_bn_grad_sums (or their mean over a group). One launch.
extern "C" int pcae_bn_dx(int bf16, const void* g, const void* y,
                          const void* moments, const void* gamma,
                          const void* beta, float eps, const void* sums,
                          void* dx, long long rows, int c, int relu,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {g, y, dx};
  return dispatch(bf16, c, ptrs, 3, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    const Layout l = layout(c / V);
    bn_dx_kernel<T, V>
        <<<dim3(row_blocks(rows, l, kApplyBlocks), l.cgrid), l.block, 0, s>>>(
            static_cast<const T*>(g), static_cast<const T*>(y),
            static_cast<const float*>(moments),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            eps, static_cast<const float*>(sums), static_cast<T*>(dx), rows,
            c, relu);
    return static_cast<int>(cudaGetLastError());
  });
}
