"""Cycles per phase of the Chamfer gradient kernel (K2) on the card, to
explain its time where no profiler shows inside a kernel.

    python -m pointnet_autoencoder_tpu_torch.csrc.grad_phases

Builds a copy of ``csrc/chamfer.cu`` into ``csrc/_build/`` with a
``clock64()`` stamp by thread 0 of each block at the kernel's start,
after each of its block barriers and at its end, launches it at B=32,
N=M=2048 (the training path's shape, with K1's indices), and prints each
phase's cycles averaged over the blocks, for a few calls. Then the device
time of the real kernel and of one ``index_add_`` of both directions'
terms (the yardstick), each the median over 50 traced calls. Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch.csrc import build
from pointnet_autoencoder_tpu_torch.ops import chamfer as ch

B, N = 32, 2048
_DECL = "  extern __shared__ __align__(16) int smem[];"
_STAMPS = """
__device__ long long pcae_stamps[4096][16];
#define STAMP do { if (threadIdx.x == 0) pcae_stamps[((blockIdx.x * 2 + \\
    blockIdx.y) * gridDim.z + blockIdx.z) % 4096][stamp++] = clock64(); \\
  } while (0)
"""
_READ = """
extern "C" int pcae_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, pcae_stamps, sizeof(pcae_stamps));
}
"""


def instrumented_library() -> ctypes.CDLL:
    src = (build.HERE / "chamfer.cu").read_text()
    head, body = src.split("template <bool kGlobal>\n__global__", 1)
    kernel, tail = body.split("\n}\n", 1)
    if _DECL not in kernel:
        raise RuntimeError("the gradient kernel's shared declaration moved")
    kernel = kernel.replace(_DECL, _DECL + "\n  int stamp = 0; STAMP;", 1)
    kernel = kernel.replace("__syncthreads();\n", "__syncthreads(); STAMP;\n")
    out = (head + _STAMPS + "template <bool kGlobal>\n__global__" + kernel
           + "\n  STAMP;\n}\n" + tail + _READ)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "chamfer_phases.cu"
    so = build.BUILD_DIR / "chamfer_phases.so"
    cu.write_text(out)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.HERE), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.pcae_nn_distance_grad.argtypes = (
        ch._SIGNATURES["pcae_nn_distance_grad"][0])
    lib.pcae_nn_distance_grad.restype = ctypes.c_int
    return lib


def median_device_us(fn, reps=50) -> float:
    """Median device duration of the kernels ``fn`` launches, over reps
    traced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    d = [e.time_range.end - e.time_range.start for e in prof.events()
         if e.device_type == DeviceType.CUDA]
    return statistics.median(d) if d else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_phases: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.RandomState(1)
    x1, x2 = (torch.from_numpy((0.5 * rng.randn(B, N, 3)).astype(
        np.float32)).cuda() for _ in range(2))
    _, i1, _, i2 = ch.nn_distance_cuda(x1, x2)
    g1, g2 = (torch.from_numpy(rng.randn(B, N).astype(np.float32)).cuda()
              for _ in range(2))
    gx1, gx2 = torch.empty_like(x1), torch.empty_like(x2)
    lib = instrumented_library()
    stream = torch.cuda.current_stream().cuda_stream
    stamps = np.zeros((4096, 16), np.int64)
    for call in range(5):
        err = lib.pcae_nn_distance_grad(
            x1.data_ptr(), x2.data_ptr(), i1.data_ptr(), i2.data_ptr(),
            g1.data_ptr(), g2.data_ptr(), gx1.data_ptr(), gx2.data_ptr(),
            None, B, N, N, stream)
        torch.cuda.synchronize()
        if err or lib.pcae_read_stamps(stamps.ctypes.data):
            raise RuntimeError("instrumented launch failed")
        used = stamps[(stamps != 0).sum(axis=1) > 1]  # blocks with rows
        last = int((used != 0).sum(axis=1).min())
        phases = np.diff(used[:, :last], axis=1).mean(axis=0)
        print(f"call {call}: {len(used)} blocks, cycles per phase "
              f"{phases.round(0).tolist()}, total "
              f"{float((used[:, last - 1] - used[:, 0]).mean()):.0f}")
    want = ch.nn_distance_grad_cuda(x1, x2, i1, i2, g1, g2)
    if not all(torch.equal(a, b) for a, b in zip(want, (gx1, gx2))):
        raise RuntimeError("the instrumented kernel's output differs")
    offs = N * torch.arange(B, device="cuda")[:, None]
    rows = torch.cat([(i1.long() + offs).reshape(-1) + B * N,
                      (i2.long() + offs).reshape(-1)])
    terms = torch.randn(2 * B * N, 3, device="cuda")
    out = torch.zeros(2 * B * N, 3, device="cuda")
    k2 = median_device_us(lambda: ch.nn_distance_grad_cuda(
        x1, x2, i1, i2, g1, g2))
    lib_us = median_device_us(lambda: out.index_add_(0, rows, terms))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device time, median of 50 calls: K2 {k2:.3f} us, index_add_ "
          f"{lib_us:.3f} us ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
