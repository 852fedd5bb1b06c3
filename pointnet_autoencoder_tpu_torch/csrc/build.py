"""Builds the port's CUDA kernels, and its host C++ sources, into shared
libraries with a plain C interface, loaded with ``ctypes``.

    python -m pointnet_autoencoder_tpu_torch.csrc.build

Each ``csrc/<name>.cu`` becomes ``csrc/_build/<name>-<key>.so``, where the
key hashes the sources (the ``.cu`` file and every ``.cuh`` header here)
and the compiler flags, so an edited source is rebuilt and an unchanged
one is reused. The build uses nothing but the sources in this directory
and the CUDA toolkit's ``nvcc``; one ``nvcc`` runs per source, all started
together. A missing ``nvcc`` or a failed compile raises: there is no
fallback to the plain PyTorch versions for CUDA tensors.

The host sources, ``csrc/render_balls.cpp`` (the point-cloud renderer)
and ``csrc/fastio.cpp`` (the data loader's text parser), are built the
same way with ``g++ -O3 -std=c++17 -shared -fPIC``, each at its first
use; a missing ``g++`` or a failed compile raises as well.

Every C entry point of a CUDA source returns ``cudaGetLastError()`` after
its launches; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
SOURCES = ("batch_norm", "chamfer", "emd", "fused_encoder", "fused_head")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Host C++ sources (``csrc/<name>.cpp``), built with g++.
HOST_SOURCES = ("render_balls", "fastio")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if none exists."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def find_gxx() -> str:
    """Path of ``g++`` on ``PATH``; raises if there is none."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host sources "
                           "(csrc/render_balls.cpp, csrc/fastio.cpp) "
                           "cannot be built")
    return gxx


def _sources(name: str) -> list:
    """``csrc/<name>.cpp`` for a host source; else ``csrc/<name>.cu`` and
    every ``.cuh`` header here."""
    if name in HOST_SOURCES:
        return [HERE / f"{name}.cpp"]
    return [HERE / f"{name}.cu", *sorted(HERE.glob("*.cuh"))]


def _flags(name: str) -> Tuple[str, ...]:
    return GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in _sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_key(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that have no up-to-date library, all
    compiler processes running at once. Returns each compiled source's
    compiler output (for a CUDA source, the ``ptxas`` report: registers,
    shared memory, spills); raises with the compiler's output if any
    compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        source = _sources(name)[0]
        compiler = find_gxx() if name in HOST_SOURCES else find_nvcc()
        tmp = BUILD_DIR / f".{name}-{os.getpid()}-{time.monotonic_ns()}.so"
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(source)]
        procs[name] = (tmp, source.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, source, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{source} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic under races
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built at
    first use, with ``argtypes`` and ``restype`` set from ``signatures``
    (entry name -> (argtypes, restype)); pointers and the stream go as
    ``c_void_p``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            sigs = dict(signatures)
            if name not in HOST_SOURCES:
                sigs["pcae_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
            for fn_name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.pcae_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


if __name__ == "__main__":
    t0 = time.perf_counter()
    for src, log in build(SOURCES + HOST_SOURCES).items():
        print(f"[{src}]\n{log}")
    print(f"built {', '.join(SOURCES + HOST_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s into {BUILD_DIR}")
    sys.exit(0)
