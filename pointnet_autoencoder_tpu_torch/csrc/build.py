"""Builds the port's CUDA kernels into shared libraries with a plain C
interface, loaded with ``ctypes``.

    python -m pointnet_autoencoder_tpu_torch.csrc.build

Each ``csrc/<name>.cu`` becomes ``csrc/_build/<name>-<key>.so``, where the
key hashes the sources (the ``.cu`` file and every ``.cuh`` header here)
and the compiler flags, so an edited source is rebuilt and an unchanged
one is reused. The build uses nothing but the sources in this directory
and the CUDA toolkit's ``nvcc``; one ``nvcc`` runs per source, all started
together. A missing ``nvcc`` or a failed compile raises: there is no
fallback to the plain PyTorch versions for CUDA tensors.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.
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
SOURCES = ("chamfer", "fused_encoder", "fused_head")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def _key(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [HERE / f"{name}.cu", *sorted(HERE.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_key(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that have no up-to-date library, all
    ``nvcc`` processes running at once. Returns each compiled source's
    ``ptxas`` report (registers, shared memory, spills); raises with the
    compiler's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".{name}-{os.getpid()}-{time.monotonic_ns()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(HERE / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic under races
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``argtypes`` and ``restype`` set from ``signatures`` (entry name ->
    (argtypes, restype)); pointers and the stream go as ``c_void_p``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            sigs = {"pcae_error_string": ([ctypes.c_int], ctypes.c_char_p),
                    **signatures}
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
    for src, log in build().items():
        print(f"[{src}]\n{log}")
    print(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"into {BUILD_DIR}")
    sys.exit(0)
