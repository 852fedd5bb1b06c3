"""Parsing of the dataset's ``.pts`` and ``.seg`` text files, the port's
copy of ``pointnet_autoencoder_tpu/data/fastio.py``.

The reference decodes shapes with ``np.loadtxt`` (part_dataset.py:110-113),
which dominates the host's time on the first epoch. ``load_pts`` and
``load_seg`` parse with native C++ (``csrc/fastio.cpp``, built with g++ at
first use into ``csrc/_build/`` and bound with ``ctypes``); a failed build
raises. ``load_pts_numpy`` and ``load_seg_numpy`` are the plain versions
beside them, reached only by name (tests and the on-card smoke run compare
the two).

Both paths first check the file's column count (``_check_columns``): a
``.pts`` with per-point normals (x y z nx ny nz) or a ``.seg`` with a
confidence column would otherwise be read as interleaved fake points or
labels. A ``.pts`` whose value count is not a multiple of 3 raises too.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np

from pointnet_autoencoder_tpu_torch.csrc import build

_SIGNATURES = {
    "count_rows": ([ctypes.c_char_p], ctypes.c_long),
    "parse_floats": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                      ctypes.c_long], ctypes.c_long),
    "parse_ints": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.c_long], ctypes.c_long),
}


def native_library() -> ctypes.CDLL:
    """The parser's library, built at first use."""
    return build.load("fastio", _SIGNATURES)


def native_available() -> bool:
    """Whether the native parser is built, or g++ is there to build it."""
    return (build.library_path("fastio").exists()
            or shutil.which("g++") is not None)


def _check_columns(path: str, expected: int) -> None:
    """Raise ValueError unless the first non-empty line of ``path`` has
    ``expected`` whitespace-separated columns."""
    with open(path, "rb") as f:
        for raw in f:
            cols = len(raw.split())
            if cols == 0:
                continue
            if cols != expected:
                raise ValueError(
                    f"{path}: expected {expected} columns, found {cols} "
                    "on the first data line")
            return


def _rows(lib: ctypes.CDLL, path: str) -> int:
    n = lib.count_rows(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    return n


def load_pts(path: str) -> np.ndarray:
    """An (N, 3) f32 array from a whitespace-separated text file of
    points, parsed natively."""
    _check_columns(path, 3)
    lib = native_library()
    out = np.empty((_rows(lib, path) * 3,), dtype=np.float32)
    got = lib.parse_floats(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if got < 0:
        raise IOError(f"cannot read {path}")
    if got % 3 != 0:
        raise ValueError(f"{path}: {got} values is not a multiple of 3")
    return out[:got].reshape(-1, 3)


def load_seg(path: str) -> np.ndarray:
    """An (N,) int64 array from a text file of one integer label per row,
    parsed natively."""
    _check_columns(path, 1)
    lib = native_library()
    out = np.empty((_rows(lib, path),), dtype=np.int32)
    got = lib.parse_ints(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.size)
    if got < 0:
        raise IOError(f"cannot read {path}")
    return out[:got].astype(np.int64)


def load_pts_numpy(path: str) -> np.ndarray:
    """``load_pts`` by ``np.loadtxt`` (parsed as f64, then rounded)."""
    _check_columns(path, 3)
    return np.loadtxt(path, ndmin=2).astype(np.float32).reshape(-1, 3)


def load_seg_numpy(path: str) -> np.ndarray:
    """``load_seg`` by ``np.loadtxt``."""
    _check_columns(path, 1)
    return np.loadtxt(path, ndmin=1).astype(np.int64)
