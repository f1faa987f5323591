"""ctypes loader for the native C++ setup kernels (shared ``csrc/native.cpp``).

Counterpart of ``dolfinx_mpc_tpu/native/__init__.py``.  The library is
compiled with g++ on first use into the git-ignored
``build/dolfinx_mpc_tpu_torch/`` directory at the repository root, keyed by a
hash of the source; every entry point keeps its numpy fallback, so the
package works without a toolchain.  This is host setup code (entity dedup and
point-in-cell search), not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys

import numpy as np

from .._build import BUILD_DIR, REPO_ROOT

__all__ = ["available", "sort_unique_inverse", "locate_points", "CELL_TYPE_IDS"]

CELL_TYPE_IDS = {
    "interval": 0,
    "triangle": 1,
    "quadrilateral": 2,
    "tetrahedron": 3,
    "hexahedron": 4,
}

_SRC = REPO_ROOT / "csrc" / "native.cpp"
# the JAX package's flags: with the same code generation (-march=native
# contracts the point-location Newton steps into FMAs) both packages locate
# points to the same bits, so their constraint coefficients are equal
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


@functools.cache
def _get():
    """The loaded library, or None (no source, no g++, or a failed build)."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libmpcnative_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"[dolfinx_mpc_tpu_torch.native] build failed ({e}); using numpy fallback",
                  file=sys.stderr)
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.sort_unique_inverse.restype = ctypes.c_int64
    lib.sort_unique_inverse.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.locate_points.restype = None
    lib.locate_points.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def available() -> bool:
    return _get() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def sort_unique_inverse(keys: np.ndarray):
    """(uniq, first_index, inverse) of an int64 key array — radix-sort native
    path, np.unique fallback."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _get()
    if lib is None or keys.size == 0 or keys.min() < 0:
        uniq, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
        return uniq, first, inverse
    n = keys.shape[0]
    uniq = np.empty(n, np.int64)
    inverse = np.empty(n, np.int64)
    first = np.empty(n, np.int64)
    nu = lib.sort_unique_inverse(
        _ptr(keys, ctypes.c_int64), n, _ptr(uniq, ctypes.c_int64),
        _ptr(inverse, ctypes.c_int64), _ptr(first, ctypes.c_int64),
    )
    return uniq[:nu].copy(), first[:nu].copy(), inverse


def locate_points(points, cell_verts, vcoords, cell_type: str, cells=None, tol=1e-8):
    """Native grid-hash point location; returns (cells (n,), X (n, tdim)) with
    -1 for misses.  Returns None if the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    points = np.ascontiguousarray(np.atleast_2d(points), np.float64)
    if cells is not None:
        cell_verts = cell_verts[cells]
    cell_verts = np.ascontiguousarray(cell_verts, np.int32)
    vcoords = np.ascontiguousarray(vcoords, np.float64)
    n, gdim = points.shape
    nc, nv = cell_verts.shape
    ctid = CELL_TYPE_IDS[cell_type]
    tdim = 1 if ctid == 0 else (2 if ctid <= 2 else 3)
    out_cells = np.empty(n, np.int64)
    out_X = np.zeros((n, tdim), np.float64)
    lib.locate_points(
        _ptr(points, ctypes.c_double), n, gdim,
        _ptr(cell_verts, ctypes.c_int32), nc, nv,
        _ptr(vcoords, ctypes.c_double), ctid, tol,
        _ptr(out_cells, ctypes.c_int64), _ptr(out_X, ctypes.c_double),
    )
    if cells is not None:
        hit = out_cells >= 0
        out_cells[hit] = np.asarray(cells, np.int64)[out_cells[hit]]
    return out_cells, out_X
