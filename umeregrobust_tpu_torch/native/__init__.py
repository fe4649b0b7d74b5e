"""Native host ops: ctypes bindings with numpy / scipy fallbacks (the port's
own copy of umeregrobust_tpu/native/__init__.py).

Builds hostops.cpp with g++ at first use (-O3 -shared -fPIC, no external
dependencies) into build/host/ at the repository root, as a library whose
name carries a hash of the source and flags, so an edited source
rebuilds and concurrent processes never load a half-written file.
Exposes:

- quantize(pts, voxel)          -> (coords (M,3) int32, idx (M,) int64)
- nn_radius(q, p, radius)       -> (idx (Nq,) int64 [-1 = none], dist)
- nn_1(q, p)                    -> (idx, dist) unbounded 1-NN
- hungarian(cost)               -> (rows, cols)

Every function falls back to numpy / scipy (np.unique, cKDTree,
linear_sum_assignment) when the library cannot be built, as the JAX
package's does; ``have_native()`` says which path is active. These are
host ops: the module imports neither torch nor the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["quantize", "nn_radius", "nn_1", "hungarian", "have_native"]

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libhostops_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library's path, built first if it is not there; None when g++
    is missing or fails."""
    so = _library_path()
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64, f32 = ctypes.c_int64, ctypes.c_float
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.umr_quantize.restype = i64
    lib.umr_quantize.argtypes = [pf32, i64, f32, pi32, pi64]
    lib.umr_nn_radius.restype = None
    lib.umr_nn_radius.argtypes = [pf32, i64, pf32, i64, f32, pi64, pf32]
    lib.umr_nn_1.restype = None
    lib.umr_nn_1.argtypes = [pf32, i64, pf32, i64, f32, pi64, pf32]
    lib.umr_hungarian.restype = None
    lib.umr_hungarian.argtypes = [pf64, i64, i64, pi64]
    _lib = lib
    return lib


def have_native() -> bool:
    return _load() is not None


def quantize(pts: np.ndarray, voxel: float) -> Tuple[np.ndarray, np.ndarray]:
    """Unique voxels + first-occurrence rows, in first-occurrence order."""
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    n = len(pts)
    if lib is None:
        from umeregrobust_tpu_torch.ops.voxel import quantize_np
        return quantize_np(pts, voxel)
    coords = np.empty((n, 3), np.int32)
    idx = np.empty(n, np.int64)
    m = lib.umr_quantize(pts, n, np.float32(voxel), coords, idx)
    return coords[:m].copy(), idx[:m].copy()


def nn_radius(q: np.ndarray, p: np.ndarray, radius: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest neighbor within radius; idx -1 when none."""
    lib = _load()
    q = np.ascontiguousarray(q, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    if lib is None:
        from scipy.spatial import cKDTree
        dist, idx = cKDTree(p).query(q, k=1)
        idx = np.where(dist <= radius, idx, -1).astype(np.int64)
        dist = np.where(idx >= 0, dist, -1.0).astype(np.float32)
        return idx, dist
    idx = np.empty(len(q), np.int64)
    dist = np.empty(len(q), np.float32)
    lib.umr_nn_radius(q, len(q), p, len(p), np.float32(radius), idx, dist)
    return idx, dist


def nn_1(q: np.ndarray, p: np.ndarray, cell: float = 1.0
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Unbounded 1-NN (expanding-ring grid search)."""
    lib = _load()
    q = np.ascontiguousarray(q, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    if lib is None:
        from scipy.spatial import cKDTree
        dist, idx = cKDTree(p).query(q, k=1)
        return idx.astype(np.int64), dist.astype(np.float32)
    idx = np.empty(len(q), np.int64)
    dist = np.empty(len(q), np.float32)
    lib.umr_nn_1(q, len(q), p, len(p), np.float32(cell), idx, dist)
    return idx, dist


def hungarian(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal assignment; returns (rows, cols) like linear_sum_assignment.
    Requires n_rows <= n_cols (transpose handled here)."""
    lib = _load()
    cost = np.ascontiguousarray(cost, np.float64)
    if lib is None:
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(cost)
        return r.astype(np.int64), c.astype(np.int64)
    transposed = cost.shape[0] > cost.shape[1]
    A = cost.T.copy() if transposed else cost
    n, m = A.shape
    r2c = np.full(n, -1, np.int64)
    lib.umr_hungarian(np.ascontiguousarray(A), n, m, r2c)
    rows = np.arange(n, dtype=np.int64)
    if transposed:
        return r2c, rows
    return rows, r2c
