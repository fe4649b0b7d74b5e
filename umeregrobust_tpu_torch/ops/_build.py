"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own nvcc process (all started together)
for sm_90a into an object file; the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The library name
carries a hash of the sources and flags, so an edited source rebuilds
and concurrent processes never load a half-written file. No PyTorch
header is included: a build takes seconds, not minutes.

Every C entry point takes raw device pointers and the CUDA stream as
`void*` and returns `cudaGetLastError()` after its launches; `check`
raises on a non-zero code. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["load_library", "check", "build_library", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C signatures: every pointer and the stream are void*, sizes are int
# (long long where they may pass 2^31)
_SIGNATURES = {
    "umr_nn1_argmin": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                       _INT, _VP],
    "umr_ume_moments": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                        _INT, _FLT, _INT, _VP, _VP],
    "umr_ume_moments_scratch": [_INT],
    "umr_corr_scores": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                        _INT, _INT, _INT, _FLT, _FLT, _VP],
    "umr_gather_rows": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
                        _VP],
    "umr_sparse_conv_rowtile": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                _INT, _INT, _INT, _VP],
    "umr_sparse_conv_tapsplit": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                                 _INT, _INT, _INT, _INT, _INT, _INT, _VP],
    "umr_conv_entries": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                         _INT, _INT, _VP],
    "umr_sparse_conv_tapsplit_mma": [_VP, _VP, _VP, _VP, _VP, _VP, _INT,
                                     _INT, _INT, _INT, _INT, _INT, _LL,
                                     _INT, _VP],
    "umr_sparse_conv_rowtile_mma": [_VP, _VP, _VP, _VP, _VP, _INT, _INT,
                                    _INT, _INT, _INT, _INT, _VP],
    "umr_sparse_conv_cin1": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                             _INT, _VP],
    "umr_row_segments": [_VP, _VP, _INT, _INT, _INT, _VP],
    "umr_gather_rows_backward": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                                 _INT, _VP],
    "umr_sparse_conv_wgrad": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                              _INT, _INT, _INT, _INT, _INT, _VP],
    "umr_sparse_conv_wgrad_mma": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                  _VP],
    "umr_sparse_conv_wgrad_cin1": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                                   _INT, _INT, _INT, _INT, _VP],
    "umr_sparse_conv_grouped": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                _VP, _LL, _LL, _INT, _INT, _INT, _INT, _INT,
                                _INT, _VP],
    "umr_sparse_conv_grouped_wgrad": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _LL, _LL, _INT, _INT, _INT,
                                      _INT, _INT, _VP],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels cannot be built, and a "
            "CUDA tensor has no other path (CPU tensors use the plain "
            "PyTorch versions)")
    return nvcc


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(sources: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    for s in sorted(CSRC.glob("*.cuh")):
        h.update(s.read_bytes())
    return BUILD_DIR / f"libumr_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link the
    shared library; returns its path. The compiler's output, including
    ptxas's register and shared-memory report, goes to build.log."""
    global build_seconds
    sources = _sources()
    lib_path = _library_path(sources)
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for s in sources:
        obj = BUILD_DIR / f"{s.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(logs))
    os.replace(tmp, lib_path)
    build_seconds = time.time() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be
    built or loaded; there is no fallback."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.umr_error_string.argtypes = [ctypes.c_int]
        lib.umr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{name}: CUDA error {code}: {lib.umr_error_string(code).decode()}")


def require(t, name: str, dtype, shape, device) -> None:
    """Validate a kernel input: dtype, shape (None = any extent), device
    and contiguity. Raises ValueError on anything the kernel does not
    take."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != e for s, e in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(device) -> int:
    """The current CUDA stream of `device`, as the int the C entry points
    take."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
