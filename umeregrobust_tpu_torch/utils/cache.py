"""The port's persistent compile cache (twin of
umeregrobust_tpu/utils/cache.py).

The port compiles no XLA programs. What it compiles is its CUDA kernel
library (ops/_build.py), once per edit of the sources: the library's
name carries a hash of the sources and flags, so its build directory is
the cache, and a later process on the same checkout loads the library
from there instead of running nvcc again. The CLIs call
`ensure_compile_cache()` where the JAX CLIs do.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from umeregrobust_tpu_torch.ops import _build

__all__ = ["ensure_compile_cache"]


def ensure_compile_cache(path: Optional[str] = None) -> str:
    """Make the kernel library's build directory and return it; `path`,
    when given, becomes that directory for the rest of the process (a
    library built or loaded before keeps its place). Safe to call more
    than once."""
    if path is not None:
        _build.BUILD_DIR = Path(path)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return str(_build.BUILD_DIR)
