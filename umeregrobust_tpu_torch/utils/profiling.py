"""Wall-clock phases and device traces (port of
umeregrobust_tpu/utils/profiling.py).

- ``phase(name)``: a context manager that times a named phase on the
  host's clock, synchronizing the current CUDA device before and after it
  (nothing to wait for on the CPU), accumulated into a registry that
  ``report()`` prints as a table;
- ``device_trace(dir)``: ``torch.profiler`` with CUDA activity, writing a
  Chrome / Perfetto trace into ``dir``. Unlike the JAX version it does not
  swallow errors: a profiler that fails to start raises.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch

__all__ = ["phase", "report", "reset", "device_trace"]

_acc: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, sync: bool = True) -> Iterator[None]:
    """Time a named phase; waits for the device's outstanding work before
    and after it when sync."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        dt = time.perf_counter() - t0
        total, n = _acc[name]
        _acc[name] = (total + dt, n + 1)


def report() -> str:
    lines = [f"{'phase':30s} {'total_s':>9s} {'calls':>6s} {'mean_ms':>9s}"]
    for name, (total, n) in sorted(_acc.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name:30s} {total:9.3f} {n:6d} {1000*total/max(n,1):9.2f}")
    out = "\n".join(lines)
    print(out, flush=True)
    return out


def reset() -> None:
    _acc.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A torch.profiler trace (CPU and, where there is a card, CUDA
    activity) of the block, written to log_dir as a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
