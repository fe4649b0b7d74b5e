"""Wall-clock phases, device traces, the path's named ranges and its
host-read counter (the first two: port of
umeregrobust_tpu/utils/profiling.py).

- ``phase(name)``: a context manager that times a named phase on the
  host's clock, synchronizing the current CUDA device before and after it
  (nothing to wait for on the CPU), accumulated into a registry that
  ``report()`` prints as a table;
- ``device_trace(dir)``: ``torch.profiler`` with CUDA activity, writing a
  Chrome / Perfetto trace into ``dir``. Unlike the JAX version it does not
  swallow errors: a profiler that fails to start raises;
- ``span(name)``: ``torch.profiler.record_function`` under one of the
  names of ``SPANS``; every named range of the port opens through it. A
  profiler trace shows each range on the host row and a copy on the
  device row, which a trace reader must know by name to tell it from a
  kernel. The five STAGE_SPANS always open (bench_port/harness/trace.py
  lists them); the finer DETAIL_SPANS (the stages' dotted children, the
  serving batch's input copy, the train step's parts) open only after
  ``detail_spans(True)``, for a reader that lists them
  (bench_port/harness/spans.py). No synchronize and no clock: an open
  range costs about 11 us on the host while no profiler is active, a
  closed one a name lookup;
- ``HOST_READS``: the blocking device-to-host reads and the implicit
  synchronizations of the path (pageable copies to the card, boolean-mask
  indexing, ``nonzero``), by site, counted with host arithmetic where
  they happen (``host_read``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch

__all__ = ["phase", "report", "reset", "device_trace", "SPANS",
           "STAGE_SPANS", "DETAIL_SPANS", "span", "detail_spans",
           "HOST_READS", "host_read"]

# the serving path's stages (pipeline/e2e.py, pipeline/registration.py)
STAGE_SPANS = ("geometry", "forward", "feat_to_raw", "hypotheses", "icp")
# the batch's copy to the device, the stages' parts (a dotted name is a
# range inside the one it extends), and the train step's parts
# (train/trainer.py, pipeline/train_keypoints.py)
DETAIL_SPANS = (
    "inputs",
    "hypotheses.keypoints", "hypotheses.ume", "hypotheses.match",
    "hypotheses.score", "hypotheses.consensus",
    "icp.grids", "icp.coarse", "icp.multires", "icp.exact", "icp.raw",
    "step.inputs", "step.geometry", "step.forward", "step.keypoints",
    "step.umes", "step.losses", "step.backward", "step.grad_check",
    "step.metrics",
)
SPANS = STAGE_SPANS + DETAIL_SPANS
_STAGES, _DETAIL = frozenset(STAGE_SPANS), frozenset(DETAIL_SPANS)
_detail = False
_CLOSED = contextlib.nullcontext()

# blocking reads and implicit synchronizations, by site ("module.function")
HOST_READS: Dict[str, int] = defaultdict(int)

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


def detail_spans(on: bool = True) -> bool:
    """Open (or close) the DETAIL_SPANS from now on; returns the previous
    setting. Closed by default."""
    global _detail
    prev, _detail = _detail, bool(on)
    return prev


def span(name: str):
    """The named range `name` (one of SPANS; any other name raises): a
    record_function, or a no-op for a closed detail span."""
    if name in _STAGES or (_detail and name in _DETAIL):
        return torch.profiler.record_function(name)
    if name in _DETAIL:
        return _CLOSED
    raise ValueError(f"{name!r} is not one of profiling.SPANS")


def host_read(site: str, n: int = 1, device=None) -> None:
    """Count n blocking reads or implicit synchronizations at `site`. With
    `device`, only where it is a CUDA device: a pageable copy to the card
    and the card's own synchronizations have no CPU counterpart."""
    if device is None or (device if isinstance(device, torch.device)
                          else torch.device(device)).type == "cuda":
        HOST_READS[site] += n


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
