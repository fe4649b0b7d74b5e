"""The program's finer spans and its counters in a traced window: the
accepted trace (harness/trace.py) extended with the program's detail
spans (the port's utils/profiling.DETAIL_SPANS, written out here, so that
this module reads a tree that lacks them), each device event charged to
the span that launched it, and the program's counters
(bench_port/counters.json) taken at the window's start and stop.

A kernel is charged by its launch call: the host-side runtime call
(cudaLaunchKernel*, cuLaunchKernel*, cudaMemcpyAsync, cudaMemsetAsync)
that carries the kernel's correlation id, and the innermost span of this
module's SPANS open on any thread when that call began. Backward kernels
come from the autograd thread while the main thread waits inside
"step.backward"; an asynchronous launch's device time lands after its
host span closed and is still charged to it.

harness/trace.py lists only the five stage spans, and reads a detail
span's device-row copy as a kernel; so run.py leaves the program's detail
spans closed, and SpanSession, which lists them, opens them for its
window. bench_port/trace_spans.py runs a cell through it.
"""
from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, Optional

import torch

from harness import trace
from harness.common import BENCH, load_json

SPANS = trace.SPANS + (
    "Optimizer.zero_grad#OptaxAdam.zero_grad",  # PyTorch's, as its step
    "inputs",
    "hypotheses.keypoints", "hypotheses.ume", "hypotheses.match",
    "hypotheses.score", "hypotheses.consensus",
    "icp.grids", "icp.coarse", "icp.multires", "icp.exact", "icp.raw",
    "step.inputs", "step.geometry", "step.forward", "step.keypoints",
    "step.umes", "step.losses", "step.backward", "step.grad_check",
    "step.metrics",
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")
COUNTERS = load_json(BENCH / "counters.json")
PROFILING = "umeregrobust_tpu_torch.utils.profiling"


def _read(counter: str) -> Optional[int]:
    """A counter by its module:name[key] (a dict without a key: the sum of
    its values); None where the program lacks it."""
    mod, _, attr = counter.partition(":")
    attr, _, key = attr.partition("[")
    try:
        v = getattr(importlib.import_module(mod), attr)
        if key:
            v = v[key.rstrip("]")]
        return int(sum(v.values())) if isinstance(v, dict) else int(v)
    except (ImportError, AttributeError, KeyError, TypeError, ValueError):
        return None


def counter_values() -> Dict[str, Optional[int]]:
    return {c: _read(c) for group in COUNTERS["groups"].values()
            for c in group}


def _detail_spans(on: bool) -> Optional[bool]:
    """Opens (or closes) the program's detail spans; the previous setting,
    or None where the program has no such switch."""
    try:
        switch = importlib.import_module(PROFILING).detail_spans
    except (ImportError, AttributeError):
        return None
    return switch(on)


def _events(prof):
    """(device events (name, start_s, end_s, correlation id), host spans
    of SPANS (name, start_s, end_s), launch calls {correlation id:
    start_s}) of a finished session, on one clock."""
    dev, host, calls = [], [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        is_dev = e.device_type() == cuda
        if is_dev and name in SPANS:  # a span's copy on the device row
            continue
        t0 = e.start_ns() * 1e-9
        if is_dev:
            dev.append((name, t0, t0 + e.duration_ns() * 1e-9,
                        e.correlation_id()))
        elif name in SPANS:
            host.append((name, t0, t0 + e.duration_ns() * 1e-9))
        elif name.startswith(LAUNCH_CALLS):
            calls[e.correlation_id()] = t0
    return dev, host, calls


def _innermost(spans, starts, t: float) -> str:
    """The latest-started span of `spans` (sorted by start) open at t, or
    'none' (trace._open_span's rule)."""
    for n, _, b in reversed(spans[:bisect.bisect_right(starts, t)]):
        if b >= t:
            return n
    return "none"


class SpanRecord(trace.Record):
    """trace.Record over this module's SPANS, with each device event's
    launching span (`launched_by`: a span name, 'none' where no span was
    open, None where no launch call was found), the counters' deltas,
    and the accepted harness's own Record of the same session
    (`accepted`)."""

    def __init__(self, dev, host, calls, window_s, launches, counters,
                 accepted=None):
        super().__init__([(n, a, b) for n, a, b, _ in dev], host, window_s,
                         launches)
        spans = sorted(host, key=lambda s: s[1])
        starts = [a for _, a, _ in spans]
        self.launched_by = [
            None if c not in calls else _innermost(spans, starts, calls[c])
            for _, _, _, c in dev]
        self.counters = counters
        self.accepted = accepted

    def _charged(self, prefix: str):
        """The device events whose launching span is `prefix` or inside
        it (a dotted child)."""
        inside = prefix + "."
        return [k for k, by in zip(self.kernels, self.launched_by)
                if by is not None and (by == prefix or by.startswith(inside))]

    def launched_s(self, prefix: str) -> float:
        """Device seconds of the events launched inside span `prefix`."""
        return float(sum(b - a for _, _, a, b in self._charged(prefix)))

    def launched_n(self, prefix: str) -> int:
        """Kernels launched inside span `prefix` (copies and fills left
        out, as kernels_per_pair counts)."""
        return sum(1 for k, _, _, _ in self._charged(prefix)
                   if not k.startswith(("Memcpy", "Memset")))

    def count(self, group: str) -> Optional[int]:
        """The summed deltas of a counters.json group; None where the
        program lacks any of them."""
        vals = [self.counters.get(c) for c in COUNTERS["groups"][group]]
        return None if any(v is None for v in vals) else int(sum(vals))

    def attribution(self) -> dict:
        """The share of device time whose launch call was found, and the
        rest by kernel name."""
        total = sum(b - a for _, _, a, b in self.kernels)
        left: Dict[str, float] = {}
        for (k, _, a, b), by in zip(self.kernels, self.launched_by):
            if by is None:
                left[k] = left.get(k, 0.0) + (b - a)
        found = total - sum(left.values())
        return {"device_s": total, "found_s": found,
                "share": found / total if total else None,
                "left": sorted(([k, v] for k, v in left.items()),
                               key=lambda kv: -kv[1])[:10]}

    def by_span(self) -> Dict[str, dict]:
        """Each span's host seconds, the device seconds, kernels and
        device-to-host copies it launched itself (not its children's), and
        the idle time that began while it was the innermost open span
        (trace.Record.breakdown's rule over these spans)."""
        out: Dict[str, dict] = {}

        def row(name):
            return out.setdefault(name, {"host_s": 0.0, "device_s": 0.0,
                                         "kernels": 0, "dtoh": 0,
                                         "idle_s": 0.0})
        for n, a, b in self.spans:
            row(n)["host_s"] += b - a
        for (k, _, a, b), by in zip(self.kernels, self.launched_by):
            if by is not None:
                r = row(by)
                r["device_s"] += b - a
                r["kernels"] += not k.startswith(("Memcpy", "Memset"))
                r["dtoh"] += k == "Memcpy DtoH"
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [a for _, a, _ in spans]
        for (_, b0), (a1, _) in zip(self.busy, self.busy[1:]):
            row(_innermost(spans, starts, b0))["idle_s"] += a1 - b0
        return out

    def top_by_span(self, n: int = 5) -> Dict[str, List[list]]:
        """Each launching span's n kernels that took most device time."""
        per: Dict[str, Dict[str, float]] = {}
        for (k, _, a, b), by in zip(self.kernels, self.launched_by):
            d = per.setdefault(str(by), {})
            d[k] = d.get(k, 0.0) + (b - a)
        return {s: sorted(([k, v] for k, v in d.items()),
                          key=lambda kv: -kv[1])[:n] for s, d in per.items()}


class SpanSession(trace.Session):
    """trace.Session with the program's detail spans open and its counters
    taken at the window's start and stop."""

    def __init__(self):
        self.detail = _detail_spans(True)
        self.c0 = counter_values()
        super().__init__()

    def stop(self) -> "SpanSession":
        super().stop()
        c1 = counter_values()
        self.counter_delta = {
            k: None if v is None or self.c0[k] is None else v - self.c0[k]
            for k, v in c1.items()}
        if self.detail is not None:
            _detail_spans(self.detail)
        return self

    def record(self) -> SpanRecord:
        accepted = trace.Record(*trace._events(self.prof), self.window,
                                self.delta)
        dev, host, calls = _events(self.prof)
        del self.prof
        return SpanRecord(dev, host, calls, self.window, self.delta,
                          self.counter_delta, accepted)
