"""The traced window: torch.profiler over a few batches or steps, read
into kernel intervals, host spans and the program's launch counters.

A session is opened after a synchronize and closed after one, so every
kernel of the traced work ends inside it. The trace is held to the
program's own launch counters: each hand kernel the counters saw launched
must be in the trace, or the run stops with no result (a profiler that
drops device events must not read as an idle device or a zero share).
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness.common import BENCH, load_json

SPANS = ("geometry", "forward", "feat_to_raw", "hypotheses", "icp",
         "Optimizer.step#OptaxAdam.step")
KERNELS = load_json(BENCH / "kernels.json")


def base_name(name: str) -> str:
    """A demangled kernel name's function: 'void ns::f<T>(int)' -> 'f'."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[len("void "):] if s.startswith("void ") else s
    while True:
        cut = re.sub(r"<[^<>]*>", "", s)
        if cut == s:
            break
        s = cut
    return s.split("(", 1)[0].strip().split("::")[-1]


def launch_counts() -> Dict[str, int]:
    """The program's hand-kernel launch counters, by the names kernels.json
    gives them."""
    import importlib

    out = {}
    for fam, spec in KERNELS["families"].items():
        for counter in spec.get("counters", []):
            mod, _, attr = counter.partition(":")
            attr, _, key = attr.partition("[")
            v = getattr(importlib.import_module(mod), attr)
            out[counter] = int(v[key.rstrip("]")] if key else v)
    return out


def _events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device events (name, start_s, end_s), host span events (name,
    start_s, end_s)) of a finished session, on one clock."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        is_dev = e.device_type() == torch.autograd.DeviceType.CUDA
        name = e.name()
        if is_dev and name in SPANS:  # a span's copy on the device row
            continue
        if not is_dev and name not in SPANS:
            continue
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        (dev if is_dev else host).append((name, t0, t1))
    return dev, host


class Session:
    """One traced window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self._sync()
        self.counts0 = launch_counts()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> "Session":
        """Ends the traced window (inside the timed loop: cheap)."""
        self._sync()
        self.window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        counts = launch_counts()
        self.delta = {k: counts[k] - self.counts0[k] for k in counts}
        return self

    def record(self) -> "Record":
        """The trace read into a Record (after the timed loop: the events
        take seconds to read)."""
        dev, host = _events(self.prof)
        del self.prof
        return Record(dev, host, self.window, self.delta)


class Record:
    """What the readers in bench_port/metrics read: device intervals, host
    spans, the window's length, the launch counters' deltas, and what the
    benchmark adds (units of work, pairs, bounds, model FLOPs)."""

    def __init__(self, dev, host, window_s, launches):
        self.window_s = float(window_s)
        self.launches = launches
        self.kernels = [(base_name(n), n, a, b) for n, a, b in dev]
        self.spans = host
        self.units = 0  # batches or steps traced
        self.pairs = 0
        self.bound_s: Dict[str, float] = {}  # family -> sum of bounds
        self.model_flops = 0.0
        self.peaks = load_json(BENCH / "peaks.json")
        iv = sorted((a, b) for _, _, a, b in self.kernels)
        self.busy = _union(iv)

    @property
    def busy_s(self) -> float:
        return float(sum(b - a for a, b in self.busy))

    def family_s(self, family: str) -> float:
        names = set(KERNELS["families"][family]["kernels"])
        return float(sum(b - a for k, _, a, b in self.kernels if k in names))

    def span_s(self, name: str) -> float:
        return float(sum(b - a for n, a, b in self.spans if n == name))

    def check_launches(self) -> List[dict]:
        """Each counted hand-kernel launch against its kernel's events in
        the trace: rows of (counter, counted, traced). Raises where the
        trace holds fewer."""
        rows, short = [], []
        names = [k for k, _, _, _ in self.kernels]
        for fam, spec in KERNELS["families"].items():
            for counter in spec.get("counters", []):
                n = self.launches.get(counter, 0)
                main = spec["counted_as"][counter]
                seen = sum(names.count(k) for k in main)
                rows.append({"counter": counter, "counted": n, "traced": seen})
                if seen < n:
                    short.append(rows[-1])
        if short:
            raise SystemExit(f"the trace lost device events: {short}")
        return rows

    def breakdown(self) -> dict:
        """The device ops that took most time, and the idle time by the
        host span open when each gap began."""
        per: Dict[str, float] = {}
        for k, _, a, b in self.kernels:
            per[k] = per.get(k, 0.0) + (b - a)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda s: s[1])
        for (a0, b0), (a1, _) in zip(self.busy, self.busy[1:]):
            gaps[_open_span(spans, b0)] = gaps.get(_open_span(spans, b0),
                                                   0.0) + (a1 - b0)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _open_span(spans, t: float) -> str:
    """The innermost (latest-started) span open at time t, or 'none'."""
    best, start = "none", -np.inf
    for n, a, b in spans:
        if a > t:
            break
        if b >= t and a >= start:
            best, start = n, a
    return best
