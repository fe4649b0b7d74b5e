#!/usr/bin/env python3
"""The implicit synchronizations of one batch or step of a cell.

    python3 bench_port/sync_audit.py --workload <cell> --seed <n>
        --seconds 1 [--device cpu]

from the root of a checkout, on the card (--device cpu rehearses the
rest, counting no synchronization): the cell's set-up and warm-up
(harness/serve.py's batches, or harness/train.py's first three steps),
then one more batch or step under torch.cuda.set_sync_debug_mode("warn")
with the program's detail spans open. Each synchronizing call (a host
read of a value, a boolean-mask selection, a pageable copy to the card, a
wait inside a library call) is counted by the innermost span open and the
program's frames on the stack. The last line of standard output is one
JSON object: `syncs`, `by_span`, `sites` ([span, frames, count], most
first) and `host_reads`, the program's HOST_READS delta by site over the
same batch or step (None where the program has no such counter).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path

T0 = time.time()
HERE = Path(__file__).resolve().parent


def _frames(limit: int = 4) -> str:
    keep = ("umeregrobust_tpu_torch/", "bench_port/")
    out = []
    for f in traceback.extract_stack()[-3::-1]:
        for mark in keep:
            if mark in f.filename:
                out.append(f"{mark}{f.filename.split(mark, 1)[1]}:"
                           f"{f.lineno}:{f.name}")
                break
        if len(out) == limit:
            break
    return " < ".join(out) or "(no frame of the program)"


def main(argv=None) -> None:
    for p in (str(HERE.parent), str(HERE)):  # the program; the benchmark
        if p not in sys.path:
            sys.path.insert(0, p)
    import run

    args = run.parse_args(argv)
    from harness.common import Cell, Clock, require_devices, set_cache_dirs
    from harness.spans import PROFILING, _detail_spans

    set_cache_dirs()
    cell = Cell(args.workload)
    import importlib

    import torch

    dev = require_devices(cell.chips) if args.device == "cuda" \
        else torch.device("cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if cell.traffic["entry"] == "serve_batched":
        from harness.serve import Serve

        runner = Serve(cell, args, dev, Clock(T0))
        runner.build()
        runner.warm_up()
        work = lambda: runner.batch(0)  # noqa: E731
    else:
        from harness.train import CHECKED, Train

        runner = Train(cell, args, dev, Clock(T0))
        runner.steps = runner._steps(False, runner.dtype)
        for _ in range(CHECKED):
            runner.steps.one()
        work = runner.steps.one
    reads = getattr(importlib.import_module(PROFILING), "HOST_READS", None)
    open_spans = []
    rf = torch.autograd.profiler.record_function
    enter, exit_ = rf.__enter__, rf.__exit__

    def entered(self):
        open_spans.append(self.name)
        return enter(self)

    def exited(self, *exc):
        open_spans.pop()
        return exit_(self, *exc)

    sites = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        # (switching the mode back warns once itself)
        if "synchroniz" in str(message) and not any(
                f.name == "set_sync_debug_mode"
                for f in traceback.extract_stack()):
            sites[open_spans[-1] if open_spans else "none", _frames()] += 1

    cuda = dev.type == "cuda"  # the CPU rehearses the rest: no syncs
    mode = torch.cuda.set_sync_debug_mode if cuda else (lambda m: None)
    if cuda:
        torch.cuda.synchronize()
    before = dict(reads) if reads is not None else None
    detail = _detail_spans(True)
    rf.__enter__, rf.__exit__ = entered, exited
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            mode("warn")
            try:
                work()
            finally:
                mode(0)
    finally:
        rf.__enter__, rf.__exit__ = enter, exit_
        if detail is not None:
            _detail_spans(detail)
    if cuda:
        torch.cuda.synchronize()
    by_span = collections.Counter()
    for (span, _), n in sites.items():
        by_span[span] += n
    host_reads = None if reads is None else {
        k: v - before.get(k, 0) for k, v in reads.items()
        if v != before.get(k, 0)}
    print(json.dumps({
        "workload": cell.name, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "syncs": sum(sites.values()), "by_span": dict(by_span),
        "host_reads_total": None if host_reads is None
        else sum(host_reads.values()),
        "host_reads": host_reads,
        "sites": [[s, f, n] for (s, f), n in sites.most_common()]}),
        flush=True)


if __name__ == "__main__":
    main()
