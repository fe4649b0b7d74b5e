#!/usr/bin/env python3
"""A traced run of a cell with the program's detail spans open.

    python3 bench_port/trace_spans.py --workload <cell> --seed <n>
        --seconds <s> [--device cpu] [--workers N]

from the root of a checkout: run.py's traced run (the same set-up,
window, traced batch or step, and check) with harness/spans.SpanSession
in harness/trace.Session's place. The last line of standard output is one
JSON object: `correct`; `metrics`, the cell's per-layer metrics read from
the extended record; `accepted_metrics`, the same readers on the accepted
harness's own record of the same session (equal where the program opens
no detail span); `detail`, the readers in bench_port/span_metrics/ that
fit the cell (".serve" or ".train"); `attribution` (the device time whose
launch call was found, and the rest by kernel name); `by_span` (each
span's host s, the device s and kernels it launched itself, the idle that
began under it); `top_by_span`; `counters` (each counter's delta); the
window, busy time and both records' breakdowns.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

T0 = time.time()
HERE = Path(__file__).resolve().parent


def main(argv=None) -> None:
    for p in (str(HERE.parent), str(HERE)):  # the program; the benchmark
        if p not in sys.path:
            sys.path.insert(0, p)
    import run

    args = run.parse_args(argv)
    from harness.common import (Cell, Clock, device_info, forbidden_modules,
                                note, require_devices, set_cache_dirs)

    set_cache_dirs()
    cell = Cell(args.workload)
    import torch

    dev = require_devices(cell.chips) if args.device == "cuda" \
        else torch.device("cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    from harness import spans, trace
    from harness.check import judge
    from harness.serve import Serve
    from harness.train import Train

    trace.Session = spans.SpanSession  # what serve.py / train.py open
    serving = cell.traffic["entry"] == "serve_batched"
    runner = (Serve if serving else Train)(cell, args, dev, Clock(T0))
    _, rec, attempted, failed, peak, results = runner.run(args.seconds, True)
    correct, checks = judge(runner.judge(results, rec),
                            cell.limits["numbers"])
    note({"phase": "launches", "rows": rec.check_launches()})
    side = ".serve" if serving else ".train"
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": {}, "accepted_metrics": {},
           "detail": {}}
    rec.accepted.units, rec.accepted.pairs = rec.units, rec.pairs
    for k in ("bound_s", "model_flops", "run_window_s", "run_units"):
        setattr(rec.accepted, k, getattr(rec, k))
    for m in cell.metrics("per_layer"):
        out["metrics"][m["name"]] = run.read_metric(m["name"], rec)
        out["accepted_metrics"][m["name"]] = run.read_metric(m["name"],
                                                             rec.accepted)
    for f in sorted((HERE / "span_metrics").glob(f"*{side}.py")):
        name = f.name[:-len(".py")]
        out["detail"][name] = _read(f, rec)
    out.update(attribution=rec.attribution(), by_span=rec.by_span(),
               top_by_span=rec.top_by_span(), counters=rec.counters,
               window_s=rec.window_s, busy_s=rec.busy_s,
               accepted_busy_s=rec.accepted.busy_s,
               breakdown=rec.breakdown(),
               accepted_breakdown=rec.accepted.breakdown(),
               checks={c["name"]: c["value"] for c in checks})
    out["device"] = device_info(dev, peak) if dev.type == "cuda" else {
        "platform": "cpu", "kind": "cpu"}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"trace_spans: the run loaded {bad}")
    print(json.dumps(out, default=float), flush=True)


def _read(path: Path, rec):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"span_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


if __name__ == "__main__":
    main()
