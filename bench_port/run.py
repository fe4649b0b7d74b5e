#!/usr/bin/env python3
"""The benchmark of umeregrobust_tpu_torch (the PyTorch / CUDA port) on
NVIDIA GPUs.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's "workloads")
names a configuration file and a traffic file; the traffic file's
"entry" picks the driver (harness/serve.py: batched registration;
harness/train.py: the train step). --trace 0 prints the cell's
end-to-end metrics, --trace 1 its per-layer metrics, read from a
profiler trace by the readers in bench_port/metrics/<name>.py. Every run
judges what the timed path produced against the reference in
bench_port/portref and prints `correct` with each number beside its
limit (bench_port/limits/<cell>.json). The last line of standard output
is one JSON object.

Options the benchmark's own tests and its calibration use (the check
passes none of them): --device cpu (a run with no card, at the sizes the
cell's files give), --control DTYPE (the reference in the program's
place, its backbone in DTYPE), --fault NAME (the timed path broken:
serving half_batch / altered, training half_batch / unchanged),
--workers N (processes that make the traffic).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time
from pathlib import Path

T0 = time.time()
HERE = Path(__file__).resolve().parent


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None,
                   choices=(None, "half_batch", "altered", "unchanged"))
    p.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    return p.parse_args(argv)


def read_metric(name: str, record):
    """The per-layer metric `name` by its reader, bench_port/metrics/
    <name>.py, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def main(argv=None) -> None:
    args = parse_args(argv)
    for p in (str(HERE.parent), str(HERE)):  # the program; the benchmark
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness.common import (Cell, Clock, device_info, finish, note,
                                require_devices, set_cache_dirs, smi)

    set_cache_dirs()
    cell = Cell(args.workload)
    import torch

    if args.device == "cuda":
        dev = require_devices(cell.chips)
    else:
        dev = torch.device("cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    from harness.check import judge
    from harness.serve import Serve
    from harness.train import Train

    driver = {"serve_batched": Serve, "train_step": Train}[
        cell.traffic["entry"]](cell, args, dev, Clock(T0))
    e2e, record, attempted, failed, peak, results = driver.run(
        args.seconds, bool(args.trace))
    values = driver.judge(results, record)
    correct, checks = judge(values, cell.limits["numbers"])
    if dev.type == "cuda":
        device = device_info(dev, peak)
        note({"phase": "card", "name": device["kind"],
              "count": torch.cuda.device_count(), **smi()})
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    breakdown = None
    if args.trace:
        note({"phase": "launches", "rows": record.check_launches()})
        metrics = {}
        for m in cell.metrics("per_layer"):
            v = read_metric(m["name"], record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device["busy_s"] = record.busy_s
        device["window_s"] = record.window_s
        breakdown = record.breakdown()
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    finish(correct, attempted, failed, metrics, device, checks, breakdown)


if __name__ == "__main__":
    main()
