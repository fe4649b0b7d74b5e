"""What every cell's run shares: the checkout's paths and caches, the
cell's files found by name, the device and its readings, seeds, and the
result line."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parents[1]  # bench_port/
ROOT = BENCH.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "umeregrobust_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel build is build/torch_kernels, fixed in code)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_port" / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and limits
    files, found by name."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.bench = bench
        self.spec = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(BENCH / "traffic" /
                                 f"{self.spec['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.chips = int(self.spec["chips"])

    def metrics(self, kind: str) -> List[dict]:
        """The cell's end_to_end or per_layer metrics."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def seed_from(*parts: int) -> int:
    """A 63-bit seed from whole numbers (any size, any sign)."""
    ss = np.random.SeedSequence([abs(int(p)) * 2 + (int(p) < 0)
                                 for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng_from(*parts: int) -> np.random.Generator:
    return np.random.default_rng(seed_from(*parts))


def require_devices(n: int):
    """The card(s) this cell asks for, or exit non-zero with no result."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"bench_port: needs {n} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def device_info(dev, peak_bytes: int) -> Dict[str, object]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def smi() -> Dict[str, str]:
    """nvidia-smi's name, clocks, power draw and power limit of the card
    CUDA calls device 0 (empty where nvidia-smi cannot be read)."""
    import torch

    q = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        uuid = str(torch.cuda.get_device_properties(0).uuid)
        sel = ["-i", uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"]
        out = subprocess.run(["nvidia-smi", *sel, f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        if out.returncode != 0:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=20)
        vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
        return dict(zip(q.split(","), vals))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def note(obj) -> None:
    """An earlier line: on standard error, one JSON object."""
    print(json.dumps(obj, default=float), file=sys.stderr, flush=True)


def percentiles(xs) -> Dict[str, float]:
    if not xs:
        return {}
    a = np.asarray(xs, np.float64)
    return {"n": len(a), "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90))}


class Clock:
    """Seconds since the process started (set-up is counted from there)."""

    def __init__(self, t0: float):
        self.t0 = t0

    def now(self) -> float:
        return time.time() - self.t0


def finish(correct: bool, attempted: int, failed: int,
           metrics: Dict[str, dict], device: Dict[str, object],
           checks: List[dict], breakdown: Optional[dict] = None) -> None:
    """The result line, last on standard output, with each compared number
    beside its limit printed last on standard error too."""
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}; no result", file=sys.stderr)
        raise SystemExit(4)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def worker_map(fn, items, workers: int) -> list:
    """fn over items on `workers` spawned processes (numpy only: the
    traffic generators import no torch), each with one BLAS thread."""
    import multiprocessing as mp

    if workers <= 1:
        return [fn(x) for x in items]
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        pool = mp.get_context("spawn").Pool(workers)
        try:
            out = pool.map(fn, items, chunksize=1)
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out
