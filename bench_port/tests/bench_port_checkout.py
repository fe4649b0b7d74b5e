"""A checkout for the benchmark's own tests in a temporary directory
(BENCHMARK.json and bench_port copied, the program and the weights
linked) with tiny cells beside the real ones, and runs of run.py in
it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_SCENE = {"observe_mode": "lidar", "extent": 15.0, "ground_points": 20000,
              "structure_points": 20000, "azimuth_bins": 600,
              "elevation_bins": 32}
# each tiny cell: (its real cell, its traffic file's changes)
TINY = {
    "resunetsmall2.tiny-serve": ("resunetsmall2.serve-kitti-b8", dict(
        batch=2, per_regime=1, scene=TINY_SCENE, sem_points=6000,
        caps={"sem": 2048, "corr": 1024, "raw": 4096, "corr_ds_src": 0.6,
              "corr_ds_tgt": 0.3},
        registration={"num_init_keypoints": 256, "ume_n_samples": 64,
                      "corr_coarse_src": 128, "icp_max_iter": 20,
                      "icp_dims": [192, 192, 48]})),
    "resunetsmall2.tiny-train": ("resunetsmall2.train-kitti-b4", dict(
        batch=2, max_pc_size=2048, num_matches=64, scene=TINY_SCENE,
        job={"ume_n_samples": 16, "ume_max_nn": 64, "ume_min_nn": 8})),
    "resunet.tiny-train": ("resunet.train-kitti-b4", dict(
        batch=2, max_pc_size=2048, num_matches=64, scene=TINY_SCENE,
        job={"ume_n_samples": 16, "ume_max_nn": 64, "ume_min_nn": 8})),
}



def _tiny_traffic(bench, real: str, changes: dict) -> str:
    spec = {w["name"]: w for w in bench["workloads"]}[real]
    t = json.loads((REPO / "bench_port" / "traffic" /
                    f"{spec['traffic']}.json").read_text())
    for k, v in changes.items():
        if k in ("registration", "job"):
            t[k] = {**t[k], **v}
        else:
            t[k] = v
    if "regimes" in t:
        t["regimes"] = {k: t["regimes"][k] for k in ("nominal", "verylow")}
    return json.dumps(t)


def make_checkout(root: Path) -> Path:
    """BENCHMARK.json and bench_port under root, the program and the
    weights linked, and the TINY cells added (each held to its real
    cell's limits and reporting its metrics)."""
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "umeregrobust_tpu_torch", root / "umeregrobust_tpu_torch")
    (root / "weights").mkdir()
    os.symlink(REPO / "weights" / "synthetic_pretrain.pkl",
               root / "weights" / "synthetic_pretrain.pkl")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (real, changes) in TINY.items():
        spec = dict({w["name"]: w for w in bench["workloads"]}[real])
        traffic = f"tiny-{spec['traffic']}"
        (root / "bench_port" / "traffic" / f"{traffic}.json").write_text(
            _tiny_traffic(bench, real, changes))
        shutil.copy(root / "bench_port" / "limits" / f"{real}.json",
                    root / "bench_port" / "limits" / f"{name}.json")
        bench["workloads"].append(dict(spec, name=name, traffic=traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, *args, timeout: int = 1800):
    """bench_port/run.py in `root`: (exit code, result line or None,
    standard error)."""
    p = subprocess.run([sys.executable, "bench_port/run.py", *args],
                       cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, line, p.stderr


def cpu_run(root: Path, cell: str, *extra, seed: int = 2 ** 33 + 5,
            trace: int = 0):
    return run(root, "--workload", cell, "--seed", str(seed), "--seconds",
               "1", "--trace", str(trace), "--device", "cpu", "--workers",
               "2", *extra)
