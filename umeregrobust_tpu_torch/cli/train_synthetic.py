"""Pretraining the coloring backbone on synthetic scenes (port of
tools/train_synthetic.py, the script that made
weights/synthetic_pretrain.pkl):

    python -m umeregrobust_tpu_torch.cli.train_synthetic [--steps 300] \
        [--batch 4] [--pc-cap 8192] [--out weights/synthetic_pretrain.pkl]
    python -m umeregrobust_tpu_torch.cli.train_synthetic --device cpu \
        --steps 2 --batch 2 --n-scenes 4 --pc-cap 1024 --out run.pkl

ResUNetSmall2 trains on procedurally generated registration pairs
(data/synthetic.py) with the full loss stack (pointwise InfoNCE,
UME-contrastive, cube-registration) in bf16, from the trainer's seeded
init or, with --resume, from a checkpoint of either package (params and
BN state; the optimizer starts fresh, as in the JAX tool). The flags,
their defaults, the scene pools, the batches and the TrainConfig are the
JAX tool's; --device (the card unless 'cpu'; raises without CUDA) is
the one flag more. The --n-scenes // --batch batches are collated on the
host and moved to the device once; step s trains on batch s mod their
count. Every 20 steps a line of losses; every 100 steps and at the end
the checkpoint (the pickle of numpy trees of train/checkpoint.py:
epoch 0, no optimizer state, the last step's total loss). A --resume
path that does not exist raises (the JAX tool skips it).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.data.synthetic import (
    SceneConfig, make_collated_batch)
from umeregrobust_tpu_torch.devices import resolve_device
from umeregrobust_tpu_torch.models.weights import (
    load_checkpoint, params_from_jax, params_to_jax)
from umeregrobust_tpu_torch.train.checkpoint import save_checkpoint
from umeregrobust_tpu_torch.train.trainer import (
    TrainConfig, Trainer, batch_to_device)

__all__ = ["build_parser", "parse_args", "train_config", "scene_pools",
           "batch_plan", "build_batches", "make_trainer", "save", "train",
           "Run", "main"]

NUM_MATCHES = 256
LOG_EVERY = 20
SAVE_EVERY = 100


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pc-cap", type=int, default=8192)
    ap.add_argument("--out", default="weights/synthetic_pretrain.pkl")
    ap.add_argument("--n-scenes", type=int, default=48)
    ap.add_argument("--resume", default="")
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--low-overlap", action="store_true",
                    help="add the low-overlap curriculum: lidar pairs at "
                         "22-30 m sensor baselines with 100-180 deg "
                         "rotations and up to 14 m translation, one batch "
                         "in two")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                    "versions (default: the card, raises without CUDA)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def train_config(args) -> TrainConfig:
    """The JAX tool's overrides of TrainConfig (bf16 stays the default)."""
    return TrainConfig(
        lr=args.lr, max_pc_size=args.pc_cap, batch_size=args.batch,
        ume_n_samples=128, ume_max_nn=512, ume_min_nn=64, ume_r_nn=5.0,
        level_capacity_ratios=(1.0, 0.8, 0.45, 0.25, 0.1))


def scene_pools(low_overlap: bool) -> List[Tuple[List[SceneConfig],
                                                 List[Dict[str, float]]]]:
    """(scenes, regimes) pools: three viewpoint-dependent ("lidar") scenes
    and one iid scene under three rotation / translation regimes; with
    low_overlap also large-baseline lidar scenes under 100-180 deg
    rotations."""
    scenes = [
        SceneConfig(extent=22.0, ground_points=10000, structure_points=20000,
                    n_boxes=20, n_walls=7, n_poles=12,
                    observe_mode="lidar", baseline=6.0),
        SceneConfig(extent=30.0, ground_points=12000, structure_points=16000,
                    n_boxes=10, n_walls=4, n_poles=6,
                    observe_mode="lidar", baseline=15.0),
        SceneConfig(extent=18.0, ground_points=8000, structure_points=24000,
                    n_boxes=32, n_walls=10, n_poles=18,
                    observe_mode="lidar", baseline=10.0),
        SceneConfig(extent=30.0, ground_points=12000, structure_points=16000,
                    n_boxes=10, n_walls=4, n_poles=6, dropout=0.45),
    ]
    regimes = [
        dict(max_rotation_deg=120, max_translation=8.0),
        dict(max_rotation_deg=180, max_translation=6.0),
        dict(max_rotation_deg=120, max_translation=12.0, sector_deg=300.0),
    ]
    pools = [(scenes, regimes)]
    if low_overlap:
        lo_scenes = [
            SceneConfig(extent=24.0, ground_points=11000,
                        structure_points=22000, n_boxes=18, n_walls=6,
                        n_poles=10, observe_mode="lidar", baseline=22.0),
            SceneConfig(extent=28.0, ground_points=12000,
                        structure_points=20000, n_boxes=14, n_walls=5,
                        n_poles=8, observe_mode="lidar", baseline=30.0),
            SceneConfig(extent=26.0, ground_points=10000,
                        structure_points=26000, n_boxes=24, n_walls=8,
                        n_poles=14, observe_mode="lidar", baseline=26.0),
        ]
        lo_regimes = [
            dict(max_rotation_deg=180, min_rotation_deg=150,
                 max_translation=14.0),
            dict(max_rotation_deg=180, min_rotation_deg=150,
                 max_translation=10.0),
            dict(max_rotation_deg=150, min_rotation_deg=100,
                 max_translation=12.0),
        ]
        pools.append((lo_scenes, lo_regimes))  # interleaved 1:1
    return pools


def batch_plan(args, pools) -> List[Tuple[int, SceneConfig, Dict[str, Any]]]:
    """(pool, scene, make_collated_batch keywords) of each batch: batch i
    from pool i mod len(pools), seeds seed0 + i * batch."""
    plan = []
    for i in range(args.n_scenes // args.batch):
        sc, rg = pools[i % len(pools)]
        j = i // len(pools)
        plan.append((i % len(pools), sc[j % len(sc)], dict(
            n_pairs=args.batch, max_pc_size=args.pc_cap,
            num_matches=NUM_MATCHES, seed=args.seed0 + i * args.batch,
            **rg[j % len(rg)])))
    return plan


def build_batches(args) -> List[Dict[str, np.ndarray]]:
    """The collated batches (numpy, host) of batch_plan."""
    batches = []
    for i, (pool, scene, kw) in enumerate(batch_plan(
            args, scene_pools(args.low_overlap))):
        b = make_collated_batch(scene, **kw)
        batches.append(b)
        print(f"  batch {i + 1} (pool {pool}, matches "
              f"{int(b['match_mask'].sum())})", flush=True)
    return batches


def make_trainer(args, cfg: TrainConfig, out_dir: str, device) -> Trainer:
    """Trainer(cfg, out_dir, seed=0) on `device`; with --resume its
    parameters and BN state from that checkpoint (either package's
    pickle), its optimizer fresh."""
    tr = Trainer(cfg, out_dir, seed=0, device=device)
    if args.resume:
        blob = load_checkpoint(args.resume)
        tr.model.load_state_dict(
            {k: v.to(tr.device) for k, v in params_from_jax(
                blob["params"], blob["bn_state"]).items()}, strict=True)
    return tr


def save(path: str, trainer: Trainer, metrics: Dict[str, float]) -> None:
    """The JAX tool's checkpoint: params and BN state as numpy trees,
    opt_state {}, epoch 0, metrics {"final_total_loss"}."""
    params, bn_state = params_to_jax(trainer.model)
    save_checkpoint(path, params=params, bn_state=bn_state, opt_state={},
                    epoch=0, metrics={"final_total_loss": float(
                        metrics["total_loss"])})


@dataclasses.dataclass
class Run:
    """What main did: the trainer, the device batches, each step's
    metrics (history[s] for step s), the first step's seconds, ms a step
    after the first (host clock; every step reads its metrics back), and
    the checkpoint written."""

    trainer: Trainer
    batches: List[Dict[str, torch.Tensor]]
    history: List[Dict[str, float]]
    first_step_s: float
    ms_per_step: float
    out: str


def _log_line(step: int, m: Dict[str, float], seconds: float) -> str:
    return (f"step {step}: total={m['total_loss']:.4f} "
            f"pw={m['pointwise_loss']:.4f} ume={m.get('ume_loss', 0):.4f} "
            f"reg={m.get('reg_loss', 0):.4f} "
            f"nonfinite_grad={m['nonfinite_grad']:.0f} ({seconds:.0f}s)")


def train(trainer: Trainer, batches, steps: int,
          save_fn: Callable[[Dict[str, float]], None]
          ) -> Tuple[List[Dict[str, float]], float, float]:
    """`steps` steps, step s on batches[s mod len]: the first timed apart
    (on the card it builds the kernel library at first use and the
    weight tiles), a log line every LOG_EVERY steps and at the last, a
    save every SAVE_EVERY steps and at the end. Returns (history, first
    step seconds, ms a step after the first)."""
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else (lambda: None))
    t_first = time.time()
    history = [trainer.train_step(batches[0])]
    sync()
    t_first = time.time() - t_first
    print(f"first step (kernel builds at first use, weight tiles, run): "
          f"{t_first:.1f}s", flush=True)
    t0 = time.time()
    for step in range(1, steps):
        m = trainer.train_step(batches[step % len(batches)])
        history.append(m)
        if step % LOG_EVERY == 0 or step == steps - 1:
            print(_log_line(step, m, time.time() - t0), flush=True)
        if (step + 1) % SAVE_EVERY == 0:
            save_fn(m)  # periodic save: a cut run keeps its weights
    sync()
    steady = (time.time() - t0) / max(steps - 1, 1)
    print(f"steady: {1e3 * steady:.0f} ms/step; first step's share of this "
          f"run: {100 * t_first / (t_first + (time.time() - t0)):.0f}%; "
          f"non-finite steps: "
          f"{sum(m['nonfinite_grad'] for m in history):.0f}", flush=True)
    save_fn(history[-1])
    return history, t_first, 1e3 * steady


def main(argv=None) -> Run:
    args = parse_args(argv)
    device = resolve_device(args.device)  # raises without CUDA
    cfg = train_config(args)
    print("building batches...", flush=True)
    batches = [batch_to_device(b, device) for b in build_batches(args)]
    with tempfile.TemporaryDirectory(prefix="train_synthetic_") as work:
        trainer = make_trainer(args, cfg, work, device)
        if args.resume:
            print(f"resumed params from {args.resume}", flush=True)
        history, first, ms = train(
            trainer, batches, args.steps,
            lambda m: save(args.out, trainer, m))
    print(f"saved {args.out}", flush=True)
    return Run(trainer, batches, history, first, ms, args.out)


if __name__ == "__main__":
    main()
