"""Coloring-network training CLI of the port, the counterpart of
umeregrobust_tpu/cli/train_coloring.py (reference train_coloring.py:252-439):

    python -m umeregrobust_tpu_torch.cli.train_coloring --config kitti
    python -m umeregrobust_tpu_torch.cli.train_coloring --config kitti \
        --set num_epochs=2 --set data_path=<root>/sequences
    python -m umeregrobust_tpu_torch.cli.train_coloring --device cpu ...

It reads the port's own copies of the training YAMLs
(configs/train/train_{kitti,nuscenes}_config.yaml, --set overrides), the
port's datasets (the SEM cache at cache_data_path, or the raw scans when
it is empty), collates each batch with collate_fixed on a prefetch
thread while the device steps, and trains on the card unless --device cpu
(raises without CUDA). Each cloud is padded to pc_capacity voxels (16384
unless set, as in the JAX CLI). Checkpoints go to
{output_path}/{run_name}_{dataset}_{time}/; resume_train_path resumes from
one of the port's own checkpoints (a JAX training checkpoint holds optax
optimizer states and is refused).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Iterator

import numpy as np
import torch

from umeregrobust_tpu_torch.data.collate import collate_fixed
from umeregrobust_tpu_torch.data.datasets import (
    NuscenesDataset, SemanticKITTIDataset)
from umeregrobust_tpu_torch.models.weights import params_from_jax
from umeregrobust_tpu_torch.train.checkpoint import (
    load_checkpoint, optimizer_state)
from umeregrobust_tpu_torch.train.trainer import TrainConfig, Trainer
from umeregrobust_tpu_torch.utils.config import (
    apply_overrides, update_namespace_from_yaml)
from umeregrobust_tpu_torch.utils.prefetch import prefetch

_CFG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "train")


def _batches(dset, batch_size, max_pc_size, num_matches, shuffle,
             rng) -> Iterator:
    order = np.arange(len(dset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        samples = [dset[int(j)] for j in order[i: i + batch_size]]
        samples = [s for s in samples if len(s[8]) > 0]  # zero-match skip
        if not samples:
            continue
        yield collate_fixed(samples, max_pc_size=max_pc_size,
                            num_matches=num_matches, rng=rng)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", choices=["kitti", "nuscenes"],
                        default="kitti")
    parser.add_argument("--set", action="append", default=[],
                        help="override config keys: --set key=value")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                        "versions (default: the card, raises without CUDA)")
    args = parser.parse_args(argv)
    cfg_path = os.path.join(_CFG_DIR, f"train_{args.config}_config.yaml")
    args = update_namespace_from_yaml(args, cfg_path)
    return apply_overrides(args, args.set)


def train_config(args) -> TrainConfig:
    return TrainConfig(
        lr=float(args.lr),
        batch_size=int(args.batch_size),
        max_pc_size=int(getattr(args, "pc_capacity", 16384)),
        num_pw_samples=int(args.num_pw_samples),
        ume_n_samples=int(args.ume_n_samples),
        ume_max_nn=int(args.ume_max_nn),
        ume_min_nn=int(args.ume_min_nn),
        ume_r_nn=float(args.ume_r_nn),
        tau=float(args.tau),
        tau_ume=float(args.tau_ume),
        tau_ume_neg=float(args.tau_ume_neg),
        use_ume_loss=bool(args.use_ume_loss),
        use_reg_loss=bool(args.use_reg_loss),
        pw_loss_weight=float(args.pw_loss_weight),
        ume_loss_weight=float(args.ume_loss_weight),
        reg_loss_weight=float(args.reg_loss_weight),
        reg_loss_cube_r=float(args.reg_loss_cube_r),
        reg_loss_intersection_thr=float(args.reg_loss_intersection_thr),
        out_channels=int(args.out_channels),
        eval_num_kpts=int(args.eval_num_kpts),
        eval_inlier_thr=float(args.eval_inlear_thr),
        calc_inlier_ratio_eval=bool(args.calc_inlear_ratio_eval),
    )


def main(argv=None) -> Trainer:
    from umeregrobust_tpu_torch.utils.cache import ensure_compile_cache

    ensure_compile_cache()
    args = parse_args(argv)
    rng = np.random.default_rng(int(args.random_seed))
    cfg = train_config(args)

    cls = SemanticKITTIDataset if args.dataset == "kitti" else NuscenesDataset
    dset_train = cls(data_path=args.data_path, split="train",
                     cache_data_path=args.cache_data_path,
                     dataset_size=int(args.train_size),
                     use_augmentations=bool(args.use_aug),
                     skip_invalid_entries=bool(args.skip_invalid_entries))
    dset_valid = cls(data_path=args.data_path, split="val",
                     cache_data_path=args.cache_data_path,
                     dataset_size=int(args.val_size))

    blob = None
    if getattr(args, "resume_train_path", ""):
        blob = load_checkpoint(args.resume_train_path)
        opt_state = optimizer_state(blob)  # raises for a JAX checkpoint
    run_name = (f"{args.run_name}_{args.dataset}_"
                f"{time.strftime('%d%m%y_%H%M%S')}")
    out_dir = os.path.join(args.output_path, run_name)
    trainer = Trainer(cfg, out_dir, seed=int(args.random_seed),
                      device=args.device)
    if blob is not None:
        trainer.model.load_state_dict(
            {k: v.to(trainer.device) for k, v in params_from_jax(
                blob["params"], blob["bn_state"]).items()}, strict=True)
        trainer.optimizer.load_state_dict(opt_state)
        trainer.epoch = int(blob["epoch"])
        print(f"resumed from {args.resume_train_path} at epoch "
              f"{trainer.epoch}")

    for epoch in range(trainer.epoch, int(args.num_epochs)):
        # host collation on a prefetch thread overlaps the device steps
        # (reference: DataLoader(num_workers=8), train_coloring.py:351-356)
        trainer.run_epoch(
            prefetch(_batches(dset_train, cfg.batch_size, cfg.max_pc_size,
                              cfg.num_pw_samples, True, rng)), train=True)
        valid = trainer.run_epoch(
            prefetch(_batches(dset_valid, cfg.batch_size, cfg.max_pc_size,
                              cfg.num_pw_samples, False, rng)), train=False)
        trainer.end_epoch(valid)
        print(f"epoch {epoch} valid: " + " ".join(
            f"{k}={v:.4f}" for k, v in valid.items()), flush=True)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return trainer


if __name__ == "__main__":
    main()
