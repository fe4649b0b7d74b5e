"""The coloring network's training step, the plain version of the port's
train/trainer.py (reference train_coloring.py:20-207): the batch's
tensors, the backbone over its clouds, each pair's losses, the
optimizer.

The B pairs of a fixed-shape batch (data/collate) run as one forward:
the 2B clouds (cloud c = 2 pair + side) in one pyramid, cloud c with
batch index 2c, so each cloud is its own block of
build_unet_geometry(pairs=2B): its levels keep the voxels its own
pyramid keeps, and its BN layers take their own statistics. Losses are
per pair (pointwise InfoNCE, UME-contrastive, cube-registration). Adam /
AdamW as optax computes them (train.optim.OptaxAdam: b1 0.9, b2 0.999,
eps 1e-8, fp32 bias corrections, AdamW's decay decoupled).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from portref.devices import to_device
from portref.losses import (
    cube_registration_loss, nanmedian_mean, pointwise_infonce,
    ume_contrastive_loss)
from portref.models.resunet import ArchSpec, ResUNet, build_unet_geometry
from portref.ops.precision import tf32_off
from portref.pipeline.train_keypoints import (
    generate_training_umes)
from portref.train.optim import OptaxAdam

__all__ = ["TrainConfig", "make_optimizer", "batch_to_device",
           "pair_losses", "tf32_off"]


@dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror configs/train/train_kitti_config.yaml."""

    arch: str = "ResUNetSmall2"
    in_channels: int = 1
    out_channels: int = 32
    lr: float = 1e-4
    weight_decay: float = 0.0
    batch_size: int = 8
    max_pc_size: int = 16384  # static per-cloud voxel capacity
    num_pw_samples: int = 512
    ume_n_samples: int = 256
    ume_max_nn: int = 750
    ume_min_nn: int = 300
    ume_r_nn: float = 5.0
    tau: float = 0.1
    tau_ume: float = 0.1
    tau_ume_neg: float = 0.1
    use_ume_loss: bool = True
    use_reg_loss: bool = True
    pw_loss_weight: float = 0.5
    ume_loss_weight: float = 0.5
    reg_loss_weight: float = 0.25
    reg_loss_cube_r: float = 30.0
    reg_loss_intersection_thr: float = 0.75
    neg_euclid_dist: float = 5.0
    flat_labels: Tuple[int, ...] = (9,)
    compute_dtype: str = "bfloat16"
    level_capacity_ratios: Tuple[float, ...] = (1.0, 0.75, 0.4, 0.2, 0.08)
    calc_inlier_ratio_eval: bool = True
    eval_num_kpts: int = 1000
    eval_inlier_thr: float = 0.6
    chr_rot_thr_deg: float = 5.0
    chr_trans_thr_m: float = 0.6


def _capacities(cfg: TrainConfig, arch: ArchSpec) -> Tuple[int, ...]:
    n0 = cfg.max_pc_size
    return tuple(int(-(-int(n0 * r) // 128) * 128)
                 for r in cfg.level_capacity_ratios[: len(arch.channels)])


def _dtype(cfg: TrainConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


_TYPES = {"src_coords": torch.int32, "tgt_coords": torch.int32,
          "src_seg": torch.int32, "tgt_seg": torch.int32,
          "src_mask": torch.bool, "tgt_mask": torch.bool,
          "matches": torch.int64, "match_mask": torch.bool}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy) as tensors on `device` in the step's types
    (fp32 for points and transforms)."""
    return {k: to_device(v, device, _TYPES.get(k, torch.float32))
            for k, v in batch.items()}


def cloud_features(model: ResUNet, batch: Dict[str, torch.Tensor],
                   caps: Tuple[int, ...], compute_dtype: torch.dtype,
                   train: bool):
    """The backbone over the batch's 2B clouds in one pyramid (cloud c =
    2 pair + side, batch index 2c, its own block). Returns (src_feat,
    tgt_feat) (B, N, C), and with train=True also the new BN state."""
    B, N = batch["src_coords"].shape[:2]
    mask = torch.stack([batch["src_mask"], batch["tgt_mask"]], dim=1)
    coords = torch.stack([batch["src_coords"], batch["tgt_coords"]],
                         dim=1).clone()
    cloud = torch.arange(2 * B, dtype=torch.int32,
                         device=coords.device).reshape(B, 2, 1)
    coords[..., 0] = torch.where(mask, 2 * cloud, coords[..., 0])
    mask = mask.reshape(-1)
    geom = build_unet_geometry(coords.reshape(-1, 4), mask, model.arch, caps,
                               pairs=2 * B)
    feats_in = mask[:, None].to(torch.float32).expand(
        -1, model.conv1.w.shape[1]).contiguous()
    out = model(geom, feats_in, compute_dtype=compute_dtype, train=train)
    feats, state = out if train else (out, None)
    feats = feats.reshape(B, 2, N, -1)
    return feats[:, 0], feats[:, 1], state


def pair_losses(model: ResUNet, batch: Dict[str, torch.Tensor],
                cfg: TrainConfig, caps: Tuple[int, ...], train: bool):
    """(total loss (B,), metrics {name: (B,)}, new BN state or None): each
    pair's losses and metrics."""
    src_feat, tgt_feat, state = cloud_features(model, batch, caps,
                                               _dtype(cfg), train)
    pw = pointwise_infonce(src_feat, batch["src_pts"], tgt_feat,
                           batch["matches"], batch["match_mask"],
                           tau=cfg.tau, neg_euclid_dist=cfg.neg_euclid_dist)
    metrics = {"pointwise_loss": pw}
    total = cfg.pw_loss_weight * pw
    if cfg.use_ume_loss:
        kp = generate_training_umes(
            batch["src_pts"], batch["src_seg"], src_feat, batch["src_mask"],
            batch["tgt_pts"], tgt_feat, batch["tgt_mask"],
            batch["gt_tform"], num_samples=cfg.ume_n_samples,
            max_nn=cfg.ume_max_nn, min_nn=cfg.ume_min_nn, nn_r=cfg.ume_r_nn,
            flat_labels=tuple(cfg.flat_labels), normalize=True)
        ume_l, valid = ume_contrastive_loss(
            kp.src_ume, kp.tgt_ume, kp.kp_mask, tau=cfg.tau_ume,
            tau_neg=cfg.tau_ume_neg)
        metrics["ume_loss"] = ume_l
        metrics["num_keypoints"] = torch.sum(kp.kp_mask.to(torch.float32), -1)
        metrics["kp_truncated"] = kp.approx_truncated.to(torch.float32)
        total = total + cfg.ume_loss_weight * ume_l
        if cfg.use_reg_loss:
            reg_l, rre, rte = cube_registration_loss(
                kp.src_ume, kp.tgt_ume, valid, batch["gt_tform"],
                kp.nn_intersection_ratio, cube_scale=cfg.reg_loss_cube_r,
                nn_inter_ratio_thr=cfg.reg_loss_intersection_thr)
            metrics["reg_loss"] = reg_l
            nan = torch.full_like(rre, torch.nan)
            metrics["rre_median"] = nanmedian_mean(torch.where(valid, rre,
                                                               nan))
            metrics["rte_median"] = nanmedian_mean(torch.where(valid, rte,
                                                               nan))
            # CHR: per-keypoint closed-form transforms within (5 deg, 0.6
            # m) of ground truth (reference train_coloring.py:141)
            vm = valid.to(torch.float32)
            hit = ((rre <= cfg.chr_rot_thr_deg)
                   & (rte <= cfg.chr_trans_thr_m)).to(torch.float32)
            metrics["chr"] = torch.sum(hit * vm, -1) / torch.clamp(
                torch.sum(vm, -1), min=1.0)
            total = total + cfg.reg_loss_weight * reg_l
    metrics["total_loss"] = total
    return total, metrics, state


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """optax.adam(lr), or optax.adamw(lr, weight_decay) when the decay is
    not 0: train.optim.OptaxAdam with optax's constants and arithmetic."""
    return OptaxAdam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=cfg.weight_decay)
