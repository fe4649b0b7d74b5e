"""Coloring-network training (port of umeregrobust_tpu/train/trainer.py):
the train and eval steps and the epoch loop with best-metric
checkpoints (reference train_coloring.py:20-207, 404-437).

A step runs the B pairs of a fixed-shape batch (data/collate) as one
forward: the 2B clouds (cloud c = 2 pair + side) in one pyramid, cloud c
with batch index 2c, so each cloud is its own block of
build_unet_geometry(pairs=2B): its levels keep the voxels its own
pyramid keeps (the JAX trainer's per-cloud forwards), and its BN layers
take their own statistics. Losses are per pair (pointwise InfoNCE,
UME-contrastive, cube-registration), averaged over the batch; the new BN
running state is the average of the clouds' (the JAX trainer's mean over
the two clouds, then the pairs). Adam / AdamW as optax computes them
(train.optim.OptaxAdam: b1 0.9, b2 0.999, eps 1e-8, fp32 bias
corrections, AdamW's decay decoupled).
A step whose gradients are not all finite leaves the parameters, the
optimizer state (its step count too) and the BN state as they were, and
reports nonfinite_grad = 1. Everything runs on the model's device (the
card unless device="cpu"), with TF32 off. With a mesh
(parallel.make_mesh) the step is data parallel over its 'dp' dimension
(make_train_step).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.losses import (
    cube_registration_loss, nanmedian_mean, pointwise_infonce,
    ume_contrastive_loss)
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, ArchSpec, ResUNet, build_unet_geometry, init_resunet)
from umeregrobust_tpu_torch.models.weights import (
    params_from_jax, params_to_jax)
from umeregrobust_tpu_torch.ops.precision import tf32_off
from umeregrobust_tpu_torch.parallel.mesh import replicate, shard_batch
from umeregrobust_tpu_torch.pipeline.train_keypoints import (
    generate_training_umes)
from umeregrobust_tpu_torch.train.checkpoint import save_checkpoint
from umeregrobust_tpu_torch.train.optim import OptaxAdam
from umeregrobust_tpu_torch.utils.profiling import (  # noqa: F401
    HOST_READS, host_read, span)

__all__ = ["TrainConfig", "Trainer", "make_train_step", "make_optimizer",
           "batch_to_device", "batch_losses", "pair_losses"]


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
    """Per-level voxel capacities: each of cfg.level_capacity_ratios (one
    a level of `arch`, else ValueError) times max_pc_size, rounded up to
    a multiple of 128."""
    ratios = cfg.level_capacity_ratios
    if len(ratios) != len(arch.channels):
        name = next((k for k, v in ARCHS.items() if v == arch), str(arch))
        raise ValueError(
            f"level_capacity_ratios has {len(ratios)} entries; {name} has "
            f"{len(arch.channels)} levels: give one ratio a level")
    n0 = cfg.max_pc_size
    return tuple(int(-(-int(n0 * r) // 128) * 128) for r in ratios)


def _dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


_TYPES = {"src_coords": torch.int32, "tgt_coords": torch.int32,
          "src_seg": torch.int32, "tgt_seg": torch.int32,
          "src_mask": torch.bool, "tgt_mask": torch.bool,
          "matches": torch.int64, "match_mask": torch.bool}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy) as tensors on `device` in the step's types
    (fp32 for points and transforms)."""
    with span("step.inputs"):
        return {k: to_device(v, device, _TYPES.get(k, torch.float32))
                for k, v in batch.items()}


def cloud_features(model: ResUNet, batch: Dict[str, torch.Tensor],
                   caps: Tuple[int, ...], compute_dtype: torch.dtype,
                   train: bool):
    """The backbone over the batch's 2B clouds in one pyramid (cloud c =
    2 pair + side, batch index 2c, its own block). Returns (src_feat,
    tgt_feat) (B, N, C), and with train=True also the new BN state."""
    B, N = batch["src_coords"].shape[:2]
    with span("step.geometry"):
        mask = torch.stack([batch["src_mask"], batch["tgt_mask"]], dim=1)
        coords = torch.stack([batch["src_coords"], batch["tgt_coords"]],
                             dim=1).clone()
        cloud = torch.arange(2 * B, dtype=torch.int32,
                             device=coords.device).reshape(B, 2, 1)
        coords[..., 0] = torch.where(mask, 2 * cloud, coords[..., 0])
        mask = mask.reshape(-1)
        geom = build_unet_geometry(coords.reshape(-1, 4), mask, model.arch,
                                   caps, pairs=2 * B)
    with span("step.forward"):
        feats_in = mask[:, None].to(torch.float32).expand(
            -1, model.conv1.w.shape[1]).contiguous()
        out = model(geom, feats_in, compute_dtype=compute_dtype, train=train)
        feats, state = out if train else (out, None)
        feats = feats.reshape(B, 2, N, -1)
    return feats[:, 0], feats[:, 1], state


def batch_losses(model: ResUNet, batch: Dict[str, torch.Tensor],
                 cfg: TrainConfig, caps: Tuple[int, ...], train: bool):
    """(mean total loss, metrics averaged over the pairs, new BN state or
    None): every loss of every pair of the batch."""
    total, metrics, state = pair_losses(model, batch, cfg, caps, train)
    return (torch.mean(total),
            {k: torch.mean(v.detach()) for k, v in metrics.items()}, state)


def pair_losses(model: ResUNet, batch: Dict[str, torch.Tensor],
                cfg: TrainConfig, caps: Tuple[int, ...], train: bool):
    """(total loss (B,), metrics {name: (B,)}, new BN state or None): each
    pair's losses and metrics."""
    src_feat, tgt_feat, state = cloud_features(model, batch, caps,
                                               _dtype(cfg), train)
    with span("step.losses"):
        pw = pointwise_infonce(src_feat, batch["src_pts"], tgt_feat,
                               batch["matches"], batch["match_mask"],
                               tau=cfg.tau,
                               neg_euclid_dist=cfg.neg_euclid_dist)
    metrics = {"pointwise_loss": pw}
    total = cfg.pw_loss_weight * pw
    if cfg.use_ume_loss:
        kp = generate_training_umes(
            batch["src_pts"], batch["src_seg"], src_feat, batch["src_mask"],
            batch["tgt_pts"], tgt_feat, batch["tgt_mask"],
            batch["gt_tform"], num_samples=cfg.ume_n_samples,
            max_nn=cfg.ume_max_nn, min_nn=cfg.ume_min_nn, nn_r=cfg.ume_r_nn,
            flat_labels=tuple(cfg.flat_labels), normalize=True)
        with span("step.losses"):
            ume_l, valid = ume_contrastive_loss(
                kp.src_ume, kp.tgt_ume, kp.kp_mask, tau=cfg.tau_ume,
                tau_neg=cfg.tau_ume_neg)
            metrics["ume_loss"] = ume_l
            metrics["num_keypoints"] = torch.sum(
                kp.kp_mask.to(torch.float32), -1)
            metrics["kp_truncated"] = kp.approx_truncated.to(torch.float32)
            total = total + cfg.ume_loss_weight * ume_l
            if cfg.use_reg_loss:
                reg_l, rre, rte = cube_registration_loss(
                    kp.src_ume, kp.tgt_ume, valid, batch["gt_tform"],
                    kp.nn_intersection_ratio, cube_scale=cfg.reg_loss_cube_r,
                    nn_inter_ratio_thr=cfg.reg_loss_intersection_thr)
                metrics["reg_loss"] = reg_l
                nan = torch.full_like(rre, torch.nan)
                metrics["rre_median"] = nanmedian_mean(
                    torch.where(valid, rre, nan))
                metrics["rte_median"] = nanmedian_mean(
                    torch.where(valid, rte, nan))
                # CHR: per-keypoint closed-form transforms within (5 deg,
                # 0.6 m) of ground truth (reference train_coloring.py:141)
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


def _dp_mean_(tensors, group) -> None:
    """Average tensors in place over the ranks of `group`: one flattened
    bucket, summed, then divided by the group's size (with one rank: the
    same bits)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def _dp_pairs(metrics: Dict[str, torch.Tensor], group):
    """Each metric's per-pair values of every rank of `group`, in rank
    order (B / dp pairs a rank -> B pairs)."""
    names = sorted(metrics)
    mine = torch.stack([metrics[k].detach().to(torch.float32)
                        for k in names])
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine.contiguous(), group=group)
    every = torch.cat(parts, dim=1)
    return {k: every[i] for i, k in enumerate(names)}


def make_train_step(cfg: TrainConfig, model: ResUNet,
                    optimizer: torch.optim.Optimizer, mesh=None):
    """(train_step, eval_step), each batch (tensors on the model's device,
    `batch_to_device`) -> metrics (floats). train_step updates the model's
    parameters and BN buffers and the optimizer in place, or nothing when
    a gradient is not finite.

    With a mesh (parallel.make_mesh), data parallel over its 'dp'
    dimension: each rank passes its B / dp pairs (parallel.shard_batch)
    and holds the same parameters; the gradients are averaged over 'dp'
    (one flattened bucket), the finite check reads the averaged gradients
    (every rank steps or skips together), the new BN running state is
    averaged over 'dp', and the metrics are the means over all B pairs.
    The step equals the one-process step on the whole batch up to the
    fp32 order of the sums (bit for bit with one rank)."""
    caps = _capacities(cfg, model.arch)
    params = [p for p in model.parameters()]
    dp = None if mesh is None else mesh.get_group("dp")

    def means(metrics):
        if dp is not None:
            metrics = _dp_pairs(metrics, dp)
        host_read("trainer.metrics", len(metrics))  # one read a metric
        return {k: float(torch.mean(v.detach())) for k, v in metrics.items()}

    def train_step(batch):
        optimizer.zero_grad(set_to_none=False)
        with tf32_off():
            total, metrics, state = pair_losses(model, batch, cfg, caps,
                                                train=True)
            with span("step.backward"):
                torch.mean(total).backward()
            grads = [p.grad for p in params if p.grad is not None]
            if dp is not None:
                with torch.no_grad():
                    _dp_mean_(grads, dp)
                    _dp_mean_(list(state.values()), dp)
            with span("step.grad_check"):
                finite = bool(torch.stack([torch.isfinite(g).all()
                                           for g in grads]).all())
                host_read("trainer.grad_check")
            if finite:
                optimizer.step()
                model.load_bn_state(state)
        with span("step.metrics"):
            out = means(metrics)
        out["nonfinite_grad"] = 0.0 if finite else 1.0
        return out

    def eval_step(batch):
        with torch.no_grad(), tf32_off():
            _, metrics, _ = pair_losses(model, batch, cfg, caps, train=False)
        return means(metrics)

    return train_step, eval_step


class Trainer:
    """Epoch loop with best-metric checkpointing (six best-of
    checkpoints plus the last, reference train_coloring.py:404-437). The
    model is made on `device` (the card unless device="cpu") from an
    explicit generator seeded `seed`."""

    BEST_KEYS = (
        ("total_loss", min), ("pointwise_loss", min), ("ume_loss", min),
        ("reg_loss", min), ("inlier_ratio", max), ("chr", max),
    )

    def __init__(self, cfg: TrainConfig, out_dir: str, seed: int = 0,
                 device="cuda", model: Optional[ResUNet] = None, mesh=None):
        self.cfg = cfg
        self.out_dir = out_dir
        self.device = resolve_device(device)
        self.mesh = mesh
        os.makedirs(out_dir, exist_ok=True)
        self.arch = ARCHS[cfg.arch]
        if model is None:
            model = init_resunet(
                self.arch, cfg.in_channels, cfg.out_channels,
                generator=torch.Generator(device=self.device).manual_seed(
                    seed), device=self.device)
        self.model = model
        if mesh is not None:  # every rank starts from rank 0's model
            replicated = replicate(mesh, dict(model.state_dict()))
            model.load_state_dict(replicated)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.train_step, self.eval_step = make_train_step(
            cfg, self.model, self.optimizer, mesh=mesh)
        self.epoch = 0
        self.best = {k: (np.inf if red is min else -np.inf)
                     for k, red in self.BEST_KEYS}
        self._log_path = os.path.join(out_dir, "metrics.jsonl")
        with open(os.path.join(out_dir, "run_config.json"), "w") as f:
            json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f,
                      indent=2)

    @classmethod
    def from_jax(cls, params, bn_state, cfg: TrainConfig, out_dir: str,
                 device="cuda") -> "Trainer":
        """A trainer whose model holds the JAX package's (params,
        bn_state) pytrees."""
        dev = resolve_device(device)
        with torch.device(dev):
            model = ResUNet(ARCHS[cfg.arch], cfg.in_channels,
                            cfg.out_channels)
        model.load_state_dict({k: v.to(dev) for k, v in params_from_jax(
            params, bn_state).items()}, strict=True)
        return cls(cfg, out_dir, device=dev, model=model)

    def log(self, tag: str, metrics: Dict[str, Any], step: int):
        rec = {"tag": tag, "step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _batch_inlier_ratio(self, batch: Dict[str, torch.Tensor]) -> float:
        """Mean validation inlier ratio over the batch's pairs (features
        from one eval forward of the batch; the assignment on the host)."""
        from umeregrobust_tpu_torch.pipeline.eval_metrics import (
            calc_inlier_ratio)

        cfg = self.cfg
        with torch.no_grad(), tf32_off():
            sf, tf, _ = cloud_features(
                self.model, batch, _capacities(cfg, self.arch),
                _dtype(cfg), train=False)
            ratios = [calc_inlier_ratio(
                batch["src_pts"][b], batch["src_seg"][b], sf[b],
                batch["src_mask"][b], batch["tgt_pts"][b], tf[b],
                batch["tgt_mask"][b], batch["gt_tform"][b],
                ume_r_nn=cfg.ume_r_nn, ume_max_nn=cfg.ume_max_nn,
                ume_min_nn=cfg.ume_min_nn, eval_num_kpts=cfg.eval_num_kpts,
                inlier_thr=cfg.eval_inlier_thr)
                for b in range(sf.shape[0])]
        return float(np.mean(ratios)) if ratios else 0.0

    def run_epoch(self, batches: Iterable[Dict[str, np.ndarray]],
                  train: bool = True, log_every: int = 10
                  ) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        n = 0
        for i, batch in enumerate(batches):
            if self.mesh is not None:  # this rank's pairs of the batch
                batch = shard_batch(self.mesh, batch)
            batch = batch_to_device(batch, self.device)
            m = self.train_step(batch) if train else self.eval_step(batch)
            if not train and self.cfg.calc_inlier_ratio_eval:
                m["inlier_ratio"] = self._batch_inlier_ratio(batch)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + v
            n += 1
            if train and (i + 1) % log_every == 0:
                self.log("train", m, self.epoch * 100000 + i)
                print(f"[epoch {self.epoch}] it {i+1} " + " ".join(
                    f"{k}={v:.4f}" for k, v in m.items()), flush=True)
        mean = {k: v / max(n, 1) for k, v in acc.items()}
        if not train:
            self.log("valid", mean, self.epoch)
        return mean

    def end_epoch(self, valid_metrics: Dict[str, float]):
        self.epoch += 1  # checkpoints record the number of completed epochs
        for key, red in self.BEST_KEYS:
            if key not in valid_metrics:
                continue
            better = (valid_metrics[key] < self.best[key]) if red is min \
                else (valid_metrics[key] > self.best[key])
            if better:
                self.best[key] = valid_metrics[key]
                self._save(f"best_{key}_checkpoint.pkl", valid_metrics)
        self._save("last_epoch_checkpoint.pkl", valid_metrics)

    def _save(self, name: str, metrics):
        params, bn_state = params_to_jax(self.model)
        save_checkpoint(
            os.path.join(self.out_dir, name), params=params,
            bn_state=bn_state, opt_state=self.optimizer.state_dict(),
            epoch=self.epoch, metrics=metrics)
