"""KITTI / nuScenes registration pair datasets (the port's own copy of
umeregrobust_tpu/data/datasets.py; host-side numpy + scipy, voxels from
the native quantizer as in the JAX package).

Every item is the reference's 9-tuple of numpy arrays
(kitti_dataset.py:317-542, nuscenes_dataset.py:315-549):

  (src_pts, src_seg, src_coords, tgt_pts, tgt_seg, tgt_coords,
   src_pts_tform, gt_tform, matches)

Modes:
- preprocess (cache_data_path == ""): read the raw scans, optional SEM
  equalization, drop unlabeled points, voxelize at 0.3 m, map coords to
  grid points, mutual matches at voxel / 2;
- cached: read the pair's pickle that SEM preprocessing wrote
  ({split}/{seq}/{f0:06d}_{f1:06d}.pickle; plain numpy, so either
  package reads the other's cache);
- cached + augmentation: independent random z-rotations of both clouds,
  re-quantization, the rotated ground truth and one-sided matches.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from umeregrobust_tpu_torch.data.laserscan import load_semantic_kitti_pair_frame
from umeregrobust_tpu_torch.data.matching_host import (
    mutual_matches, one_side_matches)
from umeregrobust_tpu_torch.data.registry import load_registry
from umeregrobust_tpu_torch.data.sem import SEMConfig, equalize_sampling
from umeregrobust_tpu_torch.native import quantize as quantize_np
from umeregrobust_tpu_torch.ops.voxel import coords_to_grid_pts_np

__all__ = ["SemanticKITTIDataset", "NuscenesDataset", "load_pair_pickle",
           "save_pair_pickle", "PAIR_KEYS"]

# the cache pickle's keys, in the 9-tuple's order
PAIR_KEYS = ("src_pts", "src_seg", "src_coords", "tgt_pts", "tgt_seg",
             "tgt_coords", "src_pts_tform", "gt_tform", "matches")


def load_pair_pickle(path: str) -> dict:
    """A cache pickle. Only unpickle caches this project wrote: unpickling
    can run arbitrary code."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pair_pickle(path: str, d: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(d, f, protocol=pickle.HIGHEST_PROTOCOL)


def _rot_z(angle_deg: float) -> np.ndarray:
    a = np.radians(angle_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


class _PairDatasetBase:
    dataset_name = ""

    def __init__(
        self,
        data_path: str,
        split: str,
        voxel_size: float = 0.3,
        use_pc_completion: bool = False,
        cache_data_path: str = "",
        dataset_size: int = -1,
        use_augmentations: bool = False,
        convert_points_to_grid: bool = True,
        skip_invalid_entries: bool = True,
        override_cache: bool = False,
        sem_config: Optional[SEMConfig] = None,
        aug_rng: Optional[np.random.Generator] = None,
    ):
        self.data_path = data_path
        self.voxel_size = voxel_size
        self.use_pc_completion = use_pc_completion
        self.cache_data_path = "" if override_cache else cache_data_path
        self.use_augmentations = use_augmentations
        self.convert_points_to_grid = convert_points_to_grid
        self.split = split
        self.sem_config = sem_config or SEMConfig()
        self.aug_rng = aug_rng or np.random.default_rng(0)

        # the skip lists apply only when reading the cache (reference
        # kitti_dataset.py:360-363; the argument as given, not as
        # override_cache leaves it)
        skip = skip_invalid_entries and cache_data_path != ""
        reg = load_registry(self.dataset_name, split, skip_invalid_entries=skip)
        self.pairs = reg.pairs
        self.gt_tforms = reg.gt_tforms
        if dataset_size != -1:
            self.pairs = self.pairs[:dataset_size]
            self.gt_tforms = self.gt_tforms[:dataset_size]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Tuple:
        if self.cache_data_path != "":
            if self.use_augmentations:
                return self.cached_getitem_augmented(idx)
            return self.cached_getitem(idx)
        return self.preprocess_getitem(idx)

    # ---- raw loading hooks (each dataset class has its own _load_frame) ----

    def _post_load_filter(self, pts, seg):
        return pts, seg

    def _pair_key(self, idx):
        seq_id, f0, f1 = self.pairs[idx]
        return seq_id, int(f0), int(f1)

    def _seq_str(self, seq_id) -> str:
        return (f"{int(seq_id):02d}" if self.dataset_name == "kitti"
                else str(seq_id))

    def cache_file(self, idx: int, root: Optional[str] = None) -> str:
        """{root}/{split}/{seq}/{f0:06d}_{f1:06d}.pickle of pair idx (root:
        the cache directory by default)."""
        seq_id, f0, f1 = self._pair_key(idx)
        root = self.cache_data_path if root is None else root
        return os.path.join(root, self.split, self._seq_str(seq_id),
                            f"{f0:06d}_{f1:06d}.pickle")

    # ---- modes ---------------------------------------------------------------

    def preprocess_getitem(self, idx: int) -> Tuple:
        seq_id, f0, f1 = self._pair_key(idx)
        src_pts, src_seg = self._load_frame(seq_id, f0)
        tgt_pts, tgt_seg = self._load_frame(seq_id, f1)
        src_pts, src_seg = self._post_load_filter(src_pts, src_seg)
        tgt_pts, tgt_seg = self._post_load_filter(tgt_pts, tgt_seg)
        gt_tform = self.gt_tforms[idx].astype(np.float32)

        if self.use_pc_completion:
            src_pts, src_seg = equalize_sampling(src_pts, src_seg, self.sem_config)
            tgt_pts, tgt_seg = equalize_sampling(tgt_pts, tgt_seg, self.sem_config)

        # drop unlabeled (kitti_dataset.py:408-413)
        sm = src_seg != 0
        src_pts, src_seg = src_pts[sm], src_seg[sm]
        tm = tgt_seg != 0
        tgt_pts, tgt_seg = tgt_pts[tm], tgt_seg[tm]

        src_coords, si = quantize_np(src_pts, self.voxel_size)
        tgt_coords, ti = quantize_np(tgt_pts, self.voxel_size)
        src_seg_q = src_seg[si]
        tgt_seg_q = tgt_seg[ti]
        if self.convert_points_to_grid:
            src_grid = coords_to_grid_pts_np(src_pts, src_coords, self.voxel_size)
            tgt_grid = coords_to_grid_pts_np(tgt_pts, tgt_coords, self.voxel_size)
        else:
            src_grid = src_pts[si]
            tgt_grid = tgt_pts[ti]

        matches = mutual_matches(src_grid, tgt_grid, gt_tform, self.voxel_size / 2)
        src_pts_tform = (src_grid @ gt_tform[:3, :3].T + gt_tform[:3, 3]).astype(
            np.float32)
        return (src_grid, src_seg_q, src_coords, tgt_grid, tgt_seg_q, tgt_coords,
                src_pts_tform, gt_tform, matches)

    def cached_getitem(self, idx: int) -> Tuple:
        d = load_pair_pickle(self.cache_file(idx))
        return (np.asarray(d["src_pts"], np.float32), np.asarray(d["src_seg"]),
                np.asarray(d["src_coords"], np.int32),
                np.asarray(d["tgt_pts"], np.float32), np.asarray(d["tgt_seg"]),
                np.asarray(d["tgt_coords"], np.int32),
                np.asarray(d["src_pts_tform"], np.float32),
                np.asarray(d["gt_tform"], np.float32),
                np.asarray(d["matches"], np.int64))

    def cached_getitem_augmented(self, idx: int) -> Tuple:
        (src_pts, src_seg, _, tgt_pts, tgt_seg, _, _, gt_tform, _) = (
            self.cached_getitem(idx))
        rng = self.aug_rng
        Rs = _rot_z(rng.uniform(-180, 180))
        Rt = _rot_z(rng.uniform(-180, 180))
        # the reference rotates as p @ R (kitti_dataset.py:476-477)
        src_aug = (src_pts @ Rs).astype(np.float32)
        tgt_aug = (tgt_pts @ Rt).astype(np.float32)

        src_coords, si = quantize_np(src_aug, self.voxel_size)
        src_grid = coords_to_grid_pts_np(src_aug, src_coords, self.voxel_size)
        src_seg_a = src_seg[si]
        tgt_coords, ti = quantize_np(tgt_aug, self.voxel_size)
        tgt_grid = coords_to_grid_pts_np(tgt_aug, tgt_coords, self.voxel_size)
        tgt_seg_a = tgt_seg[ti]

        # the ground truth after both z-rotations (kitti_dataset.py:491-499):
        # R_aug = (Rs^T R^T Rt)^T, t_aug = t @ Rt
        R = gt_tform[:3, :3]
        t = gt_tform[:3, 3]
        R_aug = (Rs.T @ R.T @ Rt).T
        t_aug = t @ Rt
        gt_aug = np.eye(4, dtype=np.float32)
        gt_aug[:3, :3] = R_aug
        gt_aug[:3, 3] = t_aug

        src_tform = (src_grid @ R_aug.T + t_aug).astype(np.float32)
        matches = one_side_matches(src_grid, tgt_grid, gt_aug, self.voxel_size / 2)
        return (src_grid, src_seg_a, src_coords, tgt_grid, tgt_seg_a, tgt_coords,
                src_tform, gt_aug, matches)


class SemanticKITTIDataset(_PairDatasetBase):
    """{data_path}/{seq:02d}/velodyne/*.bin and labels/*.label."""
    dataset_name = "kitti"

    def _load_frame(self, seq_id, frame_id):
        return load_semantic_kitti_pair_frame(self.data_path, int(seq_id), frame_id)


class NuscenesDataset(_PairDatasetBase):
    """nuScenes exported to the KITTI layout (data/nuscenes_export.py):
    {data_path}/{split}/sequences/{log}/velodyne/*.bin, labels as .npy."""
    dataset_name = "nuscenes"

    def _load_frame(self, seq_id, frame_id):
        # rotnuscenes reads the test scans (nuscenes_dataset.py:390)
        actual_split = "test" if self.split == "rotnuscenes" else self.split
        seq_dir = os.path.join(self.data_path, actual_split, "sequences",
                               str(seq_id))
        velo = os.path.join(seq_dir, "velodyne", f"{frame_id:06d}.bin")
        label = os.path.join(seq_dir, "labels", f"{frame_id:06d}.npy")
        raw = np.fromfile(velo, dtype=np.float32).reshape(-1, 4)
        pts = raw[:, :3].copy()
        if os.path.exists(label):
            seg = np.load(label).astype(np.int32)
        else:
            seg = np.ones(len(pts), np.int32)
        return pts, seg

    def _post_load_filter(self, pts, seg):
        # the ego vehicle's box removed (nuscenes_dataset.py:404-409)
        ego = (np.abs(pts[:, 0]) <= 2.5) & (np.abs(pts[:, 1]) <= 1.0)
        return pts[~ego], seg[~ego]
