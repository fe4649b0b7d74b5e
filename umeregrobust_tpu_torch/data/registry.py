"""Benchmark pair registries: the (seq, frame0, frame1) pair lists and
ground-truth 4x4 transforms of each split (the port's own copy of
umeregrobust_tpu/data/registry.py; numpy only).

The .npy files under data/metadata/ are this package's byte-identical
copies of the JAX package's. Filtering, as the reference applies it:
- translation <= 50 m, KITTI only (kitti_dataset.py:354-356);
- the curated invalid-pair skip lists when skip_invalid_entries is on
  (kitti_dataset.py:329-333, nuscenes_dataset.py:330-335).
The nuScenes train split has no metadata file; loading it raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = ["PairRegistry", "load_registry", "KITTI_INVALID_IDXS",
           "NUSCENES_INVALID_IDXS"]

_META_DIR = os.path.join(os.path.dirname(__file__), "metadata")

KITTI_INVALID_IDXS = {
    "train": [489, 3770, 5132, 5184, 7559, 9080, 9344, 11627],
    "val": [623],
    "test": [9],
    "lokitti": [241, 392, 530],
    "rotkitti": [394, 441],
}

NUSCENES_INVALID_IDXS = {
    "train": [], "val": [], "test": [], "lonuscenes": [], "rotnuscenes": [],
}


@dataclass
class PairRegistry:
    dataset: str
    split: str
    pairs: np.ndarray  # (N, 3): (seq, frame0, frame1)
    gt_tforms: np.ndarray  # (N, 4, 4) float32

    def __len__(self) -> int:
        return len(self.pairs)


def load_registry(
    dataset: str,
    split: str,
    max_translation: float = 50.0,
    skip_invalid_entries: bool = True,
) -> PairRegistry:
    meta = np.load(
        os.path.join(_META_DIR, dataset, f"{split}_metadata.npy"),
        allow_pickle=True,
    )
    tforms = np.load(
        os.path.join(_META_DIR, dataset, f"{split}_gt_tforms.npy")
    ).astype(np.float32)

    if dataset == "kitti":
        keep = np.linalg.norm(tforms[:, :3, 3], axis=-1) <= max_translation
        meta = meta[keep]
        tforms = tforms[keep]

    if skip_invalid_entries:
        table = KITTI_INVALID_IDXS if dataset == "kitti" else NUSCENES_INVALID_IDXS
        bad = np.asarray(table.get(split, []), dtype=np.int64)
        valid = np.setdiff1d(np.arange(len(meta)), bad)
        meta = meta[valid]
        tforms = tforms[valid]

    return PairRegistry(dataset=dataset, split=split, pairs=meta, gt_tforms=tforms)
