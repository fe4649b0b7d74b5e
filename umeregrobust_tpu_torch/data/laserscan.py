"""Semantic-KITTI scan readers (the port's own copy of
umeregrobust_tpu/data/laserscan.py; numpy only): xyz points from velodyne
.bin scans, semantic labels from .label files (low 16 bits; the high bits
are instance ids) and the 34 -> 20 class learning map.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "read_kitti_scan",
    "read_kitti_label",
    "load_semantic_kitti_pair_frame",
    "SEMANTIC_KITTI_LEARNING_MAP",
    "apply_learning_map",
]

# semantic-KITTI raw label -> train id (the reference's kitti_config.yaml
# learning map); train id 9 is the flat label keypoint sampling excludes
SEMANTIC_KITTI_LEARNING_MAP: Dict[int, int] = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

_LUT = np.zeros(260, dtype=np.int32)
for k, v in SEMANTIC_KITTI_LEARNING_MAP.items():
    _LUT[k] = v


def apply_learning_map(raw_labels: np.ndarray) -> np.ndarray:
    """Raw semantic-KITTI labels -> the 20-class train ids (int32)."""
    return _LUT[np.clip(raw_labels, 0, len(_LUT) - 1)]


def read_kitti_scan(path: str) -> np.ndarray:
    """A KITTI velodyne .bin -> (N, 3) float32 xyz (remission dropped)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:, :3].copy()


def read_kitti_label(path: str) -> np.ndarray:
    """A .label file -> (N,) int32 raw semantic labels (low 16 bits)."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32)


def load_semantic_kitti_pair_frame(
    base_path: str, seq_id: int, frame_id: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Points and learning-mapped labels of one frame of
    {base_path}/{seq:02d}/{velodyne,labels}/{frame:06d}.{bin,label}."""
    velo = os.path.join(base_path, f"{seq_id:02d}", "velodyne", f"{frame_id:06d}.bin")
    label = os.path.join(base_path, f"{seq_id:02d}", "labels", f"{frame_id:06d}.label")
    pts = read_kitti_scan(velo)
    seg = apply_learning_map(read_kitti_label(label))
    return pts, seg
