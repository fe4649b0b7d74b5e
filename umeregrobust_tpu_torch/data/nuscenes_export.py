"""nuScenes -> KITTI-layout exporter (the port's own copy of
umeregrobust_tpu/data/nuscenes_export.py; numpy; reference
datasets/nuscenes/export_kitti_minimal.py:71-159).

Per log of a split: each LiDAR sweep rotated into the KITTI sensor frame
(a quarter turn about z) and written as
{split}/sequences/{log}/velodyne/{idx:06d}.bin (x, y, z, intensity
float32), lidarseg labels as labels/{idx:06d}.npy (not for the test
split), and per log poses.npy (lidar to world, KITTI frame) and
timestamps.npy.

Needs the nuscenes-devkit, which is imported only when the exporter runs:
without it the call raises ImportError.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

__all__ = ["export_nuscenes_to_kitti"]

# KITTI lidar frame = nuScenes lidar frame rotated by -90 deg about z
_KITTI_TO_NU = np.array(
    [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=np.float64)


def export_nuscenes_to_kitti(
    nusc_dir: str,
    out_dir: str,
    split: str = "train",
    nusc_version: str = "v1.0-trainval",
    lidar_name: str = "LIDAR_TOP",
) -> List[str]:
    """Export every log of a split. Returns the exported log names."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils.data_classes import LidarPointCloud
        from nuscenes.utils.geometry_utils import transform_matrix
        from nuscenes.utils.splits import create_splits_logs
        from pyquaternion import Quaternion
    except ImportError as e:
        raise ImportError(
            "the nuScenes export needs the nuscenes-devkit "
            "(nuscenes and pyquaternion), which is not installed") from e

    nusc = NuScenes(version=nusc_version, dataroot=nusc_dir, verbose=False)
    split_logs = create_splits_logs(split, nusc)
    base = os.path.join(out_dir, split, "sequences")
    os.makedirs(base, exist_ok=True)

    kitti_to_nu = np.eye(4)
    kitti_to_nu[:3, :3] = _KITTI_TO_NU
    nu_to_kitti_rot = _KITTI_TO_NU.T

    def samples_of(log: str) -> List[str]:
        toks = []
        for sample in nusc.sample:
            scene = nusc.get("scene", sample["scene_token"])
            if nusc.get("log", scene["log_token"])["logfile"] == log:
                toks.append(sample["token"])
        return toks

    exported = []
    for log in split_logs:
        tokens = samples_of(log)
        if not tokens:
            continue
        vel_dir = os.path.join(base, log, "velodyne")
        lab_dir = os.path.join(base, log, "labels")
        os.makedirs(vel_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        poses, stamps = [], []
        for idx, tok in enumerate(tokens):
            sample = nusc.get("sample", tok)
            lidar_token = sample["data"][lidar_name]
            sd = nusc.get("sample_data", lidar_token)
            cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            pose = nusc.get("ego_pose", sd["ego_pose_token"])
            ego_to_world = transform_matrix(
                pose["translation"], Quaternion(pose["rotation"]))
            lid_to_ego = transform_matrix(
                cs["translation"], Quaternion(cs["rotation"]))
            poses.append(ego_to_world @ lid_to_ego @ kitti_to_nu)
            stamps.append(sd["timestamp"])

            pcl = LidarPointCloud.from_file(
                os.path.join(nusc.dataroot, sd["filename"]))
            pcl.points[:3] = nu_to_kitti_rot @ pcl.points[:3]
            pcl.points.T.astype(np.float32).tofile(
                os.path.join(vel_dir, f"{idx:06d}.bin"))

            if split != "test":
                seg_rec = nusc.get("lidarseg", lidar_token)
                seg = np.fromfile(
                    os.path.join(nusc.dataroot, seg_rec["filename"]),
                    dtype=np.uint8)
                np.save(os.path.join(lab_dir, f"{idx:06d}.npy"), seg)

        np.save(os.path.join(base, log, "poses.npy"), np.asarray(poses))
        np.save(os.path.join(base, log, "timestamps.npy"), np.asarray(stamps))
        exported.append(log)
    return exported
