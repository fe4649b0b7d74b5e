"""Synthetic structured LiDAR-like scenes with exact ground-truth
transforms (a frozen copy of the port's data/synthetic.py, numpy only): ground plane, boxes, walls and poles, observed from two
sensor poses with noise, occlusion and partial overlap, yielding (src,
tgt, gt_transform) registration pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["SceneConfig", "make_scene", "make_pair", "make_collated_batch"]


def make_collated_batch(
    scene_cfg: "SceneConfig",
    n_pairs: int,
    max_pc_size: int,
    num_matches: int,
    voxel_size: float = 0.3,
    seed: int = 0,
    max_rotation_deg: float = 180.0,
    max_translation: float = 10.0,
    min_rotation_deg: float = 0.0,
    sector_deg: float = 360.0,
) -> dict:
    """Synthetic pairs (seeds seed + i), voxelized and collated into the
    trainer's fixed-shape batch (data/collate.collate_fixed): the training
    substrate of the tests and chip_smoke.py."""
    from gen.collate import collate_fixed
    from gen.matching import mutual_matches
    from gen.voxel import coords_to_grid_pts_np, quantize_np

    samples = []
    for i in range(n_pairs):
        pair = make_pair(scene_cfg, max_rotation_deg=max_rotation_deg,
                         max_translation=max_translation, seed=seed + i,
                         min_rotation_deg=min_rotation_deg,
                         sector_deg=sector_deg)
        src_c, si = quantize_np(pair["src_pts"], voxel_size)
        tgt_c, ti = quantize_np(pair["tgt_pts"], voxel_size)
        src_g = coords_to_grid_pts_np(pair["src_pts"], src_c, voxel_size)
        tgt_g = coords_to_grid_pts_np(pair["tgt_pts"], tgt_c, voxel_size)
        gt = pair["gt_tform"]
        m = mutual_matches(src_g, tgt_g, gt, voxel_size / 2)
        tf = (src_g @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        samples.append((src_g, pair["src_seg"][si], src_c, tgt_g,
                        pair["tgt_seg"][ti], tgt_c, tf, gt, m))
    return collate_fixed(samples, max_pc_size=max_pc_size,
                         num_matches=num_matches,
                         rng=np.random.default_rng(seed))


@dataclass
class SceneConfig:
    extent: float = 50.0  # half-size of the scene in meters
    n_boxes: int = 40
    n_walls: int = 12
    n_poles: int = 25
    ground_points: int = 30000
    structure_points: int = 60000
    noise_std: float = 0.02
    dropout: float = 0.35  # per-scan random point dropout (partial overlap)
    seed: int = 0
    # --- viewpoint-dependent observation ("lidar" mode) ---------------
    # observe_mode="iid" reproduces the legacy generator (both scans see
    # the SAME sampled surface points with iid dropout — saturates recall
    # at 100%, round-2 VERDICT weak #3). "lidar" raytraces each scan from
    # its own sensor origin: spherical z-buffer (occlusion + 1/r^2 density
    # falloff in one step), independent per-scan clutter objects, and a
    # per-scan ground-z calibration offset.
    observe_mode: str = "iid"
    sensor_height: float = 1.8
    baseline: float = 6.0  # distance between the two sensor origins (m)
    azimuth_bins: int = 1800  # 0.2 deg horizontal resolution
    elevation_bins: int = 64  # beams between elevation_range
    elevation_range: Tuple[float, float] = (-25.0, 15.0)  # degrees
    lidar_dropout: float = 0.08  # per-return beam dropout
    n_clutter: int = 6  # independent per-scan objects (movers)
    ground_z_jitter: float = 0.03  # per-scan ground calibration offset (m)


def _sample_box_surface(rng, center, size, yaw, n):
    """Uniform samples on the 5 visible faces (no bottom) of a yawed box."""
    w, d, h = size
    areas = np.array([w * d, d * h, d * h, w * h, w * h])  # top,4 sides
    face = rng.choice(5, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, size=n)
    v = rng.uniform(-0.5, 0.5, size=n)
    pts = np.zeros((n, 3), np.float32)
    # top
    m = face == 0
    pts[m] = np.stack([u[m] * w, v[m] * d, np.full(m.sum(), 0.5 * h)], -1)
    m = face == 1
    pts[m] = np.stack([np.full(m.sum(), 0.5 * w), u[m] * d, v[m] * h], -1)
    m = face == 2
    pts[m] = np.stack([np.full(m.sum(), -0.5 * w), u[m] * d, v[m] * h], -1)
    m = face == 3
    pts[m] = np.stack([u[m] * w, np.full(m.sum(), 0.5 * d), v[m] * h], -1)
    m = face == 4
    pts[m] = np.stack([u[m] * w, np.full(m.sum(), -0.5 * d), v[m] * h], -1)
    pts[:, 2] += 0.5 * h
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return pts @ R.T + center


def make_scene(cfg: SceneConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (points (N,3) float32, labels (N,) int32).

    Labels follow the semantic-KITTI learning-map convention the pipeline
    consumes: 9 = flat/ground (excluded from keypoints, reference
    utils/loc_utils.py:94 flat_labels=[9]), >0 structured, 0 unlabeled.
    """
    rng = np.random.default_rng(cfg.seed)
    e = cfg.extent

    # ground plane with gentle undulation
    g_xy = rng.uniform(-e, e, size=(cfg.ground_points, 2)).astype(np.float32)
    g_z = (0.15 * np.sin(g_xy[:, 0] * 0.15) * np.cos(g_xy[:, 1] * 0.1)).astype(
        np.float32
    )
    ground = np.concatenate([g_xy, g_z[:, None]], axis=1)

    structures = []
    n_struct = cfg.n_boxes + cfg.n_walls + cfg.n_poles
    pts_per = cfg.structure_points // max(n_struct, 1)
    for _ in range(cfg.n_boxes):  # cars/containers
        center = np.array(
            [rng.uniform(-e, e), rng.uniform(-e, e), 0.0], np.float32)
        size = rng.uniform([1.5, 3.0, 1.2], [2.5, 5.5, 2.2]).astype(np.float32)
        structures.append(_sample_box_surface(
            rng, center, size, rng.uniform(0, 2 * np.pi), pts_per))
    for _ in range(cfg.n_walls):  # building facades
        center = np.array(
            [rng.uniform(-e, e), rng.uniform(-e, e), 0.0], np.float32)
        size = rng.uniform([0.3, 8.0, 4.0], [0.6, 20.0, 9.0]).astype(np.float32)
        structures.append(_sample_box_surface(
            rng, center, size, rng.uniform(0, 2 * np.pi), pts_per))
    for _ in range(cfg.n_poles):  # poles/trunks
        center = np.array(
            [rng.uniform(-e, e), rng.uniform(-e, e), 0.0], np.float32)
        size = rng.uniform([0.2, 0.2, 3.0], [0.5, 0.5, 7.0]).astype(np.float32)
        structures.append(_sample_box_surface(
            rng, center, size, rng.uniform(0, 2 * np.pi), pts_per))

    struct_pts = np.concatenate(structures, axis=0).astype(np.float32)
    pts = np.concatenate([ground, struct_pts], axis=0)
    labels = np.concatenate(
        [np.full(len(ground), 9, np.int32), np.full(len(struct_pts), 1, np.int32)]
    )
    return pts, labels


def _lidar_observe(cfg: SceneConfig, p: np.ndarray,
                   origin: np.ndarray, rng) -> np.ndarray:
    """Spherical z-buffer scan of the scene from `origin` -> kept indices.

    Bins every point into (azimuth, elevation) cells as seen from the
    sensor and keeps only the CLOSEST point per cell — occlusion (points
    behind walls vanish) and 1/r^2 density falloff (far surfaces subtend
    fewer cells) fall out of the projection, exactly as for a spinning
    scanner. A small per-return dropout models beam misses.
    """
    d = p - origin[None, :]
    r = np.linalg.norm(d, axis=1)
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2] / np.maximum(r, 1e-6), -1.0, 1.0))
    el_lo = np.radians(cfg.elevation_range[0])
    el_hi = np.radians(cfg.elevation_range[1])
    in_fov = (el >= el_lo) & (el <= el_hi) & (r >= 1.5)
    az_bin = ((az + np.pi) / (2 * np.pi) * cfg.azimuth_bins).astype(np.int64)
    az_bin %= cfg.azimuth_bins
    el_bin = ((el - el_lo) / (el_hi - el_lo) * cfg.elevation_bins)
    el_bin = np.clip(el_bin.astype(np.int64), 0, cfg.elevation_bins - 1)
    cell = az_bin * cfg.elevation_bins + el_bin
    # z-buffer: first point per cell after sorting by (cell, range)
    order = np.lexsort((r, cell))
    c_sorted = cell[order]
    first = np.ones(len(order), bool)
    first[1:] = c_sorted[1:] != c_sorted[:-1]
    sel = order[first & in_fov[order]]
    if cfg.lidar_dropout > 0:
        sel = sel[rng.uniform(size=len(sel)) > cfg.lidar_dropout]
    return sel


def _clutter_points(cfg: SceneConfig, rng, pts_per: int = 400):
    """Independent per-scan objects (parked->moved cars, pedestrians):
    structure that exists in one scan only, so correspondences cannot rely
    on every surface being shared."""
    out = []
    e = cfg.extent
    for _ in range(cfg.n_clutter):
        center = np.array([rng.uniform(-e, e), rng.uniform(-e, e), 0.0],
                          np.float32)
        size = rng.uniform([0.6, 0.6, 1.0], [2.5, 5.0, 2.0]).astype(np.float32)
        out.append(_sample_box_surface(
            rng, center, size, rng.uniform(0, 2 * np.pi), pts_per))
    if not out:
        return (np.zeros((0, 3), np.float32), np.zeros((0,), np.int32))
    q = np.concatenate(out, axis=0).astype(np.float32)
    return q, np.full(len(q), 1, np.int32)


def make_pair(
    cfg: SceneConfig,
    max_rotation_deg: float = 180.0,
    max_translation: float = 10.0,
    z_rotation_only: bool = True,
    seed: int | None = None,
    min_rotation_deg: float = 0.0,
    sector_deg: float = 360.0,
) -> dict:
    """One registration pair: two noisy partial observations of a scene.

    Returns dict with src_pts, src_seg, tgt_pts, tgt_seg (numpy) and
    gt_tform (4,4) mapping src -> tgt, i.e. tgt ~= R @ src + t on the
    overlap (the reference's convention, kitti_dataset.py:437).

    min_rotation_deg forces |yaw| >= min (rotation-heavy regimes mirroring
    rotkitti's 150-180 deg augmentation); sector_deg < 360 keeps only a
    random azimuth wedge per observation, producing spatially-structured
    partial overlap mirroring lokitti's distant-frame low-overlap pairs.

    With cfg.observe_mode == "lidar", the two scans are raytraced from two
    sensor origins cfg.baseline meters apart (see _lidar_observe): the
    observed surface SAMPLES differ between scans, occlusion is
    viewpoint-dependent, and each scan carries independent clutter — the
    hardened regime of the round-2 VERDICT (weak #3).
    """
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    pts, labels = make_scene(cfg)

    def observe_iid(p, lab):
        keep = rng.uniform(size=len(p)) > cfg.dropout
        if sector_deg < 360.0:
            center = rng.uniform(0, 2 * np.pi)
            az = np.arctan2(p[:, 1], p[:, 0])
            half = np.radians(sector_deg) / 2
            d = np.abs((az - center + np.pi) % (2 * np.pi) - np.pi)
            keep &= d <= half
        q = p[keep] + rng.normal(scale=cfg.noise_std, size=(keep.sum(), 3))
        return q.astype(np.float32), lab[keep]

    def observe_lidar(p, lab, origin):
        cp, cl = _clutter_points(cfg, rng)
        p_all = np.concatenate([p, cp], axis=0)
        l_all = np.concatenate([lab, cl], axis=0)
        sel = _lidar_observe(cfg, p_all, origin, rng)
        if sector_deg < 360.0:
            center = rng.uniform(0, 2 * np.pi)
            az = np.arctan2(p_all[sel, 1] - origin[1],
                            p_all[sel, 0] - origin[0])
            half = np.radians(sector_deg) / 2
            d = np.abs((az - center + np.pi) % (2 * np.pi) - np.pi)
            sel = sel[d <= half]
        q = p_all[sel] + rng.normal(scale=cfg.noise_std, size=(len(sel), 3))
        q[:, 2] += rng.uniform(-cfg.ground_z_jitter, cfg.ground_z_jitter)
        return q.astype(np.float32), l_all[sel]

    if cfg.observe_mode == "lidar":
        o_src = np.array([rng.uniform(-0.25, 0.25) * cfg.extent,
                          rng.uniform(-0.25, 0.25) * cfg.extent,
                          cfg.sensor_height], np.float64)
        th = rng.uniform(0, 2 * np.pi)
        o_tgt = o_src + cfg.baseline * np.array(
            [np.cos(th), np.sin(th), 0.0])
        src_pts, src_seg = observe_lidar(pts, labels, o_src)
        tgt_world, tgt_seg = observe_lidar(pts, labels, o_tgt)
    else:
        src_pts, src_seg = observe_iid(pts, labels)
        tgt_world, tgt_seg = observe_iid(pts, labels)

    mag = rng.uniform(min_rotation_deg, max_rotation_deg)
    ang = np.radians(mag * (1 if rng.uniform() < 0.5 else -1))
    if z_rotation_only:
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    else:
        A = rng.normal(size=(3, 3))
        Q, r = np.linalg.qr(A)
        Q = Q * np.sign(np.diag(r))
        if np.linalg.det(Q) < 0:
            Q[:, 2] *= -1
        R = Q.astype(np.float32)
    t = rng.uniform(-1, 1, size=3).astype(np.float32) * max_translation
    t[2] *= 0.05  # mostly planar motion, like a vehicle

    # target frame = R @ world + t; src observed in world frame
    tgt_pts = (tgt_world @ R.T + t).astype(np.float32)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = R
    gt[:3, 3] = t
    return {
        "src_pts": src_pts,
        "src_seg": src_seg.astype(np.int32),
        "tgt_pts": tgt_pts,
        "tgt_seg": tgt_seg.astype(np.int32),
        "gt_tform": gt,
        # GT surface samples (WORLD frame, no per-scan clutter/noise):
        # the shared-surface oracle for SEM completion A/Bs
        # (data/sem.py mode="oracle"; tgt-frame consumers apply gt)
        "scene_pts": pts.astype(np.float32),
        "scene_seg": labels.astype(np.int32),
    }
