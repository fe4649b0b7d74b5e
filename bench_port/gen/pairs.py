"""Serving pairs and training batches from a traffic file's parameters
(numpy only, so that worker processes import no torch).

Serving: a pair is the evaluate CLI's synthetic pair made as its dataset
mode makes one (the port's cli/evaluate.py prep_one): two lidar scans of
one scene (the regimes of the port's data/suite.py), each SEM-resampled,
ground dropped, voxelized and padded to the SEM cap; correlator clouds
quantized (source at corr_ds, target at 0.3 m) and cut to the correlator
cap; the raw clouds cut to the raw ICP cap; and the ICP grid's window
occupancy of the target clouds (pipeline/exactness.py's pre-check).

Training: a pair is the port's data/synthetic.make_collated_batch sample
(voxelized scans, mutual ground-truth matches), collated with
collate_fixed.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

from gen.collate import collate_fixed
from gen.matching import mutual_matches
from gen.sem import SEMConfig, equalize_sampling
from gen.synthetic import SceneConfig, make_pair
from gen.voxel import coords_to_grid_pts_np, quantize_np

SERVE_KEYS = ("src_coords", "src_grid", "src_mask", "tgt_coords",
              "tgt_grid", "tgt_mask", "corr_src_pts", "corr_src_mask",
              "corr_tgt_pts", "corr_tgt_mask", "raw_src_pts", "raw_src_mask",
              "raw_tgt_pts", "raw_tgt_mask")


def _scene(scene: dict) -> dict:
    out = dict(scene)
    if "elevation_range" in out:
        out["elevation_range"] = tuple(out["elevation_range"])
    return out


def _lidar_pair(seed: int, regime: dict, scene: dict) -> dict:
    rkw = dict(regime)
    baseline = rkw.pop("baseline")
    return make_pair(SceneConfig(baseline=baseline, seed=seed,
                                 **_scene(scene)), seed=seed, **rkw)


def _pad_cloud(pts, seg, coords, cap, rng):
    """The port's cli/evaluate._pad_cloud: rows always permuted, padded to
    cap."""
    n = min(len(pts), cap)
    sel = rng.permutation(len(pts))[:cap]
    c4 = np.full((cap, 4), 2**20, np.int32)
    c4[:n, 0] = 0
    c4[:n, 1:] = coords[sel[:n]]
    p = np.zeros((cap, 3), np.float32)
    p[:n] = pts[sel[:n]]
    return c4, p, np.arange(cap) < n


def _cut(pts, cap, rng):
    p = pts[rng.permutation(len(pts))[:cap]]
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(p)] = p
    return buf, np.arange(cap) < len(p)


def fine_grid(icp_max_corr: float, icp_grid_scale: float,
              icp_dims: Sequence[int]) -> Tuple[float, Tuple[int, ...]]:
    """Cell and dims of the fine ICP grid (pipeline/exactness.py)."""
    cell = float(icp_max_corr) * float(icp_grid_scale)
    dims = tuple(int(math.ceil(d * icp_max_corr / cell - 1e-6))
                 for d in icp_dims)
    return cell, dims


def window_occupancy(pts: np.ndarray, cell: float, grid_dims) -> int:
    """The largest 3-z-cell window count of a cloud on the ICP grid
    (pipeline/exactness.window_occupancy)."""
    if len(pts) == 0:
        return 0
    cc = np.floor(pts / cell).astype(np.int64)
    cc -= cc.min(axis=0)
    occ = np.zeros(cc.max(axis=0) + 1, np.int32)
    np.add.at(occ, tuple(cc.T), 1)
    w = occ.copy()
    w[:, :, :-1] += occ[:, :, 1:]
    w[:, :, 1:] += occ[:, :, :-1]
    return int(w.max())


def serve_pair(args) -> Dict[str, np.ndarray]:
    """One padded serving pair: (seed, regime, traffic) -> the 14 arrays
    of SERVE_KEYS, "gt" and the target clouds' ICP window maxima
    ("win", "raw_win")."""
    seed, regime, t = args
    pair = _lidar_pair(seed, regime, t["scene"])
    c = t["caps"]
    rng = np.random.default_rng(seed)
    out = {"gt": pair["gt_tform"]}
    for tag in ("src", "tgt"):
        pts, seg = pair[f"{tag}_pts"], pair[f"{tag}_seg"]
        ep, es = equalize_sampling(pts, seg, SEMConfig(
            num_points=int(t["sem_points"]), seed=seed))
        ep = ep[es != 0]
        coords, _ = quantize_np(ep, t["voxel"])
        grid = coords_to_grid_pts_np(ep, coords, t["voxel"])
        (out[f"{tag}_coords"], out[f"{tag}_grid"],
         out[f"{tag}_mask"]) = _pad_cloud(grid, None, coords, c["sem"], rng)
        _, sel = quantize_np(pts, c[f"corr_ds_{tag}"])
        out[f"corr_{tag}_pts"], out[f"corr_{tag}_mask"] = _cut(
            pts[sel], c["corr"], rng)
        out[f"raw_{tag}_pts"], out[f"raw_{tag}_mask"] = _cut(pts, c["raw"],
                                                             rng)
    r = t["registration"]
    cell, dims = fine_grid(r["icp_max_corr"], r.get("icp_grid_scale", 1.0),
                           r.get("icp_dims", (384, 384, 96)))
    out["win"] = window_occupancy(
        out["corr_tgt_pts"][out["corr_tgt_mask"]], cell, dims)
    out["raw_win"] = window_occupancy(
        out["raw_tgt_pts"][out["raw_tgt_mask"]], cell, dims)
    return out


def serve_pool_specs(t: dict):
    """(seed, regime, traffic) of each pool pair: `per_regime` pairs of
    every regime, at the suite's tuning seeds 100 + 37 r + i."""
    specs = []
    for r, (name, regime) in enumerate(t["regimes"].items()):
        for i in range(int(t["per_regime"])):
            specs.append((100 + 37 * r + i, regime, t))
    return specs


def train_sample(args) -> Tuple:
    """One training sample (the 9-tuple collate_fixed takes) of a lidar
    scene: (seed, regime, traffic)."""
    seed, regime, t = args
    pair = _lidar_pair(seed, regime, t["scene"])
    v = t["voxel"]
    src_c, si = quantize_np(pair["src_pts"], v)
    tgt_c, ti = quantize_np(pair["tgt_pts"], v)
    src_g = coords_to_grid_pts_np(pair["src_pts"], src_c, v)
    tgt_g = coords_to_grid_pts_np(pair["tgt_pts"], tgt_c, v)
    gt = pair["gt_tform"]
    m = mutual_matches(src_g, tgt_g, gt, v / 2)
    tf = (src_g @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
    return (src_g, pair["src_seg"][si], src_c, tgt_g, pair["tgt_seg"][ti],
            tgt_c, tf, gt, m)


def train_specs(t: dict):
    """(seed, regime, traffic) of each training pair, batch after batch:
    `batches` batches of `batch` pairs at seeds 900 + 8 b + i."""
    regime = t["regime"]
    return [(900 + int(t["batch"]) * b + i, regime, t)
            for b in range(int(t["batches"])) for i in range(int(t["batch"]))]


def collate(samples, t: dict, seed: int) -> dict:
    """A fixed-shape training batch: the samples' clouds subsampled to
    max_pc_size and their matches to num_matches by a generator seeded
    from the run's seed."""
    return collate_fixed(samples, max_pc_size=int(t["max_pc_size"]),
                         num_matches=int(t["num_matches"]),
                         rng=np.random.default_rng(seed))
