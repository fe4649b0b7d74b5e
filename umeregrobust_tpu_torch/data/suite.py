"""The synthetic registration suite as the repository's benchmark builds it
(bench.py: regimes, seeds and per-pair preparation), for the port.

A pair is two lidar-mode scans of one scene; each scan goes through SEM
equalization, ground removal (label 0 dropped), 0.3 m voxelization and
padding to SEM_CAP voxels, and a random CORR_CAP-point correlator cloud.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from umeregrobust_tpu_torch.data.sem import SEMConfig, equalize_sampling
from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
from umeregrobust_tpu_torch.ops.voxel import coords_to_grid_pts_np, quantize_np

__all__ = ["REGIMES", "REDUCED", "REDUCED_CFG", "tuning_seed", "prep_pair",
           "small_pair"]

# regime suite (bench.py): nominal / rotation-heavy / low-overlap / both
REGIMES: Dict[str, dict] = {
    "nominal": dict(baseline=8.0, max_rotation_deg=120, max_translation=8.0),
    "rotheavy": dict(baseline=8.0, max_rotation_deg=180, min_rotation_deg=150,
                     max_translation=8.0),
    "lowoverlap": dict(baseline=22.0, max_rotation_deg=120,
                       max_translation=12.0),
    "verylow": dict(baseline=30.0, max_rotation_deg=180, min_rotation_deg=150,
                    max_translation=14.0),
}

# the reduced operating point's data sizes and level capacities
REDUCED = dict(SEM_CAP=16384, CORR_CAP=4096,
               caps=(16384, 10240, 4096, 1280, 256),
               scene_kw=dict(extent=25.0, ground_points=12000,
                             structure_points=24000),
               sem_points=50000)
# the reduced point's RegistrationConfig overrides (bench.py:321-326)
REDUCED_CFG = dict(num_init_keypoints=2048, ume_n_samples=2048,
                   corr_coarse_src=512, corr_coarse_tgt=1024,
                   corr_rescore_top=4, icp_max_corr=0.4, icp_max_iter=60,
                   icp_coarse_corr=None, consensus_gate_inliers=0.01,
                   icp_exact_rows=1024, icp_dims=(192, 192, 48))


def tuning_seed(regime: str, i: int = 0) -> int:
    """Seed of the i-th tuning-suite pair of a regime (100 + 37 r + i)."""
    return 100 + 37 * list(REGIMES).index(regime) + i


def small_pair(seed: int, SEM_CAP: int = 2048, CORR_CAP: int = 1024) -> dict:
    """A small iid-mode pair (10 m scene, no SEM step) padded like
    `prep_pair`: the JAX package's small end-to-end test input
    (tests/test_e2e.py), for checks that must run in seconds."""
    pair = make_pair(SceneConfig(extent=10.0, ground_points=2500,
                                 structure_points=5000, n_boxes=8, n_walls=3,
                                 n_poles=4, dropout=0.2),
                     max_rotation_deg=60, max_translation=4.0, seed=seed)
    out = {"gt": pair["gt_tform"]}
    rng = np.random.default_rng(seed)
    for tag, pts in [("src", pair["src_pts"]), ("tgt", pair["tgt_pts"])]:
        coords, _ = quantize_np(pts, 0.3)
        grid = coords_to_grid_pts_np(pts, coords, 0.3)
        k = min(len(grid), SEM_CAP)
        pick = (rng.choice(len(grid), k, replace=False) if len(grid) > SEM_CAP
                else np.arange(k))
        ci = rng.choice(len(pts), min(len(pts), CORR_CAP), replace=False)
        out[tag] = _padded(coords[pick], grid[pick], pts[ci], SEM_CAP,
                           CORR_CAP)
    return out


def _padded(coords, grid, corr, SEM_CAP, CORR_CAP) -> dict:
    k = len(grid)
    c4 = np.full((SEM_CAP, 4), 2**20, np.int32)
    c4[:k, 0] = 0
    c4[:k, 1:] = coords
    g = np.zeros((SEM_CAP, 3), np.float32)
    g[:k] = grid
    cp = np.zeros((CORR_CAP, 3), np.float32)
    cp[: len(corr)] = corr
    return dict(coords=c4, grid=g, mask=np.arange(SEM_CAP) < k, corr_pts=cp,
                corr_mask=np.arange(CORR_CAP) < len(corr))


def prep_pair(seed: int, regime: str, SEM_CAP: int, CORR_CAP: int,
              scene_kw: dict, sem_points: int, **_) -> dict:
    """One padded suite pair: {"gt": (4, 4), "src"/"tgt": {coords (SEM_CAP,
    4) int32, grid (SEM_CAP, 3), mask, corr_pts (CORR_CAP, 3),
    corr_mask}}."""
    rkw = dict(REGIMES[regime])
    baseline = rkw.pop("baseline")
    pair = make_pair(SceneConfig(observe_mode="lidar", baseline=baseline,
                                 seed=seed, **scene_kw), seed=seed, **rkw)
    out = {"gt": pair["gt_tform"]}
    for tag, pts, seg in [("src", pair["src_pts"], pair["src_seg"]),
                          ("tgt", pair["tgt_pts"], pair["tgt_seg"])]:
        ep, es = equalize_sampling(pts, seg, SEMConfig(num_points=sem_points,
                                                       seed=seed))
        keep = es != 0
        ep = ep[keep]
        coords, _ = quantize_np(ep, 0.3)
        grid = coords_to_grid_pts_np(ep, coords, 0.3)
        k = min(len(grid), SEM_CAP)
        pick = (np.random.default_rng(seed).choice(len(grid), k, replace=False)
                if len(grid) > SEM_CAP else np.arange(k))
        ci = np.random.default_rng(seed + 1).choice(
            len(pts), min(len(pts), CORR_CAP), replace=False)
        out[tag] = _padded(coords[pick], grid[pick], pts[ci], SEM_CAP,
                           CORR_CAP)
    return out
