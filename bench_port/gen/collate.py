"""Fixed-shape batch collation (a frozen copy of the port's
data/collate.py; numpy only).

The reference's batch_collate_fn_dset (kitti_dataset.py:546-616)
subsamples every cloud to the batch's smallest size. This keeps its
sampling (a uniform random subsample a cloud, matches reindexed through
the subsample, a uniform subsample of the matches) and pads to static
capacities with validity masks:

  src/tgt coords (B, N, 4) int32 (batch index in column 0; padding rows
  hold an out-of-range sentinel), pts (B, N, 3), seg (B, N), mask (B, N),
  src_pts_tform (B, N, 3), gt_tform (B, 4, 4), matches (B, M, 2) int32,
  match_mask (B, M).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["collate_fixed"]

_PAD_COORD = 2**20


def _subsample(rng, n_have: int, n_want: int) -> np.ndarray:
    if n_have <= n_want:
        return np.arange(n_have)
    return rng.choice(n_have, n_want, replace=False)


def collate_fixed(
    samples: Sequence[Tuple],
    max_pc_size: int,
    num_matches: int,
    rng: np.random.Generator | None = None,
) -> Dict[str, np.ndarray]:
    """samples: the datasets' 9-tuples."""
    rng = rng or np.random.default_rng(0)
    B = len(samples)
    N = max_pc_size
    M = num_matches

    out = {
        "src_coords": np.full((B, N, 4), _PAD_COORD, np.int32),
        "tgt_coords": np.full((B, N, 4), _PAD_COORD, np.int32),
        "src_pts": np.zeros((B, N, 3), np.float32),
        "tgt_pts": np.zeros((B, N, 3), np.float32),
        "src_seg": np.zeros((B, N), np.int32),
        "tgt_seg": np.zeros((B, N), np.int32),
        "src_mask": np.zeros((B, N), bool),
        "tgt_mask": np.zeros((B, N), bool),
        "src_pts_tform": np.zeros((B, N, 3), np.float32),
        "gt_tform": np.zeros((B, 4, 4), np.float32),
        "matches": np.zeros((B, M, 2), np.int32),
        "match_mask": np.zeros((B, M), bool),
    }

    for b, s in enumerate(samples):
        (src_pts, src_seg, src_coords, tgt_pts, tgt_seg, tgt_coords,
         src_pts_tform, gt_tform, matches) = s
        si = _subsample(rng, len(src_pts), N)
        ti = _subsample(rng, len(tgt_pts), N)
        ns, nt = len(si), len(ti)

        out["src_pts"][b, :ns] = src_pts[si]
        out["src_seg"][b, :ns] = src_seg[si]
        out["src_coords"][b, :ns, 0] = b
        out["src_coords"][b, :ns, 1:] = src_coords[si]
        out["src_mask"][b, :ns] = True
        out["src_pts_tform"][b, :ns] = src_pts_tform[si]

        out["tgt_pts"][b, :nt] = tgt_pts[ti]
        out["tgt_seg"][b, :nt] = tgt_seg[ti]
        out["tgt_coords"][b, :nt, 0] = b
        out["tgt_coords"][b, :nt, 1:] = tgt_coords[ti]
        out["tgt_mask"][b, :nt] = True

        out["gt_tform"][b] = gt_tform

        # matches whose source AND target survive the subsample, at their
        # new positions (kitti_dataset.py:588-593)
        m = np.asarray(matches, np.int64)
        if len(m):
            src_new = np.full(len(src_pts), -1, np.int64)
            src_new[si] = np.arange(ns)
            tgt_new = np.full(len(tgt_pts), -1, np.int64)
            tgt_new[ti] = np.arange(nt)
            a = src_new[m[:, 0]]
            c = tgt_new[m[:, 1]]
            ok = (a >= 0) & (c >= 0)
            mm = np.stack([a[ok], c[ok]], axis=1)
            if len(mm) > M:
                mm = mm[rng.choice(len(mm), M, replace=False)]
            out["matches"][b, : len(mm)] = mm
            out["match_mask"][b, : len(mm)] = True
    return out
