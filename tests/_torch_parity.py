"""Shared helpers for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and the port runs its plain kernel
versions on CPU tensors. torch runs single-threaded: the suite runs
several pytest-xdist workers on a few cores.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)

# the small end-to-end configuration of tests/test_e2e.py (pairs from
# umeregrobust_tpu_torch.data.suite.small_pair)
CAPS = (2048, 2048, 1024, 512, 256)
SMALL_CFG = dict(num_init_keypoints=256, ume_n_samples=64, ume_max_nn=128,
                 corr_coarse_src=None, corr_rescore_top=16, icp_max_corr=0.5,
                 icp_max_iter=15)
WEIGHTS = "weights/synthetic_pretrain.pkl"


def t(x, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra Rb^T in degrees (f64; atan2 of the skew and trace parts
    stays accurate near zero, where arccos of the trace does not)."""
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                        d[1, 0] - d[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(d) - 1.0) / 2.0)))
