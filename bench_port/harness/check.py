"""The numbers that decide `correct`: gaps between what the program
produced and what the reference works out, each held to its limit from
the cell's limits file (bench_port/limits/<cell>.json)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def pose_gaps(Ta, Tb) -> Tuple[np.ndarray, np.ndarray]:
    """(rotation gap deg, translation gap m) of each pair of (B, 4, 4)
    transforms, in float64."""
    a = np.asarray(torch.as_tensor(Ta).detach().cpu(), np.float64)
    b = np.asarray(torch.as_tensor(Tb).detach().cpu(), np.float64)
    # the angle of R_a R_b^T from |R_a - R_b|_F = 2 sqrt(2) sin(angle / 2),
    # exact to rounding at small angles (an arccos of the trace is not)
    fro = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2))
    rot = np.degrees(2.0 * np.arcsin(np.clip(fro / (2 * np.sqrt(2)), 0, 1)))
    trans = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    bad = ~(np.isfinite(a).all(axis=(1, 2)) & np.isfinite(b).all(axis=(1, 2)))
    rot[bad] = np.inf
    trans[bad] = np.inf
    return rot, trans


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (Frobenius), float64; inf where not finite."""
    a = a.detach().to(torch.float64)
    b = b.detach().to(torch.float64)
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    if not np.isfinite(num) or not np.isfinite(den):
        return float("inf")
    return num / max(den, 1e-30)


def judge(values: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, List[dict]]:
    """Each number against its limit (value <= limit passes; a number
    that is not finite fails)."""
    checks = []
    for name, spec in limits.items():
        v = float(values[name])
        ok = bool(np.isfinite(v) and v <= float(spec["limit"]))
        checks.append({"name": name, "value": v, "limit": spec["limit"],
                       "ok": ok})
    return all(c["ok"] for c in checks), checks
