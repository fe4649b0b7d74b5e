"""Small-matrix SO(3) solvers (port of umeregrobust_tpu/core/so3.py).

- kabsch_rotation: the proper rotation argmin_R |R p - q| from the 3x3
  cross-covariance by Horn's quaternion method, with the max eigenvector
  of a symmetric 4x4 found by a FIXED number of cyclic Jacobi sweeps.
  Ported as it is (not replaced by torch.linalg.svd): at 3 sweeps the
  solver deviates up to 0.13 deg from the exact solution, and the
  pipeline's results depend on that.
  Dispatch (ops/cuda_so3.route): a CPU tensor runs kabsch_rotation_plain;
  a CUDA tensor that autograd differentiates (the training loss,
  losses.cube_registration_loss) runs it too, for its graph, counted in
  ops/cuda_so3.AUTOGRAD_CALLS; any other CUDA tensor launches the kernel
  csrc/kabsch.cu once a call (ops/cuda_so3.kabsch_rotation) or raises.
  Tier-1 holds kabsch_rotation_plain to the JAX package
  (tests/test_torch_core.py, tests/test_torch_kabsch.py); the card holds
  the kernel to kabsch_rotation_plain bit for bit
  (tests/test_torch_kabsch_card.py).
- gram_schmidt: column-orthonormal basis by modified Gram-Schmidt with one
  reorthogonalization pass; rank-deficient columns come out as zeros.
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.ops import cuda_so3

__all__ = ["kabsch_rotation", "kabsch_rotation_plain", "quat_to_rot",
           "gram_schmidt"]

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _jacobi_rotate(A, V, p, r):
    """One batched Jacobi rotation zeroing A[..., p, r] (A symmetric 4x4);
    updates A and V in place (both are private working copies)."""
    app = A[..., p, p]
    arr = A[..., r, r]
    apr = A[..., p, r]
    theta = 0.5 * torch.atan2(2.0 * apr, arr - app)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    rowp = A[..., p, :].clone()
    rowr = A[..., r, :].clone()
    A[..., p, :] = c * rowp - s * rowr
    A[..., r, :] = s * rowp + c * rowr
    colp = A[..., :, p].clone()
    colr = A[..., :, r].clone()
    A[..., :, p] = c * colp - s * colr
    A[..., :, r] = s * colp + c * colr
    vp = V[..., :, p].clone()
    vr = V[..., :, r].clone()
    V[..., :, p] = c * vp - s * vr
    V[..., :, r] = s * vp + c * vr


def _jacobi_eigh4(K, sweeps: int = 6):
    """Batched symmetric 4x4 eigendecomposition by cyclic Jacobi:
    returns (w (..., 4), V (..., 4, 4)) with K V ~= V diag(w)."""
    A = K.to(torch.float32).clone()
    V = torch.eye(4, dtype=torch.float32, device=K.device).expand(
        A.shape).clone()
    for _ in range(sweeps):
        for p, r in _PAIRS:
            _jacobi_rotate(A, V, p, r)
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def kabsch_rotation(H: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Optimal proper rotation R = argmin sum_i |R p_i - q_i|^2 given the
    cross-covariance H = sum_i p_i q_i^T, batched over leading dims: the
    kernel or the plain version, as the module docstring says."""
    way = cuda_so3.route(H.device.type, torch.is_grad_enabled(),
                         H.requires_grad)
    if way == "kernel":
        return cuda_so3.kabsch_rotation(H, sweeps)
    if way == "autograd":
        cuda_so3.AUTOGRAD_CALLS += 1
    return kabsch_rotation_plain(H, sweeps)


def kabsch_rotation_plain(H: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Optimal proper rotation R = argmin sum_i |R p_i - q_i|^2 given the
    cross-covariance H = sum_i p_i q_i^T, batched over leading dims."""
    H = H.to(torch.float32)
    scale = torch.sqrt(torch.sum(H * H, dim=(-2, -1), keepdim=True)) + 1e-30
    S = H / scale
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)
    w, V = _jacobi_eigh4(K, sweeps=sweeps)
    best = torch.argmax(w, dim=-1)
    idx = best[..., None, None].expand(V.shape[:-1] + (1,))
    q = torch.gather(V, -1, idx)[..., 0]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-30)
    return quat_to_rot(q)


def gram_schmidt(F: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Column-orthonormal basis of (..., d, k) (fp32)."""
    F = F.to(torch.float32)
    cols = []
    for i in range(F.shape[-1]):
        v = F[..., i]
        for _ in range(2):  # MGS + reorthogonalization
            for qj in cols:
                v = v - torch.sum(qj * v, dim=-1, keepdim=True) * qj
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        ref = torch.sqrt(torch.sum(F[..., i] ** 2, dim=-1, keepdim=True))
        ok = n > torch.clamp(eps * ref, min=1e-30)
        cols.append(torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)),
                                torch.zeros_like(v)))
    return torch.stack(cols, dim=-1)
