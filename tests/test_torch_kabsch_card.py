"""On the card: the SO(3) solver's kernel (ops/cuda_so3.py, csrc/kabsch.cu)
against its plain version (core/so3.kabsch_rotation_plain) run on the
card, bit for bit (a NaN equal to a NaN): the forced cases, 1e6 random
cross-covariances over six decades of scale at n = 1 to 1e6, leading
dims, strided and fp64 inputs; one launch a call; the dispatch under a
gradient (the training loss: AUTOGRAD_CALLS, no launch); and one ICP
stage over a batch of two pairs, run with the kernel and with the plain
solver forced, to the same T, rmse, fitness and iterations. Each
comparison prints one JSON line with its count of mismatching elements.
Skips where no CUDA card is found; on the chip (this file imports no JAX,
and --noconftest keeps tests/conftest.py's out):

    python -m pytest --noconftest -p no:cacheprovider -m card -s \
        tests/test_torch_kabsch_card.py
"""
import json

import numpy as np
import pytest
import torch

from umeregrobust_tpu_torch.core import so3
from umeregrobust_tpu_torch.ops import cuda_so3

_FORCED = cuda_so3.forced_cases()
_RANDOM_N = 1_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def random_h():
    """1e6 f32 cross-covariances, entries N(0, 1) times one scale a matrix
    drawn over about six decades (a fixed seed)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip only")
    g = torch.Generator().manual_seed(25)
    H = torch.randn(_RANDOM_N, 3, 3, generator=g) * torch.exp(
        torch.randn(_RANDOM_N, 1, 1, generator=g) * 2.0)
    return H.to("cuda")


def _mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose fp32 bits differ, a NaN counted equal to a NaN."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def _same(H: torch.Tensor, sweeps: int, label: str) -> torch.Tensor:
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    with torch.no_grad():
        got = so3.kabsch_rotation(H, sweeps)
        want = so3.kabsch_rotation_plain(H, sweeps)
    torch.cuda.synchronize()
    launched = int(H.numel() > 0)
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == (
        before[0] + launched, before[1])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.device.type == "cuda" and got.is_contiguous()
    bad = _mismatches(got, want)
    print(json.dumps({"kabsch_card": label, "sweeps": sweeps,
                      "elements": got.numel(), "mismatches": bad}))
    assert bad == 0
    return got


@pytest.mark.card
@pytest.mark.parametrize("sweeps", [3, 6])
@pytest.mark.parametrize("case", sorted(_FORCED))
def test_kernel_equals_plain_on_forced_cases(card, case, sweeps):
    _same(torch.as_tensor(_FORCED[case], device=card), sweeps, case)


@pytest.mark.card
@pytest.mark.parametrize("sweeps", [3, 6])
@pytest.mark.parametrize("n", [1, 8, 20_000, 262_144, _RANDOM_N])
def test_kernel_equals_plain_on_random_h(card, random_h, n, sweeps):
    _same(random_h[:n], sweeps, f"random_n{n}")


@pytest.mark.card
def test_leading_dims_strides_and_types(card, random_h):
    H = random_h[:120]
    _same(H.reshape(2, 3, 20, 3, 3), 3, "lead_2x3x20")
    _same(H.transpose(-1, -2), 6, "transposed_view")
    _same(H[::2], 3, "strided_rows")
    _same(H.double(), 6, "float64")
    _same(H.reshape(1, 120, 3, 3).expand(2, 120, 3, 3), 3, "expanded")
    empty = _same(H[:0].reshape(0, 4, 3, 3), 3, "empty")
    assert empty.shape == (0, 4, 3, 3)


@pytest.mark.card
def test_a_gradient_keeps_the_plain_version(card, random_h):
    H = random_h[:64].clone().requires_grad_(True)
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    R = so3.kabsch_rotation(H, sweeps=6)
    R.square().sum().backward()
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == (
        before[0], before[1] + 1)
    assert torch.isfinite(H.grad).all() and H.grad.abs().sum() > 0
    with torch.no_grad():
        torch.testing.assert_close(R, so3.kabsch_rotation(H, 6),
                                   rtol=0, atol=0)
    assert cuda_so3.LAUNCHES == before[0] + 1
    with torch.no_grad():
        with pytest.raises(ValueError):
            cuda_so3.kabsch_rotation(H[:0, :2], 3)


@pytest.mark.card
def test_training_loss_takes_the_autograd_path(card):
    """cube_registration_loss under a gradient: its one solver call is
    counted in AUTOGRAD_CALLS and launches no kernel."""
    from umeregrobust_tpu_torch.losses.losses import cube_registration_loss

    rng = np.random.default_rng(7)
    B, K, C = 2, 16, 8
    src = torch.tensor(rng.normal(size=(B, K, C, 4)), dtype=torch.float32,
                       device=card, requires_grad=True)
    tgt = (src.detach() + 0.01 * torch.randn_like(src)).requires_grad_(True)
    gt = torch.eye(4, device=card).expand(B, 4, 4)
    ratio = torch.tensor(rng.uniform(0, 1, (B, K)), dtype=torch.float32,
                         device=card)
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    loss, _, _ = cube_registration_loss(src, tgt, torch.ones(
        B, K, dtype=torch.bool, device=card), gt, ratio)
    loss.sum().backward()
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == (
        before[0], before[1] + 1)
    assert torch.isfinite(src.grad).all()


@pytest.mark.card
def test_icp_stage_equal_with_the_kernel_and_the_plain_solver(card,
                                                              monkeypatch):
    """One icp_loop stage (inner 6, budget 16) over a fixed batch of two
    synthetic pairs: with the kernel, each umeyama call's solver is one
    launch; with the plain solver forced, the same T, rmse, fitness and
    sub-iterations bit for bit."""
    from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
    from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid
    from umeregrobust_tpu_torch.pipeline import icp

    S = 4096
    src, tgt, init = [], [], []
    for seed in (3, 4):
        pr = make_pair(SceneConfig(seed=seed, ground_points=8000,
                                   structure_points=12000),
                       max_rotation_deg=30.0, max_translation=2.0, seed=seed)
        rng = np.random.default_rng(seed)
        src.append(pr["src_pts"][rng.permutation(len(pr["src_pts"]))[:S]])
        tgt.append(pr["tgt_pts"][rng.permutation(len(pr["tgt_pts"]))[:S]])
        a = np.deg2rad(2.0)
        off = np.array([[np.cos(a), -np.sin(a), 0, 0.3],
                        [np.sin(a), np.cos(a), 0, -0.2],
                        [0, 0, 1, 0.1], [0, 0, 0, 1]])
        init.append(off @ pr["gt_tform"])
    src_t = torch.tensor(np.stack(src), dtype=torch.float32, device=card)
    tgt_t = torch.tensor(np.stack(tgt), dtype=torch.float32, device=card)
    init_t = torch.tensor(np.stack(init), dtype=torch.float32, device=card)
    smask = torch.ones(2, S, dtype=torch.bool, device=card)
    smask[1, ::7] = False
    grid = build_dense_grid(tgt_t, torch.ones_like(smask), cell=1.0,
                            dims=(160, 160, 32))
    calls = []
    launch = cuda_so3.kabsch_rotation

    def counted(H, sweeps):
        calls.append(tuple(H.shape))
        return launch(H, sweeps)

    def run():
        with torch.no_grad():
            out = icp.icp_loop(src_t, smask, grid, init_t, 1.0, 30, 16,
                               inner=6)
        torch.cuda.synchronize()
        return out

    monkeypatch.setattr(cuda_so3, "kabsch_rotation", counted)
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    T, rmse, fit, iters = run()
    assert len(calls) > 0 and all(c == (2, 3, 3) for c in calls)
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == (
        before[0] + len(calls), before[1])
    monkeypatch.setattr(icp, "kabsch_rotation", so3.kabsch_rotation_plain)
    T_p, rmse_p, fit_p, iters_p = run()
    assert cuda_so3.LAUNCHES == before[0] + len(calls)
    bad = sum(_mismatches(a, b) for a, b in
              ((T, T_p), (rmse, rmse_p), (fit, fit_p)))
    print(json.dumps({"kabsch_card": "icp_loop_stage", "solver_calls":
                      len(calls), "iterations": iters.tolist(),
                      "rmse": rmse.tolist(), "mismatches": bad}))
    assert bad == 0 and torch.equal(iters, iters_p)
    assert torch.isfinite(rmse).all() and (fit > 0.3).all()
