"""The port's ball_query on CPU tensors (its plain version) against the
JAX package's ball_query and float64 brute force, index for index, at the
forced cases that drive the CUDA kernel's edges
(ops/cuda_ball.forced_cases); CPU tensors never launch the kernel; the
cases reach the edges they name; the wrapper's constants are the
kernel's. The kernel itself is held to the plain version on the card:
tests/test_torch_ball_query_card.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu.ops.neighbors import ball_query as jball
from umeregrobust_tpu_torch.ops import cuda_ball
from umeregrobust_tpu_torch.ops.neighbors import ball_query

_FORCED = cuda_ball.forced_cases()


def _opt(x, conv):
    return None if x is None else conv(x)


def _brute(q, p, radius, K, qm, pm):
    """First K in-radius valid indices from float64 squared distances
    (exact on the forced cases' lattices), -1 padded."""
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    ok = d2 <= np.float64(np.float32(radius)) ** 2
    if pm is not None:
        ok &= pm[None]
    if qm is not None:
        ok &= qm[:, None]
    out = np.full((len(q), K), -1, np.int64)
    for i, row in enumerate(ok):
        hits = np.flatnonzero(row)[:K]
        out[i, :len(hits)] = hits
    return out


@pytest.mark.parametrize("case", sorted(_FORCED))
def test_forced_cases_match_jax_and_brute_force(case):
    q, p, r, K, qm, pm = _FORCED[case]
    before = cuda_ball.LAUNCHES
    got = ball_query(t(q), t(p), r, K, _opt(qm, t), _opt(pm, t))
    assert cuda_ball.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.int64 and got.shape == (len(q), K)
    want = jball(jnp.asarray(q), jnp.asarray(p), r, K,
                 _opt(qm, jnp.asarray), _opt(pm, jnp.asarray))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(got), _brute(q, p, r, K, qm, pm))


def test_forced_cases_reach_the_kernels_edges():
    T = cuda_ball.TILE

    def rows(case):
        q, p, r, K, qm, pm = _FORCED[case]
        return _brute(q, p, r, K, qm, pm), K

    # a hit at exactly the radius is kept, one a 1/16 beyond it is not
    q, p = _FORCED["d2_equals_r2"][:2]
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    assert (d2 == 25.0).sum() >= len(q) and (d2 == 25.0625).sum() >= len(q)
    idx, K = rows("d2_equals_r2")
    assert (idx >= 0).all() and (d2[np.arange(len(q))[:, None], idx]
                                 == 25.0).any()
    # the K-th hit across a tile boundary, across a ballot boundary, and
    # inside a ballot whose earlier lanes are hits too
    idx, K = rows("more_than_K_across_ballot_and_tile")
    full = idx[(idx >= 0).all(1)]
    assert any(r[0] < T <= r[-1] for r in full)
    assert any(r[0] < 2 * T <= r[-1] for r in full)
    assert any(r[-1] // 32 == r[-2] // 32 and r[-1] % 32 > 0 for r in full)
    counts = (idx >= 0).sum(1)
    assert 0 in counts and any(0 < c < K for c in counts)
    sparse = [r[r >= 0] for r in idx if 0 < (r >= 0).sum() < K]
    assert any(len(set(r // 32)) == len(r) >= 20 for r in sparse)
    idx, K = rows("fewer_than_K_and_none")
    assert sorted(set((idx >= 0).sum(1))) == [0, 1, 7, 39, 40]
    assert (rows("all_points_masked")[0] == -1).all()
    qm = _FORCED["invalid_queries"][4]
    idx, _ = rows("invalid_queries")
    assert not qm[:cuda_ball.QUERIES_PER_BLOCK].any()
    assert (idx[~qm] == -1).all() and (idx[qm] >= 0).any()
    idx, K = rows("duplicate_points")
    assert (idx[0] >= 0).all() and idx[0, -1] >= 1000  # second tile
    assert _FORCED["K1"][3] == 1 and 0 < (rows("K1")[0] >= 0).mean() < 1
    q, p, r, K, qm, pm = _FORCED["K_equals_N"]
    assert K == len(p) and (rows("K_equals_N")[0] >= 0).sum(1).max() == \
        pm.sum()


def test_cpu_tensors_never_launch_the_kernel():
    q, p, r, K, qm, pm = _FORCED["K1"]
    before = cuda_ball.LAUNCHES
    for chunk in (7, 256, 1024):
        got = ball_query(t(q), t(p), r, K, t(qm), t(pm), chunk=chunk)
        np.testing.assert_array_equal(n(got), _brute(q, p, r, K, qm, pm))
    assert cuda_ball.LAUNCHES == before


def test_wrapper_constants_mirror_the_kernel():
    src = (Path(cuda_ball.__file__).resolve().parent.parent / "csrc"
           / "ball_query.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (cuda_ball.QUERIES_PER_BLOCK, cuda_ball.TILE) == (
        const["kWarps"], const["kTile"])


@pytest.mark.parametrize("radius", [0.6, 5.0, 0.1, 1.3])
def test_radius_sq_is_the_plain_versions(radius):
    want = torch.tensor(float(radius), dtype=torch.float32) ** 2
    assert np.float32(cuda_ball.radius_sq(radius)) == n(want)
