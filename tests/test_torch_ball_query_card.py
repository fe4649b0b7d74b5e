"""On the card: the ball_query kernel (ops/cuda_ball.py) against its plain
version (ops/neighbors.ball_query_plain) run on the card, index for
index: the forced cases, points within a few fp32 steps of the radius, a
pair axis, and a padded 100000-row cloud at the training keypoint
selection's three calls. Skips where no CUDA card is found; on the chip
(this file imports no JAX, and --noconftest keeps tests/conftest.py's out):

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_ball_query_card.py
"""
import numpy as np
import pytest
import torch

from umeregrobust_tpu_torch.ops import cuda_ball
from umeregrobust_tpu_torch.ops.neighbors import ball_query, ball_query_plain

_FORCED = cuda_ball.forced_cases()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip only")
    return torch.device("cuda")


def _on(dev, x):
    return None if x is None else torch.as_tensor(x).to(dev)


def _near_radius(rng, M, N, radius):
    """Queries, and points at `radius` from them within a few fp32 steps
    either side: decisions that turn on the squared distance's last bit."""
    q = rng.uniform(-40, 40, (M, 3)).astype(np.float32)
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = radius * (1 + rng.integers(-4, 5, (N, 1)) * 2.0 ** -23)
    return q, (q[rng.integers(0, M, N)] + u * scale).astype(np.float32)


def _same(args, kw=None):
    kw = kw or {}
    before = cuda_ball.LAUNCHES
    got = ball_query(*args, **kw)
    assert cuda_ball.LAUNCHES == before + 1
    want = ball_query_plain(*args, **kw)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return got


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(_FORCED))
def test_kernel_equals_plain_on_forced_cases(card, case):
    q, p, r, K, qm, pm = _FORCED[case]
    _same((_on(card, q), _on(card, p), r, K, _on(card, qm), _on(card, pm)))


@pytest.mark.card
@pytest.mark.parametrize("K", [1, 64])
def test_kernel_equals_plain_near_the_radius(card, K):
    rng = np.random.default_rng(K)
    q, p = _near_radius(rng, 300, 30000, 2.5)
    got = _same((_on(card, q), _on(card, p), 2.5, K,
                 _on(card, rng.random(300) < 0.9),
                 _on(card, rng.random(30000) < 0.9)))
    assert 0 < int((got >= 0).sum()) < got.numel()


@pytest.mark.card
def test_pair_axis_equals_each_pair(card):
    rng = np.random.default_rng(5)
    probs = [_near_radius(rng, 100, 5000, 1.0) for _ in range(3)]
    pm = np.stack([rng.random(5000) < 0.8 for _ in probs])
    qm = np.stack([rng.random(100) < 0.9 for _ in probs])
    got = ball_query(_on(card, np.stack([q for q, _ in probs])),
                     _on(card, np.stack([p for _, p in probs])), 1.0, 40,
                     _on(card, qm), _on(card, pm))
    for i, (q, p) in enumerate(probs):
        torch.testing.assert_close(got[i], ball_query_plain(
            _on(card, q), _on(card, p), 1.0, 40, _on(card, qm[i]),
            _on(card, pm[i])), rtol=0, atol=0)


@pytest.mark.card
def test_kernel_equals_plain_at_the_training_calls(card, monkeypatch):
    """A lidar pair at train_kitti_config's widths (100000-row clouds, 256
    keypoints, 750 in 5 m) through the keypoint selection: its three
    ball_query calls, each held to the plain version."""
    from umeregrobust_tpu_torch.data.synthetic import (
        SceneConfig, make_collated_batch)
    from umeregrobust_tpu_torch.pipeline import train_keypoints as tk
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    scene = SceneConfig(seed=900, observe_mode="lidar",
                        ground_points=2_000_000, structure_points=1_500_000,
                        elevation_range=(-24.8, 2.0))
    bt = batch_to_device(make_collated_batch(
        scene, 1, max_pc_size=100000, num_matches=512, seed=900), card)
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return _same(a, kw)

    monkeypatch.setattr(tk, "ball_query", record)
    with torch.no_grad():
        tk._select(bt["src_pts"][0], bt["src_seg"][0], bt["src_mask"][0],
                   bt["tgt_pts"][0], bt["tgt_mask"][0], bt["gt_tform"][0],
                   256, 750, 300, 5.0, 0.6, (9,))
    assert [(a[0].shape[0], a[1].shape[0], kw["K"]) for a, kw in calls] == [
        (100000, 100000, 1), (512, 100000, 750), (256, 100000, 750)]
