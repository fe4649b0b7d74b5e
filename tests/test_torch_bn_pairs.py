"""BatchNorm in training mode takes each cloud's statistics over its own
rows in an order of their own: a pair's output and its share of the new
running state are bit-identical alone (B = 1) and at each place of a
batch, also in a ResUNetSmall2 training forward, whose pyramid keeps one
valid prefix (a pair's rows do not sit in its equal block of rows). On
CPU tensors."""
import numpy as np
import pytest
import torch

from _torch_parity import t, voxel_cloud
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, build_unet_geometry, init_resunet)
from umeregrobust_tpu_torch.ops.sparse import cloud_order, masked_batch_norm

CAP, C = 96, 24
COUNTS = (96, 41, 1, 70)  # valid rows of the four pairs (one full, one row)


def _pair(b):
    rng = np.random.default_rng(100 + b)
    return (rng.standard_normal((COUNTS[b], C)) * (1 + b)
            + rng.standard_normal(C)).astype(np.float32)


def _params():
    rng = np.random.default_rng(5)
    return [t(rng.uniform(0.5, 2, C).astype(np.float32)),
            t(rng.normal(size=C).astype(np.float32)),
            t(rng.normal(size=C).astype(np.float32)),
            t(rng.uniform(0.5, 2, C).astype(np.float32))]


def _level(order):
    """The pairs of `order` in one level of len(order) x CAP rows with one
    valid prefix (rows of pair order[0] first), padding rows non-zero."""
    rows = np.concatenate([_pair(b) for b in order])
    N = len(order) * CAP
    feats = np.full((N, C), 3.0, np.float32)
    feats[:len(rows)] = rows
    cloud = np.zeros(N, np.int64)
    cloud[:len(rows)] = np.repeat(np.arange(len(order)), [COUNTS[b]
                                                          for b in order])
    return t(feats), t(np.arange(N) < len(rows)), t(cloud)


def _alone(b):
    feats, mask, cloud = _level([b])
    return masked_batch_norm(feats, mask, *_params(), train=True, cloud=cloud,
                             n_clouds=1)


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2)])
def test_a_pair_gets_its_one_pair_bits_at_every_place(order):
    feats, mask, cloud = _level(order)
    out, nm, nv = masked_batch_norm(feats, mask, *_params(), train=True,
                                    cloud=cloud, n_clouds=len(order))
    start = 0
    alone = [_alone(b) for b in order]
    for (o, _, _), b in zip(alone, order):
        got = out[start: start + COUNTS[b]]
        assert torch.equal(got, o[:COUNTS[b]]), b
        start += COUNTS[b]
    assert torch.equal(out[start:], torch.zeros_like(out[start:]))
    # the state is the mean of the pairs' own states (a pair's state alone
    # is its one-row mean, exact)
    assert torch.equal(nm, torch.mean(torch.stack([a[1] for a in alone]), 0))
    assert torch.equal(nv, torch.mean(torch.stack([a[2] for a in alone]), 0))


def test_cloud_order_lays_each_cloud_out_in_its_own_block():
    # blocks of 9 / 3 = 3 slots: cloud c's valid rows in row order, then
    # the rows that are not valid (cloud 5's too) in row order
    cloud = t(np.array([1, 0, 0, 1, 2, 0, 5, 1, 0], np.int64))
    valid = t(np.array([1, 1, 0, 1, 1, 1, 1, 0, 0], bool)) & (cloud < 3)
    src, n_valid = cloud_order(cloud, valid, 3)
    assert src.tolist() == [1, 5, 2, 0, 3, 6, 4, 7, 8]
    assert n_valid.tolist() == [2, 2, 1]
    with pytest.raises(ValueError, match="equal blocks"):
        cloud_order(cloud, valid, 2)
    # a cloud with more valid rows than its block raises, never drops rows
    with pytest.raises(IndexError):
        cloud_order(torch.zeros(8, dtype=torch.int64),
                    torch.ones(8, dtype=torch.bool), 2)


def _cloud_pair(seed, b):
    c4, m = voxel_cloud(seed, n_vox=150, cap=192)
    c4[:, 0] = np.where(m, c4[:, 0] + 2 * b, c4[:, 0])
    return c4, m


def test_training_forward_bn_state_is_the_mean_of_the_pairs_own():
    # one ResUNetSmall2 training forward at B = 2 against each pair alone:
    # every BN layer's new state is the mean of the two one-pair states
    caps = (192, 160, 128, 96, 64)
    model = init_resunet(ARCHS["ResUNetSmall2"], 1, 16, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    pairs = [_cloud_pair(21, 0), _cloud_pair(22, 1)]

    def state(ps):
        coords = np.concatenate([p[0] for p in ps])
        mask = np.concatenate([p[1] for p in ps])
        if len(ps) == 1:
            coords = coords.copy()
            coords[:, 0] = np.where(mask, coords[:, 0] % 2, coords[:, 0])
        geom = build_unet_geometry(t(coords), t(mask), model.arch, caps,
                                   pairs=len(ps))
        feats = t(mask)[:, None].to(torch.float32)
        with torch.no_grad():
            _, st = model(geom, feats, compute_dtype=torch.bfloat16,
                          train=True)
        return st

    both, one, two = state(pairs), state(pairs[:1]), state(pairs[1:])
    assert len(both) == 2 * 18  # mean and var of ResUNetSmall2's 18 BNs
    for k, v in both.items():
        assert torch.equal(v, torch.mean(torch.stack([one[k], two[k]]), 0)), k
