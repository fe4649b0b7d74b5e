"""The parallel layer of the port (parallel/, the data-parallel train step)
and the moments kernel's per-keypoint caps, on the CPU: the points-sharded
UME over 2 and 4 gloo ranks against the JAX package's single-device and
'sp'-sharded UME (its 8 virtual CPU devices, tests/conftest.py); the
data-parallel step over 2 gloo ranks against the one-process step on the
whole batch; a one-rank mesh against no mesh. The ranks are CPU processes
(tests/_torch_dist.py) joined with a time limit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
from _torch_parity import n, t
from umeregrobust_tpu.parallel import make_mesh as jax_mesh
from umeregrobust_tpu.parallel import ume_from_ball_query_sp as jax_sp
from umeregrobust_tpu.pipeline.ume_gen import ume_from_ball_query as jax_ume
from umeregrobust_tpu_torch.ops.cuda_ume import ume_moments_plain
from umeregrobust_tpu_torch.parallel import local_moments, points_block
from umeregrobust_tpu_torch.parallel.points_sharded import (
    block_caps, block_counts)
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The 'sp' ranks' results for 2 and 4 ranks (both spawned at once)."""
    base = tmp_path_factory.mktemp("sp")
    runs = {S: D.run_ranks(D.sp_rank, S, str(base / f"store{S}"),
                           str(base / f"out{S}")) for S in (2, 4)}
    for r in runs.values():
        r.join()
    return {S: [torch.load(base / f"out{S}_{r}.pt") for r in range(S)]
            for S in runs}


@pytest.fixture(scope="module")
def sp_jax():
    pts, feats, kpts, p_mask, k_mask = (jnp.asarray(x) for x in D.sp_cloud())
    out = {}
    for max_nn in D.SP_MAX_NN:
        kw = dict(radius=D.SP_RADIUS, max_nn=max_nn, p_mask=p_mask,
                  k_mask=k_mask, chunk=32)
        out[max_nn] = (np.asarray(jax_ume(pts, feats, kpts, **kw)),
                       np.asarray(jax_sp(jax_mesh(n_dp=1, n_sp=8), pts,
                                         feats, kpts, **kw)))
    return out


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("max_nn", D.SP_MAX_NN)
def test_sp_ume_matches_jax(sp_runs, sp_jax, S, max_nn):
    ref, ref_sp = sp_jax[max_nn]
    for rank in sp_runs[S]:  # every rank holds the whole result
        got = n(rank[max_nn]["F"])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref_sp, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(sp_runs[S][0][max_nn]["F"]),
                                  n(sp_runs[S][-1][max_nn]["F"]))


@pytest.mark.parametrize("S", [2, 4])
def test_sp_cap_counts_global_index_order(sp_runs, S):
    # the first 100 points in global order are all on the first block(s)
    for rank in sp_runs[S]:
        np.testing.assert_array_equal(n(rank["cap"])[0, :, 0], 100.0)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("max_nn", D.SP_MAX_NN)
def test_emulated_blocks_give_the_ranks_bits(sp_runs, S, max_nn):
    # one process running local_moments block by block reproduces each
    # rank's caps and block moments bit for bit, and their sum the result
    pts, feats, kpts, p_mask, k_mask = (t(x) for x in D.sp_cloud())
    blocks = [[points_block(x, r, S) for x in (pts, feats, p_mask)]
              for r in range(S)]
    counts = torch.stack([block_counts(b[0], b[2], kpts, D.SP_RADIUS)
                          for b in blocks])
    total = 0
    for r, b in enumerate(blocks):
        caps = block_caps(counts, r, max_nn)
        local = local_moments(*b, kpts, D.SP_RADIUS, caps)
        assert torch.equal(caps, sp_runs[S][r][max_nn]["caps"])
        assert torch.equal(local, sp_runs[S][r][max_nn]["local"])
        total = total + local
    one = ume_from_ball_query(pts, feats, kpts, D.SP_RADIUS, max_nn,
                              p_mask=p_mask, k_mask=k_mask)
    F = total.reshape(-1, 4, feats.shape[1]).transpose(1, 2)
    F = F / (F[:, :, 0].sum(-1, keepdim=True)[..., None] + 1e-6)
    F = F * k_mask[:, None, None]
    np.testing.assert_allclose(n(F), n(one), rtol=1e-5, atol=1e-5)
    # the blocks keep min(max_nn, in-radius count) neighbours in all
    kept = sum(torch.minimum(block_caps(counts, r, max_nn), counts[r])
               for r in range(S))
    assert torch.equal(kept, torch.clamp(counts.sum(0), max=max_nn))


def _caps_case(seed):
    rng = np.random.default_rng(seed)
    N, M, W = 700, 40, 32
    pts = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    kpts = rng.uniform(-3, 3, (M, 3)).astype(np.float32)
    Z = rng.normal(size=(N, W)).astype(np.float32)
    mask = rng.uniform(size=N) > 0.15
    return t(kpts), t(pts), t(Z * mask[:, None]), t(mask)


@pytest.mark.parametrize("max_nn", [1, 37, 5000])
def test_caps_of_max_nn_give_the_uncapped_bits(max_nn):
    kp, p, Z, m = _caps_case(1)
    want = ume_moments_plain(kp, p, Z, m, 2.0, max_nn)
    caps = torch.full((kp.shape[0],), max_nn, dtype=torch.int32)
    assert torch.equal(ume_moments_plain(kp, p, Z, m, 2.0, max_nn,
                                         caps=caps), want)
    # the caps replace max_nn: another max_nn beside them changes nothing
    assert torch.equal(ume_moments_plain(kp, p, Z, m, 2.0, 0, caps=caps),
                       want)


def test_per_keypoint_caps_and_zero_rows():
    kp, p, Z, m = _caps_case(2)
    rng = np.random.default_rng(3)
    caps = t(rng.integers(0, 60, size=kp.shape[0]).astype(np.int32))
    caps[:5] = 0
    got = ume_moments_plain(kp, p, Z, m, 2.0, 60, caps=caps)
    assert torch.count_nonzero(got[:5]) == 0
    # each row is its keypoint's own max_nn run (another product shape:
    # equal up to fp32 rounding); with a leading pair axis, the same bits
    for k in range(kp.shape[0]):
        one = ume_moments_plain(kp[k:k + 1], p, Z, m, 2.0, int(caps[k]))
        np.testing.assert_allclose(n(got[k:k + 1]), n(one), rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
    both = ume_moments_plain(torch.stack([kp, kp]), torch.stack([p, p]),
                             torch.stack([Z, Z]), torch.stack([m, m]), 2.0,
                             60, caps=torch.stack([caps, caps]))
    assert torch.equal(both[1], got)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """2 gloo ranks of the data-parallel step (B = 4, 2 pairs a rank) and a
    one-rank mesh, spawned at once; meanwhile the one-process step on the
    whole batch in this process."""
    base = tmp_path_factory.mktemp("dp")
    two = D.run_ranks(D.dp_rank, 2, str(base / "store2"), str(base / "dp"),
                      4)
    one = D.run_ranks(D.one_rank_mesh, 1, str(base / "one"), 2)
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    tr = D.tiny_trainer(str(base / "whole"))
    m = tr.train_step(batch_to_device(D.tiny_batch(4), "cpu"))
    whole = dict(m=m, s=D.trainer_state(tr))
    two.join()
    one.join()
    return (whole, [torch.load(base / f"dp_{r}.pt") for r in range(2)],
            torch.load(base / "one_0.pt"))


def _leaf_err(a, b):
    """max |a - b| over max |b| (1 where b is all zero)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def test_dp_step_matches_the_whole_batch_step(dp_runs):
    whole, ranks, _ = dp_runs
    lr = D.TINY_KW.get("lr", 1e-4)
    for r in ranks:
        # the loss and every metric: the means over the 4 pairs
        assert sorted(r["m1"]) == sorted(whole["m"])
        for k, v in whole["m"].items():
            assert r["m1"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        for k, v in whole["s"].items():
            got = r["s1"][k]
            if k.startswith("buffer."):  # the BN running state
                assert _leaf_err(got, v) <= 1e-5, k
            elif k.startswith("grad.") or k.endswith(".mu"):
                # the averaged gradient and Adam's first moment: each pair's
                # loss differs from the whole-batch forward's by ~1e-7 (a
                # cloud's BN sums depend on its place in the batch), which
                # the ill-conditioned UME normalisation carries into the
                # gradients
                assert _leaf_err(got, v) <= 1e-4, k
            elif k.endswith(".nu"):  # the second moment: g^2, twice that
                assert _leaf_err(got, v) <= 2e-4, k
            elif k.startswith("adam."):
                assert torch.equal(got, v), k  # the step count
            elif k.startswith("param."):
                g = whole["s"]["grad." + k[6:]].abs()
                firm = g >= 1e-3 * g.max()
                d = (got - v).abs()
                scale = float(v.abs().max())
                assert not firm.any() or float(d[firm].max()) <= \
                    1e-5 * scale, k
                # where the gradient is at rounding level, Adam's first
                # step lr g / (|g| + eps) may take either sign
                assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        assert r["m1"]["nonfinite_grad"] == 0.0
    for k in ranks[0]["s1"]:  # the ranks hold the same model
        assert torch.equal(ranks[0]["s1"][k], ranks[1]["s1"][k]), k


def test_nonfinite_gradient_on_one_rank_skips_both(dp_runs):
    _, ranks, _ = dp_runs
    for r in ranks:
        assert r["m2"]["nonfinite_grad"] == 1.0
        for k, v in r["s2"].items():
            assert torch.equal(v, r["s1"][k]), k  # nothing moved


def test_one_rank_mesh_gives_the_bits_of_no_mesh(dp_runs):
    one = dp_runs[2]
    assert one["mesh"]["metrics"] == one["plain"]["metrics"]
    mesh, plain = one["mesh"]["state"], one["plain"]["state"]
    assert sorted(mesh) == sorted(plain)
    for k, v in plain.items():
        assert torch.equal(mesh[k], v), k
