"""Rank programs of the torch.distributed tests (tests/test_torch_parallel.py),
run with the gloo backend in CPU processes that torch.multiprocessing.spawn
starts. This module imports torch and the port only, so a rank starts
without JAX; each rank writes what it computed to `out` with torch.save.
"""
from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = str(ROOT / "weights" / "synthetic_pretrain.pkl")
TINY_KW = dict(max_pc_size=1024, num_pw_samples=64, ume_n_samples=16,
               ume_max_nn=64, ume_min_nn=8, ume_r_nn=4.0,
               compute_dtype="float32",
               level_capacity_ratios=(1.0, 1.0, 0.8, 0.5, 0.25))
SCENE_KW = dict(extent=10.0, ground_points=1500, structure_points=2500,
                n_boxes=6, n_walls=2, n_poles=3, dropout=0.2)
SP_RADIUS = 4.0
SP_MAX_NN = (1000, 37)


def sp_cloud():
    """tests/test_points_sharded.py's cloud (N 2048, C 8, M 96, seed 0),
    with every point at least 1e-4 off the radius of every keypoint (the
    JAX CPU path measures |a|^2 + |b|^2 - 2ab, the port direct
    differences): points that land nearer are drawn again."""
    rng = np.random.default_rng(0)
    N, C, M = 2048, 8, 96
    pts = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    feats = rng.normal(size=(N, C)).astype(np.float32)
    kidx = rng.choice(N, M, replace=False)
    p_mask = rng.uniform(size=N) > 0.1
    feats[~p_mask] = 0.0
    k_mask = rng.uniform(size=M) > 0.2
    while True:
        kpts = pts[kidx]
        d = np.linalg.norm(pts[:, None].astype(np.float64) - kpts[None],
                           axis=-1)
        near = np.any(np.abs(d - SP_RADIUS) < 1e-4, axis=1)
        if not near.any():
            return pts, feats, kpts, p_mask, k_mask
        pts[near] = rng.uniform(-10, 10, (int(near.sum()), 3))


def cap_cloud():
    """tests/test_points_sharded.py's global-order case: every point in
    radius of the one keypoint, unit features, max_nn 100."""
    N, C = 512, 4
    return (np.zeros((N, 3), np.float32), np.ones((N, C), np.float32),
            np.zeros((1, 3), np.float32))


def run_ranks(fn, n, *args, timeout=120.0):
    """fn(rank, n, *args) in n spawned processes; raises if a rank fails,
    or if the ranks have not all ended within `timeout` seconds (they are
    then killed)."""
    ctx = mp.spawn(fn, args=(n, *args), nprocs=n, join=False)
    return Ranks(ctx, timeout)


class Ranks:
    def __init__(self, ctx, timeout):
        self.ctx, self.deadline = ctx, time.time() + timeout

    def join(self):
        while not self.ctx.join(timeout=max(self.deadline - time.time(),
                                            0.0)):
            if time.time() >= self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError("a rank did not finish in time")


def _init(rank, world, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _done():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def sp_rank(rank, world, store, out):
    """The points-sharded UME on an 'sp' mesh of `world` ranks: the
    result, the rank's caps and its block's moments before the sum."""
    from umeregrobust_tpu_torch.parallel import (
        make_mesh, points_block, ume_from_ball_query_sp)
    from umeregrobust_tpu_torch.parallel.points_sharded import (
        block_caps, block_counts, local_moments)

    _init(rank, world, store)
    mesh = make_mesh(n_dp=1, n_sp=world, device_type="cpu")
    pts, feats, kpts, p_mask, k_mask = (torch.from_numpy(x)
                                        for x in sp_cloud())
    res = {}
    for max_nn in SP_MAX_NN:
        F = ume_from_ball_query_sp(mesh, pts, feats, kpts, SP_RADIUS, max_nn,
                                   p_mask=p_mask, k_mask=k_mask)
        blk = [points_block(x, rank, world) for x in (pts, feats, p_mask)]
        counts = torch.stack([block_counts(
            points_block(pts, r, world), points_block(p_mask, r, world),
            kpts, SP_RADIUS) for r in range(world)])
        caps = block_caps(counts, rank, max_nn)
        res[max_nn] = dict(F=F, caps=caps, local=local_moments(
            *blk, kpts, SP_RADIUS, caps))
    cp, cf, ck = (torch.from_numpy(x) for x in cap_cloud())
    res["cap"] = ume_from_ball_query_sp(mesh, cp, cf, ck, 1.0, 100,
                                        normalize=False)
    torch.save(res, f"{out}_{rank}.pt")
    _done()


def tiny_trainer(out_dir, mesh=None):
    from umeregrobust_tpu_torch.models.resunet import ARCHS
    from umeregrobust_tpu_torch.models.weights import load_model
    from umeregrobust_tpu_torch.train.trainer import TrainConfig, Trainer

    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    return Trainer(TrainConfig(**TINY_KW), out_dir, device="cpu",
                   model=model, mesh=mesh)


def tiny_batch(n_pairs, seed=6):
    from umeregrobust_tpu_torch.data.synthetic import (
        SceneConfig, make_collated_batch)

    return make_collated_batch(SceneConfig(**SCENE_KW), n_pairs=n_pairs,
                               max_pc_size=1024, num_matches=64, seed=seed)


def trainer_state(tr):
    """Parameters, their gradients, BN buffers and Adam state, cloned."""
    s = {f"param.{k}": v.detach().clone()
         for k, v in tr.model.named_parameters()}
    s.update({f"grad.{k}": v.grad.detach().clone()
              for k, v in tr.model.named_parameters() if v.grad is not None})
    s.update({f"buffer.{k}": v.detach().clone()
              for k, v in tr.model.named_buffers()})
    for i, st in tr.optimizer.state_dict()["state"].items():
        s.update({f"adam.{i}.{k}": torch.as_tensor(v).clone()
                  for k, v in st.items()})
    return s


def dp_rank(rank, world, store, out, n_pairs):
    """One data-parallel step on this rank's pairs of an n_pairs batch,
    then a step in which rank 1's gradient of conv1.w is NaN."""
    from umeregrobust_tpu_torch.parallel import make_mesh, shard_batch
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    _init(rank, world, store)
    mesh = make_mesh(n_dp=world, device_type="cpu")
    tr = tiny_trainer(f"{out}_run{rank}", mesh)
    batch = batch_to_device(shard_batch(mesh, tiny_batch(n_pairs)), "cpu")
    m1 = tr.train_step(batch)
    s1 = trainer_state(tr)
    if rank == 1:
        tr.model.conv1.w.register_hook(lambda g: g * float("nan"))
    # one pair a rank: the skip does not depend on the batch
    m2 = tr.train_step({k: v[:1] for k, v in batch.items()})
    s2 = {k: v for k, v in trainer_state(tr).items()
          if not k.startswith("grad.")}
    torch.save(dict(m1=m1, s1=s1, m2=m2, s2=s2), f"{out}_{rank}.pt")
    _done()


def one_rank_mesh(rank, world, out, n_pairs):
    """A step on a one-rank mesh and one without a mesh, same batch; the
    mesh starts its own process group (none runs here)."""
    import torch.distributed as dist

    from umeregrobust_tpu_torch.parallel import make_mesh, shard_batch
    from umeregrobust_tpu_torch.train.trainer import batch_to_device

    torch.set_num_threads(1)
    assert not dist.is_initialized()
    mesh = make_mesh(device_type="cpu")
    assert dist.get_world_size() == 1
    batch = tiny_batch(n_pairs)
    res = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        tr = tiny_trainer(f"{out}_{name}", m)
        b = batch_to_device(shard_batch(m, batch) if m is not None
                            else batch, "cpu")
        metrics = [tr.train_step(b)]
        res[name] = dict(metrics=metrics, state=trainer_state(tr))
    torch.save(res, f"{out}_{rank}.pt")
    _done()
