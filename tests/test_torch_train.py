"""Training in the port against the JAX package on the CPU, at the TINY
configuration of tests/test_trainer.py with B = 2 and fp32: the
synthetic batch bit for bit; one train step (every loss and metric to
1e-5 relative, every gradient leaf to 1e-4 x its max |grad|, the new BN
state to 1e-5); the optimizer against optax over 3 steps on fixed
gradients (1e-6 relative); five steps that lower the loss and move the
parameters and BN means; the non-finite skip; checkpoints read both
ways (features to 1e-5 through the other package's forward); and the
train CLI with --device cpu on a small KITTI tree, its checkpoint loaded
by the evaluate CLI. The JAX step compiles once (~40 s), in a
module-scoped fixture."""
import functools
import glob
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from test_torch_data import _scene, _write_scan
from umeregrobust_tpu.data.synthetic import (
    SceneConfig as JSceneConfig, make_collated_batch as jax_batch)
from umeregrobust_tpu.models.resunet import ARCHS as JARCHS
from umeregrobust_tpu.models.resunet import build_unet_geometry as jax_geom
from umeregrobust_tpu.models.resunet import init_resunet as jax_init
from umeregrobust_tpu.models.resunet import resunet_apply
from umeregrobust_tpu.train import checkpoint as jckpt
from umeregrobust_tpu.train import trainer as jtrainer
from umeregrobust_tpu_torch.cli import evaluate as ev
from umeregrobust_tpu_torch.cli import train_coloring
from umeregrobust_tpu_torch.data.registry import load_registry
from umeregrobust_tpu_torch.data.synthetic import (
    SceneConfig, make_collated_batch)
from umeregrobust_tpu_torch.models.resunet import build_unet_geometry
from umeregrobust_tpu_torch.models.weights import (
    load_checkpoint as port_read, params_to_jax)
from umeregrobust_tpu_torch.train import (
    TrainConfig, Trainer, load_checkpoint, optimizer_state)
from umeregrobust_tpu_torch.train.trainer import (
    _capacities, batch_losses, batch_to_device, make_optimizer)

TINY_KW = dict(max_pc_size=1024, num_pw_samples=64, ume_n_samples=16,
               ume_max_nn=64, ume_min_nn=8, ume_r_nn=4.0,
               compute_dtype="float32",
               level_capacity_ratios=(1.0, 1.0, 0.8, 0.5, 0.25))
TINY = TrainConfig(**TINY_KW)
SCENE_KW = dict(extent=10.0, ground_points=1500, structure_points=2500,
                n_boxes=6, n_walls=2, n_poles=3, dropout=0.2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def batch2():
    return make_collated_batch(SceneConfig(**SCENE_KW), n_pairs=2,
                               max_pc_size=1024, num_matches=64, seed=4)


@pytest.fixture(scope="module")
def jax_model():
    return jax_init(jax.random.PRNGKey(0), JARCHS["ResUNetSmall2"], 1, 32)


@pytest.fixture(scope="module")
def jax_step(batch2, jax_model):
    """JAX's train-step loss, metrics, new BN state and gradients on the
    batch (the trainer's own per-pair loss, vmapped and averaged)."""
    cfg = jtrainer.TrainConfig(**TINY_KW)
    arch = JARCHS[cfg.arch]
    caps = jtrainer._capacities(cfg, arch)

    def loss_fn(params, bn_state, batch):
        f = functools.partial(jtrainer._pair_losses, params, bn_state,
                              cfg=cfg, arch=arch, caps=caps, train=True)
        totals, (metrics, states) = jax.vmap(f)(batch)
        return jnp.mean(totals), (
            jax.tree_util.tree_map(jnp.mean, metrics),
            jax.tree_util.tree_map(lambda x: jnp.mean(x, 0), states))

    params, bn = jax_model
    (loss, (metrics, new_bn)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, bn, {k: jnp.asarray(v) for k, v in batch2.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            _flat(jax.tree_util.tree_map(np.asarray, new_bn)),
            _flat(jax.tree_util.tree_map(np.asarray, grads)))


def test_synthetic_batch_is_jax_bit_for_bit(batch2):
    want = jax_batch(JSceneConfig(**SCENE_KW), n_pairs=2, max_pc_size=1024,
                     num_matches=64, seed=4)
    assert sorted(batch2) == sorted(want)
    for k in want:
        assert batch2[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(batch2[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def port_step(batch2, jax_model, tmp_path_factory):
    tr = Trainer.from_jax(*jax_model, TINY, str(tmp_path_factory.mktemp(
        "step")), device="cpu")
    batch = batch_to_device(batch2, "cpu")
    loss, metrics, state = batch_losses(
        tr.model, batch, TINY, _capacities(TINY, tr.model.arch), train=True)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tr.model.named_parameters()}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, \
        {k: v.numpy() for k, v in state.items()}, grads


def test_train_step_losses_and_metrics_match_jax(jax_step, port_step):
    loss_j, metrics_j = jax_step[:2]
    loss, metrics = port_step[:2]
    assert sorted(metrics) == sorted(metrics_j)
    assert loss == pytest.approx(loss_j, rel=1e-5)
    for k, v in metrics_j.items():
        assert metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert metrics["num_keypoints"] == 16.0  # the losses saw keypoints


def test_train_step_gradients_match_jax(jax_step, port_step):
    grads_j, grads = jax_step[3], port_step[3]
    assert sorted(grads) == sorted(grads_j)
    for k, want in grads_j.items():
        got = grads[k]
        assert got.shape == want.shape, k
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=0, err_msg=k,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-30))


def test_train_step_bn_state_matches_jax(jax_step, port_step):
    state_j, state = jax_step[2], port_step[2]
    assert sorted(state) == sorted(state_j)
    for k, want in state_j.items():
        np.testing.assert_allclose(state[k], want, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["adam", "adamw"])
def test_optimizer_matches_optax(wd):
    rng = np.random.default_rng(int(wd * 100))
    # parameters of the updates' size, so that the update read back as a
    # difference of parameters keeps its digits
    p0 = {"a": rng.normal(size=(5, 7)).astype(np.float32) * 1e-3,
          "b": rng.normal(size=(11,)).astype(np.float32) * 1e-3}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * s
              for k, v in p0.items()} for s in (1.0, 0.1, 3.0)]
    cfg = TrainConfig(lr=1e-3, weight_decay=wd)
    opt_j = optax.adamw(cfg.lr, weight_decay=wd) if wd else optax.adam(cfg.lr)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = opt_j.init(pj)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = make_optimizer(cfg, list(pt.values()))
    assert isinstance(opt, torch.optim.Optimizer)
    for g in grads:
        before = {k: v.detach().numpy().copy() for k, v in pt.items()}
        upd, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               sj, pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in pt.items():
            v.grad = torch.tensor(g[k])
        opt.step()
        for k in p0:
            want = np.asarray(upd[k])
            got = pt[k].detach().numpy() - before[k]
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_five_steps_lower_the_loss_and_move_the_state(batch2, tmp_path):
    tr = Trainer(TINY, str(tmp_path), device="cpu")
    p0 = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    m0 = tr.model.norm1.mean.clone()
    batch = batch_to_device(batch2, "cpu")
    losses = [tr.train_step(batch)["total_loss"] for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    moved = max(float((v.detach() - p0[k]).abs().max())
                for k, v in tr.model.named_parameters())
    assert moved > 0
    assert float((tr.model.norm1.mean - m0).abs().max()) > 0
    assert int(tr.optimizer.state_dict()["state"][0]["step"]) == 5


def test_nonfinite_gradients_skip_the_whole_update(batch2, tmp_path):
    tr = Trainer(TINY, str(tmp_path), device="cpu")
    batch = batch_to_device(batch2, "cpu")
    assert tr.train_step(batch)["nonfinite_grad"] == 0.0
    with torch.no_grad():
        tr.model.conv1.w.fill_(float("inf"))
    params = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    bufs = {k: v.clone() for k, v in tr.model.named_buffers()}
    opt = {k: v.clone() for k, v in tr.optimizer.state_dict()["state"][
        3].items()}
    m = tr.train_step(batch)
    assert m["nonfinite_grad"] == 1.0
    for k, v in tr.model.named_parameters():
        assert torch.equal(v, params[k]) or k == "conv1.w", k
    assert torch.isinf(tr.model.conv1.w).all()
    for k, v in tr.model.named_buffers():
        assert torch.equal(v, bufs[k]), k
    after = tr.optimizer.state_dict()["state"][3]
    for k, v in opt.items():
        assert torch.equal(after[k], v), k
    assert int(after["step"]) == 1


def _features_jax(params, bn, coords, mask):
    arch = JARCHS["ResUNetSmall2"]
    geom = jax_geom(jnp.asarray(coords), jnp.asarray(mask), arch,
                    (512, 512, 384, 256, 128))
    fin = jnp.asarray(mask, jnp.float32)[:, None]
    return np.asarray(resunet_apply(params, bn, geom, fin, arch)[0])


def _features_port(model, coords, mask):
    geom = build_unet_geometry(torch.from_numpy(coords),
                               torch.from_numpy(mask), model.arch,
                               (512, 512, 384, 256, 128))
    return model(geom, torch.from_numpy(mask)[:, None].float()).numpy()


@pytest.fixture(scope="module")
def cloud(batch2):
    return batch2["src_coords"][0][:512].copy(), batch2["src_mask"][0][:512]


def test_port_checkpoint_reads_in_jax(batch2, cloud, tmp_path):
    tr = Trainer(TINY, str(tmp_path), device="cpu")
    tr.train_step(batch_to_device(batch2, "cpu"))
    tr.end_epoch({"total_loss": 1.0, "pointwise_loss": 0.5, "ume_loss": 0.3,
                  "reg_loss": 2.0, "chr": 0.1})
    path = os.path.join(str(tmp_path), "last_epoch_checkpoint.pkl")
    blob = jckpt.load_checkpoint(path)  # the JAX package's reader
    assert blob["epoch"] == 1 and blob["format_version"] == 1
    got = _features_port(tr.model, *cloud)
    want = _features_jax(blob["params"], blob["bn_state"], *cloud)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    best = glob.glob(os.path.join(str(tmp_path), "best_*_checkpoint.pkl"))
    assert len(best) == 5  # every BEST_KEY the metrics hold
    # the port resumes its own optimizer state
    tr2 = Trainer(TINY, str(tmp_path / "again"), device="cpu")
    tr2.optimizer.load_state_dict(optimizer_state(load_checkpoint(path)))
    a = tr.optimizer.state_dict()["state"][0]
    b = tr2.optimizer.state_dict()["state"][0]
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_jax_checkpoint_reads_in_the_port(jax_model, cloud, tmp_path):
    params, bn = jax_model
    opt = optax.adam(1e-4)
    path = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(path, params=params, bn_state=bn,
                          opt_state=opt.init(params), epoch=3)
    blob = load_checkpoint(path)  # imports nothing of optax
    tr = Trainer.from_jax(blob["params"], blob["bn_state"], TINY,
                          str(tmp_path / "run"), device="cpu")
    np.testing.assert_allclose(_features_port(tr.model, *cloud),
                               _features_jax(params, bn, *cloud),
                               rtol=0, atol=1e-5)
    mine, _ = params_to_jax(tr.model)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_array_equal(_flat(mine)[k], v, err_msg=k)
    with pytest.raises(ValueError, match="resumes training only from"):
        optimizer_state(blob)
    assert port_read(path)["epoch"] == 3


def _write_split(base, split, n_pairs, seed0):
    """KITTI-layout scans of the first n_pairs of kitti/{split}: each
    pair's target is its scene's target scan moved by the registry's
    ground truth."""
    reg = load_registry("kitti", split, skip_invalid_entries=False)
    for i in range(n_pairs):
        seq, f0, f1 = (int(x) for x in reg.pairs[i])
        gt = reg.gt_tforms[i]
        scene = _scene(seed0 + i)
        d = base / f"{seq:02d}"
        (d / "velodyne").mkdir(parents=True, exist_ok=True)
        (d / "labels").mkdir(parents=True, exist_ok=True)
        tgt = ((scene["tgt_pts"] - scene["gt_tform"][:3, 3])
               @ scene["gt_tform"][:3, :3])
        tgt = (tgt @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        for fid, pts, seg in [(f0, scene["src_pts"], scene["src_seg"]),
                              (f1, tgt, scene["tgt_seg"])]:
            _write_scan(d / "velodyne" / f"{fid:06d}.bin", pts)
            raw = np.where(seg == 9, 40, np.where(seg == 0, 0, 10))
            raw.astype(np.uint32).tofile(d / "labels" / f"{fid:06d}.label")


TRAIN_SETS = ["pc_capacity=1024", "batch_size=2", "num_epochs=1",
              "train_size=2", "val_size=2", "ume_n_samples=16",
              "ume_max_nn=64", "ume_min_nn=8", "ume_r_nn=4.0",
              "num_pw_samples=64", "eval_num_kpts=32", "cache_data_path="]


def test_train_cli_runs_on_the_cpu_and_evaluate_loads_it(tmp_path, capsys):
    tree = tmp_path / "sequences"
    _write_split(tree, "train", 2, 20)
    _write_split(tree, "val", 2, 30)
    sets = TRAIN_SETS + [f"data_path={tree}", f"output_path={tmp_path}/out"]
    tr = train_coloring.main(["--device", "cpu"]
                             + [a for s in sets for a in ("--set", s)])
    out = capsys.readouterr().out
    assert "epoch 0 valid:" in out and "inlier_ratio=" in out
    assert tr.epoch == 1 and tr.device == torch.device("cpu")
    ckpt = pathlib.Path(tr.out_dir) / "last_epoch_checkpoint.pkl"
    assert ckpt.is_file()
    res = ev.main(["--synthetic", "1", "--device", "cpu",
                   "--set", f"model_checkpoint_path={ckpt}",
                   "--set", "max_pc_size=4096", "--set", "pc_corr_max_size=2048",
                   "--set", "icp_raw_max_size=4096",
                   "--set", "num_init_keypoints=512",
                   "--set", "ume_n_samples=128", "--set", "ume_max_nn=128"])
    assert f"loaded checkpoint: {ckpt}" in capsys.readouterr().out
    assert res["n_pairs"] == 1 and all(r["finite"] for r in res["per_pair"])
    # resuming from a JAX training checkpoint is refused, clearly
    params, bn = jax_init(jax.random.PRNGKey(1), JARCHS["ResUNetSmall2"])
    jpath = str(tmp_path / "jax_train.pkl")
    jckpt.save_checkpoint(jpath, params=params, bn_state=bn,
                          opt_state=optax.adam(1e-4).init(params), epoch=1)
    with pytest.raises(ValueError, match="resumes training only from"):
        train_coloring.main(["--device", "cpu", "--set",
                             f"resume_train_path={jpath}"]
                            + [a for s in sets for a in ("--set", s)])


def test_train_cli_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TINY, "unused_dir_never_made", device="cuda")
