"""The port's synthetic pretraining CLI (cli/train_synthetic.py) against
tools/train_synthetic.py on the CPU: the flags and their defaults (the
port adds --device only); the scene pools, the batches (bit for bit) and
the TrainConfig, read from the JAX tool's own main run through runpy
with its Trainer and make_collated_batch recording their arguments (no
JAX step is compiled there); the loop's log and save schedule; two fp32
steps of the port's loop against the JAX package's make_train_step on
the tool's first two batches at its loss settings (--pc-cap 1024), both
from weights/synthetic_pretrain.pkl (a JAX-written start, the tool's
--resume): each step's losses and metrics to 1e-5 relative, both
batches' gradient leaves at that start to 1e-4 x their max |grad| (the
loops' own second gradients sit on parameters that Adam's first step
moved apart: a weight whose gradient is near zero moves by +-lr), the
parameters and BN state after the two steps within the tolerances below;
the same first step from JAX's random init, whose gap starts at the UME
loss head; the CLI with --device cpu, its pickle read by both packages,
--resume starting from that file's bits; and the refusal to fall back
to the CPU."""
import argparse
import dataclasses
import functools
import pathlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from _torch_parity import WEIGHTS
from test_torch_train import _flat
from umeregrobust_tpu.models.resunet import ARCHS as JARCHS
from umeregrobust_tpu.train import checkpoint as jckpt
from umeregrobust_tpu.train import trainer as jtrainer
from umeregrobust_tpu_torch.cli import train_synthetic as ts
from umeregrobust_tpu_torch.models.resunet import ARCHS
from umeregrobust_tpu_torch.models.weights import (
    load_checkpoint, load_model, params_to_jax)
from umeregrobust_tpu_torch.train.trainer import (
    Trainer, _capacities, batch_losses, batch_to_device)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "train_synthetic.py"
SMALL = ["--batch", "2", "--pc-cap", "1024", "--n-scenes", "4"]
# after two steps: Adam moves a weight by about lr a step, so a weight
# whose gradient is within the packages' fp32 difference of zero may move
# the other way (at most ADAM_BOUND x lr apart); on average a leaf's
# weights stay within PARAM_MEAN_TOL of their mean move (found 0.037,
# conv1.w; 0.0044 elsewhere); the BN state within BN_TOL x its max
# (found 2.5e-5)
ADAM_BOUND = 4.0
PARAM_MEAN_TOL = 0.05
BN_TOL = 1e-4
# from a random init (test_random_init_first_step_parts_at_the_ume_loss_head)
RANDOM_INIT_GRAD = 2e-4


class _Stop(Exception):
    pass


def _jax_tool(monkeypatch, tmp_path, argv):
    """tools/train_synthetic.py's main run through runpy up to its
    Trainer: its argparse parser, each make_collated_batch call
    (scene, keywords, the numpy batch) and the TrainConfig."""
    import umeregrobust_tpu.data.synthetic as jsyn
    import umeregrobust_tpu.train as jtrain
    import umeregrobust_tpu.utils.cache as jcache

    rec = {"batches": []}
    parse, make = argparse.ArgumentParser.parse_args, jsyn.make_collated_batch

    def parse_args(self, args=None, namespace=None):
        rec["parser"] = self
        return parse(self, argv, namespace)

    def batch(scene, **kw):
        b = make(scene, **kw)
        rec["batches"].append((scene, kw, b))
        return b

    def trainer(cfg, out_dir, *a, **kw):
        rec["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(jsyn, "make_collated_batch", batch)
    monkeypatch.setattr(jtrain, "Trainer", trainer)
    monkeypatch.setattr(jcache, "ensure_compile_cache", lambda *a: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(_Stop):
        runpy.run_path(str(TOOL), run_name="__main__")
    monkeypatch.undo()
    return rec


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.const, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_are_the_jax_tools(monkeypatch, tmp_path):
    rec = _jax_tool(monkeypatch, tmp_path, SMALL)
    want = _actions(rec["parser"])
    got = _actions(ts.build_parser())
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"][:2] == (("--device",), "cuda")
    assert vars(ts.parse_args([])) == {
        "steps": 300, "batch": 4, "pc_cap": 8192,
        "out": "weights/synthetic_pretrain.pkl", "n_scenes": 48,
        "resume": "", "seed0": 1000, "lr": 1e-4, "low_overlap": False,
        "device": "cuda"}


@pytest.mark.parametrize("extra", [[], ["--low-overlap"]],
                         ids=["default", "low_overlap"])
def test_batches_and_config_are_the_jax_tools(monkeypatch, tmp_path, extra):
    argv = ["--batch", "2", "--pc-cap", "512", "--n-scenes", "8",
            "--seed0", "2000", "--lr", "3e-4"] + extra
    rec = _jax_tool(monkeypatch, tmp_path, argv)
    args = ts.parse_args(argv + ["--device", "cpu"])
    cfg = ts.train_config(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rec["cfg"])
    assert cfg.compute_dtype == "bfloat16" and cfg.lr == 3e-4
    plan = ts.batch_plan(args, ts.scene_pools(args.low_overlap))
    assert len(plan) == len(rec["batches"]) == 4
    assert [p for p, _, _ in plan] == ([0, 1, 0, 1] if extra else [0] * 4)
    for (_, scene, kw), (jscene, jkw, _) in zip(plan, rec["batches"]):
        assert dataclasses.asdict(scene) == dataclasses.asdict(jscene)
        assert kw == jkw
    batches = ts.build_batches(args)
    for got, (_, _, want) in zip(batches, rec["batches"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_loop_logs_and_saves_as_the_jax_tool(capsys):
    """Step s trains on batch s mod n; a log line at every 20th step and
    the last; a save at every 100th step and at the end."""

    class Stub:
        device = torch.device("cpu")

        def __init__(self):
            self.seen = []

        def train_step(self, b):
            self.seen.append(b)
            return {"total_loss": float(len(self.seen)),
                    "pointwise_loss": 0.0, "nonfinite_grad": 0.0}

    stub, saves = Stub(), []
    hist, first, ms = ts.train(stub, [0, 1, 2], 205, saves.append)
    lines = capsys.readouterr().out.splitlines()
    assert stub.seen == [s % 3 for s in range(205)]
    assert [m["total_loss"] for m in saves] == [100.0, 200.0, 205.0]
    steps = [int(s.split(":")[0][5:]) for s in lines
             if s.startswith("step ")]
    assert steps == list(range(20, 205, 20)) + [204]
    assert len(hist) == 205 and first >= 0 and ms >= 0
    assert "nonfinite_grad=0" in lines[1]
    assert lines[-1].startswith("steady: ") and "non-finite steps: 0" in \
        lines[-1]


@pytest.fixture(scope="module")
def tool_batches():
    args = ts.parse_args(SMALL + ["--device", "cpu"])
    batches = ts.build_batches(args)
    for b in batches:  # full clouds: the JAX trainer's gradient is finite
        assert b["src_mask"].all() and b["tgt_mask"].all()
    return args, batches


@pytest.fixture(scope="module")
def jax_fp32(tool_batches):
    """The JAX trainer's TrainConfig (the tool's, fp32) and its batch loss
    and gradients, jitted once."""
    args, _ = tool_batches
    cfg = jtrainer.TrainConfig(**dataclasses.asdict(dataclasses.replace(
        ts.train_config(args), compute_dtype="float32")))
    arch = JARCHS[cfg.arch]
    caps = jtrainer._capacities(cfg, arch)

    def loss_fn(params, bn_state, batch):
        f = functools.partial(jtrainer._pair_losses, params, bn_state,
                              cfg=cfg, arch=arch, caps=caps, train=True)
        totals, (metrics, _) = jax.vmap(f)(batch)
        return jnp.mean(totals), jax.tree_util.tree_map(jnp.mean, metrics)

    return cfg, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_two_steps(tool_batches, jax_fp32):
    """Two steps of the JAX package's make_train_step (fp32, the tool's
    loss settings) from weights/synthetic_pretrain.pkl (the tool's
    --resume): before each step its parameters and BN state, the loss
    and metrics, and the batch's gradients at the common start."""
    _, batches = tool_batches
    cfg, grad_fn = jax_fp32
    opt = optax.adam(cfg.lr)
    step, _ = jtrainer.make_train_step(cfg, opt)
    blob = jckpt.load_checkpoint(WEIGHTS)
    params, bn = blob["params"], blob["bn_state"]
    state = opt.init(params)
    out = []
    for s, b in enumerate(batches[:2]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        (loss, _), grads = grad_fn(params, bn, jb)
        at_start = grads if s == 0 else grad_fn(
            blob["params"], blob["bn_state"], jb)[1]
        before = (params, bn)
        params, bn, state, m = step(params, bn, state, jb)
        out.append(dict(
            before=before, loss=float(loss),
            metrics={k: float(v) for k, v in m.items()},
            grads_at_start=_flat(jax.tree_util.tree_map(np.asarray,
                                                        at_start))))
    return out, _flat(jax.tree_util.tree_map(np.asarray, params)), \
        _flat(jax.tree_util.tree_map(np.asarray, bn))


def test_two_fp32_steps_match_jax(tool_batches, jax_two_steps, tmp_path):
    args, batches = tool_batches
    want, params_j, bn_j = jax_two_steps
    cfg = dataclasses.replace(ts.train_config(args),
                              compute_dtype="float32")
    batches = [batch_to_device(b, "cpu") for b in batches[:2]]
    tr = Trainer.from_jax(*want[0]["before"], cfg, str(tmp_path / "loop"),
                          device="cpu")
    hist, _, _ = ts.train(tr, batches, 2, lambda m: None)
    for s, (m, w) in enumerate(zip(hist, want)):
        assert m["nonfinite_grad"] == w["metrics"]["nonfinite_grad"] == 0
        assert m["total_loss"] == pytest.approx(w["loss"], rel=1e-5)
        for k, v in w["metrics"].items():
            assert m[k] == pytest.approx(v, rel=1e-5, abs=1e-7), (s, k)
        assert m["num_keypoints"] > 0
    # both batches' gradients at the loops' common start
    start = Trainer.from_jax(*want[0]["before"], cfg, str(tmp_path / "s"),
                             device="cpu")
    for s, (b, w) in enumerate(zip(batches, want)):
        start.model.zero_grad(set_to_none=False)
        loss, _, _ = batch_losses(start.model, b, cfg,
                                  _capacities(cfg, start.model.arch), True)
        loss.backward()
        for k, p in start.model.named_parameters():
            gw = w["grads_at_start"][k]
            np.testing.assert_allclose(
                p.grad.numpy(), gw, rtol=0, atol=1e-4 * np.abs(gw).max(),
                err_msg=f"batch {s} {k}")
    params, bn = (_flat(t_) for t_ in params_to_jax(tr.model))
    flat0 = _flat(want[0]["before"][0])
    for k, pj in params_j.items():
        d = np.abs(params[k] - pj)
        moved = np.abs(pj - np.asarray(flat0[k]))
        assert d.max() <= ADAM_BOUND * cfg.lr, k
        assert d.mean() <= PARAM_MEAN_TOL * moved.mean(), k
    for k, v in bn_j.items():
        np.testing.assert_allclose(bn[k], v, rtol=0, err_msg=k,
                                   atol=BN_TOL * np.abs(v).max())


def _loss_head(xp, src_feat, tgt_feat, b, cfg, gen, pw, ume, reg):
    """Each pair's pointwise, UME and registration losses (means over
    the pairs) from given features, with the package `xp`'s functions."""
    kp = gen(b["src_pts"], b["src_seg"], src_feat, b["src_mask"],
             b["tgt_pts"], tgt_feat, b["tgt_mask"], b["gt_tform"],
             num_samples=cfg.ume_n_samples, max_nn=cfg.ume_max_nn,
             min_nn=cfg.ume_min_nn, nn_r=cfg.ume_r_nn, flat_labels=(9,),
             normalize=True)
    ul, valid = ume(kp.src_ume, kp.tgt_ume, kp.kp_mask, tau=cfg.tau_ume,
                    tau_neg=cfg.tau_ume_neg)
    rl, _, _ = reg(kp.src_ume, kp.tgt_ume, valid, b["gt_tform"],
                   kp.nn_intersection_ratio, cube_scale=cfg.reg_loss_cube_r,
                   nn_inter_ratio_thr=cfg.reg_loss_intersection_thr)
    return (xp.mean(pw(src_feat, b["src_pts"], tgt_feat, b["matches"],
                       b["match_mask"], tau=cfg.tau,
                       neg_euclid_dist=cfg.neg_euclid_dist)),
            xp.mean(ul), xp.mean(rl), kp.src_ume)


def test_random_init_first_step_parts_at_the_ume_loss_head(
        tool_batches, jax_fp32, tmp_path):
    """From JAX's init_resunet(PRNGKey(0)) instead of the in-repo weights
    (found on the tool's first batch): the losses agree to 1e-5, but the
    gradient leaves only to RANDOM_INIT_GRAD x max (1.3e-4 found, past
    the 1e-4 held above), and the gap starts at the UME loss head: given
    the same features, the pointwise loss's feature gradients agree to
    2.7e-7 x max and the UME and registration losses' to 9.9e-5 / 6.2e-5,
    whose UMEs reach ~1000 (the mass normalization divides by a ball's
    nearly cancelling feature sum: ROADMAP Queue 3 item 11)."""
    from umeregrobust_tpu.losses import (
        cube_registration_loss as jreg, pointwise_infonce as jpw,
        ume_contrastive_loss as jume)
    from umeregrobust_tpu.models.resunet import init_resunet as jax_init
    from umeregrobust_tpu.pipeline.train_keypoints import (
        generate_training_umes as jgen)
    from umeregrobust_tpu_torch.losses import (
        cube_registration_loss, pointwise_infonce, ume_contrastive_loss)
    from umeregrobust_tpu_torch.pipeline.train_keypoints import (
        generate_training_umes)
    from umeregrobust_tpu_torch.train.trainer import cloud_features

    args, batches = tool_batches
    jcfg, grad_fn = jax_fp32
    params, bn = jax_init(jax.random.PRNGKey(0), JARCHS[jcfg.arch], 1, 32)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (_, mj), gj = grad_fn(params, bn, jb)
    gj = _flat(jax.tree_util.tree_map(np.asarray, gj))
    cfg = dataclasses.replace(ts.train_config(args),
                              compute_dtype="float32")
    tr = Trainer.from_jax(params, bn, cfg, str(tmp_path), device="cpu")
    b = batch_to_device(batches[0], "cpu")
    loss, m, _ = batch_losses(tr.model, b, cfg,
                              _capacities(cfg, tr.model.arch), True)
    loss.backward()
    for k, v in mj.items():
        assert float(m[k]) == pytest.approx(float(v), rel=1e-5,
                                            abs=1e-7), k
    worst = max(np.abs(p.grad.numpy() - gj[k]).max() / np.abs(gj[k]).max()
                for k, p in tr.model.named_parameters())
    assert worst <= RANDOM_INIT_GRAD, worst
    # the loss head alone, on the port's features
    with torch.no_grad():
        sf, tf, _ = cloud_features(tr.model, b,
                                   _capacities(cfg, tr.model.arch),
                                   torch.float32, True)

    def jax_head(a, c):
        return jax.vmap(lambda a_, c_, bp: _loss_head(
            jnp, a_, c_, bp, cfg, jgen, jpw, jume, jreg))(a, c, jb)

    for i, tol in ((0, 1e-6), (1, RANDOM_INIT_GRAD),
                   (2, RANDOM_INIT_GRAD)):
        want = jax.jit(jax.grad(lambda a, c: jnp.mean(jax_head(a, c)[i]),
                                argnums=(0, 1)))(
            jnp.asarray(sf.numpy()), jnp.asarray(tf.numpy()))
        a, c = sf.clone().requires_grad_(), tf.clone().requires_grad_()
        terms = _loss_head(torch, a, c, b, cfg, generate_training_umes,
                           pointwise_infonce, ume_contrastive_loss,
                           cube_registration_loss)
        terms[i].backward()
        for got, w in ((a.grad, want[0]), (c.grad, want[1])):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=str(i))
    assert float(terms[3].detach().abs().max()) > 100  # found ~1000


def test_cli_on_the_cpu_writes_a_pickle_both_packages_read(tmp_path,
                                                           capsys):
    out = tmp_path / "w" / "synthetic.pkl"
    run = ts.main(["--device", "cpu", "--steps", "2", "--out", str(out)]
                  + SMALL)
    text = capsys.readouterr().out
    assert "building batches..." in text and "step 1: total=" in text
    assert f"saved {out}" in text and "nonfinite_grad=" in text
    assert len(run.history) == 2 and len(run.batches) == 2
    assert all(np.isfinite(m["total_loss"]) for m in run.history)
    assert run.trainer.device == torch.device("cpu")
    blob = jckpt.load_checkpoint(str(out))  # the JAX package's reader
    assert blob["epoch"] == 0 and blob["format_version"] == 1
    assert blob["opt_state"] == {}
    assert blob["metrics"] == {
        "final_total_loss": run.history[-1]["total_loss"]}
    params, bn = params_to_jax(run.trainer.model)
    for tree, want in ((blob["params"], params), (blob["bn_state"], bn)):
        got = _flat(jax.tree_util.tree_map(np.asarray, tree))
        assert sorted(got) == sorted(_flat(want))
        for k, v in _flat(want).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = load_model(str(out), ARCHS["ResUNetSmall2"], device="cpu")
    for k, v in run.trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_resume_starts_from_the_files_bits(tmp_path, capsys):
    args = ts.parse_args(["--device", "cpu", "--resume", WEIGHTS] + SMALL)
    tr = ts.make_trainer(args, ts.train_config(args), str(tmp_path / "a"),
                         "cpu")
    blob = load_checkpoint(WEIGHTS)
    params, bn = params_to_jax(tr.model)
    for tree, want in ((params, blob["params"]), (bn, blob["bn_state"])):
        want = _flat(want)
        assert sorted(_flat(tree)) == sorted(want)
        for k, v in _flat(tree).items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert tr.optimizer.state_dict()["state"] == {}  # a fresh optimizer
    out = tmp_path / "resumed.pkl"
    run = ts.main(["--device", "cpu", "--resume", WEIGHTS, "--steps", "1",
                   "--out", str(out)] + SMALL)
    assert f"resumed params from {WEIGHTS}" in capsys.readouterr().out
    assert np.isfinite(run.history[0]["total_loss"]) and out.is_file()
    with pytest.raises(FileNotFoundError):
        ts.main(["--device", "cpu", "--resume", str(tmp_path / "none.pkl"),
                 "--steps", "1", "--out", str(out)] + SMALL)


def test_cli_refuses_to_fall_back_to_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setattr(ts, "build_batches", None)  # raises before these
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.main(["--steps", "1"] + SMALL)
