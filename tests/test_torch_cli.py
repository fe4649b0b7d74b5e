"""The port's evaluate CLI and config layer against the JAX package's: the
YAML reader against yaml.safe_load, the port's own YAML copies, the
RegistrationConfig an argv gives, the --set key check, the cloud padding
and the synthetic pairs bit for bit, and main() end to end on the CPU on
one small synthetic pair (default and reference-parity profiles, and the
Hungarian switch)."""
import argparse
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
import yaml

import _torch_parity  # noqa: F401  (single-threaded torch)
from umeregrobust_tpu.cli import evaluate as jev
from umeregrobust_tpu.utils import config as jconfig
from umeregrobust_tpu_torch.cli import evaluate as ev
from umeregrobust_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(ROOT / "umeregrobust_tpu_torch" / "configs"))
               for p in (ROOT / "umeregrobust_tpu_torch" / "configs").rglob(
                   "*.yaml"))


def test_the_port_has_all_eight_configs():
    jax_yamls = sorted(
        str(p.relative_to(ROOT / "umeregrobust_tpu" / "configs"))
        for p in (ROOT / "umeregrobust_tpu" / "configs").rglob("*.yaml"))
    assert YAMLS == jax_yamls and len(YAMLS) == 8


@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_copy_is_byte_identical(rel):
    ours = (ROOT / "umeregrobust_tpu_torch" / "configs" / rel).read_bytes()
    assert ours == (ROOT / "umeregrobust_tpu" / "configs" / rel).read_bytes()


@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_reader_matches_safe_load(rel):
    path = ROOT / "umeregrobust_tpu_torch" / "configs" / rel
    got = config.load_yaml_config(str(path))
    want = yaml.safe_load(path.read_text())
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()}


def test_yaml_reader_scalars_match_safe_load(tmp_path):
    text = "\n".join([
        "# a comment", "", "a: 1", "b: -2", "c: 0.5", "d: 1.", "e: -3.25e+2",
        "f: 1e5", "g: true", "h: False", "i: yes", "j: OFF", "k: null",
        "l: ~", "m:", "n: ''", 'o: ""', "p: 'it''s # not a comment'",
        'q: "x\\ty"', "r: /data/kitti/sequences   # trailing comment",
        "s: weights/a.pkl", "t: 1_000", "u: .inf", "v: -.inf", "w: 0",
        "x: 007", "y: 0x1F", "z: plain words here", "aa: a#b",
        "bb: 2.5   ", "cc: +7", "dd: .5"]) + "\n"
    path = tmp_path / "c.yaml"
    path.write_text(text)
    got = config.load_yaml_config(str(path))
    want = yaml.safe_load(text)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "- 1\n", "a: [1, 2]\n",
                                  "a: 1\na: 2\n", "just words\n"])
def test_yaml_reader_refuses_what_it_does_not_read(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        config.load_yaml_config(str(path))


def _args(pkg_ev, pkg_config, benchmark, sets):
    args = argparse.Namespace(set=list(sets), benchmark=benchmark)
    path = str(pathlib.Path(pkg_ev._CFG_DIR)
               / pkg_ev.BENCHMARK_CONFIGS[benchmark])
    args = pkg_config.update_namespace_from_yaml(args, path)
    return pkg_config.apply_overrides(args, args.set)


@pytest.mark.parametrize("benchmark,sets", [
    ("kitti_test", []),
    ("kitti_test", ["parity=true"]),
    ("kitti_test", ["parity=true", "corr_mode=radius", "icp_inner=4"]),
    ("kitti_test", ["filter_by_ume_dist=false"]),
    ("kitti_test", ["filter_by_ume_dist_cond=false"]),
    ("lonuscenes", []),
    ("lonuscenes", ["filter_by_ume_dist=true", "parity=true"]),
    ("kitti_test", ["icp_dims=192,192,48", "consensus_polish_radii=1.0,0.5",
                    "feat_copy_dims=(128, 128, 32)"]),
    ("kitti_test", ["corr_coarse_src=0", "corr_var_anchors=0",
                    "icp_coarse_corr=0", "feat_copy_radius=0.6"]),
    ("rotkitti", ["num_init_keypoints=4096", "sr_kpts=1024",
                  "sr_gate_inliers=2.0"]),
], ids=lambda x: x if isinstance(x, str) else "+".join(x) or "defaults")
def test_registration_cfg_matches_jax(benchmark, sets):
    got = ev._registration_cfg(_args(ev, config, benchmark, sets))
    want = jev._registration_cfg(_args(jev, jconfig, benchmark, sets))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_set_key_is_refused():
    with pytest.raises(SystemExit, match="unknown --set key.*no_such_knob"):
        ev.main(["--synthetic", "1", "--device", "cpu",
                 "--set", "no_such_knob=1"])


def test_pad_cloud_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    seg = rng.integers(0, 9, 700).astype(np.int32)
    coords = rng.integers(-50, 50, (700, 3)).astype(np.int32)
    for cap in (512, 1024):
        got = ev._pad_cloud(pts, seg, coords, cap, np.random.default_rng(3))
        want = jev._pad_cloud(pts, seg, coords, cap, np.random.default_rng(3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_synthetic_pair_iter_matches_jax():
    args = argparse.Namespace(seed=3)
    (got,), (want,) = (list(m._synthetic_pair_iter(args, 1)[0])
                       for m in (ev, jev))
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


SMALL = ["--synthetic", "1", "--device", "cpu",
         "--set", "model_checkpoint_path=weights/synthetic_pretrain.pkl",
         "--set", "max_pc_size=4096", "--set", "pc_corr_max_size=2048",
         "--set", "icp_raw_max_size=4096", "--set", "num_init_keypoints=512",
         "--set", "ume_n_samples=128", "--set", "ume_max_nn=128"]


@pytest.mark.parametrize("extra", [[], ["--set", "parity=true"],
                                   ["--set", "hungarian_matching_flag=true"]],
                         ids=["default", "parity", "hungarian"])
def test_main_runs_one_small_pair_on_the_cpu(capsys, extra):
    res = ev.main(SMALL + extra)
    out = capsys.readouterr().out
    assert "loaded checkpoint: weights/synthetic_pretrain.pkl" in out
    assert "N.P: " in out and " | S.P: " in out
    assert res["n_pairs"] == 1 and all(r["finite"] for r in res["per_pair"])
    assert res["per_pair"][0]["prep_s"] > 0 < res["per_pair"][0]["pipeline_s"]
    cfg = res["registration_config"]
    if "parity=true" in extra:
        assert cfg.corr_mode == "knn" and cfg.icp_inner == 1
        assert "parity=true" in out
    else:
        assert cfg.corr_mode == "radius" and cfg.num_init_keypoints == 512
    assert ("Hungarian parity path" in out) == ("hungarian" in " ".join(extra))


def test_main_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.main(["--synthetic", "1"])


def test_dataset_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 15"):
        ev.main(["--device", "cpu"])


def test_pth_checkpoint_is_not_ported(tmp_path):
    path = tmp_path / "coloring.pth"
    path.write_bytes(b"")
    args = argparse.Namespace(model_checkpoint_path=str(path), out_ch=32)
    with pytest.raises(NotImplementedError, match="item 17"):
        ev._load_model(args, "cpu")


def test_missing_checkpoint_gives_seeded_random_parameters(capsys):
    args = argparse.Namespace(model_checkpoint_path="no/such.pkl", out_ch=32)
    (_, a), (_, b) = ev._load_model(args, "cpu"), ev._load_model(args, "cpu")
    assert "smoke mode" in capsys.readouterr().out
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
