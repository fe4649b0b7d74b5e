"""The port's evaluate CLI and config layer against the JAX package's: the
YAML reader against yaml.safe_load, the port's own YAML copies, the
RegistrationConfig an argv gives, the --set key check, the cloud padding
and the synthetic pairs bit for bit, the dataset pairs (SEM cache or raw
scans) bit for bit on a small KITTI tree the tests write, and main() end
to end on the CPU on one small pair: synthetic (default and
reference-parity profiles, the Hungarian switch, a MinkowskiEngine .pth
checkpoint) and from the dataset tree."""
import argparse
import dataclasses
import itertools
import pathlib
import pickle

import numpy as np
import pytest
import torch
import yaml

import _torch_parity  # noqa: F401  (single-threaded torch)
from test_torch_data import write_kitti_tree
from umeregrobust_tpu.cli import evaluate as jev
from umeregrobust_tpu.utils import config as jconfig
from umeregrobust_tpu_torch.cli import evaluate as ev
from umeregrobust_tpu_torch.cli import sem_preprocessing
from umeregrobust_tpu_torch.data import registry
from umeregrobust_tpu_torch.models.convert import to_me_state_dict
from umeregrobust_tpu_torch.ops.voxel import quantize_np
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


WEIGHTS_PKL = "weights/synthetic_pretrain.pkl"
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


@pytest.fixture(scope="module")
def kitti_cache(tmp_path_factory):
    """A KITTI tree of kitti/test's first two pairs and its SEM cache
    (the port's SEM CLI)."""
    root = tmp_path_factory.mktemp("kitti")
    tree = write_kitti_tree(root / "sequences", n_pairs=2)
    cache = str(root / "sem_cache")
    assert sem_preprocessing.main([
        "--dataset_mode", "kitti", "--split", "test", "--data_path", tree,
        "--output_path", cache, "--range_idxs", "0", "2"]) == 2
    return tree, cache


def _dataset_args(pkg_ev, pkg_config, tree, cache, sets):
    return _args(pkg_ev, pkg_config, "kitti_test",
                 [f"data_path={tree}", f"cache_data_path={cache}"] + sets)


@pytest.mark.parametrize("sets,cached", [
    ([], True), (["corr_no_nksr=true"], True),
    (["corr_no_nksr=true", "skip_invalid_entries_flag=false"], False)],
    ids=["cache", "cache_and_raw_scans", "preprocess"])
def test_dataset_pair_iter_matches_jax(kitti_cache, sets, cached):
    tree, cache = kitti_cache
    cache = cache if cached else ""
    args = _dataset_args(ev, config, tree, cache, sets)
    jargs = _dataset_args(jev, jconfig, tree, cache, sets)
    it, n = ev._dataset_pair_iter(*ev._datasets(args))
    jit, jn = jev._dataset_pair_iter(jargs)
    assert n == jn == (1475 if cached else 1476)
    for got, want in itertools.islice(zip(it, jit), 2):
        assert got.keys() == want.keys()
        for k in ("sem_src", "sem_tgt"):
            # the JAX CLI keeps every row beside fewer coords (its
            # _pad_cloud then fails); the port keeps the row of each
            # coord's first occurrence, which is all rows where the
            # re-quantization is one to one
            pts, seg, coords = want[k]
            assert len(coords) < len(pts)
            _, first = quantize_np(pts, 0.3)
            want[k] = (pts[first], seg[first], coords)
        for k in got:
            g, w = got[k], want[k]
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert all(len(x) == len(got[k][0]) for k in ("sem_src", "sem_tgt")
                   for x in got[k])
    raw_from_cache = cached and "corr_no_nksr=true" not in sets
    sem_pts = ev._datasets(args)[0][1][0]  # pair 1's evaluated cloud
    assert np.array_equal(got["raw_src"], sem_pts) == raw_from_cache


def test_datasets_keep_the_first_pairs(kitti_cache):
    tree, cache = kitti_cache
    args = _dataset_args(ev, config, tree, cache, ["corr_no_nksr=true"])
    dset, raw = ev._datasets(args, dataset_size=2)
    assert (len(dset), len(raw)) == (2, 2)
    assert dset.cache_data_path == cache and raw.cache_data_path == ""


@pytest.fixture
def two_pair_registry(tmp_path, monkeypatch):
    """The registry's kitti/test cut to its first two pairs."""
    meta = tmp_path / "metadata"
    (meta / "kitti").mkdir(parents=True)
    for name in ("test_metadata", "test_gt_tforms"):
        arr = np.load(pathlib.Path(registry._META_DIR) / "kitti"
                      / f"{name}.npy", allow_pickle=True)
        np.save(meta / "kitti" / f"{name}.npy", arr[:2])
    monkeypatch.setattr(registry, "_META_DIR", str(meta))


def test_main_runs_dataset_mode_on_the_cpu(kitti_cache, two_pair_registry,
                                           capsys):
    tree, cache = kitti_cache
    res = ev.main(["--device", "cpu"] + SMALL[4:] + [
        "--set", f"data_path={tree}", "--set", f"cache_data_path={cache}",
        "--set", "corr_no_nksr=true"])
    out = capsys.readouterr().out
    assert "Evaluate kitti benchmark: kitti_test" in out
    assert res["n_pairs"] == 2 and all(r["finite"] for r in res["per_pair"])
    assert "N.P: " in out


def test_main_runs_with_a_pth_checkpoint(tmp_path, capsys):
    with open(WEIGHTS_PKL, "rb") as f:
        blob = pickle.load(f)
    path = tmp_path / "kitti_coloring_best_checkpoint.pth"
    torch.save({"model_state_dict": {
        k: torch.from_numpy(np.array(v)) for k, v in
        to_me_state_dict(blob["params"], blob["bn_state"]).items()}}, path)
    argv = list(SMALL)
    argv[argv.index("model_checkpoint_path=weights/synthetic_pretrain.pkl")] \
        = f"model_checkpoint_path={path}"
    res = ev.main(argv)
    out = capsys.readouterr().out
    assert f"loaded checkpoint: {path}" in out
    assert res["n_pairs"] == 1 and all(r["finite"] for r in res["per_pair"])


def test_missing_checkpoint_gives_seeded_random_parameters(capsys):
    args = argparse.Namespace(model_checkpoint_path="no/such.pkl", out_ch=32)
    (_, a), (_, b) = ev._load_model(args, "cpu"), ev._load_model(args, "cpu")
    assert "smoke mode" in capsys.readouterr().out
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
