"""The port's data layer against the JAX package's: pair registries (and
the byte-identical metadata copies), the KITTI readers and learning map,
ground-truth matches, the SEM patch and oracle modes, the KITTI and
nuScenes datasets in their three modes on small trees the tests write,
cache pickles read across the packages, and collate_fixed. The same
numpy inputs go through both packages; the arrays must be equal."""
import filecmp
import os
import pathlib

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (single-threaded torch)
import umeregrobust_tpu.data as J
from umeregrobust_tpu.data import datasets as jds
from umeregrobust_tpu_torch.data import (
    collate, datasets, laserscan, matching_host, registry, sem)
from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = sorted(str(p.relative_to(ROOT / "umeregrobust_tpu" / "data"))
              for p in (ROOT / "umeregrobust_tpu" / "data" / "metadata"
                        ).rglob("*.npy"))
SPLITS = ([("kitti", s) for s in ("train", "val", "test", "lokitti",
                                  "rotkitti")]
          + [("nuscenes", s) for s in ("val", "test", "lonuscenes",
                                       "rotnuscenes")])


def assert_items_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(i))


# ---- registries --------------------------------------------------------------

def test_metadata_copies_are_all_there():
    assert len(META) == 19
    mine = sorted(str(p.relative_to(ROOT / "umeregrobust_tpu_torch" / "data"))
                  for p in (ROOT / "umeregrobust_tpu_torch" / "data"
                            / "metadata").rglob("*.npy"))
    assert mine == META


@pytest.mark.parametrize("rel", META)
def test_metadata_copy_is_byte_identical(rel):
    assert filecmp.cmp(ROOT / "umeregrobust_tpu" / "data" / rel,
                       ROOT / "umeregrobust_tpu_torch" / "data" / rel,
                       shallow=False)


@pytest.mark.parametrize("skip", [False, True], ids=["all", "skip_invalid"])
@pytest.mark.parametrize("ds,split", SPLITS, ids=lambda x: x)
def test_registry_equals_jax(ds, split, skip):
    got = registry.load_registry(ds, split, skip_invalid_entries=skip)
    want = J.load_registry(ds, split, skip_invalid_entries=skip)
    assert len(got) == len(want) > 0
    assert got.pairs.dtype == want.pairs.dtype
    np.testing.assert_array_equal(got.pairs, want.pairs)
    assert got.gt_tforms.dtype == want.gt_tforms.dtype == np.float32
    np.testing.assert_array_equal(got.gt_tforms, want.gt_tforms)


def test_registry_filters_as_the_reference():
    # the <= 50 m filter is KITTI's alone; the test split skips one pair
    full = registry.load_registry("kitti", "test", skip_invalid_entries=False)
    assert len(full) == 1476
    assert len(registry.load_registry("kitti", "test")) == 1475
    far = registry.load_registry("kitti", "train", max_translation=5.0,
                                 skip_invalid_entries=False)
    assert len(far) < len(registry.load_registry(
        "kitti", "train", skip_invalid_entries=False))
    nu = registry.load_registry("nuscenes", "test", max_translation=0.0)
    assert len(nu) == len(J.load_registry("nuscenes", "test"))


def test_nuscenes_train_split_raises_as_in_jax():
    with pytest.raises(FileNotFoundError):
        J.load_registry("nuscenes", "train")
    with pytest.raises(FileNotFoundError):
        registry.load_registry("nuscenes", "train")


# ---- readers -------------------------------------------------------------------

def test_readers_and_learning_map_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "08"
    (d / "velodyne").mkdir(parents=True)
    (d / "labels").mkdir(parents=True)
    rng.normal(size=(500, 4)).astype(np.float32).tofile(
        d / "velodyne" / "000007.bin")
    raw = (rng.integers(0, 300, 500).astype(np.uint32)
           | (rng.integers(0, 1 << 16, 500).astype(np.uint32) << 16))
    raw.tofile(d / "labels" / "000007.label")
    assert laserscan.SEMANTIC_KITTI_LEARNING_MAP == \
        J.SEMANTIC_KITTI_LEARNING_MAP
    path = str(d / "velodyne" / "000007.bin")
    assert_items_equal([laserscan.read_kitti_scan(path)],
                       [J.read_kitti_scan(path)])
    lab = str(d / "labels" / "000007.label")
    got, want = laserscan.read_kitti_label(lab), J.read_kitti_label(lab)
    assert_items_equal([got], [want])
    assert got.max() < 300  # the instance bits are gone
    assert_items_equal([laserscan.apply_learning_map(got)],
                       [J.apply_learning_map(want)])
    assert_items_equal(
        laserscan.load_semantic_kitti_pair_frame(str(tmp_path), 8, 7),
        J.load_semantic_kitti_pair_frame(str(tmp_path), 8, 7))


# ---- matches -------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["one_side_matches", "mutual_matches"])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_equal_jax(fn, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-6, 6, (3000, 3)).astype(np.float32)
    a = np.radians(rng.uniform(-40, 40))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = rng.uniform(-2, 2, 3)
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(0, 0.08, src.shape)).astype(np.float32)
    tgt = tgt[rng.permutation(len(tgt))[:2500]]
    got = getattr(matching_host, fn)(src, tgt, T, 0.15)
    want = getattr(J, fn)(src, tgt, T, 0.15)
    assert len(want) > 500
    assert_items_equal([got], [want])


# ---- SEM -------------------------------------------------------------------------

def _lidar_pair(seed=3):
    return make_pair(SceneConfig(extent=10.0, ground_points=3000,
                                 structure_points=4000, n_boxes=6, n_walls=2,
                                 n_poles=3, observe_mode="lidar",
                                 baseline=4.0, azimuth_bins=600,
                                 elevation_bins=32),
                     max_rotation_deg=30, max_translation=2.0, seed=seed)


@pytest.mark.parametrize("mode", ["voxel", "patch", "oracle"])
def test_sem_modes_equal_jax(mode):
    pair = _lidar_pair()
    kw = dict(num_points=12000, mode=mode, seed=5)
    extra = {}
    if mode == "oracle":
        extra = dict(scene_pts=pair["scene_pts"], scene_seg=pair["scene_seg"])
    got = sem.equalize_sampling(pair["src_pts"], pair["src_seg"],
                                sem.SEMConfig(**kw), **extra)
    want = J.equalize_sampling(pair["src_pts"], pair["src_seg"],
                               J.SEMConfig(**kw), **extra)
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[0].shape == (12000, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert_items_equal([got[1]], [want[1]])
    assert (got[1] > 0).mean() > 0.9


def test_sem_config_fields_equal_jax():
    from dataclasses import asdict

    assert asdict(sem.SEMConfig()) == asdict(J.SEMConfig())
    with pytest.raises(ValueError, match="scene_pts"):
        sem.equalize_sampling(np.zeros((10, 3), np.float32),
                              np.ones(10, np.int32),
                              sem.SEMConfig(mode="oracle"))


# ---- datasets -----------------------------------------------------------------

def _scene(seed, **kw):
    return make_pair(SceneConfig(extent=15.0, ground_points=4000,
                                 structure_points=6000, n_boxes=8, n_walls=3,
                                 n_poles=4, **kw), seed=seed)


def _write_scan(path, pts):
    arr = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    arr.astype(np.float32).tofile(path)


def write_kitti_tree(base, n_pairs=2):
    """KITTI-layout scans for the first n_pairs of kitti/test: each pair's
    target is its scene's target scan moved by the registry's ground
    truth (the JAX package's tests/test_data.py fixture)."""
    reg = J.load_registry("kitti", "test", skip_invalid_entries=False)
    for i in range(n_pairs):
        seq, f0, f1 = (int(x) for x in reg.pairs[i])
        gt = reg.gt_tforms[i]
        scene = _scene(2 + i)
        d = base / f"{seq:02d}"
        (d / "velodyne").mkdir(parents=True, exist_ok=True)
        (d / "labels").mkdir(parents=True, exist_ok=True)
        tgt = ((scene["tgt_pts"] - scene["gt_tform"][:3, 3])
               @ scene["gt_tform"][:3, :3])
        tgt = (tgt @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        for fid, pts, seg in [(f0, scene["src_pts"], scene["src_seg"]),
                              (f1, tgt, scene["tgt_seg"])]:
            _write_scan(d / "velodyne" / f"{fid:06d}.bin", pts)
            # raw ids: 9 -> 40 (road), else 10 (car); 0 stays unlabeled
            raw = np.where(seg == 9, 40, np.where(seg == 0, 0, 10))
            raw.astype(np.uint32).tofile(d / "labels" / f"{fid:06d}.label")
    return str(base)


def write_nuscenes_tree(base, split="test", n_pairs=1):
    """nuScenes-exported layout for the first n_pairs of nuscenes/{split}:
    string log names, .npy labels, and points inside the ego box."""
    reg = J.load_registry("nuscenes", split, skip_invalid_entries=False)
    rng = np.random.default_rng(11)
    for i in range(n_pairs):
        seq, f0, f1 = reg.pairs[i]
        gt = reg.gt_tforms[i]
        scene = _scene(7 + i)
        d = base / ("test" if split == "rotnuscenes" else split) / \
            "sequences" / str(seq)
        (d / "velodyne").mkdir(parents=True, exist_ok=True)
        (d / "labels").mkdir(parents=True, exist_ok=True)
        tgt = ((scene["tgt_pts"] - scene["gt_tform"][:3, 3])
               @ scene["gt_tform"][:3, :3])
        tgt = (tgt @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        for fid, pts, seg in [(int(f0), scene["src_pts"], scene["src_seg"]),
                              (int(f1), tgt, scene["tgt_seg"])]:
            ego = rng.uniform([-2.5, -1.0, -1.0], [2.5, 1.0, 1.0], (200, 3))
            pts = np.concatenate([pts, ego.astype(np.float32)])
            _write_scan(d / "velodyne" / f"{fid:06d}.bin", pts)
            np.save(d / "labels" / f"{fid:06d}.npy",
                    np.concatenate([seg, np.ones(200, seg.dtype)]
                                   ).astype(np.uint8))
    return str(base)


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    return write_kitti_tree(tmp_path_factory.mktemp("kitti") / "sequences")


def _pair(kind, **kw):
    cls = {"kitti": (datasets.SemanticKITTIDataset, J.SemanticKITTIDataset),
           "nuscenes": (datasets.NuscenesDataset, J.NuscenesDataset)}[kind]
    return (cls[0](**kw, aug_rng=np.random.default_rng(9)),
            cls[1](**kw, aug_rng=np.random.default_rng(9)))


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "raw_points"])
def test_kitti_preprocess_items_equal_jax(kitti_tree, grid):
    got, want = _pair("kitti", data_path=kitti_tree, split="test",
                      dataset_size=2, convert_points_to_grid=grid)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_items_equal(got[i], want[i])
        assert len(got[i][8]) > 50


@pytest.mark.parametrize("aug", [False, True], ids=["cached", "augmented"])
def test_kitti_cached_items_equal_jax(kitti_tree, tmp_path, aug):
    cache = str(tmp_path / "cache")
    src, _ = _pair("kitti", data_path=kitti_tree, split="test",
                   dataset_size=2)
    for i in range(2):
        datasets.save_pair_pickle(src.cache_file(i, cache),
                                  dict(zip(datasets.PAIR_KEYS,
                                           src.preprocess_getitem(i))))
    got, want = _pair("kitti", data_path=kitti_tree, split="test",
                      cache_data_path=cache, dataset_size=2,
                      use_augmentations=aug)
    for i in range(2):
        assert_items_equal(got[i], want[i])
    if not aug:
        assert_items_equal(got[0], src.preprocess_getitem(0))


def test_cache_pickles_read_across_the_packages(kitti_tree, tmp_path):
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    src, jsrc = _pair("kitti", data_path=kitti_tree, split="test",
                      dataset_size=1)
    item = src.preprocess_getitem(0)
    datasets.save_pair_pickle(src.cache_file(0, mine),
                              dict(zip(datasets.PAIR_KEYS, item)))
    jds.save_pair_pickle(src.cache_file(0, theirs),
                         dict(zip(datasets.PAIR_KEYS,
                                  jsrc.preprocess_getitem(0))))
    for cache in (mine, theirs):
        got, want = _pair("kitti", data_path=kitti_tree, split="test",
                          cache_data_path=cache, dataset_size=1)
        assert_items_equal(got[0], item)
        assert_items_equal(want[0], item)
    a = datasets.load_pair_pickle(src.cache_file(0, mine))
    b = J.load_pair_pickle(src.cache_file(0, theirs))
    assert list(a) == list(b) == list(datasets.PAIR_KEYS)


def test_cached_mode_skips_invalid_entries_only_with_a_cache(kitti_tree):
    pre, jpre = _pair("kitti", data_path=kitti_tree, split="test")
    cached, jcached = _pair("kitti", data_path=kitti_tree, split="test",
                            cache_data_path="unused")
    raw, jraw = _pair("kitti", data_path=kitti_tree, split="test",
                      cache_data_path="unused", override_cache=True)
    assert (len(pre), len(cached), len(raw)) == (1476, 1475, 1475)
    assert (len(jpre), len(jcached), len(jraw)) == (1476, 1475, 1475)
    assert raw.cache_data_path == "" and cached.cache_data_path == "unused"


@pytest.mark.parametrize("split", ["test", "rotnuscenes"])
def test_nuscenes_items_equal_jax(tmp_path, split):
    base = write_nuscenes_tree(tmp_path / "nusc", split)
    got, want = _pair("nuscenes", data_path=base, split=split,
                      dataset_size=1)
    seq, f0, f1 = got._pair_key(0)
    assert isinstance(seq, str) and seq.startswith("n0")
    pts, seg = got._load_frame(seq, f0)
    kept, _ = got._post_load_filter(pts, seg)
    assert len(pts) - len(kept) >= 200  # the ego box is gone
    assert_items_equal(got[0], want[0])
    cache = str(tmp_path / "cache")
    datasets.save_pair_pickle(got.cache_file(0, cache),
                              dict(zip(datasets.PAIR_KEYS, got[0])))
    assert got.cache_file(0, cache).endswith(
        os.path.join(split, seq, f"{f0:06d}_{f1:06d}.pickle"))
    for aug in (False, True):
        g, w = _pair("nuscenes", data_path=base, split=split,
                     cache_data_path=cache, dataset_size=1,
                     use_augmentations=aug)
        assert_items_equal(g[0], w[0])


def test_sem_preprocess_mode_equals_jax(kitti_tree):
    cfg = dict(num_points=8000)
    got = datasets.SemanticKITTIDataset(
        data_path=kitti_tree, split="test", dataset_size=1,
        use_pc_completion=True, sem_config=sem.SEMConfig(**cfg))
    want = J.SemanticKITTIDataset(
        data_path=kitti_tree, split="test", dataset_size=1,
        use_pc_completion=True, sem_config=J.SEMConfig(**cfg))
    assert_items_equal(got[0], want[0])


# ---- collate -------------------------------------------------------------------

@pytest.mark.parametrize("cap,matches", [(4096, 128), (20000, 100000)])
def test_collate_fixed_equals_jax(kitti_tree, cap, matches):
    dset = datasets.SemanticKITTIDataset(data_path=kitti_tree, split="test",
                                         dataset_size=2)
    samples = [dset[0], dset[1]]
    got = collate.collate_fixed(samples, cap, matches,
                                np.random.default_rng(2))
    want = J.collate_fixed(samples, cap, matches, np.random.default_rng(2))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["match_mask"].any()
