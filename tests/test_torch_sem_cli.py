"""The port's SEM preprocessing CLI and nuScenes exporter against the JAX
package's: the CLI writes the reference cache layout, resumes (a second
run writes nothing), honours --range_idxs, and its pickles equal the JAX
CLI's; the exporter writes the same KITTI-layout tree behind the
stand-in devkit of tests/test_nuscenes_export.py and raises ImportError
without one."""
import os
import sys

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (single-threaded torch)
from test_nuscenes_export import _install_fake_devkit
from test_torch_data import assert_items_equal, write_kitti_tree
from umeregrobust_tpu.cli import sem_preprocessing as jcli
from umeregrobust_tpu.data import load_pair_pickle as jload
from umeregrobust_tpu_torch.cli import sem_preprocessing as cli
from umeregrobust_tpu_torch.data import datasets

KEYS = datasets.PAIR_KEYS


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kitti_tree(tmp_path_factory.mktemp("kitti") / "sequences",
                            n_pairs=3)


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


def _run(main, tree, out, lo, hi, capsys):
    main(["--dataset_mode", "kitti", "--split", "test", "--data_path", tree,
          "--output_path", out, "--range_idxs", str(lo), str(hi)])
    return capsys.readouterr().out


def test_cli_writes_resumes_and_honours_the_range(tree, tmp_path, capsys):
    out = str(tmp_path / "cache")
    assert "wrote 1 pairs" in _run(cli.main, tree, out, 1, 2, capsys)
    assert _files(out) == ["test/08/000157_000164.pickle"]
    assert "wrote 0 pairs" in _run(cli.main, tree, out, 1, 2, capsys)
    assert "wrote 1 pairs" in _run(cli.main, tree, out, 0, 2, capsys)
    assert _files(out) == ["test/08/000150_000156.pickle",
                           "test/08/000157_000164.pickle"]
    blob = datasets.load_pair_pickle(os.path.join(out, _files(out)[0]))
    assert list(blob) == list(KEYS)
    assert blob["src_pts"].shape[1] == 3 and len(blob["matches"]) > 0


def test_cli_pickles_equal_the_jax_clis(tree, tmp_path, capsys):
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    assert "wrote 2 pairs" in _run(cli.main, tree, mine, 1, 3, capsys)
    assert "wrote 2 pairs" in _run(jcli.main, tree, theirs, 1, 3, capsys)
    assert _files(mine) == _files(theirs)
    for rel in _files(mine):
        a = datasets.load_pair_pickle(os.path.join(mine, rel))
        b = jload(os.path.join(theirs, rel))
        assert list(a) == list(b)
        assert_items_equal([a[k] for k in KEYS], [b[k] for k in KEYS])
    # the cache reads the same through either package's dataset
    import umeregrobust_tpu.data as J

    for cache in (mine, theirs):
        got = datasets.SemanticKITTIDataset(tree, "test",
                                            cache_data_path=cache,
                                            dataset_size=3)
        want = J.SemanticKITTIDataset(tree, "test", cache_data_path=cache,
                                      dataset_size=3)
        assert_items_equal(got[2], want[2])


def test_exporter_equals_jax_behind_the_stand_in_devkit(tmp_path,
                                                        monkeypatch):
    nusc_dir = str(tmp_path / "nusc")
    mods, sweeps, seg = _install_fake_devkit(nusc_dir)
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    from umeregrobust_tpu.data.nuscenes_export import (
        export_nuscenes_to_kitti as jexport)
    from umeregrobust_tpu_torch.data.nuscenes_export import (
        _KITTI_TO_NU, export_nuscenes_to_kitti)

    for split in ("train", "test"):
        mine, theirs = str(tmp_path / f"m_{split}"), str(tmp_path / f"t_{split}")
        assert export_nuscenes_to_kitti(nusc_dir, mine, split=split) == \
            jexport(nusc_dir, theirs, split=split) == ["log-0001"]
        assert _files(mine) == _files(theirs)
        for rel in _files(mine):
            a, b = (open(os.path.join(r, rel), "rb").read()
                    for r in (mine, theirs))
            assert a == b, rel
        base = os.path.join(mine, split, "sequences", "log-0001")
        pts = np.fromfile(os.path.join(base, "velodyne", "000001.bin"),
                          np.float32).reshape(-1, 4)
        np.testing.assert_allclose(pts[:, :3], (_KITTI_TO_NU.T @ sweeps[1][:3]).T,
                                   rtol=1e-6)
        labels = os.path.join(base, "labels", "000000.npy")
        assert os.path.exists(labels) == (split != "test")


def test_exporter_without_devkit_raises_importerror(monkeypatch):
    for name in list(sys.modules):
        if name.startswith("nuscenes") or name == "pyquaternion":
            monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    from umeregrobust_tpu_torch.data.nuscenes_export import (
        export_nuscenes_to_kitti)

    with pytest.raises(ImportError, match="nuscenes-devkit"):
        export_nuscenes_to_kitti("/nonexistent", "/nonexistent/out")
