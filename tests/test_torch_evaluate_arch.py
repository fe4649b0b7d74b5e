"""The evaluate CLI's model loading: the network is the one ARCHS entry
whose parameter names and shapes the checkpoint holds (smoke mode stays
ResUNetSmall2), refused where none or several match, with the level
capacities following the arch; and TrainConfig's level ratios held to the
arch's level count."""
import argparse

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from test_torch_cli import SMALL
from umeregrobust_tpu_torch.cli import evaluate as ev
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, ArchSpec, default_level_capacities, init_resunet)
from umeregrobust_tpu_torch.models.weights import params_to_jax
from umeregrobust_tpu_torch.train.checkpoint import save_checkpoint
from umeregrobust_tpu_torch.train.trainer import TrainConfig, _capacities

WEIGHTS = "weights/synthetic_pretrain.pkl"
# ResUNet's structure (k7 stem, stride 4, k5 strided layers, 'BN' blocks)
# at an eighth of its widths: a stand-in for its 1.5 GB of weights
NARROW = ArchSpec((4, 8, 16, 32, 64, 128), (16, 16, 32, 32, 64, 64),
                  (7, 5, 5, 5, 5, 5), (1, 4, 2, 2, 2, 3), "BN")


@pytest.fixture
def narrow_ckpt(tmp_path, monkeypatch):
    """A .pkl checkpoint of NARROW, put into ARCHS as "ResUNetNarrow"."""
    monkeypatch.setitem(ARCHS, "ResUNetNarrow", NARROW)
    model = init_resunet(NARROW, 1, 32, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    params, state = params_to_jax(model)
    path = str(tmp_path / "narrow.pkl")
    save_checkpoint(path, params=params, bn_state=state, opt_state={},
                    epoch=0)
    return path, model


def _args(path):
    return argparse.Namespace(model_checkpoint_path=path, out_ch=32)


@pytest.mark.parametrize("which", ["ResUNetSmall2", "ResUNetNarrow"])
def test_a_checkpoint_loads_as_its_arch(which, narrow_ckpt, capsys):
    path, model = narrow_ckpt
    if which == "ResUNetSmall2":
        path = WEIGHTS
    arch, got = ev._load_model(_args(path), "cpu")
    assert arch == ARCHS[which] and got.arch == ARCHS[which]
    assert f"loaded checkpoint: {path}" in capsys.readouterr().out
    if which == "ResUNetNarrow":
        want = model.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_smoke_mode_is_resunetsmall2(capsys):
    arch, model = ev._load_model(_args("no/such.pkl"), "cpu")
    assert arch == ARCHS["ResUNetSmall2"] == model.arch
    assert "smoke mode" in capsys.readouterr().out


def test_every_archs_entry_matches_itself_alone():
    """Each entry's own parameters name that entry and no other (the
    per-entry check the loader runs, on meta tensors)."""
    for name, arch in ARCHS.items():
        with torch.device("meta"):
            sd = ev.ResUNet(arch, 1, 32).state_dict()
        params = {k: np.zeros(v.shape, np.float32) for k, v in sd.items()}
        assert ev._arch_of(params, {}, 32) == arch, name


def test_an_ambiguous_checkpoint_is_refused(narrow_ckpt, monkeypatch):
    path, _ = narrow_ckpt
    monkeypatch.setitem(ARCHS, "ResUNetNarrowTwin", NARROW)
    with pytest.raises(ValueError, match="several") as e:
        ev._load_model(_args(path), "cpu")
    assert "ResUNetNarrow" in str(e.value) and "ResUNetNarrowTwin" in str(
        e.value)


@pytest.mark.parametrize("change", ["drop", "reshape", "out_ch"])
def test_an_unknown_checkpoint_is_refused(narrow_ckpt, tmp_path, change):
    path, model = narrow_ckpt
    params, state = params_to_jax(model)
    args = _args(str(tmp_path / "odd.pkl"))
    if change == "drop":
        del params["conv6"]
    elif change == "reshape":
        params["conv1"]["w"] = np.zeros((125, 1, 4), np.float32)  # a k5 stem
    else:
        args.out_ch = 16
    save_checkpoint(args.model_checkpoint_path, params=params,
                    bn_state=state, opt_state={}, epoch=0)
    with pytest.raises(ValueError, match="no ARCHS") as e:
        ev._load_model(args, "cpu")
    assert "ResUNetSmall2" in str(e.value)  # the candidates are named


def test_level_capacities_follow_the_arch():
    # ResUNetSmall2: the five ratios of the SEM cap, as before
    assert ev._level_caps(50000, ARCHS["ResUNetSmall2"]) == (
        50048, 37504, 20096, 10112, 4096)
    assert ev._level_caps(4096, ARCHS["ResUNetSmall2"]) == tuple(
        int(-(-int(4096 * r) // 128) * 128)
        for r in (1.0, 0.75, 0.4, 0.2, 0.08))
    for name in ("ResUNet", "ResUNet4", "ResUNetSmall"):
        assert ev._level_caps(50000, ARCHS[name]) == \
            default_level_capacities(50000, ARCHS[name])


def test_cli_registers_with_a_resunet_checkpoint(narrow_ckpt, monkeypatch,
                                                 capsys):
    """main() end to end on the CPU with the narrow ResUNet: its model,
    its capacities."""
    path, _ = narrow_ckpt
    seen = []
    real = ev.register_pair_e2e

    def spy(model, caps, *a, **k):
        seen.append((model.arch, caps))
        return real(model, caps, *a, **k)

    monkeypatch.setattr(ev, "register_pair_e2e", spy)
    argv = list(SMALL)
    argv[argv.index(f"model_checkpoint_path={WEIGHTS}")] = \
        f"model_checkpoint_path={path}"
    res = ev.main(argv)
    assert f"loaded checkpoint: {path}" in capsys.readouterr().out
    assert res["n_pairs"] == 1 and all(r["finite"] for r in res["per_pair"])
    assert seen == [(NARROW, default_level_capacities(4096, NARROW))]


@pytest.mark.parametrize("arch,n_ratios", [("ResUNet", 5), ("ResUNet", 7),
                                            ("ResUNetSmall2", 6)])
def test_train_capacities_refuse_a_ratio_count_off_the_levels(arch,
                                                              n_ratios):
    cfg = TrainConfig(arch=arch, level_capacity_ratios=(1.0,) * n_ratios)
    with pytest.raises(ValueError, match=f"{n_ratios} entries; {arch} has "
                       f"{len(ARCHS[arch].channels)} levels"):
        _capacities(cfg, ARCHS[arch])


def test_train_capacities_one_ratio_a_level():
    cfg = TrainConfig(max_pc_size=100000, level_capacity_ratios=(
        1.0, 0.12544, 0.0448, 0.01664, 0.0064, 0.00128))
    assert _capacities(cfg, ARCHS["ResUNet"]) == (
        100096, 12544, 4480, 1664, 640, 128)
    assert _capacities(TrainConfig(), ARCHS["ResUNetSmall2"]) == (
        16384, 12288, 6656, 3328, 1408)
