"""The port's MinkowskiEngine checkpoint converter against the JAX
package's: the golden fixture of tests/test_convert_fixture.py in both tap
orders through the port's sparse_conv; offset_permutation,
convert_state_dict and decide_me_order on a full ResUNetSmall2 state dict
in MinkowskiEngine key naming, built from the in-repo weights by the
inverse mapping (to_me_state_dict); a .pth round trip through the CLI's
_load_model gives the .pkl model's state dict exactly; a checkpoint that
needs arbitrary unpickling is refused."""
import argparse
import pickle

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from _torch_parity import WEIGHTS
from test_convert_fixture import _COORDS, _GOLDEN, _KERNEL, _expected
from umeregrobust_tpu.models import convert as jconvert
from umeregrobust_tpu_torch.cli import evaluate as ev
from umeregrobust_tpu_torch.models import convert
from umeregrobust_tpu_torch.ops.sparse import (
    build_self_map, sort_level, sparse_conv)

ORDERS = ("x_fastest", "z_fastest")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in got:
        assert isinstance(got[k], np.ndarray), k  # numpy leaves, no jnp
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def blob():
    with open(WEIGHTS, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("order", ORDERS)
def test_golden_fixture_through_the_ports_sparse_conv(order):
    params, _ = convert.convert_state_dict({"conv1.kernel": _KERNEL},
                                           me_order=order)
    coords = torch.from_numpy(_COORDS)
    level, perm, inv = sort_level(coords, torch.ones(5, dtype=torch.bool))
    nbr = build_self_map(level, kernel_size=3, t=1)
    out = sparse_conv(torch.ones(5, 1)[perm],
                      torch.from_numpy(params["conv1"]["w"]), nbr)
    got = out[inv][:, 0].numpy()
    np.testing.assert_allclose(got, _GOLDEN[order], atol=1e-5)
    np.testing.assert_allclose(_expected(order), _GOLDEN[order], atol=1e-5)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("k", [3, 5, 7])
def test_offset_permutation_equals_jax(k, order):
    got = convert.offset_permutation(k, order)
    np.testing.assert_array_equal(got, jconvert.offset_permutation(k, order))
    np.testing.assert_array_equal(got[got], np.arange(k ** 3))
    with pytest.raises(ValueError):
        convert.offset_permutation(k, "y_fastest")


@pytest.mark.parametrize("order", ORDERS)
def test_convert_state_dict_equals_jax_on_a_full_checkpoint(blob, order):
    sd = convert.to_me_state_dict(blob["params"], blob["bn_state"], order)
    assert "conv1.kernel" in sd and "norm1.bn.running_var" in sd
    assert "block1.norm1.bn.num_batches_tracked" in sd
    assert len(sd) == 111
    params, state = convert.convert_state_dict(sd, me_order=order)
    jparams, jstate = jconvert.convert_state_dict(sd, me_order=order)
    _assert_trees_equal(params, jparams)
    _assert_trees_equal(state, jstate)
    # the inverse mapping round-trips to the repository's weights
    _assert_trees_equal(params, blob["params"])
    _assert_trees_equal(state, blob["bn_state"])
    # tensors (a torch state dict) convert alike
    tparams, _ = convert.convert_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, order)
    _assert_trees_equal(tparams, params)


@pytest.mark.parametrize("order", ORDERS)
def test_decide_me_order_equals_jax(blob, order):
    sd = convert.to_me_state_dict(blob["params"], blob["bn_state"], order)
    assert convert.decide_me_order(sd) == jconvert.decide_me_order(sd)
    rng = np.random.default_rng(0)
    vol = (np.linspace(0, 1, 3)[None, None, :, None, None]
           * rng.standard_normal((1, 1, 3, 4, 4))
           + 0.05 * rng.standard_normal((3, 3, 3, 4, 4))).reshape(27, 4, 4)
    inv = np.argsort(convert.offset_permutation(3, order))
    flat = {"conv1.kernel": vol[inv] if order == "x_fastest" else vol}
    got = convert.decide_me_order(flat)
    assert got == jconvert.decide_me_order(flat) and got[0] == order


def test_unknown_keys_raise():
    with pytest.raises(KeyError, match="unhandled"):
        convert.convert_state_dict({"conv1.weird": np.zeros(3)})


def _save_pth(blob, path, wrap=True):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          convert.to_me_state_dict(blob["params"], blob["bn_state"]).items()}
    torch.save({"model_state_dict": sd, "epoch": 3} if wrap else sd, path)


@pytest.mark.parametrize("wrap", [True, False], ids=["checkpoint", "bare"])
def test_pth_round_trip_through_the_cli_loader(blob, tmp_path, capsys, wrap):
    path = tmp_path / "kitti_coloring_best_checkpoint.pth"
    _save_pth(blob, path, wrap)
    _, got = ev._load_model(argparse.Namespace(
        model_checkpoint_path=str(path), out_ch=32), "cpu")
    _, want = ev._load_model(argparse.Namespace(
        model_checkpoint_path=WEIGHTS, out_ch=32), "cpu")
    assert f"loaded checkpoint: {path}" in capsys.readouterr().out
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not got.training


class _Payload:
    def __reduce__(self):
        return (print, ("unpickled",))


def test_a_checkpoint_needing_arbitrary_unpickling_is_refused(tmp_path):
    path = tmp_path / "evil.pth"
    torch.save({"model_state_dict": {}, "extra": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError):
        convert.load_torch_checkpoint(str(path))
