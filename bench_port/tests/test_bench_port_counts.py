"""The roofline and mfu counts of small conv layers against counts by
hand, and the readers on a made-up record."""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import counts  # noqa: E402
from portref.ops.sparse import GroupedMap  # noqa: E402


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_per_tap_layer_by_hand():
    # 2 taps, 3 output rows, 4 input rows; entries: tap 0 -> rows 0, 1;
    # tap 1 -> rows 1, 3 and a miss: 4 entries, input rows {0, 1, 3}
    nbr = torch.tensor([[0, 1, -1], [-1, 1, 3]])
    w = torch.zeros(2, 5, 7)
    r = counts._layer(torch.zeros(4, 5), w, nbr)
    assert r["entries"] == 4 and r["in_rows"] == 3 and r["out_rows"] == 3
    assert r["ops"] == 2 * 4 * 5 * 7
    assert r["bytes"] == 4 * (3 * 5 + 3 * 7) + 2 * 2 * 5 * 7
    peaks = counts.PEAKS
    assert r["bound_s"] == max(r["ops"] / peaks["bf16_flops"],
                               r["bytes"] / peaks["hbm_bytes_per_s"])


def test_grouped_layer_by_hand():
    # one output row; group 0 slots 0 and 2 valid at centre 5 (input rows
    # 3 and 5), group 4 slot 1 at centre 2 (row 1) and a patho row (its
    # slot-1 row, 1, once more): 4 entries, input rows {1, 3, 5}
    masks = torch.zeros(9, 3, 1, dtype=torch.bool)
    masks[0, 0, 0] = masks[0, 2, 0] = masks[4, 1, 0] = True
    patho = torch.zeros(9, 1, dtype=torch.bool)
    patho[4, 0] = True
    center = torch.zeros(9, 1, dtype=torch.int64)
    center[0, 0], center[4, 0] = 5, 2
    g = GroupedMap(center, masks, patho, torch.tensor([0, 1, 2]))
    r = counts._layer(torch.zeros(6, 8), torch.zeros(27, 8, 16), g)
    assert r["kind"] == "grouped"
    assert r["entries"] == 4 and r["in_rows"] == 3 and r["out_rows"] == 1
    assert r["ops"] == 2 * 4 * 8 * 16
    assert r["bytes"] == 4 * (3 * 8 + 1 * 16) + 2 * 27 * 8 * 16


def test_training_counts_and_mfu_reader():
    layers = [{"kind": "grouped", "ops": 10.0, "bound_s": 1.0},
              {"kind": "pertap", "ops": 100.0, "bound_s": 2.0},
              {"kind": "dense", "ops": 1.0, "bound_s": 0.0}]
    assert counts.training_flops(layers) == 3 * 111 - 10
    assert counts.forward_flops(layers) == 111
    assert counts.family_bounds(layers, True) == {"grouped": 2.0,
                                                  "pertap": 6.0}
    assert counts.family_bounds(layers, False) == {"grouped": 1.0,
                                                   "pertap": 2.0}

    class Rec:
        peaks = counts.PEAKS
        model_flops = 989e12 * 0.5  # half a second of the bf16 peak a unit
        run_units, run_window_s = 4, 10.0

    assert reader("mfu.train")(Rec()) == pytest.approx(20.0)
    assert reader("mfu.serve")(Rec()) == pytest.approx(20.0)


def test_roofline_reader_reads_nothing_without_kernels():
    class Rec:
        bound_s = {"sparse_conv_grouped": 1.0}

        def family_s(self, fam):
            return 0.0

    assert reader("sparse_conv_grouped_roofline.serve")(Rec()) is None
