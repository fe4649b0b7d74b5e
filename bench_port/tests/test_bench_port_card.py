"""On the card: a short run of each cell, correct, with the contract's
device fields (chip only; skips without a card)."""
import json

import pytest

from bench_port_checkout import REPO, run

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    rc, line, err = run(REPO, "--workload", cell, "--seed", str(2 ** 31 + 7),
                        "--seconds", "5", "--trace", "0", timeout=1200)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
