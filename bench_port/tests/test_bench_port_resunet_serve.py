"""The ResUNet serving cell at a tiny size on the CPU: a cell of the
`resunet_kitti_test` configuration (the published widths, seeded
weights) under the tiny serving traffic, held to resunet.serve-kitti-b8's limits and
reporting its metrics, added to the temporary checkout as new files and
entries. The sound run prints one contract line with `correct` true (the
program's plain versions and the reference run the same code: every
compared number reads 0); the control and both serving faults read
false."""
import json
import shutil

import pytest

from bench_port_checkout import cpu_run

CELL = "resunet.tiny-serve"
REAL = "resunet.serve-kitti-b8"


@pytest.fixture(scope="module")
def resunet_checkout(checkout):
    b = checkout / "bench_port"
    shutil.copy(b / "limits" / f"{REAL}.json", b / "limits" / f"{CELL}.json")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    spec = {w["name"]: w for w in bench["workloads"]}[REAL]
    bench["workloads"].append(dict(spec, name=CELL,
                                   traffic="tiny-serve-kitti-b8"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return checkout


@pytest.mark.parametrize("trace", [0, 1])
def test_resunet_serve_prints_one_correct_line(resunet_checkout, trace):
    rc, line, err = cpu_run(resunet_checkout, CELL, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and list(line)[-1] == "checks"
    assert line["checks"] and all(
        c["value"] == 0.0 for c in line["checks"].values()), line["checks"]
    bench = json.loads((resunet_checkout / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind]
            if CELL in m.get("workloads", [CELL])}
    if trace:
        assert set(line["metrics"]) <= mine
        assert "pertap_conv_roofline.serve" in mine
        assert line["metrics"]["forward_ms.serve"]["value"] > 0
        assert line["metrics"]["geometry_ms.serve"]["value"] > 0
    else:
        assert set(line["metrics"]) == mine == {"pairs_per_s",
                                                "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("extra", [["--control", "float8_e4m3fn"],
                                   ["--fault", "half_batch"],
                                   ["--fault", "altered"]],
                         ids=["control", "half_batch", "altered"])
def test_resunet_serve_broken_path_is_not_correct(resunet_checkout, extra):
    rc, line, err = cpu_run(resunet_checkout, CELL, *extra)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
