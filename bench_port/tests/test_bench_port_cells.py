"""Each cell end to end at a tiny size on the CPU (the plain versions):
one contract line; on the CPU the program and the reference run the same
plain code, so every compared number reads 0."""
import pytest

from bench_port_checkout import TINY, cpu_run

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_one_contract_line(checkout, cell, trace):
    rc, line, err = cpu_run(checkout, cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    checks = line["checks"]
    if "serve" in cell:
        # the reference agrees with the port's CPU path: the same bits
        assert all(c["value"] == 0.0 for c in checks.values()), checks
    else:
        # the same forward; the reference's pair-by-pair backward adds the
        # gradients in another order
        assert checks["loss1_rel_gap"]["value"] < 1e-5, checks
        assert checks["pw_loss1_rel_gap"]["value"] < 1e-5, checks
    import json
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= mine
    if not trace:
        assert set(line["metrics"]) == mine
    else:
        assert "busy_s" in line["device"] and "window_s" in line["device"]


def test_no_card_no_result(checkout):
    """Without a card (and without --device cpu) the run exits non-zero
    and prints nothing on standard output."""
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "resunetsmall2.serve-kitti-b8", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=checkout,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bench_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and bench_port: no result."""
    import shutil

    from bench_port_checkout import REPO, run

    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    rc, line, _ = run(tmp_path, "--workload", "resunetsmall2.serve-kitti-b8",
                      "--seed", "1", "--seconds", "1", "--device", "cpu",
                      "--workers", "1")
    assert rc != 0 and line is None
