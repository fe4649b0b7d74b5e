"""harness/spans.py and trace_spans.py: a device event charged to the span
open when its launch call began (on any thread), the readers of
span_metrics/ on a made-up record, counters the program lacks read as
missing, and each tiny cell through trace_spans.py on the CPU (the span
and counter metrics non-null; the accepted readers read what run.py's
record reads)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import spans  # noqa: E402
from bench_port_checkout import TINY  # noqa: E402


def _record():
    # main thread: step.backward [0, 10], inside it nothing else; the
    # autograd thread launches k1 at t = 2 (kernel 3-4) and k2 at t = 9
    # (kernel 12-15, after the span closed); step.keypoints [20, 30]
    # launches k3 at 21 (kernel 22-24) and a copy at 25 (26-26.5); k4
    # has no launch call; k5 is launched at 40 with no span open
    dev = [("k1", 3.0, 4.0, 1), ("k2", 12.0, 15.0, 2), ("k3", 22.0, 24.0, 3),
           ("Memcpy HtoD (Pageable -> Device)", 26.0, 26.5, 4),
           ("k4", 27.0, 28.0, 5), ("k5", 41.0, 42.0, 6)]
    host = [("step.backward", 0.0, 10.0), ("step.keypoints", 20.0, 30.0)]
    calls = {1: 2.0, 2: 9.0, 3: 21.0, 4: 25.0, 6: 40.0}
    counters = {c: 3 for g in spans.COUNTERS["groups"].values() for c in g}
    rec = spans.SpanRecord(dev, host, calls, 50.0, {}, counters)
    rec.units, rec.pairs = 1, 2
    return rec


def test_kernels_are_charged_to_the_span_of_their_launch_call():
    rec = _record()
    assert rec.launched_by == ["step.backward", "step.backward",
                               "step.keypoints", "step.keypoints", None,
                               "none"]
    assert rec.launched_s("step.backward") == 4.0
    assert rec.launched_s("step") == 4.0 + 2.5
    assert rec.launched_n("step.keypoints") == 1  # copies left out
    a = rec.attribution()
    assert a["device_s"] == 8.5 and a["found_s"] == 7.5
    assert a["left"] == [["k4", 1.0]]
    rows = rec.by_span()
    assert rows["step.backward"]["device_s"] == 4.0
    assert rows["step.backward"]["idle_s"] == 8.0  # 4 -> 12, from t = 4
    assert rows["step.keypoints"]["kernels"] == 1
    assert rows["step.keypoints"]["dtoh"] == 0  # the copy is HtoD


def test_span_readers_on_a_made_up_record():
    import importlib.util

    rec = _record()

    def read(name):
        spec = importlib.util.spec_from_file_location(
            name, BENCH / "span_metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(rec)

    assert read("backward_device_ms.train") == 4000.0
    assert read("keypoints_device_ms.train") == 2500.0
    assert read("keypoints_ms.train") == 10000.0
    assert read("umes_device_ms.train") is None  # nothing launched there
    assert read("icp_blocks.serve") == 12.0  # 4 stages x 3
    assert read("icp_live_share.serve") == 100.0
    assert read("host_reads.train") == 3.0
    assert read("icp_exact_ms.serve") is None


def test_a_counter_the_program_lacks_reads_as_missing():
    assert spans._read("umeregrobust_tpu_torch.pipeline.icp:NOT_THERE") \
        is None
    assert spans._read("no_such_module:COUNTS[blocks.exact]") is None
    assert spans._read(
        "umeregrobust_tpu_torch.pipeline.icp:COUNTS[no_such_key]") is None
    rec = _record()
    rec.counters = dict(rec.counters)
    rec.counters[spans.COUNTERS["groups"]["host_reads"][0]] = None
    assert rec.count("host_reads") is None
    assert rec.count("icp.blocks") == 12


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cell_through_trace_spans(checkout, cell):
    p = subprocess.run(
        [sys.executable, "bench_port/trace_spans.py", "--workload", cell,
         "--seed", str(2 ** 33 + 5), "--seconds", "1", "--device", "cpu",
         "--workers", "2"], cwd=checkout, capture_output=True, text=True,
        timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    # no detail span's copy on a device row here: the same readings
    assert line["metrics"] == line["accepted_metrics"]
    detail = line["detail"]
    if "serve" in cell:
        for name in ("icp_exact_ms.serve", "icp_raw_ms.serve",
                     "icp_blocks.serve", "scoring_ms.serve"):
            assert detail[name] > 0, name
        assert 0 < detail["icp_live_share.serve"] <= 100
        assert detail["icp_kernels_per_pair.serve"] is None  # no card
    else:
        assert detail["keypoints_ms.train"] > 0
        assert detail["host_reads.train"] > 0
        for name in ("keypoints_device_ms.train", "umes_device_ms.train",
                     "backward_device_ms.train"):
            assert detail[name] is None  # no device events on the CPU
