"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and entries only: the harness finds each
by its name."""
import json
import shutil

from bench_port_checkout import cpu_run


def test_new_config_mix_cell_metric_found_by_name(checkout):
    b = checkout / "bench_port"
    conf = json.loads((b / "configs" / "resunetsmall2.json").read_text())
    conf["weights"] = {"serve": "seeded", "train": "seeded"}
    (b / "configs" / "small2seeded.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "tiny-serve-kitti-b8.json").read_text())
    mix["batch"] = 3
    (b / "traffic" / "tiny-b3.json").write_text(json.dumps(mix))
    (b / "metrics" / "spans_ms.added.py").write_text(
        "def read(rec):\n"
        "    return 1e3 * sum(b - a for _, a, b in rec.spans) / rec.units\n")
    cell = "small2seeded.tiny-b3"
    shutil.copy(b / "limits" / "resunetsmall2.tiny-serve.json",
                b / "limits" / f"{cell}.json")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small2seeded", "source": "x",
                             "file": "bench_port/configs/small2seeded.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "small2seeded",
                               "traffic": "tiny-b3", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "pairs_per_s" == m["name"]:
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "spans_ms.added", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "Entry", "moves": "pairs_per_s",
                               "workloads": [cell]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = cpu_run(checkout, cell, trace=0)
    assert rc == 0, err[-3000:]
    assert line["attempted"] % 3 == 0
    assert set(line["metrics"]) == {"pairs_per_s", "peak_mem_gib", "setup_s"}
    rc, line, err = cpu_run(checkout, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert list(line["metrics"]) == ["spans_ms.added"]
    assert line["metrics"]["spans_ms.added"]["value"] > 0
