"""The comparison that decides `correct` fails what it must: the control
(the reference in the program's place, its backbone in fp8, the next
precision below the configuration's bf16) and each fault the cells can
have, the timed path broken underneath a run that skips the look for a
card. Tiny cells held to their real cells' limits."""
import pytest

from bench_port_checkout import cpu_run

CASES = [
    ("resunetsmall2.tiny-serve", ["--control", "float8_e4m3fn"]),
    ("resunetsmall2.tiny-serve", ["--fault", "half_batch"]),
    ("resunetsmall2.tiny-serve", ["--fault", "altered"]),
    ("resunetsmall2.tiny-train", ["--control", "float8_e4m3fn"]),
    ("resunetsmall2.tiny-train", ["--fault", "half_batch"]),
    ("resunetsmall2.tiny-train", ["--fault", "unchanged"]),
    ("resunet.tiny-train", ["--control", "float8_e4m3fn"]),
    ("resunet.tiny-train", ["--fault", "half_batch"]),
    ("resunet.tiny-train", ["--fault", "unchanged"]),
]


@pytest.mark.parametrize("cell,extra", CASES,
                         ids=[f"{c}{' '.join(e)}" for c, e in CASES])
def test_broken_path_is_not_correct(checkout, cell, extra):
    rc, line, err = cpu_run(checkout, cell, *extra)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
