"""Nothing a run loads has the top-level name jax, jaxlib, flax or the
JAX package's; the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "umeregrobust_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for p in BENCH.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(p)), p


def test_reference_and_generators_import_nothing_of_the_program():
    for sub in ("portref", "gen"):
        for p in (BENCH / sub).rglob("*.py"):
            assert "umeregrobust_tpu_torch" not in set(_imports(p)), p


def test_a_run_loads_no_jax(checkout):
    code = (
        "import sys, runpy\n"
        "sys.argv = ['bench_port/run.py', '--workload',"
        " 'resunetsmall2.tiny-serve', '--seed', '3', '--seconds', '1',"
        " '--device', 'cpu', '--workers', '1']\n"
        "runpy.run_path('bench_port/run.py', run_name='__main__')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        f"assert not top & {set(FORBIDDEN)!r}, top\n"
        "assert 'umeregrobust_tpu_torch' in top\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, 'bench_port')\n"
            "import portref.pipeline.e2e, portref.train.trainer, gen.pairs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('umeregrobust_tpu_torch', 'umeregrobust_tpu', 'jax')]\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
