"""Nothing the benchmark runs imports JAX, Flax, the JAX package or the old
benchmarks: by the top-level name of each module, compared whole (the
program's name, ``repro_torch``, begins with the JAX package's)."""

import ast
import subprocess
import sys

from conftest import BENCH
from harness.main import FORBIDDEN


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_them():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = set(_top_names(f)) & set(FORBIDDEN)
        assert not bad, (f, bad)


def test_a_run_loads_none_of_them():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}]\n"
        "import conftest\n"
        "from harness import main, prefill, train\n"
        "from harness.trace import Tracer\n"
        "for name, drv, mix in (('olmoe-1b-7b', prefill, 'prefill-split'),"
        " ('granite-3-2b', train, 'train-2k')):\n"
        "    drv.run(conftest.smoke_conf(name), conftest.smoke_mix(mix), 3,"
        " 0.2, Tracer(False), 'cpu', time.perf_counter())\n"
        "print(main.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "granite-3-2b.prefill-split", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
