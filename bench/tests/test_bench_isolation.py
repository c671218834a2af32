"""What the benchmark runs imports neither JAX, flax, the JAX package
(``repro``) nor ``benchmarks/``, and its reference imports nothing of the
program; top-level module names compared whole (``repro_torch`` is not
``repro``). Also: the entry point refuses to run without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_banned(path):
    assert not _imports(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    assert _imports(BENCH / "reference.py") <= {"__future__", "contextlib", "math", "typing",
                                                "numpy", "torch"}


def _python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}",
                                                **env))


def test_a_run_loads_nothing_banned():
    code = ("import sys, time\n"
            "from bench import harness\nfrom bench.tests import tiny\n"
            "out = harness.run(tiny.cell('granite-moe-fedveca'), 5, 0.2, True, 'cpu', "
            "time.perf_counter())\n"
            "assert out['result']['correct'], out['numbers']\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % BANNED)
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reference_alone_loads_no_program():
    res = _python("import sys, bench.reference\n"
                  "print(sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch'))")
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr[-2000:]


def test_entry_point_refuses_without_a_card():
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen05-fedveca",
                          "--seed", "3", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr
