"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (`paella_tpu_torch` is not `paella_tpu`), and
the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from bench_port.core.guard import FORBIDDEN  # noqa: E402

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "paella_tpu_torch" not in _imports(path) and "paella_tpu" not in _imports(path)
    assert not {t for t in _imports(path) if t.startswith("paella")}


def test_a_run_loads_no_jax():
    """A whole run at test size in a fresh process, then sys.modules."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(ROOT)!r}, {str(Path(__file__).parent)!r}]
import _tiny
from bench_port.core import guard, runner
for name in ("t2i-b1-fresh", "train-1b-b16"):
    runner.run_cell(_tiny.spec(name, f32=True), 5, 0.2, True, torch.device("cpu"), time.perf_counter())
print("FOUND", guard.loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "OMP_NUM_THREADS": "2"})
    assert "FOUND []" in out.stdout, out.stdout[-2000:] + out.stderr[-4000:]
