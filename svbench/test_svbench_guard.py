"""The benchmark imports neither JAX nor the JAX package, its reference
imports nothing of the program, and nothing of it reads ``benchmarks/``.

Top-level module names are compared whole: ``swiftvideo_tpu_torch`` (the
program under test) begins with ``swiftvideo_tpu`` (the JAX package).
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from svbench import cells
from svbench.conftest import tiny

HERE = cells.ROOT / "svbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "swiftvideo_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _strings(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "swiftvideo_tpu_torch" not in set(_imports(path))
    assert not any("swiftvideo_tpu" in s for s in _strings(path))


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmarks(path):
    assert not any("benchmarks" in Path(s).parts or s.startswith(
        "benchmarks.") for s in _strings(path))
    assert "benchmarks" not in set(_imports(path))


def test_the_whole_name_compare_tells_the_port_from_the_jax_package(
        monkeypatch):
    import types
    from svbench.run import FORBIDDEN as RUN_FORBIDDEN, forbidden_modules
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    clean = forbidden_modules()
    monkeypatch.setitem(sys.modules, "swiftvideo_tpu_torch.fake_probe",
                        types.ModuleType("probe"))
    assert forbidden_modules() == clean
    monkeypatch.setitem(sys.modules, "swiftvideo_tpu.fake_probe",
                        types.ModuleType("probe"))
    assert "swiftvideo_tpu" in forbidden_modules()


def test_a_run_loads_neither():
    """Drive every cell at a tiny size on the CPU in a fresh process and
    read its modules afterwards."""
    code = (
        "import json, sys\n"
        "from svbench import run, cells\n"
        f"tiny = {json.dumps({w['name']: tiny(w['name']) for w in cells.load_benchmark()['workloads']})}\n"
        "for w in tiny:\n"
        "    run.run_cell(w, 5, 0.2, True, device='cpu', overrides=tiny[w])\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
