"""Nothing the harness or the reference imports is jax, jaxlib, flax or the
JAX package (top-level names compared whole); the reference imports
nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuvof"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def imported_top_levels(path: Path) -> set[str]:
    """Top-level module names a file imports; a relative import that
    leaves its package reads as '..'."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            elif node.level > 1:
                names.add("..")
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert names <= {"__future__", "base64", "numpy", "torch"}, names


def test_run_loads_no_jax_module():
    """A whole small run on the CPU, then sys.modules holds none of them."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(BENCH / "tests")!r})
from held_cells import load_any_cell
from portbench.harness import run_cell
from portbench.run import forbidden_modules
cell = load_any_cell("dambreak2d-512.cli")
cell.config = dict(cell.config, nx=16, ny=16)
cell.traffic = dict(cell.traffic, steps=4, frame_every=2, trace_frames=1)
run_cell(cell, 3, 0.01, True, "cpu", time.time())
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
