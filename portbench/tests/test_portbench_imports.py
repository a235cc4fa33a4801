"""What a run may import: no module under ``portbench/`` that a run loads
imports JAX or the JAX package (``memo_tpu``, whose name the port's begins
with, so top-level names are compared whole) or ``bench``; the reference
imports nothing but NumPy and PyTorch; and a rehearsal in a fresh interpreter that
refuses those modules runs to its result with none of them loaded."""

import ast
import json
import pathlib
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny

BENCH = tiny.REPO / "portbench"


def imported(path: pathlib.Path) -> set[str]:
    """The top-level names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def run_files() -> list[pathlib.Path]:
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_run_file_imports_jax_or_the_jax_package():
    files = run_files()
    assert len(files) > 10
    for path in files:
        assert not imported(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_numpy_and_torch_only():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "numpy", "torch"}, path


BLOCKED_RUN = """
import importlib.abc, json, pathlib, sys, time
FORBIDDEN = {forbidden!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
from portbench import harness
r = harness.run_cell(pathlib.Path({root!r}), "chr90.genes", 3, 0.3, True, "cpu", time.perf_counter())
print(json.dumps({{"correct": r["correct"], "loaded": harness.forbidden_modules()}}))
"""


def test_a_rehearsal_loads_none_of_them(tmp_path):
    root = tiny.copy(tmp_path)
    code = BLOCKED_RUN.format(forbidden=set(harness.FORBIDDEN), repo=str(tiny.REPO), root=str(root))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == {"correct": True, "loaded": []}
