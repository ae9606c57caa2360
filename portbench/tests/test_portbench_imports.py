"""Nothing of the benchmark loads JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import harness

SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE_MAY = {"torch", "numpy", "math", "__future__"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_anywhere(path):
    for name, level in _imports(path):
        if level == 0:
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, name)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        if level == 0:
            assert name.split(".")[0] in REFERENCE_MAY, (path, name)
        else:
            assert level == 1, (path, name)  # its own package only


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "crossclr_tpu_torch_like", object())
    assert "crossclr_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax"]


BLOCKED_RUN = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "crossclr_tpu"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
from portbench.tests import tiny
from portbench import harness
results = [tiny.run(n, trace=True) for n in tiny.CELLS]
assert harness.forbidden_loaded() == [], harness.forbidden_loaded()
print(json.dumps([r["correct"] for r in results]))
"""


def test_cells_run_with_jax_blocked():
    script = BLOCKED_RUN.replace("ROOT", repr(str(harness.ROOT)))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=900, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[true, true]"
