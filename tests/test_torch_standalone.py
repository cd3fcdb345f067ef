"""The port stands alone: no file of `meilisearch_tpu_torch/` imports the
JAX package, jax, transformers, safetensors, sacremoses or `regex` (the
card's machine has neither of the last two: models/moses.py is the port's
own Moses, over Python's `re`), and every module of the port imports in a
process where none of them can be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "meilisearch_tpu_torch"
FORBIDDEN = ("meilisearch_tpu", "jax", "jaxlib", "flax", "transformers", "safetensors",
             "sacremoses", "regex")
FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py"))


def _imported(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, top-level package) of every absolute import in the tree,
    nested and lazy imports included."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            out.append((node.lineno, str(node.args[0].value).split(".")[0]))
    return out


@pytest.mark.parametrize("path", FILES)
def test_file_imports_neither_the_jax_package_nor_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [(line, mod) for line, mod in _imported(tree) if mod in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


CHILD = r'''
import importlib
import pkgutil
import sys

for name in ("meilisearch_tpu", "jax", "jaxlib", "flax", "transformers", "safetensors",
             "sacremoses", "regex"):
    sys.modules[name] = None  # import raises ImportError

import meilisearch_tpu_torch

names = [
    m.name
    for m in pkgutil.walk_packages(
        meilisearch_tpu_torch.__path__, "meilisearch_tpu_torch."
    )
]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names))
'''


def test_every_module_imports_without_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # every file but the package's own __init__ is a module walked
    assert f"IMPORTED {len(FILES) - 1}" in proc.stdout, proc.stdout
