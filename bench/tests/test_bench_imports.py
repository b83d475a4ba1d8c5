"""What the benchmark's modules import, by whole top-level names: nothing
of JAX or of the JAX package (``repro``; the port, ``repro_torch``, only
begins with that name), and nothing of the program in the reference."""

import ast
from pathlib import Path

import pytest

from bench.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(path: Path):
    """Every module ``path`` imports, by its full dotted name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _imports(path: Path):
    return {name.split(".")[0] for name in _modules(path)}


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = list((BENCH / "reference").rglob("*.py"))
    assert ref
    for path in ref:
        assert "repro_torch" not in _imports(path), path
        # the harness drives the program: the reference uses only the
        # yardsticks beside it
        assert not [m for m in _modules(path)
                    if m.startswith("bench.") and not
                    m.startswith(("bench.yardstick", "bench.reference"))]
