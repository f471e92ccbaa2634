"""No module of the benchmark imports JAX or the JAX package; the reference imports
nothing of the program.  Top-level names are compared whole: tpul2_torch is not tpul2."""

import ast
import importlib.util
import sys

import pytest

from gemmbench.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "tpul2"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    assert "tpul2_torch" not in set(_imports(BENCH / "reference.py"))
    assert set(_imports(BENCH / "reference.py")) <= {"__future__", "math", "torch"}


def test_the_run_refuses_a_process_that_loaded_the_jax_package(monkeypatch):
    spec = importlib.util.spec_from_file_location("gemmbench_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpul2_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpul2.dispatch", object())
    assert run.forbidden_modules() == ["tpul2"]
