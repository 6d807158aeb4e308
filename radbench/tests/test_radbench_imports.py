"""What the harness may import and read: no JAX, no JAX package, a
reference that imports nothing of the program, and nothing read from the
JAX package's benchmark folder."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]  # radbench/
FORBIDDEN = {"jax", "jaxlib", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported_names(tree):
    """Top-level names of every import, and of every ``import_module`` or
    ``__import__`` call with a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    # names compared whole: ``repro_torch`` is the port, ``repro`` the JAX package
    found = set(imported_names(ast.parse(path.read_text()))) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported_names(ast.parse(path.read_text())))
    assert "repro_torch" not in names and not names & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmark_folder(path):
    # this file names the folder to look for it, so it is left out
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if s.rstrip("/") == "benchmarks" or "benchmarks/" in s
                or s.startswith("benchmarks.")]


def test_the_checks_catch_what_they_look_for():
    bad = ast.parse("import jax.numpy\nfrom repro.core import x\n"
                    "importlib.import_module('jaxlib.xla')\nimport repro_torch\n")
    assert set(imported_names(bad)) == {"jax", "repro", "jaxlib", "repro_torch"}
