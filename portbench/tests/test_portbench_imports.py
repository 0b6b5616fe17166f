"""Nothing of the benchmark imports JAX or the JAX package, and nothing
of the reference imports the port: top-level module names compared
whole (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)


def test_names_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    from portbench import run
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["jax"]
