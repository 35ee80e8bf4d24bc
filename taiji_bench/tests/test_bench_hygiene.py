"""The benchmark imports neither JAX nor the JAX package (``repro``, by its
whole top-level name: ``repro_torch`` is the program), and its plain
references import nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_its_package(path):
    bad = [m for m in imported(path) if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    bad = [m for m in imported(path) if m.split(".")[0] == "repro_torch"]
    assert not bad, bad
