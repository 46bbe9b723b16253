"""What the benchmark's files import: never JAX, its libraries or the JAX
package (compared by whole top-level names), and in the reference nothing
of the program either."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

HARNESS = Path(__file__).resolve().parents[1]
FILES = sorted(HARNESS.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HARNESS)))
def test_portbench_no_jax(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_portbench_reference_imports_no_program(path):
    assert "hypelcnn_tpu_torch" not in _top_level_imports(path)


def test_portbench_forbidden_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hypelcnn_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hypelcnn_tpu.models", sys)
    assert harness.forbidden_modules() == ["hypelcnn_tpu"]
