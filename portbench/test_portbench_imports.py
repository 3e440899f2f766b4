"""Nothing the benchmark runs imports JAX or the JAX package, by the
top-level module name compared whole (``bipk_tpu_torch`` is the measured
package); the reference imports nothing of the measured package."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "bipk_tpu"}


@pytest.mark.parametrize("path", sorted(p for p in (HERE / "reference").rglob("*.py")
                                       if "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_is_independent(path):
    assert not top_level_imports(path) & {"bipk_tpu_torch", "bipk_tpu"}
    assert "bipk_tpu" not in path.read_text()
