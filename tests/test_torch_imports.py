"""The port stands alone: no module of ``sctools_tpu_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or pandas.

The card's machine has no JAX and no pandas, and the port keeps its own
copies of whatever it needs from the JAX package. The check reads each
file's syntax tree (every ``import`` and ``from ... import`` node, deferred
ones inside functions included) instead of importing the modules, since
importing proves nothing where JAX is already loaded.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "sctools_tpu", "pandas")
SOURCES = sorted((REPO / "sctools_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    """(line, top-level module name) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_the_walk_sees_deferred_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import jax.numpy as jnp\n    from pandas import read_csv\n")
    assert list(imported_modules(probe)) == [(2, "jax"), (3, "pandas")]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_forbidden_import(path):
    bad = [(line, name) for line, name in imported_modules(path) if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
