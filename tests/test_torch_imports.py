"""The port stands alone: no module of ``sctools_tpu_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or pandas, every
``#include "..."`` of its C++ and CUDA sources names a file inside the
package, and every runner the scheduler resolves by name is a port module.

The card's machine has no JAX and no pandas, and the port keeps its own
copies of whatever it needs from the JAX package. The check reads each
file's syntax tree (every ``import`` and ``from ... import`` node, deferred
ones inside functions included) instead of importing the modules, since
importing proves nothing where JAX is already loaded.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "sctools_tpu", "pandas")
PACKAGE = REPO / "sctools_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
NATIVE_SOURCES = sorted(
    p for suffix in ("*.cpp", "*.h", "*.cu", "*.cuh") for p in PACKAGE.rglob(suffix)
    if "_build" not in p.parts
)
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


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


def quoted_includes(path: Path):
    """Each ``#include "..."`` of ``path`` with the file it resolves to
    (quoted includes resolve beside the including file)."""
    for name in _QUOTED_INCLUDE.findall(path.read_text()):
        yield name, (path.parent / name).resolve()


def test_the_include_scan_sees_quoted_includes(tmp_path):
    probe = tmp_path / "probe.cpp"
    probe.write_text('#include <zlib.h>\n  # include "a.h"\n#include "../b/c.h"\n')
    assert [name for name, _ in quoted_includes(probe)] == ["a.h", "../b/c.h"]


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=[str(p.relative_to(REPO)) for p in NATIVE_SOURCES])
def test_includes_resolve_inside_the_package(path):
    for name, target in quoted_includes(path):
        assert target.is_file() and PACKAGE in target.parents, f"{path.relative_to(REPO)} includes {name}"


def test_runner_targets_are_the_ports():
    """``sched.runners`` names its runners as import strings, which the
    syntax walk above does not read: each must be a port module."""
    from sctools_tpu_torch.sched.runners import RUNNERS, resolve

    assert RUNNERS
    for kind, target in RUNNERS.items():
        assert target.startswith("sctools_tpu_torch."), f"runner {kind!r} -> {target}"
        assert callable(resolve(kind))
