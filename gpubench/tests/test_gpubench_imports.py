"""What the benchmark imports: no JAX, no JAX package, and a reference that
takes nothing from the program."""

import ast
import subprocess
import sys
from pathlib import Path

from gpubench import core

BENCH = core.BENCH


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules({"sctools_tpu_torch": 1, "sctools_tpu_torch.ops": 1, "jaxtyping": 1,
                                   "numpy": 1}) == []
    assert core.forbidden_modules({"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
                                   "sctools_tpu.ops": 1}) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                                              "sctools_tpu.ops"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        names = set(top_level_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "sctools_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(top_level_imports(path))
        assert names <= {"__future__", "gzip", "math", "struct", "typing", "zlib", "numpy", "torch"}, (path, names)


def test_the_generators_import_nothing_of_the_program():
    for path in (BENCH / "gen").rglob("*.py"):
        assert set(top_level_imports(path)) <= {"__future__", "struct", "zlib", "concurrent", "pathlib",
                                                "numpy"}, path


def test_the_port_loads_no_jax():
    """The port's modules that the cells drive, imported in a clean process
    (no site hooks), leave no JAX module behind."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import sctools_tpu_torch.fastqprocess, sctools_tpu_torch.metrics.gatherer, sctools_tpu_torch.gtf; "
            "from gpubench import core; print(core.forbidden_modules())") % str(core.ROOT)
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ":".join(p for p in sys.path if "site-packages" in p)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
