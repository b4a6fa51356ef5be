"""The native layer's sanitizer builds and its pinned library.

- ``native.sanitize``: each leg (TSan, ASan, UBSan) builds the port's
  sources with the JAX package's sanitizer flags and passes
  ``tests/test_torch_native_threads.py`` under its runtime, loading the
  pinned build (that module's first test asserts it).
- ``SCTOOLS_TPU_TORCH_NATIVE_LIB``: a pinned file loads as it is and
  nothing is built; a missing file, a file that does not load and a
  library without the bound symbols raise, naming the path; the JAX
  package's variable does not reach the port.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sctools_tpu_torch import native
from sctools_tpu_torch.native import sanitize

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kind", sanitize.KINDS)
def test_leg_passes_the_threaded_tests(kind, capsys):
    assert sanitize.main([kind]) == 0
    out = capsys.readouterr().out
    assert f"[sanitize] {kind}: passed" in out
    assert re.search(r"\b9 passed\b", out) and "skipped" not in out and "failed" not in out, out
    assert sanitize.build(kind).name.startswith(f"libsctools_native.{kind}-")


def test_the_legs_module_loads_neither_jax_nor_torch():
    """What the threaded tests import, in a fresh interpreter: nothing of
    JAX, torch or the JAX package, whose runtimes the sanitizers would
    report."""
    probe = ("import sys; sys.path.insert(0, 'tests'); import test_torch_native_threads; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'torch', 'sctools_tpu'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("kind", sanitize.KINDS)
def test_flags_are_the_jax_makefiles(kind):
    """The JAX package's compile line for the kind (its Makefile), less its
    warnings and its `-fPIC`, which the release flags carry."""
    makefile = (REPO / "sctools_tpu" / "native" / "Makefile").read_text()
    name = {"tsan": "thread", "asan": "address", "ubsan": "undefined"}[kind]
    line = re.search(rf"-std=c\+\+17 (-O1 -g -fsanitize={name}[^$]*)-fPIC", makefile).group(1).split()
    ours = sanitize.flags(kind)
    assert ours[-len(line):] == line
    assert set(ours) - set(line) == set(native.CXX_FLAGS) - {"-O3"}


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="msan"):
        sanitize.flags("msan")
    with pytest.raises(SystemExit):
        sanitize.main(["msan"])


def test_leg_env_preloads_the_runtime_first(tmp_path):
    env = sanitize.leg_env("tsan", tmp_path / "lib.so")
    runtime, stdcxx = env["LD_PRELOAD"].split()
    assert runtime.endswith("libtsan.so") and "libstdc++.so" in stdcxx
    assert env[native.PIN_ENV] == str(tmp_path / "lib.so")
    assert f"suppressions={sanitize.SUPPRESSIONS}" in env["TSAN_OPTIONS"]
    assert "exitcode=66" in sanitize.leg_env("asan", tmp_path)["ASAN_OPTIONS"]
    assert "halt_on_error=1" in sanitize.leg_env("ubsan", tmp_path)["UBSAN_OPTIONS"]


@pytest.fixture
def unloaded(monkeypatch):
    """The module with no library loaded; the loaded one comes back after."""
    monkeypatch.setattr(native, "_lib", None)
    return monkeypatch


def test_pin_to_a_missing_file_raises_naming_it(unloaded, tmp_path):
    path = str(tmp_path / "nowhere.so")
    unloaded.setenv(native.PIN_ENV, path)
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        native.library()
    assert native.loaded_path() is None


def test_pin_loads_the_file_and_never_builds(unloaded, tmp_path):
    copy = tmp_path / "pinned.so"
    shutil.copy(native.ensure_built(), copy)

    def no_build(*args, **kwargs):
        raise AssertionError("a pinned library must not build")

    unloaded.setattr(native, "_build", no_build)
    unloaded.setattr(native, "ensure_built", no_build)
    unloaded.setenv(native.PIN_ENV, str(copy))
    native.library()
    assert native.loaded_path() == str(copy)
    assert native.format_csv_block(["a"], [[1]]) == b"a,1\n"


def test_pin_that_does_not_load_raises_naming_it(unloaded, tmp_path):
    bogus = tmp_path / "bogus.so"
    bogus.write_text("not a shared object")
    unloaded.setenv(native.PIN_ENV, str(bogus))
    with pytest.raises(RuntimeError, match=re.escape(str(bogus))):
        native.library()


def test_pin_without_the_symbols_raises_naming_it(unloaded, tmp_path):
    source = tmp_path / "other.cpp"
    source.write_text('extern "C" long scx_stream_next(void*, long n) { return n; }\n')
    other = tmp_path / "other.so"
    subprocess.run(["g++", "-shared", "-fPIC", str(source), "-o", str(other)], check=True)
    unloaded.setenv(native.PIN_ENV, str(other))
    with pytest.raises(RuntimeError, match=re.escape(str(other)) + ".*scx_stream_open"):
        native.library()


def test_the_jax_packages_variable_does_not_reach_the_port(unloaded, tmp_path):
    unloaded.delenv(native.PIN_ENV, raising=False)
    unloaded.setenv("SCTOOLS_TPU_NATIVE_LIB", str(tmp_path / "nowhere.so"))
    native.library()
    assert native.loaded_path() == str(native.library_path())
