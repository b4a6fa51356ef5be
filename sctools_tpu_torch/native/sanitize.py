"""Sanitizer builds of the native layer, and the test legs that run them.

The port's counterpart of the JAX package's ``make ci-deep`` native legs
(``sctools_tpu/native/Makefile``'s ``tsan`` / ``asan`` / ``ubsan`` targets
and the repository Makefile's ``ci-deep`` recipe):

- ``build(kind)`` compiles the port's sources for ``kind`` in ``tsan``,
  ``asan`` or ``ubsan`` with the JAX package's flags (``-O1 -g
  -fsanitize=<kind>`` at compile and link, ``-fno-omit-frame-pointer`` for
  ASan, ``-fno-sanitize-recover=undefined`` for UBSan), by the release
  build's scheme (one g++ per source, then the link, under the ``fcntl``
  lock) into ``_build/libsctools_native.<kind>-<hash>.so``, the hash over
  the sources and the flags;
- ``run(kind)`` runs ``tests/test_torch_native_threads.py`` in a child
  Python under that build: the sanitizer runtime and libstdc++ (both as
  ``g++ -print-file-name`` resolves them) in ``LD_PRELOAD``, the runtime's
  options (TSan reads the suppressions of ``tsan.supp`` beside this file),
  and ``SCTOOLS_TPU_TORCH_NATIVE_LIB`` pinning the built file. The child
  runs pytest with ``--noconftest``: the repository's ``tests/conftest.py``
  imports JAX, whose uninstrumented runtime TSan would report, and the
  test module imports neither JAX nor torch. It runs with ``-s``: a
  runtime writes its report to stderr while a test runs, which pytest
  would otherwise capture and drop. A leg passes only when the child
  exits 0 (a TSan or ASan report exits 66, a UBSan report 1).

``python -m sctools_tpu_torch.native.sanitize {tsan,asan,ubsan,all}``
builds and runs the named legs, prints each leg's output, and exits 0 only
when every leg passed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

from . import CXX_FLAGS, PIN_ENV, ensure_built

KINDS = ("tsan", "asan", "ubsan")
_SANITIZE_FLAGS = {
    "tsan": ["-fsanitize=thread"],
    "asan": ["-fsanitize=address", "-fno-omit-frame-pointer"],
    "ubsan": ["-fsanitize=undefined", "-fno-sanitize-recover=undefined"],
}
_RUNTIMES = {"tsan": "libtsan.so", "asan": "libasan.so", "ubsan": "libubsan.so"}
SUPPRESSIONS = Path(__file__).resolve().parent / "tsan.supp"
REPO = Path(__file__).resolve().parent.parent.parent
TEST_MODULE = "tests/test_torch_native_threads.py"
LEG_TIMEOUT = 600  # seconds a leg's child may run


@dataclass
class Leg:
    """One leg's result: the child's exit code and its merged output."""

    kind: str
    returncode: int
    output: str
    seconds: float

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def flags(kind: str) -> List[str]:
    """The compile and link flags of a ``kind`` build: the release flags
    at ``-O1 -g`` with the sanitizer's."""
    if kind not in KINDS:
        raise ValueError(f"unknown sanitizer {kind!r}: one of {', '.join(KINDS)}")
    base = [flag for flag in CXX_FLAGS if not flag.startswith("-O")]
    return [*base, "-O1", "-g", *_SANITIZE_FLAGS[kind]]


def build(kind: str) -> Path:
    """The ``kind`` build of the native layer, compiled unless it is there."""
    return ensure_built(flags(kind), kind)


def runtime(name: str) -> Optional[str]:
    """The path ``g++ -print-file-name`` gives for ``name``, or None when
    g++ is missing or does not resolve it (it then echoes the bare name)."""
    compiler = shutil.which("g++")
    if compiler is None:
        return None
    found = subprocess.run([compiler, f"-print-file-name={name}"], capture_output=True,
                           text=True).stdout.strip()
    return found if os.path.isabs(found) and os.path.exists(found) else None


def leg_env(kind: str, library: Path) -> dict:
    """The child's environment for a ``kind`` leg over ``library``."""
    preload = [runtime(_RUNTIMES[kind]), runtime("libstdc++.so")]
    if None in preload:
        raise RuntimeError(f"g++ does not resolve {_RUNTIMES[kind]} and libstdc++.so: "
                           f"the {kind} leg needs both preloaded")
    env = dict(os.environ)
    env["LD_PRELOAD"] = " ".join(preload)  # the runtime first: it must initialize first
    env[PIN_ENV] = str(library)
    if kind == "tsan":
        env["TSAN_OPTIONS"] = f"report_bugs=1 exitcode=66 suppressions={SUPPRESSIONS}"
    elif kind == "asan":
        # LSan would report the uninstrumented interpreter's arenas at exit
        env["ASAN_OPTIONS"] = "detect_leaks=0 abort_on_error=0 exitcode=66"
    else:
        env["UBSAN_OPTIONS"] = "halt_on_error=1 print_stacktrace=1"
    return env


def run(kind: str) -> Leg:
    """Build the ``kind`` library and run the threaded native tests under it."""
    if not (REPO / TEST_MODULE).is_file():
        raise FileNotFoundError(f"{REPO / TEST_MODULE}: the sanitizer legs run the "
                                "repository's test module")
    env = leg_env(kind, build(kind))
    start = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", TEST_MODULE,
         "-q", "-s"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=LEG_TIMEOUT)
    return Leg(kind, child.returncode, child.stdout, time.perf_counter() - start)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.native.sanitize",
        description="Build the native layer under a sanitizer and run the threaded native "
        "tests under it. Exit 0 == every leg passed.")
    parser.add_argument("kind", choices=[*KINDS, "all"])
    args = parser.parse_args(argv)
    failed = []
    for kind in KINDS if args.kind == "all" else (args.kind,):
        leg = run(kind)
        print(leg.output, end="" if leg.output.endswith("\n") else "\n")
        print(f"[sanitize] {kind}: {'passed' if leg.ok else f'FAILED (exit {leg.returncode})'} "
              f"in {leg.seconds:.1f} s")
        if not leg.ok:
            failed.append(kind)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
