"""Build and bind the port's hand-written CUDA kernels; count their launches.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` beside this
file (a directory git ignores), under a name that carries the hash of the
source, so an edited source is rebuilt and never shadowed by a stale
library. The library is bound with ``ctypes``: pointers and the stream go
over as ``c_void_p``, and the entry point returns ``cudaGetLastError()``,
which the caller turns into an exception with ``check``. A source may include
the toolkit's ``cuda.h`` for driver types such as ``CUtensorMap``; it then
fetches driver functions through ``cudaGetDriverEntryPoint``, so no library
links ``-lcuda`` and the flags below are all a build needs.

The build runs inside ``library``, never at import: the CPU tests import
every module, and the CPU machine has no nvcc.

``launches`` counts, per kernel, the launches its wrapper made; the wrapper
adds one where it launches the kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from .analysis.witness import make_lock
from .guard.watchdog import shielded

_PACKAGE = Path(__file__).resolve().parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

launches: Dict[str, int] = {"whitelist_correct": 0}

# the compiler's -Xptxas -v output (registers, shared memory, spills) of each
# kernel this process built
build_output: Dict[str, str] = {}

_lock = make_lock("kernels.loader")
_libraries: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def _library_path(name: str) -> Path:
    source = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> str:
    """Compile ``csrc/<name>.cu``; returns the compiler's output."""
    target = _library_path(name)
    BUILD_DIR.mkdir(exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    result = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(partial),
         str(SOURCE_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if result.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{result.stdout}")
    os.replace(partial, target)  # atomic: a concurrent loader sees all or nothing
    return result.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                # no Stall may land inside nvcc's build (guard.watchdog)
                with shielded():
                    build_output[name] = _build(name)
            lib = _libraries[name] = ctypes.CDLL(str(path))
        return lib


def check(name: str, status: int) -> None:
    """Raise if a kernel's entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {status}")
