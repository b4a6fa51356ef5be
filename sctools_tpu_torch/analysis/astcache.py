"""Shared parse cache for the port's whole-package passes.

The port's copy of ``sctools_tpu.analysis.astcache``. The race pass
(SCX4xx) and the frame-lifetime pass (SCX6xx) each build a package-wide
model from the same ``.py`` files; the in-memory layer makes one CLI run
read and ``ast.parse`` every file exactly once, keyed by (path, mtime_ns,
size) so a test that rewrites a tmp file still reparses.

The cache is also persistent across runs: parsed trees pickle to a
content-hash-keyed store (``.scx_cache/`` under the working directory, or
``SCTOOLS_TPU_SCX_CACHE`` when set; ``SCTOOLS_TPU_SCX_CACHE=0`` disables
it), the directory and variable the JAX package's passes use. So that the
two packages never read each other's pickles there, this store's key
hashes :data:`CACHE_SALT` before the source and its file names end in
``.torch-ast.pkl``. Keys carry the interpreter version (pickled AST layout
is not stable across Pythons) and the exact source hash, so an edited file
never hits a stale tree; a corrupt or unreadable entry falls back to a real
parse. :data:`stats` counts parsed / disk-hit / memory-hit so the CLI can
print the cache's effect.

Pure stdlib, imports nothing under analysis.
"""

from __future__ import annotations

import ast
import hashlib
import os
import pickle
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# directory names never worth walking into — the ONE copy, shared by the
# cli file walk and every whole-package model build
SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "node_modules",
             ".scx_cache"}

CACHE_ENV = "SCTOOLS_TPU_SCX_CACHE"
_DEFAULT_CACHE_DIR = ".scx_cache"
# hashed ahead of each source: the JAX package's passes share the store
CACHE_SALT = b"sctools_tpu_torch.analysis\0"

# (abspath, mtime_ns, size) -> (source text, parsed tree)
_cache: Dict[Tuple[str, int, int], Tuple[str, ast.Module]] = {}

# per-process effectiveness counters (the CLI prints them):
# parsed = real ast.parse calls; disk_hits = unpickled from the
# persistent store; memory_hits = same-process re-reads
stats = {"parsed": 0, "disk_hits": 0, "memory_hits": 0}


def _store_dir() -> Optional[str]:
    configured = os.environ.get(CACHE_ENV)
    if configured is not None:
        if configured in ("", "0"):
            return None
        return configured
    return _DEFAULT_CACHE_DIR


def _store_path(source: str) -> Optional[str]:
    directory = _store_dir()
    if directory is None:
        return None
    digest = hashlib.sha256(CACHE_SALT + source.encode("utf-8")).hexdigest()
    version = f"py{sys.version_info[0]}{sys.version_info[1]}"
    return os.path.join(directory, f"{digest}.{version}.torch-ast.pkl")


def _store_load(source: str) -> Optional[ast.Module]:
    path = _store_path(source)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            tree = pickle.load(f)
    except Exception:  # noqa: BLE001 - any corrupt entry means reparse
        return None
    return tree if isinstance(tree, ast.Module) else None


def _store_save(source: str, tree: ast.Module) -> None:
    path = _store_path(source)
    if path is None:
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(tree, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def parse_cached(path: str) -> Optional[Tuple[str, ast.Module]]:
    """(source, tree) for ``path``, parsed at most once per file version.

    Returns ``None`` on unreadable or syntactically invalid files —
    reporting those is the lint pass's job (SCX100), not a model-build
    failure.
    """
    abspath = os.path.abspath(path)
    try:
        stat = os.stat(abspath)
        key = (abspath, stat.st_mtime_ns, stat.st_size)
        hit = _cache.get(key)
        if hit is not None:
            stats["memory_hits"] += 1
            return hit
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
        tree = _store_load(source)
        if tree is not None:
            stats["disk_hits"] += 1
        else:
            tree = ast.parse(source, filename=path)
            stats["parsed"] += 1
            _store_save(source, tree)
    except (OSError, SyntaxError):
        return None
    _cache[key] = (source, tree)
    return (source, tree)


def collect_py_files(
    paths: Sequence[str], exempt_dirs: Sequence[str] = ()
) -> List[Tuple[str, str, bool]]:
    """(file_path, dotted_module_name, is_pkg) for every analyzable file.

    ``exempt_dirs`` names directories (by basename) whose subtrees are
    the analysis mechanism itself, not the subject, and are pruned.
    """
    out: List[Tuple[str, str, bool]] = []
    exempt = set(exempt_dirs)
    for root in paths:
        root = os.path.normpath(root)
        if os.path.isfile(root):
            if root.endswith(".py"):
                out.append((root, os.path.basename(root)[:-3], False))
            continue
        base = os.path.dirname(root)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [
                d for d in sorted(dirnames)
                if d not in SKIP_DIRS and not d.startswith(".")
            ]
            if os.path.basename(dirpath) in exempt:
                dirnames[:] = []
                continue
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, base) if base else fpath
                parts = rel.split(os.sep)
                is_pkg = parts[-1] == "__init__.py"
                if is_pkg:
                    parts = parts[:-1]
                else:
                    parts[-1] = parts[-1][:-3]
                out.append((fpath, ".".join(parts), is_pkg))
    return out
