"""The graph manifest of the serve path: its loader and integrity check.

The port of ``sctools_tpu.serve.manifest``. As in JAX, the manifest is the
product of the static AOT pass (:mod:`sctools_tpu_torch.analysis.aotcheck`)
over the package: ``graph_manifest.json`` beside this module, committed,
is what ``python -m sctools_tpu_torch.analysis --emit-aot-manifest FILE
sctools_tpu_torch`` writes (``python -m sctools_tpu_torch.serve.manifest``
runs that over this package and rewrites the file), and ``python -m
sctools_tpu_torch.analysis --aot-manifest FILE`` is its staleness gate. It
holds JAX's layout: ``version`` 1, the shape ``contract`` with its
``contract_hash`` (canonical sha256), the ``sites`` table (each device
site with its ``static_argnames``, ``dims``, ``serve_reachable`` and
``precompile``) and ``serve_entries``.

The port's serve path compiles one site, the metrics engine's pass, whose
compiled form is a CUDA graph keyed by the engine's static arguments and
its input columns' shapes (:func:`~.graphs.graph_key`). The worker
validates the steering controller's buckets against the contract with
``analysis.shardcheck.dim_admissible``, and warmup captures the graphs of
the ladder's rungs only.

JAX's ``aot_cache_dir`` has no counterpart: the port keeps no executable
cache on disk, because a CUDA graph lives in the process that captured it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..analysis.aotcheck import contract_hash

DEFAULT_MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "graph_manifest.json"
)

MANIFEST_VERSION = 1


class ManifestError(RuntimeError):
    """A manifest failed to load or failed its integrity check."""


def load_manifest(path: Optional[str] = None) -> Dict[str, Any]:
    """Load and integrity-check the committed graph manifest.

    Raises :class:`ManifestError` on a missing/unreadable file or any
    integrity problem (see :func:`validate_loaded_manifest`).
    """
    path = path or DEFAULT_MANIFEST_PATH
    try:
        with open(path, "r", encoding="utf-8") as handle:
            manifest = json.load(handle)
    except (OSError, ValueError) as exc:
        raise ManifestError(
            f"cannot load graph manifest {path!r}: {exc}; build one with "
            f"python -m sctools_tpu_torch.serve.manifest"
        ) from exc
    problems = validate_loaded_manifest(manifest)
    if problems:
        raise ManifestError(
            f"graph manifest {path!r} failed integrity: " + "; ".join(problems)
        )
    return manifest


def validate_loaded_manifest(manifest: Dict[str, Any]) -> List[str]:
    """Integrity problems with an in-memory manifest.

    Checks version, presence of the embedded contract + hash, and that
    the embedded contract actually hashes to the recorded value.
    """
    problems: List[str] = []
    version = manifest.get("version")
    if version != MANIFEST_VERSION:
        problems.append(f"manifest version {version!r} != {MANIFEST_VERSION}")
    embedded = manifest.get("contract")
    recorded = manifest.get("contract_hash")
    if not isinstance(embedded, dict) or not recorded:
        problems.append("manifest missing embedded contract or hash")
        return problems
    actual = contract_hash(embedded)
    if actual != recorded:
        problems.append(
            f"embedded contract hash mismatch (recorded {recorded[:12]}…, "
            f"actual {actual[:12]}…)"
        )
    if not isinstance(manifest.get("sites"), dict):
        problems.append("manifest missing sites table")
    return problems


def precompile_sites(manifest: Dict[str, Any]) -> List[str]:
    """Names of the sites whose graphs warmup captures (``precompile``)."""
    sites = manifest.get("sites", {})
    return sorted(
        name for name, entry in sites.items() if entry.get("precompile")
    )


if __name__ == "__main__":
    from ..analysis.cli import main as _analysis

    raise SystemExit(_analysis([
        "--emit-aot-manifest", DEFAULT_MANIFEST_PATH,
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ]))
