"""scx-cost autotuner: recorded occupancy registries -> pinned bucket floors.

The port's copy of ``sctools_tpu.analysis.retune``:
``python -m sctools_tpu_torch.analysis --retune <run_dir> [paths]`` reads
the xprof registries a traced run of the port dumped, asks ``obs
efficiency --suggest``'s engine (:func:`sctools_tpu_torch.obs.xprof.suggest_buckets`,
the single source of truth; the CLI's ``--suggest --json`` emits exactly
the rows consumed here) for per-site bucket advice, folds the advice onto
the two pinned floors in ``ops/segments.py`` (``RECORD_BUCKET_MIN`` /
``ENTITY_BUCKET_MIN`` — each suggestion row carries the ``constant`` it
applies to), and rewrites those constants in place. The paths default to
``sctools_tpu_torch``, so the file it finds is the port's
``ops/segments.py``.

Derivation, per constant: the tightest suggested pad across that
constant's sites (the smallest pow2 holding each site's mean dispatch),
clamped UP to a hard floor that bounds how many distinct shapes (graph
keys) the pow2 ladder can admit, and clamped DOWN to never exceed the
current pin — raising a floor can only lower occupancy, so the tuner only
ever tightens. No telemetry for a constant leaves it untouched.

The edit is double-gated by construction, which is what lets the tuner
be aggressive:

1. the SCX5xx pass re-runs over the edited tree (:func:`check_shards`
   must stay clean — a floor edit that let a raw unbucketed size through
   would fail here), and
2. the shape contract regenerated from the edited tree
   (:func:`build_shape_contract`) must still cover every signature the
   recorded registries observed (:func:`check_signatures`) — the same
   subset check ``chip_smoke.py`` enforces live.

Either gate failing restores the original file byte-for-byte and exits 5;
nothing lands half-tuned. Run it on a copy of the tree to try it: it
rewrites a source file.

Heavier imports (``obs.xprof``, ``steer``) resolve lazily inside
:func:`retune`, so the lint passes keep their milliseconds-only import
cost.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .astcache import collect_py_files

# the tunable surface: constant name -> hard floor (the lowest value the
# tuner will ever pin; a pow2 ladder from here up bounds the distinct
# compiled shapes the contract admits)
HARD_FLOORS = {"RECORD_BUCKET_MIN": 256, "ENTITY_BUCKET_MIN": 16}

_CONSTANT_LINE = re.compile(
    r"^(?P<name>RECORD_BUCKET_MIN|ENTITY_BUCKET_MIN)(?P<mid>\s*=\s*)"
    r"(?P<value>\d+)",
    re.MULTILINE,
)


def find_segments_file(paths: Sequence[str]) -> Optional[str]:
    """The ``ops/segments.py`` holding the pinned floors under ``paths``."""
    for path, name, _ in collect_py_files(paths):
        normalized = os.path.normpath(path).split(os.sep)
        if normalized[-1] == "segments.py" and (
            len(normalized) < 2 or normalized[-2] == "ops"
        ):
            return path
    return None


def read_constants(segments_file: str) -> Dict[str, int]:
    with open(segments_file, encoding="utf-8") as f:
        source = f.read()
    return {
        m.group("name"): int(m.group("value"))
        for m in _CONSTANT_LINE.finditer(source)
    }


def rewrite_constants(
    segments_file: str, new_values: Dict[str, int]
) -> Dict[str, int]:
    """Pin ``new_values`` into the ``NAME = <int>`` lines; returns what
    was written. Atomic (tmp + rename)."""
    with open(segments_file, encoding="utf-8") as f:
        source = f.read()
    written: Dict[str, int] = {}

    def _sub(match: re.Match) -> str:
        name = match.group("name")
        if name in new_values:
            written[name] = int(new_values[name])
            return f"{name}{match.group('mid')}{int(new_values[name])}"
        return match.group(0)

    updated = _CONSTANT_LINE.sub(_sub, source)
    tmp = f"{segments_file}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(updated)
    os.replace(tmp, segments_file)
    return written


def _pow2_at_least(n: float, floor: int) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def derive_constants(
    suggestions: List[Dict[str, Any]], current: Dict[str, int]
) -> Dict[str, Dict[str, Any]]:
    """Fold per-site suggestion rows onto the pinned constants.

    Each row carries the ``constant`` it applies to (from
    ``suggest_buckets``). Per constant: ``derived = min(current,
    max(hard_floor, min(suggested_pad)))`` plus dispatch-weighted
    observed vs projected occupancy at the derived floor.
    """
    out: Dict[str, Dict[str, Any]] = {}
    for name, pinned in sorted(current.items()):
        rows = [r for r in suggestions if r.get("constant") == name]
        entry: Dict[str, Any] = {
            "current": pinned,
            "derived": pinned,
            "sites": [r["site"] for r in rows],
            "observed_occupancy": None,
            "projected_occupancy": None,
        }
        if rows:
            hard = HARD_FLOORS.get(name, 1)
            tightest = min(int(r["suggested_pad"]) for r in rows)
            entry["derived"] = min(pinned, max(hard, tightest))
            dispatches = sum(int(r["dispatches"]) for r in rows)
            real = sum(
                float(r["mean_real_rows"]) * int(r["dispatches"])
                for r in rows
            )
            padded_seen = sum(
                float(r["mean_padded_rows"]) * int(r["dispatches"])
                for r in rows
            )
            padded_projected = sum(
                _pow2_at_least(float(r["mean_real_rows"]), entry["derived"])
                * int(r["dispatches"])
                for r in rows
            )
            if dispatches and padded_seen and padded_projected:
                entry["observed_occupancy"] = round(real / padded_seen, 4)
                entry["projected_occupancy"] = round(
                    real / padded_projected, 4
                )
        out[name] = entry
    return out


def retune(
    run_dir: str,
    paths: Sequence[str],
    target: float = 0.35,
    segments_file: Optional[str] = None,
    apply: bool = True,
    out=None,
) -> Tuple[int, Dict[str, Any]]:
    """The full record -> derive -> rewrite -> gate pipeline.

    Returns ``(exit_code, report)``. Exit 2: no registries / no segments
    file. Exit 5: a gate rejected the edit (the file is restored).
    """
    import sys

    from ..obs.xprof import (
        efficiency_report,
        load_registries,
        merge_registries,
        suggest_buckets,
    )
    from .shardcheck import build_model, build_shape_contract, check_shards
    from .shardcheck import check_signatures as _check_signatures

    echo = out if out is not None else sys.stdout.write

    registries = load_registries(run_dir)
    if not registries:
        echo(
            f"scx-cost --retune: no xprof registries under {run_dir}: "
            "run with SCTOOLS_TPU_TRACE set first\n"
        )
        return 2, {}
    segments_file = segments_file or find_segments_file(paths)
    if segments_file is None:
        echo(
            "scx-cost --retune: no ops/segments.py under the given "
            "paths — nothing to pin\n"
        )
        return 2, {}
    current = read_constants(segments_file)
    if not current:
        echo(
            f"scx-cost --retune: {segments_file} carries no pinned "
            "RECORD_BUCKET_MIN/ENTITY_BUCKET_MIN lines\n"
        )
        return 2, {}

    report = efficiency_report(run_dir)
    suggestions = suggest_buckets(report, target=target)
    # the scx-steer controller's journaled refusals join the registry
    # evidence: an online downshift the pinned floor refused is a
    # recorded argument for a lower floor, in the same row schema
    from .. import steer as _steer

    suggestions = suggestions + _steer.suggest_from_decisions(
        _steer.load_decisions(run_dir), target=target
    )
    constants = derive_constants(suggestions, current)
    changed = {
        name: entry["derived"]
        for name, entry in constants.items()
        if entry["derived"] != entry["current"]
    }
    result: Dict[str, Any] = {
        "run_dir": os.path.abspath(run_dir),
        "segments_file": segments_file,
        "target": target,
        "constants": constants,
        "changed": changed,
        "applied": False,
        "gates": {},
    }
    for name, entry in sorted(constants.items()):
        sites = ", ".join(entry["sites"]) or "no telemetry"
        move = (
            f"{entry['current']} -> {entry['derived']}"
            if entry["derived"] != entry["current"]
            else f"{entry['current']} (unchanged)"
        )
        projection = ""
        if entry["projected_occupancy"] is not None:
            projection = (
                f"; occupancy {100 * entry['observed_occupancy']:.1f}% "
                f"-> {100 * entry['projected_occupancy']:.1f}% projected"
            )
        echo(f"scx-cost --retune: {name}: {move} [{sites}]{projection}\n")
    if not changed:
        echo(
            "scx-cost --retune: pinned floors already match the recorded "
            "traffic; nothing to rewrite\n"
        )
        return 0, result
    if not apply:
        echo("scx-cost --retune: dry run; no file written\n")
        return 0, result

    # any row the derived floors cannot lift to the target is worth a
    # loud line: pow2 ceilings cap a mean dispatch's projected occupancy
    # near 0.5, so targets above that are structurally unmeetable
    for row in suggestions:
        if not row.get("meets_target"):
            echo(
                f"scx-cost --retune: note: {row['site']} projects "
                f"{100 * row['projected_occupancy']:.1f}% at its tightest "
                f"pow2 pad — below the {100 * target:.0f}% target; no "
                "bucket floor can close that gap (resize the dispatches "
                "or lower the target)\n"
            )

    with open(segments_file, encoding="utf-8") as f:
        original = f.read()

    def _restore() -> None:
        tmp = f"{segments_file}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(original)
        os.replace(tmp, segments_file)

    # the rewrite->gate window is exception-safe by construction:
    # "nothing lands half-tuned" must hold even when a malformed
    # registry makes a gate RAISE rather than fail cleanly
    try:
        rewrite_constants(segments_file, changed)
        # one model of the edited tree serves both gates
        model = build_model(paths)
        # gate 1: the shardcheck pass over the edited tree stays clean
        shard_findings = check_shards(paths, model)
        result["gates"]["shardcheck"] = {
            "ok": not shard_findings,
            "findings": [f.render() for f in shard_findings],
        }
        # gate 2: the regenerated shape contract must still cover every
        # signature the recorded registries observed
        violations: List[str] = []
        observed = {}
        if not shard_findings:
            contract = build_shape_contract(paths, model)
            observed = merge_registries(registries)["sites"]
            violations = _check_signatures(contract, observed)
            result["gates"]["shape_contract"] = {
                "ok": not violations,
                "violations": violations,
            }
    except BaseException:
        _restore()
        raise
    if shard_findings or violations:
        _restore()
        for line in (
            [f.render() for f in shard_findings] + violations
        ):
            echo(f"scx-cost --retune: GATE: {line}\n")
        echo(
            "scx-cost --retune: a gate rejected the edit; "
            f"{os.path.basename(segments_file)} restored\n"
        )
        return 5, result
    result["applied"] = True
    observed_signatures = sum(
        len(r.get("signatures") or {}) for r in observed.values()
    )
    echo(
        f"scx-cost --retune: pinned {changed} into "
        f"{segments_file} (shardcheck green, shape contract covers "
        f"{observed_signatures} observed signature(s))\n"
    )
    return 0, result
