"""Runtime collective-schedule witness: the dynamic half of scx-mesh.

The port's copy of ``sctools_tpu.analysis.meshwitness``. The static pass
(:mod:`.meshcheck`) proves properties about a MODEL of the package's
mapped regions and the collectives they can issue; this module checks the
model against live runs. Every mesh collective of the port is issued
through :mod:`sctools_tpu_torch.parallel.collective` (the one sanctioned
spelling), and each wrapper notes the collective here as it issues it.
SPMD safety is the property that every process of a mesh issues the same
sequence of collectives for the same mapped computation: two processes
that issue different sequences wait on each other until the group's
timeout.

Off by default, and off means OFF: with ``SCTOOLS_TPU_MESH_DEBUG`` unset
(or anything but ``1``) the collective wrappers never touch this module's
state (pinned by test). With ``SCTOOLS_TPU_MESH_DEBUG=1`` each wrapper
records, per issue:

- the **collective entry** ``(name, axis, shape, dtype, nbytes)`` of one
  shard into the region of the mapped computation being run (the
  :func:`mapped` decorator, the port's counterpart of
  JAX's ``platform.shard_map`` shim, tags regions with JAX's region label,
  the package prefix swapped);
- a **static-schedule check**: when ``SCTOOLS_TPU_MESH_SCHEDULE`` points
  at a schedule emitted by ``python -m sctools_tpu_torch.analysis
  --emit-collective-schedule``, any observed ``(name, axis)`` pair
  missing from the static universe is a violation;
- an **outside-region check**: a collective recorded with no open region
  is a violation. ``axis_index`` is the one exception: in the port it is
  host arithmetic on the mesh (no device, no peer), so outside a region it
  records nothing and flags nothing (``parallel.metrics.place`` calls it to
  place rows); inside a region it records, as JAX's does.

**What the numbers mean in the port.** JAX records at trace time, once per
compiled shape; the port records on every host call, once per batch. The
per-region ``schedules`` keep JAX's de-duplication: a region call whose
sequence equals one already seen adds one to that row's ``count`` (in the
port: calls, in JAX: traces), and a different sequence gets a row of its
own. ``sequence`` holds the entries of each distinct region schedule once,
when it is first seen, and collectives outside any region (each a
violation), up to :data:`SEQUENCE_CAP` entries: it grows with the shape
vocabulary, as JAX's does, not with the batches of a run. ``counts`` and
``bytes`` count every issue (one per call per batch), where JAX's count one
per trace.

At interpreter exit (when a trace dir is configured) the witness writes
``mesh.<worker>.json`` next to the worker's trace capture, in JAX's format
(``{"schedules", "sequence", "counts", "bytes", "violations", ...}``);
each package's :func:`load_dumps` reads the other's. ``obs efficiency``
and ``obs timeline`` read them.

Pure stdlib; obs is imported lazily and only on the cold paths
(violations, the exit dump).
"""

from __future__ import annotations

import atexit
import functools
import glob
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

ENV_FLAG = "SCTOOLS_TPU_MESH_DEBUG"
ENV_SCHEDULE = "SCTOOLS_TPU_MESH_SCHEDULE"
# the most entries ``sequence`` keeps (each distinct region schedule once,
# and every outside-region collective); past it ``sequence_dropped`` counts
SEQUENCE_CAP = 4096

__all__ = [
    "enabled",
    "record_collective",
    "region",
    "mapped",
    "snapshot",
    "dump",
    "load_dumps",
    "collective_totals",
    "violations",
    "reset",
]


def enabled() -> bool:
    """Whether collective witnessing is on (``SCTOOLS_TPU_MESH_DEBUG=1``)."""
    return os.environ.get(ENV_FLAG, "") == "1"


# witness bookkeeping. _meta is a raw bounded-acquire lock (the lock
# witness's death-path discipline): a flight dump fired from a signal
# handler may read the snapshot, and must never hang on it.
_meta = threading.Lock()
_META_TIMEOUT_S = 1.0
# region label -> list of distinct observed sequences, each
# {"entries": [entry...], "count": calls}
_schedules: Dict[str, List[Dict[str, Any]]] = {}
_sequence: List[Dict[str, Any]] = []  # first-seen issue order, this process
_sequence_dropped = 0
_counts: Dict[str, int] = {}
_bytes: Dict[str, int] = {}
_violations: List[Dict[str, Any]] = []
_static_pairs: Optional[Set[Tuple[str, str]]] = None
_static_path: Optional[str] = None
_static_loaded = False
_dump_registered = False
_tls = threading.local()


def _axis_key(axis) -> str:
    """One canonical string per axis spec (``'shard'``, ``'dcn+shard'``)."""
    if isinstance(axis, (tuple, list)):
        return "+".join(str(a) for a in axis)
    return str(axis)


def _region_stack() -> List[Tuple[str, List[Dict[str, Any]]]]:
    stack = getattr(_tls, "regions", None)
    if stack is None:
        stack = _tls.regions = []
    return stack


def in_region() -> bool:
    """Whether a region is open on this thread."""
    return bool(getattr(_tls, "regions", None))


def _load_static() -> Optional[Set[Tuple[str, str]]]:
    global _static_pairs, _static_loaded, _static_path
    if _static_loaded:
        return _static_pairs
    if not _meta.acquire(timeout=_META_TIMEOUT_S):
        return _static_pairs
    try:
        if _static_loaded:
            return _static_pairs
        path = os.environ.get(ENV_SCHEDULE, "").strip()
        pairs: Optional[Set[Tuple[str, str]]] = None
        if path:
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                pairs = {
                    (str(name), str(axis))
                    for name, axis in data.get("collectives", ())
                }
                _static_path = path
            except (OSError, ValueError, KeyError, TypeError):
                # an unreadable schedule must not crash the instrumented
                # process; the smoke comparing dumps catches it
                pairs = None
        _static_pairs = pairs
        _static_loaded = True
    finally:
        _meta.release()
    return _static_pairs


def _append_sequence(entries: Sequence[Dict[str, Any]]) -> None:
    """Extend ``_sequence`` up to the cap (caller holds ``_meta``)."""
    global _sequence_dropped
    room = SEQUENCE_CAP - len(_sequence)
    _sequence.extend(entries[:max(room, 0)])
    _sequence_dropped += max(len(entries) - max(room, 0), 0)


def _record_violation(kind: str, detail: Dict[str, Any]) -> None:
    entry = dict(detail)
    entry["kind"] = kind
    if _meta.acquire(timeout=_META_TIMEOUT_S):
        try:
            _violations.append(entry)
        finally:
            _meta.release()
    try:
        sys.stderr.write(
            f"sctools-tpu mesh-witness: {kind}: "
            f"{json.dumps(entry, sort_keys=True, default=str)}\n"
        )
        sys.stderr.flush()
    except OSError:
        pass
    # an unscheduled collective is a static-model lie about the very
    # property that hangs meshes: persist the postmortem now
    if getattr(_tls, "announcing", False):
        return
    _tls.announcing = True
    try:
        from .. import obs

        obs.flight_dump(reason=f"mesh-witness:{kind}")
    except Exception:  # noqa: BLE001 - diagnosis must never be fatal
        pass
    finally:
        _tls.announcing = False


def record_collective(
    name: str,
    axis,
    shape: Sequence[int],
    dtype: str,
    nbytes: int,
) -> None:
    """One collective issued (called by the wrappers)."""
    if not enabled():
        return
    _ensure_dump_registered()
    entry = {
        "name": str(name),
        "axis": _axis_key(axis),
        "shape": [int(d) for d in shape],
        "dtype": str(dtype),
        "nbytes": int(nbytes),
    }
    stack = _region_stack()
    if stack:
        entry["region"] = stack[-1][0]
        stack[-1][1].append(entry)
    else:
        entry["region"] = None
        _record_violation(
            "outside-region",
            {
                "collective": entry["name"],
                "axis": entry["axis"],
                "note": "collective issued outside any meshwitness.mapped "
                "region — the choke-point invariant is broken",
            },
        )
    static = _load_static()
    # the static emitter writes axis "*" for parameter-forwarded axes (the
    # axis is known only at run time); an exact pair OR the wildcard
    # admits the observation
    if static is not None and (
        (entry["name"], entry["axis"]) not in static
        and (entry["name"], "*") not in static
    ):
        _record_violation(
            "unscheduled-collective",
            {
                "collective": entry["name"],
                "axis": entry["axis"],
                "region": entry["region"],
                "schedule": _static_path,
                "note": "observed collective missing from the static "
                "collective schedule",
            },
        )
    if _meta.acquire(timeout=_META_TIMEOUT_S):
        try:
            if not stack:
                _append_sequence([entry])
            _counts[entry["name"]] = _counts.get(entry["name"], 0) + 1
            _bytes[entry["name"]] = _bytes.get(entry["name"], 0) + entry[
                "nbytes"
            ]
        finally:
            _meta.release()


class _Region:
    """Context manager that scopes recorded collectives to one mapped body."""

    __slots__ = ("label", "_entries")

    def __init__(self, label: str):
        self.label = label
        self._entries: List[Dict[str, Any]] = []

    def __enter__(self) -> "_Region":
        _region_stack().append((self.label, self._entries))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = _region_stack()
        for index in range(len(stack) - 1, -1, -1):
            if stack[index][1] is self._entries:
                del stack[index]
                break
        if exc_type is not None:
            return
        # fold this call's sequence into the region's schedule set: repeat
        # calls of an identical sequence dedupe (count++), a DIFFERENT
        # sequence for the same region is kept separately so the fleet
        # check can see it (and fail on cross-worker drift)
        key = [
            {k: e[k] for k in ("name", "axis", "shape", "dtype", "nbytes")}
            for e in self._entries
        ]
        if not _meta.acquire(timeout=_META_TIMEOUT_S):
            return
        try:
            rows = _schedules.setdefault(self.label, [])
            for row in rows:
                if row["entries"] == key:
                    row["count"] += 1
                    return
            rows.append({"entries": key, "count": 1})
            _append_sequence(self._entries)
        finally:
            _meta.release()


def region(label: str) -> _Region:
    """Open a collective-recording region named ``label``."""
    return _Region(label)


def mapped(label: str, replicated=False):
    """Mark a function as the port's counterpart of one of JAX's mapped
    bodies (JAX's ``platform.shard_map`` shim tags those): under the witness
    its calls record into the region ``sctools_tpu_torch.<label>``, where
    ``label`` is JAX's region label without its package prefix, so the two
    packages' schedules compare. ``replicated`` (a bool, or one a result)
    says which results are the same on every shard, JAX's ``P()``
    out_specs: the static pass holds such a region to a reducing collective
    (SCX805). Off, the wrapper calls straight through; a call made while
    another region is open joins that region (a mapped body's helpers are
    part of its program, as in JAX, where no ``shard_map`` nests inside
    another)."""
    full = f"{__name__.partition('.')[0]}.{label}"

    def wrap(fn):
        @functools.wraps(fn)
        def tagged(*args, **kwargs):
            if not enabled() or in_region():
                return fn(*args, **kwargs)
            with region(full):
                return fn(*args, **kwargs)

        return tagged

    return wrap


def _ensure_dump_registered() -> None:
    global _dump_registered
    if _dump_registered:
        return
    _dump_registered = True
    atexit.register(_dump_at_exit)


# ------------------------------------------------------------- read side


def violations() -> List[Dict[str, Any]]:
    """Snapshot of recorded violations."""
    with _meta:
        return [dict(v) for v in _violations]


def collective_totals() -> Dict[str, Dict[str, int]]:
    """Per-collective issue counts and operand bytes (this process)."""
    with _meta:
        return {
            name: {"count": _counts[name], "nbytes": _bytes.get(name, 0)}
            for name in sorted(_counts)
        }


def snapshot(lock_timeout: Optional[float] = None) -> Dict[str, Any]:
    """The whole witness state as one JSON-safe dict (the dump payload).

    ``lock_timeout`` bounds the death path: on contention the snapshot
    degrades to the enabled flag alone rather than hanging a signal
    handler.
    """
    timeout = _META_TIMEOUT_S if lock_timeout is None else lock_timeout
    if not _meta.acquire(timeout=timeout):
        return {"enabled": enabled(), "degraded": "lock-timeout"}
    try:
        return {
            "enabled": enabled(),
            "schedules": {
                label: [
                    {"entries": list(row["entries"]), "count": row["count"]}
                    for row in rows
                ]
                for label, rows in sorted(_schedules.items())
            },
            "sequence": [dict(e) for e in _sequence],
            "sequence_dropped": _sequence_dropped,
            "counts": dict(_counts),
            "bytes": dict(_bytes),
            "violations": [dict(v) for v in _violations],
            "static_schedule": _static_path,
        }
    finally:
        _meta.release()


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the witness snapshot to ``path`` (default: the trace dir)."""
    target = path
    if target is None:
        from .. import obs

        base = obs.configured_trace_dir()
        if base is None:
            return None
        target = os.path.join(
            base, f"mesh.{obs.configured_worker_name()}.json"
        )
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snapshot(), f, sort_keys=True, indent=1)
            f.write("\n")
        os.replace(tmp, target)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return target


def _dump_at_exit() -> None:
    try:
        dump()
    except Exception:  # noqa: BLE001 - exit hook must never raise
        pass


def load_dumps(run_dir: str) -> Dict[str, Dict[str, Any]]:
    """``mesh.<worker>.json`` dumps under ``run_dir``, keyed by worker.

    Searches the run dir and one level of subdirectories. Unreadable dumps
    are skipped: the surfaces riding this (``obs efficiency``, the fleet
    timeline) degrade to absence, never crash a report.
    """
    out: Dict[str, Dict[str, Any]] = {}
    patterns = [
        os.path.join(run_dir, "mesh.*.json"),
        os.path.join(run_dir, "*", "mesh.*.json"),
    ]
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            base = os.path.basename(path)
            worker = base[len("mesh."):-len(".json")] or "worker"
            if worker in out:
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(data, dict):
                out[worker] = data
    return out


def reset() -> None:
    """Clear observed schedules, totals, violations, and the schedule
    cache (tests)."""
    global _static_pairs, _static_loaded, _static_path, _sequence_dropped
    with _meta:
        _schedules.clear()
        _sequence.clear()
        _sequence_dropped = 0
        _counts.clear()
        _bytes.clear()
        _violations.clear()
        _static_pairs = None
        _static_loaded = False
        _static_path = None
