"""Poison-record quarantine sidecars: one JSONL line per isolated range.

The port's copy of ``sctools_tpu.guard.quarantine``. When the guard isolates
a poisoned record range it must (a) keep the task alive -- the chunk
commits without those records -- and (b) leave a durable, machine-readable
trail an operator or the scheduler can act on. That trail is a per-worker
append-only JSONL sidecar under the run's quarantine directory (by
convention ``<journal_dir>/quarantine/``, set by
``parallel.launch.run_process_cell_metrics``, or named by
``SCTOOLS_TPU_GUARD_QUARANTINE``)::

    {"task": "chunk0003", "task_id": "9f2c...", "worker": "proc1-...",
     "site": "gatherer.dispatch", "name": "/data/chunk0003.bam",
     "record_start": 17, "record_stop": 18, "approx_bytes": 53,
     "reason": "PoisonData: injected corrupt record", "ts": 1754200000.0}

Record indices are absolute positions in the task's decode stream (the
order the ring yields records for that input); ``approx_bytes`` scales the
range by the packed arena record size. Per-worker files (like the sched
journal) make torn concurrent appends impossible. The format is JAX's, so
``sched status`` and ``obs audit`` (which holds each range against the
ledger's ``records.quarantined``) read either package's sidecars with
:func:`load_quarantine`.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..analysis.witness import make_lock
from ..obs import audit

ENV_DIR = "SCTOOLS_TPU_GUARD_QUARANTINE"

# rough bytes/record for the approx byte range: the packed arena record
# size (ingest.arena ARENA_SPEC) — not imported to keep this module free
# of the ingest dependency; the arena's own byte-parity test pins the real
# value, this is deliberately "approx"
_APPROX_RECORD_BYTES = 53

_lock = make_lock("guard.quarantine")
_dir: Optional[str] = None  # programmatic override (beats the env)


def set_quarantine_dir(path: Optional[str]) -> None:
    """Point sidecar writes at ``path`` (None = back to the env knob)."""
    global _dir
    with _lock:
        _dir = os.path.abspath(path) if path else None


def quarantine_dir() -> Optional[str]:
    """Where sidecars land (programmatic override, else env, else None)."""
    with _lock:
        if _dir is not None:
            return _dir
    env = os.environ.get(ENV_DIR, "").strip()
    return os.path.abspath(env) if env else None


def _worker_name() -> str:
    context = obs.get_context()
    return str(context.get("worker") or obs.configured_worker_name())


def record_quarantine(
    site: str,
    record_start: int,
    record_stop: int,
    reason: str,
    name: str = "",
) -> Optional[Dict[str, Any]]:
    """Append one quarantined-range entry; returns it (None when no dir).

    The task identity comes from the obs context the scheduler set around
    the task body, so call sites never thread task ids by hand. The entry
    is always counted (``guard_quarantined_ranges`` /
    ``guard_poison_records``) even when no quarantine dir is configured —
    a poisoned record must never be silently invisible.
    """
    obs.count("guard_quarantined_ranges")
    obs.count("guard_poison_records", max(0, record_stop - record_start))
    # conservation ledger: every quarantined record is a NAMED loss (the
    # reason's exception class), so the audit report balances decoded ==
    # computed + quarantined and never reads the drop as unexplained
    audit.add(
        "records.quarantined",
        max(0, record_stop - record_start),
        reason=reason.split(":", 1)[0].strip() or "unknown",
    )
    context = obs.get_context()
    entry = {
        "task": context.get("task"),
        "task_id": context.get("task_id"),
        "worker": _worker_name(),
        "site": site,
        "name": name,
        "record_start": int(record_start),
        "record_stop": int(record_stop),
        "approx_bytes": int(
            max(0, record_stop - record_start) * _APPROX_RECORD_BYTES
        ),
        "reason": reason[:500],
        "ts": round(time.time(), 6),  # scx-lint: disable=SCX109 -- cross-process timestamp, not a duration
    }
    with obs.span(
        "guard:quarantine",
        site=site,
        record_start=int(record_start),
        record_stop=int(record_stop),
    ):
        pass
    base = quarantine_dir()
    if base is None:
        return entry
    safe = "".join(
        c if c.isalnum() or c in "-_." else "_" for c in _worker_name()
    )
    path = os.path.join(base, f"records-{safe}.jsonl")
    line = json.dumps(entry, sort_keys=True, separators=(",", ":"))
    try:
        os.makedirs(base, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        # sidecar IO failure must not fail the batch the quarantine just
        # saved; the counters above still carry the signal
        return entry
    return entry


def load_quarantine(base: str) -> List[Dict[str, Any]]:
    """Every worker's sidecar entries under ``base`` (stream order).

    Torn trailing lines (a worker killed mid-append) are skipped, same
    contract as the journal's scan.
    """
    entries: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(base, "records-*.jsonl"))):
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(entry, dict):
                        entries.append(entry)
        except OSError:
            continue
    entries.sort(
        key=lambda e: (
            str(e.get("task") or ""),
            e.get("record_start") or 0,
        )
    )
    return entries
