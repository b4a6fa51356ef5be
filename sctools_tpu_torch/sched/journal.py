"""Durable task journal: content-hashed ids over an append-only JSONL log.

The port's copy of ``sctools_tpu.sched.journal``: the file layout, the
event format, the task ids and the fold are the JAX package's, so a
journal written by either package replays to the same states under the
other. A journal is a directory on the shared filesystem every worker can
reach:

``tasks-<worker>.jsonl``
    One line per registered task spec ``{"id", "kind", "name", "payload"}``.
    Every worker registers the same specs; replay dedupes by id, so
    registration is idempotent and order-free.

``events-<worker>.jsonl``
    One line per state transition ``{"id", "event", "ts", "seq", "worker",
    ...extras}``. Each worker appends ONLY to its own file, so no two
    processes ever write the same file and a torn concurrent append is
    impossible by construction (the usual failure mode of one shared log
    on NFS).

``leases/``
    The lock files of :mod:`.lease`.

Replay merges every worker's events in ``(ts, seq, worker)`` order and
folds them into one :class:`TaskState` per task. ``committed`` is terminal
and first-write-wins: if a presumed-dead worker finishes after its lease
was stolen, the duplicate commit event is simply ignored (parts are
byte-identical and atomically replaced, so the artifact is consistent
either way). Clock skew between workers therefore cannot corrupt state —
it can only reorder non-terminal noise.

Task ids are content hashes of the full spec (kind + name + payload), so a
re-launch over the same inputs resolves to the same ids and resumes, while
any input change yields fresh tasks.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..analysis.witness import make_lock

# journal event kinds, in the order a task typically sees them
EVENTS = ("leased", "failed", "committed", "quarantined", "requeued")

# task lifecycle states (derived; only events are stored)
PENDING = "pending"
LEASED = "leased"
COMMITTED = "committed"
FAILED = "failed"
QUARANTINED = "quarantined"

TERMINAL = (COMMITTED, QUARANTINED)


def wall_clock() -> float:
    """Cross-process wall timestamp (lease deadlines, event ordering).

    This is the ONE sanctioned wall-clock read in the library: scheduler
    deadlines must be comparable across processes, which perf_counter is
    not. It is never used for duration math.
    """
    return time.time()  # scx-lint: disable=SCX109 -- cross-process timestamp, not a duration


@dataclass(frozen=True)
class Task:
    """One schedulable unit of work. ``payload`` must be JSON-serializable
    and self-contained enough for ``python -m sctools_tpu_torch.sched resume``
    to re-run the task in a fresh process (see :mod:`.runners`)."""

    id: str
    kind: str
    name: str
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id, "kind": self.kind, "name": self.name,
            "payload": self.payload,
        }


def task_id(kind: str, name: str, payload: Dict[str, Any]) -> str:
    """Content-hashed task id: stable across re-launches of the same work."""
    blob = json.dumps(
        {"kind": kind, "name": name, "payload": payload},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def make_task(kind: str, name: str, payload: Dict[str, Any]) -> Task:
    return Task(id=task_id(kind, name, payload), kind=kind, name=name,
                payload=dict(payload))


@dataclass
class TaskState:
    """The folded state of one task after replay."""

    state: str = PENDING
    attempts: int = 0  # leased events (executions started)
    failures: int = 0  # failed events (drives the quarantine threshold)
    steals: int = 0
    worker: Optional[str] = None
    error: Optional[str] = None
    part: Optional[str] = None  # committed artifact path
    sha256: Optional[str] = None  # committed artifact content hash
    not_before: float = 0.0  # backoff deadline (wall clock)

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL


def _fold(state: TaskState, event: Dict[str, Any]) -> None:
    kind = event.get("event")
    if state.state == COMMITTED:
        return  # terminal and immutable: late duplicate events are ignored
    if kind == "leased":
        state.state = LEASED
        state.attempts += 1
        state.steals += int(event.get("stolen", 0))
        state.worker = event.get("worker")
        state.error = None
    elif kind == "failed":
        state.state = FAILED
        state.failures += 1
        state.error = event.get("error")
        state.not_before = float(event.get("not_before", 0.0))
    elif kind == "committed":
        state.state = COMMITTED
        state.worker = event.get("worker")
        state.part = event.get("part")
        state.sha256 = event.get("sha256")
    elif kind == "quarantined":
        state.state = QUARANTINED
        state.error = event.get("error", state.error)
    elif kind == "requeued":
        state.state = PENDING
        state.attempts = 0
        state.failures = 0
        state.error = None
        state.not_before = 0.0


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


class Journal:
    """Append-only task journal rooted at a shared directory.

    One instance per (worker, journal dir); the worker's two JSONL files
    are opened lazily and kept open for the life of the instance. Reads
    (:meth:`replay`) always re-scan every worker's files, so a fresh view
    is one call away and needs no coordination.
    """

    def __init__(self, root: str, worker_id: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.worker_id = worker_id or default_worker_id()
        self._lock = make_lock("sched.journal")
        self._seq = 0
        self._events_file = None
        self._tasks_file = None
        # bytes actually parsed by _scan_file since construction: observable
        # proof the incremental cache works (a second `sched status` must
        # read only appended bytes, not replay history)
        self.bytes_scanned = 0
        # incremental scan state: path -> [consumed byte offset, records].
        # The files are append-only by construction, so replay() only
        # parses bytes appended since the previous call — without this,
        # the scheduler's poll loop would re-parse every worker's whole
        # history on every claim (O(N^2) over a large run, all of it
        # shared-filesystem traffic).
        self._scan_cache: Dict[str, List] = {}
        os.makedirs(os.path.join(self.root, "leases"), exist_ok=True)

    # ------------------------------------------------------------- paths

    @property
    def leases_dir(self) -> str:
        return os.path.join(self.root, "leases")

    def _worker_path(self, prefix: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "-_." else "_" for c in self.worker_id
        )
        return os.path.join(self.root, f"{prefix}-{safe}.jsonl")

    def _append(self, which: str, record: Dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True, separators=(",", ":"))
        with self._lock:
            f = getattr(self, f"_{which}_file")
            if f is None:
                f = open(self._worker_path(which), "a", encoding="utf-8")
                setattr(self, f"_{which}_file", f)
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def close(self) -> None:
        with self._lock:
            for name in ("_events_file", "_tasks_file"):
                f = getattr(self, name)
                if f is not None:
                    try:
                        f.close()
                    except OSError:
                        pass
                    setattr(self, name, None)

    # ------------------------------------------------------------ writes

    def register(self, tasks: Iterable[Task]) -> List[Task]:
        """Record task specs not already present; returns the new ones."""
        known, _ = self.replay()
        fresh = [t for t in tasks if t.id not in known]
        for t in fresh:
            self._append("tasks", t.to_json())
        return fresh

    def record(self, tid: str, event: str, **extra: Any) -> None:
        """Append one state-transition event for task ``tid``."""
        if event not in EVENTS:
            raise ValueError(f"unknown journal event {event!r}")
        with self._lock:
            self._seq += 1
            seq = self._seq
        record = {
            "id": tid, "event": event, "ts": round(wall_clock(), 6),
            "seq": seq, "worker": self.worker_id,
        }
        record.update(extra)
        self._append("events", record)

    def announce_worker(self, meta: Dict[str, Any]) -> None:
        """Describe this worker in its event log (the mesh it serves).

        Worker announcements are META events (``"event": "worker"``, no
        task id): :meth:`replay` ignores them by construction (it folds
        only string task ids), while :meth:`worker_meta` and ``sched
        status`` read them to group workers per mesh rather than per
        process.
        """
        with self._lock:
            self._seq += 1
            seq = self._seq
        record = {
            "id": None, "event": "worker", "ts": round(wall_clock(), 6),
            "seq": seq, "worker": self.worker_id,
        }
        record.update(meta)
        self._append("events", record)

    # ------------------------------------------------------------- reads

    def worker_meta(self) -> Dict[str, Dict[str, Any]]:
        """Per-worker announcement metadata, last announcement wins."""
        out: Dict[str, Dict[str, Any]] = {}
        for event in self.events():
            if event.get("event") != "worker":
                continue
            worker = event.get("worker")
            if not isinstance(worker, str):
                continue
            meta = {
                k: v
                for k, v in event.items()
                if k not in ("id", "event", "ts", "seq", "worker")
            }
            out[worker] = meta
        return out

    def _read_jsonl(self, pattern: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for path in sorted(glob.glob(os.path.join(self.root, pattern))):
            out.extend(self._scan_file(path))
        return out

    def _scan_file(self, path: str) -> List[Dict[str, Any]]:
        """Parsed records of one JSONL file, reading only appended bytes.

        Only newline-terminated lines are consumed: a torn final line from
        a crashed (or mid-write) worker stays unconsumed and is retried on
        the next scan, so a record is never half-parsed. A complete line
        that still fails to parse is skipped permanently (debris).
        """
        with self._lock:
            entry = self._scan_cache.setdefault(path, [0, []])
            offset, records = entry
            try:
                size = os.path.getsize(path)
            except OSError:
                return list(records)
            if size < offset:
                # file shrank (manual surgery): rescan from the start
                entry[0] = offset = 0
                entry[1] = records = []
            if size > offset:
                try:
                    with open(path, "rb") as f:
                        f.seek(offset)
                        data = f.read()
                except OSError:
                    return list(records)
                self.bytes_scanned += len(data)
                end = data.rfind(b"\n")
                if end >= 0:
                    for line in data[:end].split(b"\n"):
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            records.append(json.loads(line))
                        except ValueError:
                            continue
                    entry[0] = offset + end + 1
            return list(records)

    def events(self) -> List[Dict[str, Any]]:
        """Every worker's raw events, merged in replay order (read-only).

        The same `(ts, seq, worker)` order :meth:`replay` folds in.
        """
        events = self._read_jsonl("events-*.jsonl")
        events.sort(
            key=lambda e: (
                e.get("ts", 0.0), e.get("seq", 0), e.get("worker", "")
            )
        )
        return events

    def replay(self) -> Tuple[Dict[str, Task], Dict[str, TaskState]]:
        """Fold every worker's log into (tasks by id, states by id)."""
        tasks: Dict[str, Task] = {}
        for spec in self._read_jsonl("tasks-*.jsonl"):
            tid = spec.get("id")
            if isinstance(tid, str) and tid not in tasks:
                tasks[tid] = Task(
                    id=tid,
                    kind=spec.get("kind", ""),
                    name=spec.get("name", ""),
                    payload=spec.get("payload") or {},
                )
        events = self.events()
        states: Dict[str, TaskState] = {tid: TaskState() for tid in tasks}
        for event in events:
            tid = event.get("id")
            if not isinstance(tid, str):
                continue
            _fold(states.setdefault(tid, TaskState()), event)
        return tasks, states

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
