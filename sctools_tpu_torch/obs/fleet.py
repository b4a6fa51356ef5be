"""scx-fleet for the port: run-level observability across every worker.

The port's copy of ``sctools_tpu.obs.fleet``: the same discovery, clock
stitching and analysis over the same files, so that either package merges
the other's run directory. Its reads go through the port's own modules:
the journal through ``sched.Journal``, rings through ``pulse.load_rings``,
serve traces through ``slo.stitch`` and mesh dumps through
``xprof.load_mesh_dumps``. Flight records are JAX's format, so a crashed
worker of either package shows here from its flight record.

scx-trace sees one process; a scatter-gather run is N of them. Each worker
leaves its own span capture (``trace[.<worker>].jsonl``), counter snapshot
(``metrics[.<worker>].prom``), possibly a crash flight record
(``flight.<worker>.jsonl``), and they all share one scx-sched journal.
This module is the Dapper-style stitching layer over those artifacts: it
discovers everything under a run directory, normalizes each process's
monotonic span clock onto the shared wall clock, and merges spans and
scheduler events into ONE timeline keyed by ``(worker, task)`` — so lease,
steal, retry, and commit transitions interleave with the decode/upload/
compute/writeback spans they caused.

Clock normalization: span ``ts`` is seconds since *process* start
(``time.perf_counter``), incomparable across workers. Journal events carry
wall-clock timestamps written by the same worker, and ``sched:task`` spans
carry the ``(task_id, attempt)`` their ``leased``/``committed`` events
carry — matching them yields that worker's mono->wall offset (median over
every pair, robust to fs latency on any one). Captures with no scheduler
spans fall back to the clock-sync anchor the sink writes at attach
(``{"meta":"clock","wall":...,"mono":...}``).

On top of the merged timeline: per-worker lanes with busy/wait/idle
fractions, per-task duration stats (p50/p95/max skew, stragglers), the
critical chain of tasks that bounded the run, and committed-task
attribution (which surviving lineage produced each artifact). The CLI is
``python -m sctools_tpu_torch.obs timeline <run_dir>``.

Pure stdlib, no torch import: a fleet capture analyzes anywhere.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import pulse as _pulse
from .xprof import load_mesh_dumps

__all__ = [
    "CaptureFile",
    "FleetRun",
    "analyze",
    "discover",
    "load_capture",
    "render_timeline",
]

# an ``obs timeline``/``summarize`` read must tolerate a capture still
# being appended to (or torn by a crash): only the LAST line may be
# unterminated, and that is a warning, never an error
_SPAN_KEYS = ("name", "ts", "dur")


@dataclass
class CaptureFile:
    """One worker capture: a trace sink or a flight record, parsed."""

    path: str
    kind: str  # "trace" | "flight"
    records: List[dict] = field(default_factory=list)
    metas: List[dict] = field(default_factory=list)
    torn: bool = False
    bad_lines: int = 0
    worker: str = "unknown"
    offset: Optional[float] = None  # mono -> wall seconds
    offset_source: str = "none"  # "journal" | "clock-meta" | "none"

    @property
    def clock_meta(self) -> Optional[dict]:
        for meta in self.metas:
            if meta.get("meta") in ("clock", "flight"):
                if isinstance(meta.get("wall"), (int, float)) and \
                        isinstance(meta.get("mono"), (int, float)):
                    return meta
        return None

    @property
    def flight_meta(self) -> Optional[dict]:
        for meta in self.metas:
            if meta.get("meta") == "flight":
                return meta
        return None


def _filename_worker(path: str) -> Optional[str]:
    base = os.path.basename(path)
    for prefix in ("trace.", "flight."):
        if base.startswith(prefix) and base.endswith(".jsonl"):
            inner = base[len(prefix): -len(".jsonl")]
            if inner:
                return inner
    return None


def load_capture(path: str, kind: str) -> CaptureFile:
    """Parse one capture JSONL; torn/garbled lines degrade, never raise."""
    capture = CaptureFile(path=path, kind=kind)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        capture.torn = True
        return capture
    lines = data.split(b"\n")
    # a capture from a crashed (or still-running) worker legitimately ends
    # mid-line; only content AFTER the last newline can be torn
    unterminated = lines[-1].strip()
    for lineno, raw in enumerate(lines[:-1], 1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            record = json.loads(raw)
        except ValueError:
            capture.bad_lines += 1
            continue
        if not isinstance(record, dict):
            capture.bad_lines += 1
        elif "meta" in record:
            capture.metas.append(record)
        elif isinstance(record.get("name"), str):
            capture.records.append(record)
        else:
            capture.bad_lines += 1
    if unterminated:
        try:
            record = json.loads(unterminated)
            if isinstance(record, dict) and "meta" in record:
                capture.metas.append(record)
            elif isinstance(record, dict) and \
                    isinstance(record.get("name"), str):
                capture.records.append(record)
            else:
                capture.torn = True
        except ValueError:
            capture.torn = True
    workers = {}
    for record in capture.records:
        worker = record.get("worker")
        if isinstance(worker, str):
            workers[worker] = workers.get(worker, 0) + 1
    flight = capture.flight_meta
    if workers:
        capture.worker = max(workers, key=workers.get)
    elif flight is not None and flight.get("worker"):
        capture.worker = str(flight["worker"])
    else:
        capture.worker = _filename_worker(path) or "unknown"
    return capture


@dataclass
class FleetRun:
    """Everything discovered under one run directory, clock-normalized."""

    run_dir: str
    journal_dir: Optional[str]
    tasks: Dict[str, Any] = field(default_factory=dict)  # id -> sched.Task
    states: Dict[str, Any] = field(default_factory=dict)  # id -> TaskState
    events: List[dict] = field(default_factory=list)
    captures: List[CaptureFile] = field(default_factory=list)
    metrics_files: List[str] = field(default_factory=list)
    # scx-pulse heartbeat rings found under the run dir, keyed by worker
    pulse_rings: Dict[str, dict] = field(default_factory=dict)
    # scx-mesh collective-schedule witness dumps (mesh.<worker>.json)
    mesh_dumps: Dict[str, dict] = field(default_factory=dict)
    # per-worker mesh fingerprints announced to the sched journal
    worker_meshes: Dict[str, dict] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)

    def merged_spans(self) -> List[dict]:
        """Every capture's spans on the wall clock, deduped, time-sorted.

        Each returned record gains ``wall_ts`` (wall-clock start) and a
        resolved ``worker``. A crashed worker's flight record duplicates
        the spans its sink already flushed; those collapse to one copy
        (the ring holds the exact records the sink serialized, so the
        identity key is exact, not fuzzy).
        """
        out: List[dict] = []
        seen: set = set()
        ordered = sorted(
            self.captures, key=lambda c: (c.kind != "trace", c.path)
        )
        # an unanchored capture's spans sit at seconds-since-ITS-start;
        # merging them at offset 0 next to epoch-anchored spans would blow
        # the shared window out to ~1e9 s and collapse every lane. When
        # any capture IS anchored, unanchored ones stay out of the merge
        # (discover() already warned); with none anchored, everything is
        # process-relative and merging at 0 is the honest best effort.
        any_anchored = any(c.offset is not None for c in self.captures)
        for capture in ordered:
            if any_anchored and capture.offset is None:
                continue
            offset = capture.offset or 0.0
            for record in capture.records:
                ts = record.get("ts")
                dur = record.get("dur")
                if not isinstance(ts, (int, float)) or \
                        not isinstance(dur, (int, float)):
                    continue
                key = (
                    record.get("worker", capture.worker),
                    record.get("name"), float(ts), float(dur),
                    record.get("thread"),
                )
                if key in seen:
                    continue
                seen.add(key)
                merged = dict(record)
                merged.setdefault("worker", capture.worker)
                merged["wall_ts"] = float(ts) + offset
                merged["source"] = capture.kind
                out.append(merged)
        out.sort(key=lambda r: r["wall_ts"])
        return out


def _find_journal_dir(run_dir: str) -> Optional[str]:
    candidates = [
        os.path.join(run_dir, "sched-journal"),
        run_dir,
    ]
    candidates += sorted(glob.glob(os.path.join(run_dir, "*", "sched-journal")))
    for candidate in candidates:
        if glob.glob(os.path.join(candidate, "events-*.jsonl")) or \
                glob.glob(os.path.join(candidate, "tasks-*.jsonl")):
            return candidate
    return None


def _find_captures(run_dir: str) -> Tuple[List[Tuple[str, str]], List[str]]:
    spans: List[Tuple[str, str]] = []
    metrics: List[str] = []
    for root in [run_dir] + sorted(
        p for p in glob.glob(os.path.join(run_dir, "*")) if os.path.isdir(p)
    ):
        if os.path.basename(root) == "sched-journal":
            continue
        for path in sorted(glob.glob(os.path.join(root, "trace*.jsonl"))):
            spans.append((path, "trace"))
        for path in sorted(glob.glob(os.path.join(root, "flight.*.jsonl"))):
            spans.append((path, "flight"))
        metrics.extend(sorted(glob.glob(os.path.join(root, "metrics*.prom"))))
    return spans, metrics


def _journal_offsets(
    captures: List[CaptureFile], events: List[dict]
) -> None:
    """Fill each capture's mono->wall offset, preferring journal pairs.

    A worker's ``leased`` event is journaled immediately before the
    matching ``sched:task`` span opens, and ``committed`` immediately
    after it closes — both by the same process that stamped the span's
    monotonic clock, so each pair is one observation of that process's
    offset. The median absorbs fsync/replay latency outliers.
    """
    leased: Dict[tuple, float] = {}
    committed: Dict[tuple, float] = {}
    for event in events:
        key = (
            event.get("id"), event.get("attempt"), event.get("worker")
        )
        ts = event.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if event.get("event") == "leased":
            leased[key] = float(ts)
        elif event.get("event") == "committed":
            committed[key] = float(ts)
    for capture in captures:
        deltas: List[float] = []
        for record in capture.records:
            if record.get("name") != "sched:task":
                continue
            attrs = record.get("attrs") or {}
            key = (
                attrs.get("task_id"), attrs.get("attempt"),
                record.get("worker"),
            )
            ts, dur = record.get("ts"), record.get("dur", 0.0)
            if not isinstance(ts, (int, float)):
                continue
            if key in leased:
                deltas.append(leased[key] - float(ts))
            if key in committed:
                deltas.append(committed[key] - (float(ts) + float(dur)))
        if deltas:
            capture.offset = statistics.median(deltas)
            capture.offset_source = "journal"
            continue
        meta = capture.clock_meta
        if meta is not None:
            capture.offset = float(meta["wall"]) - float(meta["mono"])
            capture.offset_source = "clock-meta"


def discover(run_dir: str) -> FleetRun:
    """Load every capture + the journal under ``run_dir``, normalized."""
    run_dir = os.path.abspath(run_dir)
    journal_dir = _find_journal_dir(run_dir)
    run = FleetRun(run_dir=run_dir, journal_dir=journal_dir)
    span_files, run.metrics_files = _find_captures(run_dir)
    for path, kind in span_files:
        capture = load_capture(path, kind)
        if capture.torn:
            run.warnings.append(
                f"{path}: torn/unparseable trailing line "
                "(crashed or still-writing worker); parsed what terminated"
            )
        if capture.bad_lines:
            run.warnings.append(
                f"{path}: skipped {capture.bad_lines} malformed line(s)"
            )
        run.captures.append(capture)
    run.pulse_rings = _pulse.load_rings(run_dir)
    run.mesh_dumps = load_mesh_dumps(run_dir)
    if journal_dir is not None:
        from ..sched import Journal

        journal = Journal(journal_dir, worker_id="fleet-read")
        run.tasks, run.states = journal.replay()
        run.events = journal.events()
        # worker META events (mesh announcements) ride the same event
        # list — fold them out of the copy already in hand rather than
        # re-reading every events-*.jsonl through worker_meta()
        for event in run.events:
            if event.get("event") != "worker":
                continue
            worker = event.get("worker")
            if isinstance(worker, str) and isinstance(
                event.get("mesh"), dict
            ):
                run.worker_meshes[worker] = event["mesh"]
    _journal_offsets(run.captures, run.events)
    any_anchored = any(c.offset is not None for c in run.captures)
    for capture in run.captures:
        if capture.offset is None and capture.records:
            run.warnings.append(
                f"{capture.path}: no clock anchor (no scheduler spans, no "
                "clock meta); "
                + (
                    "excluded from the merged timeline"
                    if any_anchored
                    else "spans placed on the process clock"
                )
            )
    return run


# ------------------------------------------------------------- analysis

def _percentile(values: List[float], q: float) -> float:
    ordered = sorted(values)
    if not ordered:
        return 0.0
    index = min(int(q * (len(ordered) - 1) + 0.5), len(ordered) - 1)
    return ordered[index]


def analyze(run: FleetRun) -> Dict[str, Any]:
    """The run-level report: lanes, task stats, critical path, attribution.

    Returned dict is JSON-serializable (the ``timeline --json`` payload).
    """
    spans = run.merged_spans()
    by_worker: Dict[str, List[dict]] = {}
    for record in spans:
        by_worker.setdefault(str(record.get("worker")), []).append(record)

    # --- committed-task attribution: which lineage produced the artifact
    task_rows: Dict[str, dict] = {}
    committing_spans: List[dict] = []
    for tid, task in run.tasks.items():
        state = run.states.get(tid)
        row = {
            "id": tid,
            "name": getattr(task, "name", tid),
            "state": getattr(state, "state", "pending"),
            "worker": getattr(state, "worker", None),
            "attempts": getattr(state, "attempts", 0),
            "steals": getattr(state, "steals", 0),
            "span_workers": [],
            "committing_span": None,
            "duration": None,
            # scx-xprof columns: padded-dispatch occupancy and bytes over
            # the device link, summed from the task's pipeline spans (the
            # gatherer stamps real_rows/padded_rows on compute spans and
            # bytes on upload/writeback)
            "occupancy": None,
            "transfer_bytes": 0,
            "_real_rows": 0,
            "_padded_rows": 0,
        }
        task_rows[tid] = row
    for record in spans:
        attrs = record.get("attrs") or {}
        tid = attrs.get("task_id") or record.get("task_id")
        if tid not in task_rows:
            continue
        row = task_rows[tid]
        worker = str(record.get("worker"))
        if worker not in row["span_workers"]:
            row["span_workers"].append(worker)
        if isinstance(attrs.get("padded_rows"), (int, float)):
            row["_real_rows"] += int(attrs.get("real_rows") or 0)
            row["_padded_rows"] += int(attrs["padded_rows"])
        if record.get("name") in ("upload", "writeback") and isinstance(
            attrs.get("bytes"), (int, float)
        ):
            row["transfer_bytes"] += int(attrs["bytes"])
        if record.get("name") != "sched:task" or record.get("error"):
            continue
        if row["state"] == "committed" and worker == row["worker"]:
            # the surviving lineage's execution of this task
            entry = {
                "task": row["name"],
                "task_id": tid,
                "worker": worker,
                "start": record["wall_ts"],
                "end": record["wall_ts"] + float(record.get("dur", 0.0)),
                "dur": float(record.get("dur", 0.0)),
                "stolen": bool(attrs.get("stolen")),
                "attempt": attrs.get("attempt"),
            }
            if row["committing_span"] is None or \
                    entry["end"] > row["committing_span"]["end"]:
                row["committing_span"] = entry
                row["duration"] = entry["dur"]
    for row in task_rows.values():
        padded = row.pop("_padded_rows")
        real = row.pop("_real_rows")
        if padded:
            row["occupancy"] = real / padded
    committing_spans = [
        row["committing_span"] for row in task_rows.values()
        if row["committing_span"] is not None
    ]

    # --- per-worker lanes: busy (task execution), wait (sched:wait), idle
    lanes: Dict[str, dict] = {}
    for worker, records in by_worker.items():
        start = min(r["wall_ts"] for r in records)
        end = max(r["wall_ts"] + float(r.get("dur", 0.0)) for r in records)
        task_s = sum(
            float(r.get("dur", 0.0)) for r in records
            if r.get("name") == "sched:task"
        )
        wait_s = sum(
            float(r.get("dur", 0.0)) for r in records
            if r.get("name") == "sched:wait"
        )
        real_rows = 0
        padded_rows = 0
        transfer_bytes = 0
        for r in records:
            attrs = r.get("attrs") or {}
            if isinstance(attrs.get("padded_rows"), (int, float)):
                real_rows += int(attrs.get("real_rows") or 0)
                padded_rows += int(attrs["padded_rows"])
            if r.get("name") in ("upload", "writeback") and isinstance(
                attrs.get("bytes"), (int, float)
            ):
                transfer_bytes += int(attrs["bytes"])
        window = max(end - start, 1e-9)
        has_sched = any(
            r.get("name", "").startswith("sched:") for r in records
        )
        if not has_sched:
            # a non-scheduled process (e.g. the launcher): busy = top-level
            # span coverage, bounded by the window
            task_s = min(
                window,
                sum(
                    float(r.get("dur", 0.0)) for r in records
                    if r.get("depth", 0) == 0
                ),
            )
        lanes[worker] = {
            "start": start,
            "end": end,
            "window_s": window,
            "busy_s": task_s,
            "wait_s": wait_s,
            "idle_s": max(0.0, window - task_s - wait_s),
            "busy_frac": min(1.0, task_s / window),
            "wait_frac": min(1.0, wait_s / window),
            "idle_frac": max(0.0, 1.0 - min(1.0, (task_s + wait_s) / window)),
            "spans": len(records),
            "tasks": sum(
                1 for s in committing_spans if s["worker"] == worker
            ),
            "steals": sum(
                1 for s in committing_spans
                if s["worker"] == worker and s["stolen"]
            ),
            "occupancy": (
                real_rows / padded_rows if padded_rows else None
            ),
            "transfer_bytes": transfer_bytes,
        }

    # --- task duration stats + stragglers
    durations = [s["dur"] for s in committing_spans]
    p50 = _percentile(durations, 0.5)
    p95 = _percentile(durations, 0.95)
    longest = max(durations) if durations else 0.0
    stats = {
        "n": len(durations),
        "p50_s": p50,
        "p95_s": p95,
        "max_s": longest,
        "skew": (longest / p50) if p50 > 0 else None,
    }
    # per-task straggler diagnosis: a task slow because its dispatches ran
    # mostly on padding (tiny chunk in a big bucket, or a pathological
    # batch cut) reads directly off the occupancy column — "slow because
    # 12% occupancy" — instead of needing a per-worker trace dive
    occupancies = [
        row["occupancy"] for row in task_rows.values()
        if row["occupancy"] is not None
    ]
    occupancy_median = (
        statistics.median(occupancies) if occupancies else None
    )
    stragglers = []
    for span_entry in sorted(
        (
            s for s in committing_spans
            if p50 > 0 and s["dur"] > 2.0 * p50
        ),
        key=lambda s: -s["dur"],
    ):
        entry = dict(span_entry)
        row = task_rows.get(entry["task_id"]) or {}
        occupancy = row.get("occupancy")
        entry["occupancy"] = occupancy
        if (
            occupancy is not None
            and occupancy_median
            and occupancy < 0.5 * occupancy_median
        ):
            entry["diagnosis"] = (
                f"slow because {100 * occupancy:.0f}% occupancy "
                f"(fleet median {100 * occupancy_median:.0f}%)"
            )
        elif entry["stolen"]:
            entry["diagnosis"] = "waited out a dead worker's lease"
        else:
            entry["diagnosis"] = ""
        stragglers.append(entry)

    # --- critical path: the chain of executions that bounded the run.
    # From the last-finishing committed execution walk backwards: the
    # predecessor is the latest execution on the SAME worker that finished
    # before this one started (that worker could not have started sooner
    # because it was busy with exactly that task). A stolen link explains
    # a gap: the chain waited out a dead worker's lease TTL.
    chain: List[dict] = []
    if committing_spans:
        current = max(committing_spans, key=lambda s: s["end"])
        guard = 0
        while current is not None and guard <= len(committing_spans):
            guard += 1
            chain.append(current)
            same_lane = [
                s for s in committing_spans
                if s["worker"] == current["worker"]
                and s is not current
                and s["end"] <= current["start"] + 1e-6
            ]
            current = max(same_lane, key=lambda s: s["end"]) \
                if same_lane else None
        chain.reverse()

    # --- scx-pulse heartbeats: per-worker windowed rates + bubble
    # attribution. A ring FILE is authoritative; a flight record's
    # embedded pulse section (the last few heartbeats a SIGTERM'd worker
    # carried out) only fills in for workers with no ring on disk —
    # the same dedupe discipline as flight-vs-sink spans.
    pulse_keys = (
        "heartbeats", "cells_per_s", "occupancy", "retraces",
        "bubble_fraction", "limiting_stage",
    )
    pulse_workers: Dict[str, dict] = {}
    for worker, ring in sorted(run.pulse_rings.items()):
        row = _pulse.worker_row(ring["records"])
        pulse_workers[worker] = {
            **{key: row[key] for key in pulse_keys}, "source": "ring",
        }
    for capture in run.captures:
        if capture.kind != "flight":
            continue
        section = ((capture.flight_meta or {}).get("sections") or {}).get(
            "pulse"
        )
        if not isinstance(section, dict) or capture.worker in pulse_workers:
            continue
        recent = [
            r for r in (section.get("recent") or [])
            if isinstance(r, dict) and isinstance(r.get("legs"), dict)
        ]
        if not recent:
            continue
        row = _pulse.worker_row(recent)
        pulse_workers[capture.worker] = {
            **{key: row[key] for key in pulse_keys},
            "heartbeats": int(section.get("seq") or row["heartbeats"]),
            "source": "flight",
        }

    # --- scx-mesh collective witness: per-worker collective counts and
    # operand bytes (mesh.<worker>.json dumps), so merge cost is visible
    # next to the transfer columns; absent dumps -> absent section
    collective_workers: Dict[str, dict] = {}
    for worker, dumped in sorted(run.mesh_dumps.items()):
        counts = {
            str(k): int(v) for k, v in (dumped.get("counts") or {}).items()
        }
        nbytes = {
            str(k): int(v) for k, v in (dumped.get("bytes") or {}).items()
        }
        collective_workers[worker] = {
            "counts": counts,
            "bytes": nbytes,
            "issued": sum(counts.values()),
            "operand_bytes": sum(nbytes.values()),
            "violations": len(dumped.get("violations") or ()),
            "mesh": run.worker_meshes.get(worker),
        }

    # --- scx-slo: per-job serve traces (submit->lease->pack->device->
    # commit decomposition + pro-rata device cost), only when the
    # journal carries serve jobs; a stitch failure degrades to absence
    serve_slo = None
    try:
        from . import slo as _slo

        if any(
            getattr(task, "kind", None) == _slo.SERVE_KIND
            for task in run.tasks.values()
        ):
            serve_slo = _slo.stitch(
                run.tasks, run.events, run.pulse_rings,
                run_dir=run.run_dir,
            )
    except Exception:  # noqa: BLE001 - telemetry must not kill the timeline
        serve_slo = None

    wall_start = min((l["start"] for l in lanes.values()), default=0.0)
    wall_end = max((l["end"] for l in lanes.values()), default=0.0)
    flights = [
        {
            "path": c.path,
            "worker": c.worker,
            "reason": (c.flight_meta or {}).get("reason", ""),
            "open_spans": (c.flight_meta or {}).get("open_spans", []),
            "spans": len(c.records),
        }
        for c in run.captures if c.kind == "flight"
    ]
    states = [row["state"] for row in task_rows.values()]
    return {
        "run_dir": run.run_dir,
        "journal_dir": run.journal_dir,
        "wall_window_s": max(0.0, wall_end - wall_start),
        "wall_start": wall_start,
        "workers": lanes,
        "tasks": {
            row["name"]: {
                key: row[key] for key in (
                    "id", "state", "worker", "attempts", "steals",
                    "span_workers", "duration", "occupancy",
                    "transfer_bytes",
                )
            }
            for row in task_rows.values()
        },
        "occupancy_median": occupancy_median,
        "serve_slo": serve_slo,
        "pulse": pulse_workers,
        "collectives": collective_workers,
        "worker_meshes": dict(run.worker_meshes),
        "task_totals": {
            state: states.count(state) for state in sorted(set(states))
        },
        "task_stats": stats,
        "stragglers": stragglers,
        "critical_path": chain,
        "flight_records": flights,
        "captures": [
            {
                "path": c.path, "kind": c.kind, "worker": c.worker,
                "spans": len(c.records), "offset": c.offset,
                "offset_source": c.offset_source, "torn": c.torn,
            }
            for c in run.captures
        ],
        "warnings": list(run.warnings),
    }


# ------------------------------------------------------------ rendering

_LANE_WIDTH = 48


def _lane_bar(
    records: List[dict], start: float, end: float, width: int = _LANE_WIDTH
) -> str:
    """ASCII gantt cell row: '#' task, '~' wait, '·' idle."""
    if end <= start:
        return "·" * width
    cells = [0] * width  # 0 idle, 1 wait, 2 task
    scale = width / (end - start)
    # workers that never closed a sched:task span (a crashed worker, or a
    # plain non-scheduled process) paint their top-level spans instead, so
    # the lane still shows when the process was actually doing work
    has_tasks = any(r.get("name") == "sched:task" for r in records)
    for record in records:
        name = record.get("name")
        if has_tasks:
            weight = 2 if name == "sched:task" else 1 \
                if name == "sched:wait" else 0
        else:
            weight = 2 if record.get("depth", 0) == 0 \
                and not str(name).startswith("sched:") else 0
        if not weight:
            continue
        lo = int((record["wall_ts"] - start) * scale)
        hi = int(
            (record["wall_ts"] + float(record.get("dur", 0.0)) - start)
            * scale
        )
        for index in range(max(lo, 0), min(hi + 1, width)):
            cells[index] = max(cells[index], weight)
    return "".join("·~#"[c] for c in cells)


def render_timeline(run: FleetRun, analysis: Dict[str, Any]) -> str:
    """The human-facing ``obs timeline`` report."""
    lines: List[str] = []
    window = analysis["wall_window_s"]
    lanes = analysis["workers"]
    totals = analysis["task_totals"]
    lines.append(f"fleet timeline: {analysis['run_dir']}")
    n_flight = len(analysis["flight_records"])
    lines.append(
        f"wall window {window:.2f}s, {len(lanes)} worker(s), "
        f"{sum(l['spans'] for l in lanes.values())} span(s) from "
        f"{len(analysis['captures'])} capture(s)"
        + (f" ({n_flight} flight record(s))" if n_flight else "")
    )
    if analysis["tasks"]:
        summary = ", ".join(f"{k}={v}" for k, v in sorted(totals.items()))
        steals = sum(l["steals"] for l in lanes.values())
        lines.append(
            f"tasks: {len(analysis['tasks'])} ({summary}), "
            f"{steals} steal(s)"
        )
    lines.append("")
    if lanes:
        spans = run.merged_spans()
        start = analysis["wall_start"]
        name_width = max(len(w) for w in lanes)
        lines.append(
            f"{'worker'.ljust(name_width)}  "
            f"{'lane (#task ~wait ·idle)'.ljust(_LANE_WIDTH)}  "
            "busy%  wait%  idle%  tasks  steals   occ%  moved_MB"
        )
        for worker in sorted(lanes):
            lane = lanes[worker]
            records = [s for s in spans if s.get("worker") == worker]
            bar = _lane_bar(records, start, start + window)
            occupancy = lane.get("occupancy")
            occ = (
                f"{100 * occupancy:5.1f}" if occupancy is not None
                else "    -"
            )
            moved = lane.get("transfer_bytes") or 0
            lines.append(
                f"{worker.ljust(name_width)}  {bar}  "
                f"{100 * lane['busy_frac']:5.1f}  "
                f"{100 * lane['wait_frac']:5.1f}  "
                f"{100 * lane['idle_frac']:5.1f}  "
                f"{lane['tasks']:5d}  {lane['steals']:6d}  "
                f"{occ}  {moved / 1e6:8.1f}"
            )
        lines.append("")
    pulse_rows = analysis.get("pulse") or {}
    if pulse_rows:
        lines.append(
            "pulse (live heartbeat rings; `obs pulse` for the full view):"
        )
        for worker in sorted(pulse_rows):
            row = pulse_rows[worker]
            bubble = row.get("bubble_fraction")
            bub = f"{100 * bubble:.1f}%" if bubble is not None else "-"
            lines.append(
                f"  {worker}: {row['heartbeats']} heartbeat(s), "
                f"{row['cells_per_s'] or 0.0:.1f} cells/s, bubble {bub} "
                f"limited by {row.get('limiting_stage') or '-'}"
                + (" (from flight record)" if row["source"] == "flight"
                   else "")
            )
        lines.append("")
    serve_slo = analysis.get("serve_slo") or {}
    if serve_slo.get("jobs"):
        fleet_slo = serve_slo.get("fleet") or {}
        complete = fleet_slo.get("complete_fraction")
        lines.append(
            "serve jobs (scx-slo traces; `obs slo` for the full view): "
            + (
                f"trace {100 * complete:.0f}% complete"
                if complete is not None
                else "trace -"
            )
        )
        for job in serve_slo["jobs"]:
            legs = job.get("legs")
            if legs:
                detail = (
                    f"queue {legs['queue_wait']:.2f} "
                    f"pack {legs['pack_wait']:.2f} "
                    f"device {legs['device']:.2f} "
                    f"writeback {legs['writeback']:.2f} "
                    f"commit {legs['commit']:.2f}"
                )
            else:
                detail = "incomplete trace"
            e2e = job.get("e2e_s")
            cost = job.get("cost") or {}
            lines.append(
                f"  {job['name']}  "
                + (f"{e2e:.2f}s" if e2e is not None else "-")
                + f"  [{detail}]  "
                f"dev {cost.get('device_s', 0.0):.3f}s"
                + (
                    f"  pack x{job['pack_size']}"
                    if job.get("pack_size")
                    else ""
                )
                + (" (stolen)" if job.get("stolen") else "")
            )
        lines.append("")
    collective_rows = analysis.get("collectives") or {}
    if collective_rows:
        lines.append(
            "collectives (mesh witness dumps; `obs efficiency` for the "
            "fleet totals):"
        )
        for worker in sorted(collective_rows):
            row = collective_rows[worker]
            mesh = row.get("mesh") or {}
            shape = ",".join(
                f"{axis}={size}"
                for axis, size in zip(
                    mesh.get("axes") or [], mesh.get("sizes") or []
                )
            ) or "?"
            per_kind = ", ".join(
                f"{name} x{count}"
                for name, count in sorted(row["counts"].items())
            ) or "none"
            lines.append(
                f"  {worker} (mesh {shape}): {per_kind}, "
                f"{row['operand_bytes'] / 1e6:.2f} MB operand, "
                f"{row['violations']} violation(s)"
            )
        lines.append("")
    stats = analysis["task_stats"]
    if stats["n"]:
        skew = f"{stats['skew']:.1f}x" if stats["skew"] else "-"
        lines.append(
            f"task durations: n={stats['n']}  p50={stats['p50_s']:.3f}s  "
            f"p95={stats['p95_s']:.3f}s  max={stats['max_s']:.3f}s  "
            f"skew(max/p50)={skew}"
        )
        for straggler in analysis["stragglers"][:5]:
            diagnosis = straggler.get("diagnosis") or ""
            lines.append(
                f"  straggler: {straggler['task']} {straggler['dur']:.3f}s "
                f"on {straggler['worker']}"
                + (" (stolen)" if straggler["stolen"] else "")
                + (f" — {diagnosis}" if diagnosis else "")
            )
        lines.append("")
    chain = analysis["critical_path"]
    if chain:
        chained = sum(link["dur"] for link in chain)
        lines.append(
            f"critical path ({len(chain)} task(s), {chained:.3f}s of "
            f"{window:.2f}s wall):"
        )
        start = analysis["wall_start"]
        for index, link in enumerate(chain, 1):
            lines.append(
                f"  {index}. {link['task']}  {link['worker']}  "
                f"{link['start'] - start:.3f}-{link['end'] - start:.3f}s  "
                f"{link['dur']:.3f}s"
                + (" (stolen)" if link["stolen"] else "")
            )
        lines.append("")
    if analysis["flight_records"]:
        lines.append("flight records (crashed-worker postmortems):")
        for flight in analysis["flight_records"]:
            where = " > ".join(flight["open_spans"]) or "-"
            lines.append(
                f"  {flight['worker']}: {flight['reason'] or 'unknown'} "
                f"(open: {where}; {flight['spans']} buffered span(s))"
            )
        lines.append("")
    for warning in analysis["warnings"]:
        lines.append(f"warning: {warning}")
    return "\n".join(lines).rstrip() + "\n"
