"""scx-audit for the port: the record conservation ledger and explains.

The port's copy of ``sctools_tpu.obs.audit``, with the same stage names,
journal extras, sidecar and report, so that each package's ``obs audit``
balances the other's journals. Where the perf planes (pulse, xprof, slo,
delta) answer "where did the time go", this module answers "where did the
DATA go" — a machine-checked proof that

    records decoded == records computed + records quarantined
    rows computed   == rows emitted    + rows filtered
    merge rows_in   == merge rows_out  + merged:collision

holds EXACTLY, per task and fleet-wide, with every loss named.

Write side — the RecordLedger. A process-global accumulator of plain
integer counts keyed by ``(task_id, stage, reason)``. Pipeline stages
that create, split, drop, or emit records call :func:`add` with a stage
name; the task identity comes from the obs context the scheduler (or
the serve packer's ``_trace_task``) stamps around the task body, so the
ring's prefetch thread and the writeback path attribute correctly
without threading ids by hand. One dict update under a lock per BATCH
(never per record), on host ints the batch already has: a tap never
reads a device tensor.

Stage vocabulary (the ledger schema):

===========================  ==============================================
key                          counted where
===========================  ==============================================
``records.ingested``         ingest ring producer, per handed-off frame
``records.decoded``          stream consumer (gatherer/count), per frame
``records.computed``         guard.run_batch, per (sub-)frame whose
                             dispatch succeeded (post filter, post split)
``records.quarantined:R``    guard.quarantine, per isolated range, by the
                             sidecar reason's exception class ``R``
``rows.computed``            gatherer finalize, per device batch entities
``rows.emitted``             MetricCSVWriter, per row/block written
``rows.filtered:R``          gatherer row filter (``multi_gene``)
===========================  ==============================================

Transport: the scheduler pops the committed task's counts with
:func:`take` and attaches them as the ``audit`` extra of the existing
``committed`` journal event; the serve packer attaches per-execution
ledgers and per-member routed/claimed row counts to the ``pack_execs``
segments it already journals. File-level and collective merges append
one JSONL line to ``<journal_dir>/audit-merge.jsonl`` via
:func:`record_merge`. No new daemon, no new wire format.

Read side: :func:`audit_run` folds journals + quarantine sidecars +
merge sidecars into a conservation report (``python -m
sctools_tpu_torch.obs audit <run_dir>``, exit nonzero on ANY unexplained
record); :func:`explain_run` traces one barcode / record index / job
through chunk -> task -> attempts/steals -> pack membership -> quarantine
or output file:row; :func:`render_audit_metrics` feeds the per-tenant
``sctools_tpu_audit_*`` gauges on the pulse exporter.

Pure stdlib, like the rest of obs.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.witness import make_lock
from .. import obs as _obs

_lock = make_lock("obs.audit")

#: task_id -> {"stage" or "stage:reason" -> count}; "" holds counts
#: recorded outside any task context (never journaled, never read back)
_ledger: Dict[str, Dict[str, int]] = {}

MERGE_SIDECAR = "audit-merge.jsonl"


# --------------------------------------------------------- the write side


def add(
    stage: str, n: int, reason: str = "", task_id: Optional[str] = None
) -> None:
    """Accumulate ``n`` records/rows for ``stage`` under the current task.

    The task identity defaults to the obs-context ``task_id`` (set by the
    scheduler around task bodies and by the serve packer per execution),
    so helper threads — the ring's prefetch decode, the writeback drain —
    attribute to the task that owns them. Integer adds under one lock,
    called per batch: the whole hot-path cost of the ledger.
    """
    if n == 0:
        return
    tid = task_id if task_id is not None else _obs._context.get("task_id")
    key = f"{stage}:{reason}" if reason else stage
    with _lock:
        bucket = _ledger.get(tid or "")
        if bucket is None:
            bucket = _ledger[tid or ""] = {}
        bucket[key] = bucket.get(key, 0) + int(n)


def take(task_id: str) -> Dict[str, int]:
    """Pop and return the folded counts for one task (commit time).

    Returns ``{}`` when the task recorded nothing. Popping (not reading)
    keeps a retried task's second attempt from inheriting counts the
    first attempt left behind in the same process.
    """
    with _lock:
        return _ledger.pop(task_id, None) or {}


def discard(task_id: str) -> None:
    """Drop a task's partial counts (the failure-path companion of
    :func:`take`): a failed attempt's half-ledger must not pollute the
    retry's balance."""
    with _lock:
        _ledger.pop(task_id, None)


def peek(task_id: str) -> Dict[str, int]:
    """Read (without popping) one task's counts — test/diagnostic use."""
    with _lock:
        return dict(_ledger.get(task_id) or {})


def reset() -> None:
    """Clear every bucket (tests)."""
    with _lock:
        _ledger.clear()


def record_merge(
    journal_dir: Optional[str],
    op: str,
    output: str,
    parts: int,
    rows_in: int,
    rows_out: int,
    collisions: int = 0,
) -> Dict[str, Any]:
    """Append one merge-accounting entry to the journal's merge sidecar.

    A merge FOLDS rows — gene collisions across parts combine into one
    output row — and the conservation report must read that fold as
    ``merged:collision``, not as loss. With no ``journal_dir`` the entry
    is still built and returned (callers expose it as ``.audit``).
    """
    entry = {
        "op": op,
        "output": output,
        "parts": int(parts),
        "rows_in": int(rows_in),
        "rows_out": int(rows_out),
        "merged:collision": int(collisions),
        "ts": round(time.time(), 6),  # scx-lint: disable=SCX109 -- cross-process timestamp, not a duration
    }
    if journal_dir:
        path = os.path.join(journal_dir, MERGE_SIDECAR)
        line = json.dumps(entry, sort_keys=True, separators=(",", ":"))
        try:
            os.makedirs(journal_dir, exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            # sidecar IO failure must not fail the merge it describes
            pass
    return entry


def load_merges(journal_dir: str) -> List[Dict[str, Any]]:
    """Every merge-accounting entry under one journal dir (append order)."""
    path = os.path.join(journal_dir, MERGE_SIDECAR)
    entries: List[Dict[str, Any]] = []
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
        pass
    return entries


# ---------------------------------------------------------- ledger algebra


def ledger_sum(ledger: Dict[str, int], stage: str) -> int:
    """Total over one stage including every ``stage:reason`` variant."""
    prefix = stage + ":"
    return sum(
        int(v)
        for k, v in ledger.items()
        if k == stage or k.startswith(prefix)
    )


def ledger_reasons(ledger: Dict[str, int], stage: str) -> Dict[str, int]:
    """``{reason: count}`` for one stage's reason-tagged variants."""
    prefix = stage + ":"
    out: Dict[str, int] = {}
    for k, v in ledger.items():
        if k.startswith(prefix):
            reason = k[len(prefix):]
            out[reason] = out.get(reason, 0) + int(v)
    return out


def balance(ledger: Dict[str, int]) -> Dict[str, Any]:
    """The two conservation equations over one ledger.

    Each space is checked only when its input side is present (a CPU-path
    task counts emitted rows but no device batches; a count task has no
    row space at all), so a missing stage is "not audited", never a
    phantom loss.
    """
    decoded = ledger_sum(ledger, "records.decoded")
    computed = ledger_sum(ledger, "records.computed")
    quarantined = ledger_sum(ledger, "records.quarantined")
    ingested = ledger_sum(ledger, "records.ingested")
    rows_computed = ledger_sum(ledger, "rows.computed")
    emitted = ledger_sum(ledger, "rows.emitted")
    filtered = ledger_sum(ledger, "rows.filtered")
    unexplained = 0
    if decoded:
        unexplained += abs(decoded - computed - quarantined)
        if ingested:
            # the ring handed off a different record count than the
            # consumer saw: a dropped or duplicated frame
            unexplained += abs(ingested - decoded)
    if rows_computed:
        unexplained += abs(rows_computed - emitted - filtered)
    return {
        "records": {
            "ingested": ingested,
            "decoded": decoded,
            "computed": computed,
            "quarantined": quarantined,
            "quarantined_reasons": ledger_reasons(
                ledger, "records.quarantined"
            ),
        },
        "rows": {
            "computed": rows_computed,
            "emitted": emitted,
            "filtered": filtered,
            "filtered_reasons": ledger_reasons(ledger, "rows.filtered"),
        },
        "unexplained": unexplained,
    }


# ------------------------------------------------------------ the run fold


def _journal_dirs(run_dir: str) -> List[str]:
    from . import slo

    return slo.find_journal_dirs(run_dir)


def _first_committed(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """First committed event per task, in the journal's fold order.

    First-commit-wins is the journal's replay contract; a late duplicate
    commit (a stolen task's loser finishing anyway) must not double the
    audited counts.
    """
    out: Dict[str, Dict[str, Any]] = {}
    for event in events:
        tid = event.get("id")
        if (
            isinstance(tid, str)
            and event.get("event") == "committed"
            and tid not in out
        ):
            out[tid] = event
    return out


def _sidecar_by_task(quarantine_entries) -> Dict[str, List[Tuple]]:
    """Deduped quarantined ranges per task_id.

    A stolen/retried task re-isolates the same deterministic ranges on
    every attempt, and each attempt appends its own sidecar line; the
    conservation check compares the COMMITTED attempt's ledger against
    the distinct ranges, so duplicates from dead attempts collapse.
    """
    out: Dict[str, List[Tuple]] = {}
    seen = set()
    for entry in quarantine_entries:
        tid = entry.get("task_id") or ""
        key = (
            tid,
            entry.get("site"),
            entry.get("record_start"),
            entry.get("record_stop"),
        )
        if key in seen:
            continue
        seen.add(key)
        out.setdefault(tid, []).append(
            (
                int(entry.get("record_start") or 0),
                int(entry.get("record_stop") or 0),
                entry,
            )
        )
    return out


def _pack_segments(
    committed: Dict[str, Dict[str, Any]]
) -> Dict[str, Dict[str, Any]]:
    """Unique executed pack segments across every member's commit extras."""
    out: Dict[str, Dict[str, Any]] = {}
    for event in committed.values():
        for segment in event.get("pack_execs") or ():
            if not isinstance(segment, dict):
                continue
            exec_id = segment.get("exec_id")
            if isinstance(exec_id, str) and not segment.get("aborted"):
                out.setdefault(exec_id, segment)
    return out


def audit_run(run_dir: str) -> Dict[str, Any]:
    """Fold one run directory into the conservation report dict.

    Raises ``OSError``/``ValueError`` when the run dir holds no journal;
    every other outcome — including an unbalanced run — is a report with
    ``fleet.unexplained`` (the CLI's exit signal) and per-task findings.
    """
    from ..guard.quarantine import load_quarantine
    from ..sched.journal import Journal

    dirs = _journal_dirs(run_dir)
    if not dirs:
        raise FileNotFoundError(f"no sched journal under {run_dir}")

    tasks: Dict[str, Dict[str, Any]] = {}
    findings: List[Dict[str, Any]] = []
    merges: List[Dict[str, Any]] = []
    serve_jobs: Dict[str, Dict[str, Any]] = {}
    fleet_ledger: Dict[str, int] = {}
    quarantine_ranges = 0
    quarantine_records = 0
    states_seen = {"committed": 0, "other": 0}

    def fold(ledger: Dict[str, int]) -> None:
        for key, value in ledger.items():
            fleet_ledger[key] = fleet_ledger.get(key, 0) + int(value)

    for journal_dir in dirs:
        journal = Journal(journal_dir, worker_id="audit-reader")
        specs, states = journal.replay()
        events = journal.events()
        journal.close()
        committed = _first_committed(events)
        sidecars = _sidecar_by_task(
            load_quarantine(os.path.join(journal_dir, "quarantine"))
        )
        segments = _pack_segments(committed)
        merges.extend(load_merges(journal_dir))

        history: Dict[str, List[Dict[str, Any]]] = {}
        for event in events:
            tid = event.get("id")
            if isinstance(tid, str):
                history.setdefault(tid, []).append(event)

        for tid, state in states.items():
            spec = specs.get(tid)
            if state.state != "committed":
                states_seen["other"] += 1
                continue
            states_seen["committed"] += 1
            event = committed.get(tid, {})
            is_serve = "pack" in event
            ledger = event.get("audit") if not is_serve else None
            entry: Dict[str, Any] = {
                "id": tid,
                "name": spec.name if spec else None,
                "kind": spec.kind if spec else None,
                "journal": journal_dir,
                "worker": state.worker,
                "attempts": state.attempts,
                "steals": state.steals,
                "part": state.part,
                "serve": is_serve,
                "ledger": ledger,
                "balance": None,
                "unexplained": 0,
                "problems": [],
            }
            if isinstance(ledger, dict):
                fold(ledger)
                entry["balance"] = balance(ledger)
                entry["unexplained"] = entry["balance"]["unexplained"]
                if entry["unexplained"]:
                    entry["problems"].append(
                        f"ledger imbalance: {entry['unexplained']} "
                        "unexplained"
                    )
                # the sidecar cross-check: the ledger's quarantined count
                # must match the distinct sidecar ranges record-for-record
                ranges = sidecars.get(tid, [])
                sidecar_records = sum(b - a for a, b, _ in ranges)
                ledger_quarantined = entry["balance"]["records"][
                    "quarantined"
                ]
                entry["sidecar_quarantined"] = sidecar_records
                if sidecar_records != ledger_quarantined:
                    skew = abs(sidecar_records - ledger_quarantined)
                    entry["unexplained"] += skew
                    entry["problems"].append(
                        f"quarantine sidecar skew: ledger says "
                        f"{ledger_quarantined}, sidecars hold "
                        f"{sidecar_records}"
                    )
                quarantine_ranges += len(ranges)
                quarantine_records += sidecar_records
            elif is_serve:
                member = event.get("audit")
                job = {
                    "id": tid,
                    "tenant": str(
                        (spec.payload if spec else {}).get("tenant", "?")
                    ),
                    "journal": journal_dir,
                    "pack": event.get("pack"),
                    "rows_emitted": None,
                    "rows_claimed": None,
                    "unexplained": 0,
                    "problems": [],
                }
                if isinstance(member, dict):
                    emitted = member.get("rows_emitted")
                    claimed = member.get("rows_claimed")
                    job["rows_emitted"] = emitted
                    job["rows_claimed"] = claimed
                    if (
                        emitted is not None
                        and claimed is not None
                        and emitted != claimed
                    ):
                        job["unexplained"] = abs(emitted - claimed)
                        job["problems"].append(
                            f"routed {emitted} rows but claimed {claimed} "
                            "entities"
                        )
                serve_jobs[tid] = job
                entry["unexplained"] = job["unexplained"]
                entry["problems"] = list(job["problems"])
            tasks[tid] = entry
            entry["history"] = [
                {
                    "event": e.get("event"),
                    "worker": e.get("worker"),
                    "attempt": e.get("attempt"),
                    "stolen": e.get("stolen"),
                    "ts": e.get("ts"),
                }
                for e in history.get(tid, ())
            ]
            if entry["unexplained"]:
                findings.append(entry)

        # pack execution ledgers: each device run (packed or solo) must
        # balance on its own, and a packed run's routed rows must sum to
        # the execution's emitted total
        for exec_id, segment in segments.items():
            ledger = segment.get("ledger")
            if not isinstance(ledger, dict):
                continue
            fold(ledger)
            seg_balance = balance(ledger)
            unexplained = seg_balance["unexplained"]
            problems = []
            routed = segment.get("rows_routed")
            if isinstance(routed, list):
                total_routed = sum(int(r) for r in routed)
                emitted = seg_balance["rows"]["emitted"]
                if total_routed != emitted:
                    unexplained += abs(total_routed - emitted)
                    problems.append(
                        f"pack routed {total_routed} rows but execution "
                        f"emitted {emitted}"
                    )
            ranges = sidecars.get(exec_id, [])
            sidecar_records = sum(b - a for a, b, _ in ranges)
            if sidecar_records != seg_balance["records"]["quarantined"]:
                unexplained += abs(
                    sidecar_records
                    - seg_balance["records"]["quarantined"]
                )
                problems.append("quarantine sidecar skew on pack execution")
            quarantine_ranges += len(ranges)
            quarantine_records += sidecar_records
            if unexplained:
                findings.append(
                    {
                        "id": exec_id,
                        "name": f"pack:{exec_id}",
                        "kind": "pack-exec",
                        "journal": journal_dir,
                        "unexplained": unexplained,
                        "problems": problems
                        or ["pack execution ledger imbalance"],
                    }
                )

    merge_unexplained = 0
    for entry in merges:
        rows_in = int(entry.get("rows_in") or 0)
        rows_out = int(entry.get("rows_out") or 0)
        collisions = int(entry.get("merged:collision") or 0)
        skew = abs(rows_in - rows_out - collisions)
        entry["unexplained"] = skew
        if skew:
            merge_unexplained += skew
            findings.append(
                {
                    "id": entry.get("output"),
                    "name": f"merge:{entry.get('op')}",
                    "kind": "merge",
                    "unexplained": skew,
                    "problems": [
                        f"merge {entry.get('output')!r}: {rows_in} rows in, "
                        f"{rows_out} out, {collisions} collision-folded"
                    ],
                }
            )

    total_unexplained = (
        sum(t["unexplained"] for t in tasks.values())
        + sum(
            f["unexplained"]
            for f in findings
            if f.get("kind") in ("pack-exec",)
        )
        + merge_unexplained
    )
    fleet = balance(fleet_ledger)
    losses: Dict[str, int] = {}
    for reason, n in fleet["records"]["quarantined_reasons"].items():
        losses[f"quarantined:{reason}"] = n
    bare = fleet["records"]["quarantined"] - sum(
        fleet["records"]["quarantined_reasons"].values()
    )
    if bare:
        losses["quarantined"] = bare
    for reason, n in fleet["rows"]["filtered_reasons"].items():
        losses[f"filtered:{reason}"] = n
    merge_collisions = sum(
        int(e.get("merged:collision") or 0) for e in merges
    )
    if merge_collisions:
        losses["merged:collision"] = merge_collisions

    audited = sum(
        1 for t in tasks.values() if t["balance"] is not None or t["serve"]
    )
    return {
        "run_dir": os.path.abspath(run_dir),
        "journals": dirs,
        "tasks": tasks,
        "serve_jobs": serve_jobs,
        "merges": merges,
        "findings": findings,
        "quarantine": {
            "ranges": quarantine_ranges,
            "records": quarantine_records,
        },
        "fleet": {
            "records": fleet["records"],
            "rows": fleet["rows"],
            "losses": losses,
            "tasks_committed": states_seen["committed"],
            "tasks_other": states_seen["other"],
            "tasks_audited": audited,
            "unexplained": total_unexplained,
            "exact": total_unexplained == 0,
        },
    }


def render_audit_report(report: Dict[str, Any]) -> str:
    """The conservation report as terminal text."""
    fleet = report["fleet"]
    records = fleet["records"]
    rows = fleet["rows"]
    lines = [
        f"scx-audit conservation report — {report['run_dir']}",
        f"journals: {len(report['journals'])}   tasks: "
        f"{fleet['tasks_committed']} committed "
        f"({fleet['tasks_audited']} audited), "
        f"{fleet['tasks_other']} not committed",
        "",
        "records",
        f"  ingested     {records['ingested']:>12}",
        f"  decoded      {records['decoded']:>12}",
        f"  computed     {records['computed']:>12}",
        f"  quarantined  {records['quarantined']:>12}",
    ]
    for reason, n in sorted(records["quarantined_reasons"].items()):
        lines.append(f"    - {reason}: {n}")
    lines += [
        "",
        "rows",
        f"  computed     {rows['computed']:>12}",
        f"  emitted      {rows['emitted']:>12}",
        f"  filtered     {rows['filtered']:>12}",
    ]
    for reason, n in sorted(rows["filtered_reasons"].items()):
        lines.append(f"    - {reason}: {n}")
    if report["merges"]:
        rows_in = sum(int(e.get("rows_in") or 0) for e in report["merges"])
        rows_out = sum(int(e.get("rows_out") or 0) for e in report["merges"])
        folded = sum(
            int(e.get("merged:collision") or 0) for e in report["merges"]
        )
        lines += [
            "",
            f"merges ({len(report['merges'])})",
            f"  rows in      {rows_in:>12}",
            f"  rows out     {rows_out:>12}",
            f"  collision-folded {folded:>8}",
        ]
    quarantine = report["quarantine"]
    lines += [
        "",
        f"quarantine sidecars: {quarantine['records']} record(s) in "
        f"{quarantine['ranges']} range(s)",
    ]
    if report["serve_jobs"]:
        emitted = sum(
            j["rows_emitted"] or 0 for j in report["serve_jobs"].values()
        )
        lines.append(
            f"serve: {len(report['serve_jobs'])} job(s), "
            f"{emitted} row(s) emitted"
        )
    if fleet["losses"]:
        lines.append("")
        lines.append("named losses/folds")
        for reason, n in sorted(fleet["losses"].items()):
            lines.append(f"  {reason}: {n}")
    lines.append("")
    if fleet["exact"]:
        lines.append("RESULT: EXACT — 0 unexplained records")
    else:
        lines.append(
            f"RESULT: UNBALANCED — {fleet['unexplained']} unexplained "
            "record(s)"
        )
        for finding in report["findings"]:
            label = finding.get("name") or finding.get("id")
            for problem in finding["problems"]:
                lines.append(f"  {label}: {problem}")
    return "\n".join(lines)


# ------------------------------------------------------------ explain side


def _iter_csv_rows(path: str):
    """(data_row_number, index_value, line) over one CSV artifact."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        f.readline()  # header
        for number, line in enumerate(f, start=1):
            if not line.strip():
                continue
            yield number, line.split(",", 1)[0], line.rstrip("\n")


def _task_story(
    tid: str,
    spec,
    history: List[Dict[str, Any]],
    committed: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    return {
        "id": tid,
        "name": spec.name if spec else None,
        "kind": spec.kind if spec else None,
        "payload": dict(spec.payload) if spec else {},
        "events": [
            {
                "event": e.get("event"),
                "worker": e.get("worker"),
                "attempt": e.get("attempt"),
                "stolen": e.get("stolen"),
                "error": e.get("error"),
                "ts": e.get("ts"),
            }
            for e in history
        ],
        "attempts": sum(1 for e in history if e.get("event") == "leased"),
        "steals": sum(
            int(e.get("stolen") or 0)
            for e in history
            if e.get("event") == "leased"
        ),
        "part": (committed or {}).get("part"),
        "ledger": (committed or {}).get("audit"),
        "pack": (committed or {}).get("pack"),
        "pack_members": (committed or {}).get("pack_members"),
    }


def explain_run(
    run_dir: str,
    barcode: Optional[str] = None,
    record: Optional[int] = None,
    job: Optional[str] = None,
) -> Dict[str, Any]:
    """Trace one entity's journey through the run.

    Exactly one selector drives the primary lookup: ``barcode`` scans the
    committed artifacts (and merged outputs) for the entity's row,
    ``record`` resolves an absolute decode-stream index against the
    quarantine sidecars, ``job`` pulls one task's full story by name or
    id (prefix). ``job`` may also be combined with ``record`` to scope
    the sidecar search. Returns ``{"found": bool, "matches": [...]}``.
    """
    from ..guard.quarantine import load_quarantine
    from ..sched.journal import Journal

    dirs = _journal_dirs(run_dir)
    if not dirs:
        raise FileNotFoundError(f"no sched journal under {run_dir}")
    matches: List[Dict[str, Any]] = []

    for journal_dir in dirs:
        journal = Journal(journal_dir, worker_id="audit-reader")
        specs, states = journal.replay()
        events = journal.events()
        journal.close()
        committed = _first_committed(events)
        history: Dict[str, List[Dict[str, Any]]] = {}
        for event in events:
            tid = event.get("id")
            if isinstance(tid, str):
                history.setdefault(tid, []).append(event)

        def story_of(tid: str) -> Dict[str, Any]:
            return _task_story(
                tid, specs.get(tid), history.get(tid, []),
                committed.get(tid),
            )

        wanted = None
        if job is not None:
            for tid, spec in specs.items():
                if spec.name == job or tid == job or tid.startswith(job):
                    wanted = tid
                    break

        if job is not None and record is None and barcode is None:
            if wanted is not None:
                quarantines = []
                seen_ranges = set()
                for e in load_quarantine(
                    os.path.join(journal_dir, "quarantine")
                ):
                    if e.get("task_id") != wanted:
                        continue
                    # retried/stolen attempts re-isolate the same
                    # deterministic ranges; show each range once
                    key = (
                        e.get("site"),
                        e.get("record_start"),
                        e.get("record_stop"),
                    )
                    if key in seen_ranges:
                        continue
                    seen_ranges.add(key)
                    quarantines.append(e)
                matches.append(
                    {
                        "kind": "job",
                        "journal": journal_dir,
                        "task": story_of(wanted),
                        "quarantined": quarantines,
                    }
                )
            continue

        if record is not None:
            seen = set()
            for entry in load_quarantine(
                os.path.join(journal_dir, "quarantine")
            ):
                start = int(entry.get("record_start") or 0)
                stop = int(entry.get("record_stop") or 0)
                tid = entry.get("task_id")
                if not (start <= record < stop):
                    continue
                if wanted is not None and tid != wanted:
                    continue
                key = (tid, entry.get("site"), start, stop)
                if key in seen:
                    continue
                seen.add(key)
                matches.append(
                    {
                        "kind": "quarantined-record",
                        "journal": journal_dir,
                        "record": record,
                        "range": [start, stop],
                        "site": entry.get("site"),
                        "input": entry.get("name"),
                        "reason": entry.get("reason"),
                        "worker": entry.get("worker"),
                        "task": story_of(tid) if tid else None,
                    }
                )
            continue

        if barcode is not None:
            for tid, state in states.items():
                if wanted is not None and tid != wanted:
                    continue
                part = state.part
                if not part or not os.path.exists(part):
                    continue
                try:
                    for number, index, line in _iter_csv_rows(part):
                        if index == barcode:
                            matches.append(
                                {
                                    "kind": "output-row",
                                    "journal": journal_dir,
                                    "barcode": barcode,
                                    "file": part,
                                    "row": number,
                                    "line": line[:200],
                                    "task": story_of(tid),
                                }
                            )
                            break
                except OSError:
                    continue
            for entry in load_merges(journal_dir):
                output = entry.get("output")
                if not output or not os.path.exists(output):
                    continue
                try:
                    for number, index, line in _iter_csv_rows(output):
                        if index == barcode:
                            matches.append(
                                {
                                    "kind": "merged-row",
                                    "journal": journal_dir,
                                    "barcode": barcode,
                                    "file": output,
                                    "row": number,
                                    "op": entry.get("op"),
                                }
                            )
                            break
                except OSError:
                    continue

    return {
        "run_dir": os.path.abspath(run_dir),
        "found": bool(matches),
        "matches": matches,
    }


def render_explain(result: Dict[str, Any]) -> str:
    """The explain result as terminal text."""
    if not result["found"]:
        return "no match — nothing in this run's journals, artifacts, " \
            "or quarantine sidecars matches the query"
    lines: List[str] = []
    for match in result["matches"]:
        kind = match["kind"]
        if kind in ("output-row", "merged-row"):
            lines.append(
                f"barcode {match['barcode']!r} -> {match['file']}:row "
                f"{match['row']}"
            )
        elif kind == "quarantined-record":
            start, stop = match["range"]
            lines.append(
                f"record {match['record']} -> QUARANTINED "
                f"[{start}, {stop}) at {match['site']} "
                f"({match['reason']})"
            )
            if match.get("input"):
                lines.append(f"  input: {match['input']}")
            lines.append(f"  isolated by: {match['worker']}")
        elif kind == "job":
            pass
        task = match.get("task")
        if task:
            name = task["name"] or task["id"]
            lines.append(
                f"  task {name} (id {task['id']}) — "
                f"{task['attempts']} attempt(s), {task['steals']} steal(s)"
            )
            payload = task.get("payload") or {}
            for key in ("bam", "chunk", "input", "tenant", "out"):
                if key in payload:
                    lines.append(f"    {key}: {payload[key]}")
            for event in task["events"]:
                stolen = " (stolen)" if event.get("stolen") else ""
                error = (
                    f" — {event['error']}" if event.get("error") else ""
                )
                lines.append(
                    f"    {event['event']}{stolen} on "
                    f"{event['worker']} (attempt "
                    f"{event.get('attempt')}){error}"
                )
            if task.get("pack"):
                members = task.get("pack_members") or []
                lines.append(
                    f"    packed: exec {task['pack']} with "
                    f"{len(members)} member(s)"
                )
            if task.get("part"):
                lines.append(f"    artifact: {task['part']}")
            if task.get("ledger"):
                rendered = ", ".join(
                    f"{k}={v}"
                    for k, v in sorted(task["ledger"].items())
                )
                lines.append(f"    ledger: {rendered}")
        quarantined = match.get("quarantined")
        if quarantined:
            for entry in quarantined:
                lines.append(
                    f"    quarantined [{entry.get('record_start')}, "
                    f"{entry.get('record_stop')}) at "
                    f"{entry.get('site')}: {entry.get('reason')}"
                )
    return "\n".join(lines)


# -------------------------------------------------------- pulse gauge side


def render_audit_metrics(run_dir: str) -> str:
    """Per-tenant ``sctools_tpu_audit_*`` gauges (Prometheus exposition).

    Rides the existing pulse exporter's run-dir mode, next to the slo and
    steer gauge blocks; an unreadable run dir renders as no gauges (the
    exporter's contract for optional blocks).
    """
    from . import pulse as _pulse

    try:
        report = audit_run(run_dir)
    except (OSError, ValueError):
        return ""
    lines: List[str] = []
    claimed: Dict[str, str] = {}
    header_done = set()

    def typed(metric: str) -> None:
        if metric not in header_done:
            header_done.add(metric)
            lines.append(f"# TYPE sctools_tpu_audit_{metric} gauge")

    def gauge(metric: str, tenant: Optional[str], value) -> None:
        if value is None:
            return
        name = f"sctools_tpu_audit_{metric}"
        typed(metric)
        if tenant is None:
            lines.append(f"{name} {value}")
            return
        label = _pulse._sanitize_label(tenant)
        series = f'{name}{{tenant="{label}"}}'
        previous = claimed.setdefault(series, tenant)
        if previous != tenant:
            raise ValueError(
                f"audit metric label collision after sanitizing: "
                f"{previous!r} and {tenant!r} both render as {series!r}"
            )
        lines.append(f"{series} {value}")

    tenants: Dict[str, Dict[str, int]] = {}
    for job in report["serve_jobs"].values():
        row = tenants.setdefault(
            job["tenant"], {"emitted": 0, "claimed": 0, "jobs": 0}
        )
        row["jobs"] += 1
        row["emitted"] += int(job["rows_emitted"] or 0)
        row["claimed"] += int(job["rows_claimed"] or job["rows_emitted"] or 0)
    for tenant, row in sorted(tenants.items()):
        gauge("rows_emitted_total", tenant, row["emitted"])
        gauge("rows_claimed_total", tenant, row["claimed"])
        gauge("jobs_audited", tenant, row["jobs"])
    fleet = report["fleet"]
    gauge("records_decoded_total", None, fleet["records"]["decoded"])
    gauge("records_quarantined_total", None, fleet["records"]["quarantined"])
    gauge("rows_emitted_fleet_total", None, fleet["rows"]["emitted"])
    gauge("unexplained_records", None, fleet["unexplained"])
    return "\n".join(lines) + "\n" if lines else ""
