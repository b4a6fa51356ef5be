"""The scheduler's CLI: inspect and drive a journal from the shell.

The port of ``sctools_tpu.sched.cli``:
``python -m sctools_tpu_torch.sched <command> <journal_dir>``:

- ``status`` — the folded per-task table (state, attempts, steals, worker,
  error) plus a one-line totals summary. Exit 0 when every task is
  committed, 2 when quarantined tasks remain, 1 when work is still open.
  ``--watch`` turns it into a live dashboard for an in-flight run:
  per-worker progress, lease holders with heartbeat age, and steal
  activity, refreshed every ``--interval`` seconds until the run
  converges. One :class:`Journal` instance lives across refreshes, so
  each frame parses only the bytes appended since the previous one (the
  append-only logs' incremental offset cache) — watching a large run does
  not re-replay its whole history once a second.
- ``resume`` — re-enter the worker loop over every non-terminal task,
  resolving each task's runner by kind (:mod:`.runners`). The command any
  operator (or cron) runs after a crash; committed tasks are skipped by
  replay, so it is idempotent. The tasks run on ``cuda`` unless the caller
  of :func:`main` asks for ``cpu``.
- ``retry-quarantined`` — record a ``requeued`` event for each quarantined
  task, zeroing its attempt count so the next ``resume`` (or pipeline
  re-launch) retries it. Journal-only: nothing executes here. Tasks whose
  payload carries a content signature (``chunk`` + ``chunk_sig``) are
  re-verified against the file on disk first: a chunk that changed (or
  vanished) since quarantine is REFUSED, not resurrected blind — task ids
  bind to content, and requeueing a changed input would commit an
  artifact under the wrong identity.

``status`` also prints one line per announced device mesh, and the
poison-record sidecars of the journal's ``quarantine/`` directory when it
holds any (the JAX package's guard writes them; no port code does). Not
ported: the serve, slo, efficiency, profile and pulse views, which read
the JAX package's serving plane and telemetry.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import List, Optional

from .journal import COMMITTED, LEASED, QUARANTINED, Journal, wall_clock
from .scheduler import WorkQueue


def _status(journal_dir: str, out, journal: Optional[Journal] = None) -> int:
    # a caller-supplied journal (the --watch loop) keeps its incremental
    # scan cache warm across calls; one-shot status builds a fresh one
    if journal is None:
        journal = Journal(journal_dir, worker_id="cli-status")
    tasks, states = journal.replay()
    if not tasks:
        print(f"no tasks registered under {journal_dir}", file=out)
        return 1
    rows = [("task", "state", "attempts", "steals", "worker", "detail")]
    totals = {}
    for tid in sorted(tasks, key=lambda t: tasks[t].name):
        task, st = tasks[tid], states.get(tid)
        state = st.state if st else "pending"
        totals[state] = totals.get(state, 0) + 1
        detail = ""
        if st and st.state == COMMITTED and st.part:
            detail = st.part
        elif st and st.error:
            detail = st.error
        rows.append(
            (
                task.name, state, str(st.attempts if st else 0),
                str(st.steals if st else 0), st.worker or "-" if st else "-",
                detail,
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    for index, row in enumerate(rows):
        line = "  ".join(
            cell.ljust(widths[i]) for i, cell in enumerate(row[:5])
        )
        print(f"{line}  {row[5]}", file=out)
        if index == 0:
            print("  ".join("-" * w for w in widths), file=out)
    summary = ", ".join(f"{k}={v}" for k, v in sorted(totals.items()))
    print(f"total={len(tasks)} ({summary})", file=out)
    _print_mesh_summary(journal, out)
    _print_quarantined_records(journal_dir, out)
    if totals.get(QUARANTINED):
        return 2
    return 0 if totals.get(COMMITTED, 0) == len(tasks) else 1


def _print_mesh_summary(journal: Journal, out) -> None:
    """One line per announced device mesh.

    Workers that passed a ``mesh=`` fingerprint to their WorkQueue group
    here by topology — the operator sees at a glance whether every
    worker of a run serves the SAME mesh (the precondition for the
    on-device collective merge) or the fleet is split across shapes.
    """
    try:
        meta = journal.worker_meta()
    except Exception:  # noqa: BLE001 - status must never die on telemetry
        return
    by_mesh = {}
    for worker, info in sorted(meta.items()):
        mesh = info.get("mesh")
        if not isinstance(mesh, dict):
            continue
        axes = mesh.get("axes") or []
        sizes = mesh.get("sizes") or []
        shape = ",".join(
            f"{axis}={size}" for axis, size in zip(axes, sizes)
        ) or "?"
        key = f"{shape} ({mesh.get('device_kind', '?')})"
        by_mesh.setdefault(key, []).append(worker)
    for shape, workers in sorted(by_mesh.items()):
        print(
            f"mesh {shape}: {len(workers)} worker(s) — "
            f"{', '.join(workers)}",
            file=out,
        )


def _print_quarantined_records(journal_dir: str, out) -> None:
    """Surface the guard's poison-record sidecars next to the task table.

    A run can converge with every TASK committed while individual RECORDS
    were quarantined below the scheduler (guard's poison isolation) — the
    operator reading ``sched status`` must see that the output is
    record-complete or not without hunting for sidecar files.
    """
    from ..guard.quarantine import load_quarantine

    try:
        entries = load_quarantine(os.path.join(journal_dir, "quarantine"))
    except Exception:  # noqa: BLE001 - status must never die on telemetry
        return
    if not entries:
        return
    records = sum(
        max(0, (e.get("record_stop") or 0) - (e.get("record_start") or 0))
        for e in entries
    )
    print(
        f"guard: {records} poisoned record(s) quarantined across "
        f"{len(entries)} range(s):", file=out,
    )
    for entry in entries[:10]:
        print(
            f"  {entry.get('task') or '?'}  records "
            f"[{entry.get('record_start')}, {entry.get('record_stop')})  "
            f"{str(entry.get('reason', ''))[:60]}", file=out,
        )
    if len(entries) > 10:
        print(f"  ... {len(entries) - 10} more range(s)", file=out)


def _chunk_signature_drift(task) -> Optional[str]:
    """Why ``task``'s input no longer matches its quarantine-era content
    signature (None = no signature to check, or it matches)."""
    from .commit import content_signature

    payload = task.payload if task is not None else {}
    chunk = payload.get("chunk")
    expected = payload.get("chunk_sig")
    if not chunk or not expected:
        return None
    try:
        current = content_signature(chunk)
    except OSError:
        return f"input {chunk} is gone"
    if current != expected:
        return (
            f"input {chunk} changed since quarantine "
            f"(signature {current} != {expected})"
        )
    return None


def _read_leases(leases_dir: str) -> List[dict]:
    """One row per held lock file: holder, heartbeat age, TTL remaining."""
    now = wall_clock()
    rows = []
    for path in sorted(glob.glob(os.path.join(leases_dir, "*.lock"))):
        try:
            with open(path, encoding="utf-8") as f:
                body = json.loads(f.read())
        except (OSError, ValueError):
            body = {}
        if not isinstance(body, dict):
            body = {}
        deadline = body.get("deadline")
        renewed = body.get("ts")
        rows.append(
            {
                "task_id": os.path.basename(path)[: -len(".lock")],
                "worker": body.get("worker") or "?",
                "beat_age": (
                    now - float(renewed)
                    if isinstance(renewed, (int, float)) else None
                ),
                "ttl_left": (
                    float(deadline) - now
                    if isinstance(deadline, (int, float)) else None
                ),
            }
        )
    return rows


def _render_watch_frame(journal: Journal, out) -> int:
    """One live-dashboard frame; returns the status exit code."""
    tasks, states = journal.replay()
    totals = {}
    workers = {}
    # only registered tasks count: replay folds states for event-only ids
    # too (a worker can journal before its register lands), and those must
    # not make the per-state summary disagree with total=len(tasks)
    for tid, st in states.items():
        if tid not in tasks:
            continue
        totals[st.state] = totals.get(st.state, 0) + 1
        if st.worker:
            row = workers.setdefault(
                st.worker, {"committed": 0, "running": 0, "steals": 0}
            )
            if st.state == COMMITTED:
                row["committed"] += 1
            elif st.state == LEASED:
                row["running"] += 1
            row["steals"] += st.steals
    summary = ", ".join(f"{k}={v}" for k, v in sorted(totals.items()))
    print(f"{journal.root}: total={len(tasks)} ({summary})", file=out)
    if workers:
        print("worker                          commit  run  steals", file=out)
        for name in sorted(workers):
            row = workers[name]
            print(
                f"{name:<30}  {row['committed']:>6}  {row['running']:>3}  "
                f"{row['steals']:>6}",
                file=out,
            )
    leases = _read_leases(journal.leases_dir)
    if leases:
        print("held leases (task  holder  beat-age  ttl-left):", file=out)
        for row in leases:
            name = tasks[row["task_id"]].name if row["task_id"] in tasks \
                else row["task_id"]
            beat = (
                f"{row['beat_age']:.1f}s" if row["beat_age"] is not None
                else "-"
            )
            left = (
                f"{row['ttl_left']:.1f}s" if row["ttl_left"] is not None
                else "-"
            )
            print(
                f"  {name:<16} {row['worker']:<30} {beat:>8}  {left:>8}",
                file=out,
            )
    if not tasks:
        return 1
    if totals.get(QUARANTINED):
        return 2
    return 0 if totals.get(COMMITTED, 0) == len(tasks) else 1


def _watch(
    journal_dir: str, interval: float, out, max_frames: int = 0
) -> int:
    """Refresh the dashboard until the run converges (or frame budget).

    ONE Journal instance across every frame: the append-only logs'
    incremental offset cache means each refresh parses only the bytes
    workers appended since the last one.
    """
    journal = Journal(journal_dir, worker_id="cli-status")
    frames = 0
    while True:
        frames += 1
        if hasattr(out, "isatty") and out.isatty():
            out.write("\x1b[2J\x1b[H")
        code = _render_watch_frame(journal, out)
        tasks_registered = bool(journal.replay()[0])
        if not tasks_registered:
            # a mistyped/never-used journal dir must error like one-shot
            # status does, not clear the screen forever over 'total=0'
            print(
                f"no tasks registered under {journal_dir}; not watching",
                file=out,
            )
            return 1
        if code != 1 or (max_frames and frames >= max_frames):
            return code
        time.sleep(interval)


def _resume(
    journal_dir: str, lease_ttl: float, max_attempts: int, out,
    device=None,
) -> int:
    from ..device import resolve as resolve_device
    from .runners import resolve

    # a cuda request without a GPU raises here, before any task is leased:
    # inside the loop it would burn every task's attempts into quarantine
    device = resolve_device(device)
    queue = WorkQueue(
        journal_dir, lease_ttl=lease_ttl, max_attempts=max_attempts
    )
    tasks, states = queue.journal.replay()
    open_ids = [
        tid for tid in tasks
        if not (states.get(tid) and states[tid].terminal)
    ]
    if not open_ids:
        print("nothing to resume: every task is terminal", file=out)
        return _status(journal_dir, out)

    # resolve every runner BEFORE entering the loop: an unknown kind is a
    # registry/version mismatch, not a task failure — hitting it inside
    # the loop would burn attempts and falsely quarantine healthy tasks
    runner_by_kind = {}
    for kind in sorted({tasks[tid].kind for tid in open_ids}):
        try:
            runner_by_kind[kind] = resolve(kind)
        except KeyError as error:
            print(f"cannot resume: {error.args[0]}", file=out)
            return 1

    def run_task(task):
        return runner_by_kind[task.kind](task, device=device)

    summary = queue.run(run_task, only_ids=open_ids)
    print(
        f"resumed: {summary.attempts} attempt(s), "
        f"{len(summary.committed)} committed here, "
        f"{summary.steals} steal(s), "
        f"{len(summary.quarantined)} quarantined",
        file=out,
    )
    return 2 if summary.quarantined else 0


def _retry_quarantined(journal_dir: str, out) -> int:
    journal = Journal(journal_dir, worker_id="cli-requeue")
    tasks, states = journal.replay()
    requeued = 0
    refused = 0
    for tid, st in states.items():
        if st.state != QUARANTINED:
            continue
        name = tasks[tid].name if tid in tasks else tid
        # re-verify the task's content signature before resurrecting it:
        # a quarantined task whose input changed since quarantine is a
        # DIFFERENT computation under a stale identity — requeueing it
        # blind would let the next resume commit the new bytes' output
        # under the old task id (and part path)
        drift = _chunk_signature_drift(tasks.get(tid))
        if drift is not None:
            print(
                f"REFUSED {name}: {drift}; re-split and re-launch to "
                "register the new content", file=out,
            )
            refused += 1
            continue
        journal.record(tid, "requeued")
        print(f"requeued {name}", file=out)
        requeued += 1
    print(f"{requeued} task(s) requeued, {refused} refused", file=out)
    return 1 if refused else 0


def main(
    argv: Optional[List[str]] = None, out=None, device=None
) -> int:
    """Run one CLI command; returns its exit code. ``device``: where
    ``resume`` runs its tasks, ``cuda`` unless the caller asks for
    ``cpu``."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.sched",
        description="inspect and drive a scheduler journal",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("status", "resume", "retry-quarantined"):
        p = sub.add_parser(name)
        p.add_argument("journal", help="journal directory")
        if name == "resume":
            p.add_argument("--lease-ttl", type=float, default=30.0)
            p.add_argument("--max-attempts", type=int, default=3)
        if name == "status":
            p.add_argument(
                "--watch", action="store_true",
                help="live dashboard: per-worker progress, lease "
                "heartbeats, steals; refreshes until the run converges",
            )
            p.add_argument(
                "--interval", type=float, default=2.0,
                help="--watch refresh period in seconds (default 2)",
            )
            p.add_argument(
                "--frames", type=int, default=0,
                help="stop --watch after N refreshes (0 = until converged)",
            )
    args = parser.parse_args(argv)
    if args.command == "status":
        if args.watch:
            return _watch(args.journal, args.interval, out, args.frames)
        return _status(args.journal, out)
    if args.command == "resume":
        return _resume(
            args.journal, args.lease_ttl, args.max_attempts, out, device
        )
    return _retry_quarantined(args.journal, out)
