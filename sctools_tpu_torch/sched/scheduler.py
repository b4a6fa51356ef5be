"""The work-stealing scheduler loop: claim, run, commit, retry, quarantine.

The port of ``sctools_tpu.sched.scheduler``: its ``sched:task`` /
``sched:wait`` spans, ``sched_*`` counters and obs context (``worker``,
then ``task`` / ``task_id`` around each task body) are JAX's, and so is
the audit ledger (:mod:`..obs.audit`) that a commit carries as the
``audit`` extra of its ``committed`` event and a failed or interrupted
attempt discards.
One :class:`WorkQueue` per worker process. Every worker runs the same
loop against the shared journal; there is no leader and no assignment
step — the lock files ARE the schedule:

1. replay the journal; collect non-terminal tasks whose backoff deadline
   has passed;
2. try to lease one (claim order is task-name order, so workers sweep the
   queue front-to-back; an expired lease is stolen in the same call);
3. record ``leased`` (attempt n), run the task under a heartbeat thread,
   and on success record ``committed`` with the artifact path + content
   hash;
4. on failure record ``failed`` with an exponential-backoff ``not_before``
   (full jitter), or ``quarantined`` once attempts reach the cap;
5. when nothing is claimable but non-terminal tasks remain (peers hold
   leases, or everything is backing off), sleep briefly and re-poll —
   this is where a fast worker *steals* a straggler's expired lease
   instead of idling.

The loop exits when every registered task is terminal. Dynamic load
balance falls out: workers pull tasks as they finish, so a skewed chunk
occupies one worker while the rest drain the queue — the round-robin
straggler problem this module replaces. What one worker did comes back
in its :class:`RunSummary`.
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .. import obs
from ..obs import audit
from . import faults
from .commit import sha256_file
from .journal import (
    COMMITTED,
    LEASED,
    QUARANTINED,
    Journal,
    Task,
    TaskState,
    wall_clock,
)
from .lease import LeaseBroker, LeaseLost


class QuarantinedTasksError(RuntimeError):
    """Raised by a queue's caller when a run converged with quarantined tasks."""

    def __init__(self, quarantined: Dict[str, str]):
        self.quarantined = dict(quarantined)
        names = ", ".join(sorted(self.quarantined))
        super().__init__(
            f"{len(self.quarantined)} task(s) quarantined after repeated "
            f"failures: {names}; inspect with `python -m sctools_tpu_torch.sched "
            "status <journal>` and requeue with `retry-quarantined`"
        )


@dataclass
class RunSummary:
    """What one worker's :meth:`WorkQueue.run` did and saw."""

    committed: List[str] = field(default_factory=list)  # artifact paths (ours)
    attempts: int = 0
    steals: int = 0
    failures: int = 0
    quarantined: Dict[str, str] = field(default_factory=dict)  # name -> error
    all_committed: int = 0  # queue-wide, at exit


def backoff_delay(
    attempt: int, base: float, cap: float, rng: random.Random
) -> float:
    """Full-jitter exponential backoff (attempt is 1-based)."""
    ceiling = min(cap, base * (2 ** max(0, attempt - 1)))
    return ceiling * (0.5 + 0.5 * rng.random())


class WorkQueue:
    """A durable, fault-tolerant task queue over a shared journal dir."""

    def __init__(
        self,
        journal_dir: str,
        worker_id: Optional[str] = None,
        lease_ttl: float = 30.0,
        max_attempts: int = 3,
        backoff_base: float = 0.25,
        backoff_cap: float = 30.0,
        poll_interval: float = 0.5,
        mesh: Optional[Dict] = None,
    ):
        """``mesh`` (a ``parallel.mesh.mesh_fingerprint`` dict) announces
        which device mesh this worker serves: `sched status` groups
        workers by fingerprint."""
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.journal = Journal(journal_dir, worker_id)
        self.mesh = dict(mesh) if mesh else None
        if self.mesh is not None:
            self.journal.announce_worker({"mesh": self.mesh})
        self.broker = LeaseBroker(
            self.journal.leases_dir, self.journal.worker_id, ttl=lease_ttl
        )
        self.max_attempts = int(max_attempts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.poll_interval = float(poll_interval)
        self._rng = random.Random(self.journal.worker_id)
        # every span this process records from here on carries the journal
        # worker id, so a merge of workers' captures can lane spans by
        # worker and correlate them with this worker's journal events
        obs.set_context(worker=self.journal.worker_id)

    @property
    def worker_id(self) -> str:
        return self.journal.worker_id

    def register(self, tasks: Iterable[Task]) -> List[Task]:
        return self.journal.register(tasks)

    # ------------------------------------------------------------ one task

    def _heartbeat(self, lease, task: Task, stop: threading.Event) -> None:
        interval = max(self.broker.ttl / 3.0, 0.05)
        while not stop.wait(interval):
            faults.fire("lease.renew", name=task.name)
            try:
                lease.renew()
            except LeaseLost:
                obs.count("sched_lease_lost")
                return
            except OSError:
                continue  # transient fs hiccup; the TTL absorbs a few

    def _run_one(
        self,
        task: Task,
        state: TaskState,
        lease,
        run_fn: Callable[[Task], Optional[str]],
        summary: RunSummary,
    ) -> None:
        attempt = state.attempts + 1
        self.journal.record(
            task.id, "leased", attempt=attempt, stolen=int(lease.stolen)
        )
        obs.count("sched_attempts")
        summary.attempts += 1
        if lease.stolen:
            obs.count("sched_steals")
            summary.steals += 1
        stop = threading.Event()
        beat = threading.Thread(
            target=self._heartbeat, args=(lease, task, stop),
            name=f"sched-heartbeat-{task.name}", daemon=True,
        )
        beat.start()
        # spans inside the task body (on the ring's producer thread too)
        # carry the task's identity
        obs.set_context(task=task.name, task_id=task.id)
        try:
            faults.fire("task.claimed", name=task.name)
            with obs.span(
                "sched:task", task=task.name, task_id=task.id,
                attempt=attempt, stolen=int(lease.stolen),
            ):
                artifact = run_fn(task)
            # a crash here (after the work, before the commit record) is
            # the resume-proof window: the journal still says leased, so a
            # re-launch recomputes once and the atomic part replace makes
            # the recompute invisible
            faults.fire("task.commit", name=task.name)
        except BaseException as error:  # noqa: BLE001 - every failure journals
            obs.set_context(task=None, task_id=None)
            # a failed attempt's half-counted ledger must not pollute the
            # retry's conservation balance
            audit.discard(task.id)
            stop.set()
            beat.join(timeout=5.0)
            if not isinstance(error, Exception):
                # operator interrupt / SystemExit is not a TASK failure:
                # no failed event is journaled, and quarantine counts
                # FAILED events (not leased ones), so interrupts never
                # push a healthy task toward quarantine. Release the
                # lease and propagate; the leased event already on record
                # makes a resume recompute it.
                lease.release()
                raise
            self._record_failure(task, attempt, state, error, summary)
            lease.release()
            return
        obs.set_context(task=None, task_id=None)
        stop.set()
        beat.join(timeout=5.0)
        # the conservation ledger rides the commit record: counts fold
        # post-run into the existing journal event, so the transport adds
        # no hot-path work and no new wire format
        ledger = audit.take(task.id)
        extra = {"audit": ledger} if ledger else {}
        self.journal.record(
            task.id, "committed", attempt=attempt, part=artifact,
            sha256=sha256_file(artifact) if artifact else None,
            **extra,
        )
        obs.count("sched_commits")
        if artifact:
            summary.committed.append(artifact)
        lease.release()

    def _record_failure(
        self, task: Task, attempt: int, state: TaskState,
        error: BaseException, summary: RunSummary,
    ) -> None:
        message = f"{type(error).__name__}: {error}"
        obs.count("sched_failures")
        summary.failures += 1
        # quarantine counts FAILED events, not leased ones: crashes and
        # operator interrupts start executions without journaling a
        # failure, and must not push a task toward quarantine
        failures = state.failures + 1
        if failures >= self.max_attempts:
            self.journal.record(
                task.id, "failed", attempt=attempt, error=message,
                trace=traceback.format_exc(limit=8),
            )
            self.journal.record(task.id, "quarantined", error=message)
            obs.count("sched_quarantined")
            summary.quarantined[task.name] = message
            return
        delay = backoff_delay(
            failures, self.backoff_base, self.backoff_cap, self._rng
        )
        obs.count("sched_backoff_seconds", delay)
        self.journal.record(
            task.id, "failed", attempt=attempt, error=message,
            not_before=round(wall_clock() + delay, 6),
        )

    # ---------------------------------------------------------- the loop

    def run(
        self,
        run_fn: Callable[[Task], Optional[str]],
        only_ids: Optional[Iterable[str]] = None,
    ) -> RunSummary:
        """Work the queue until every (selected) task is terminal.

        ``run_fn(task)`` performs the work and returns the committed
        artifact path (or None for artifact-free tasks). It MUST publish
        its artifact atomically (commit module docs). ``only_ids``
        restricts the loop to a subset of registered tasks.
        """
        summary = RunSummary()
        selected = set(only_ids) if only_ids is not None else None
        while True:
            tasks, states = self.journal.replay()
            if selected is not None:
                tasks = {t: task for t, task in tasks.items() if t in selected}
            open_tasks = [
                (task, states.get(tid) or TaskState())
                for tid, task in tasks.items()
                if not (states.get(tid) or TaskState()).terminal
            ]
            if not open_tasks:
                break
            now = wall_clock()
            ready = sorted(
                (
                    (task, st) for task, st in open_tasks
                    if st.not_before <= now
                ),
                key=lambda pair: pair[0].name,
            )
            claimed = False
            for task, st in ready:
                lease = self.broker.acquire(task.id)
                if lease is None:
                    continue
                # the lock serializes execution; replay again under the
                # lease so a commit OR a fresh backoff deadline that
                # landed between replay and acquire is seen (never
                # recompute a committed task; never bypass a racing
                # peer's just-recorded backoff)
                _, fresh = self.journal.replay()
                current = fresh.get(task.id) or TaskState()
                if current.terminal or current.not_before > wall_clock():
                    lease.release()
                    continue
                self._run_one(task, current, lease, run_fn, summary)
                claimed = True
                break
            if claimed:
                continue
            # nothing claimable: peers hold live leases or backoff pending
            wait = self.poll_interval
            future = [
                st.not_before - now
                for _, st in open_tasks
                if st.not_before > now
            ]
            leased_elsewhere = any(
                st.state == LEASED for _, st in open_tasks
            )
            if future and not leased_elsewhere:
                wait = max(0.05, min(wait, min(future)))
            with obs.span("sched:wait", tasks=len(open_tasks)):
                time.sleep(wait)
        final_tasks, final = self.journal.replay()
        if selected is not None:
            final = {t: st for t, st in final.items() if t in selected}
        summary.all_committed = sum(
            1 for st in final.values() if st.state == COMMITTED
        )
        for tid, st in final.items():
            if st.state == QUARANTINED:
                name = final_tasks[tid].name if tid in final_tasks else tid
                summary.quarantined.setdefault(name, st.error or "")
        return summary

    def close(self) -> None:
        self.journal.close()

    def __enter__(self) -> "WorkQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
