"""Lease protocol: atomic ``O_CREAT|O_EXCL`` lock files with TTL + steal.

The port's copy of ``sctools_tpu.sched.lease``; a lock body written by
either package reads the same under the other.

Mutual exclusion for task execution over a shared filesystem, with no
coordinator process. One lock file per task id under the journal's
``leases/`` directory:

- **Acquire** — ``open(path, O_CREAT|O_EXCL)`` is atomic on POSIX (and on
  NFSv3+ via the exclusive-create protocol): exactly one worker wins. The
  file body is JSON ``{"worker", "deadline", "ts"}``.
- **Renew (heartbeat)** — the holder periodically rewrites the body with a
  pushed-out deadline via tmp-file + ``os.replace`` so readers never see a
  torn body. Renewal first re-reads the lock: if another worker has stolen
  it (we were presumed dead — e.g. a long GC or network stall), renew
  raises :class:`LeaseLost` instead of clobbering the thief's lock.
- **Steal** — when the embedded deadline has passed, contenders race for
  a per-task ``*.steal`` intent file (``O_CREAT|O_EXCL`` again: exactly
  one wins). Under that mutex the winner re-reads the lock, verifies it
  is STILL the expired body it observed (a bare rename-the-stale-lock
  scheme has a TOCTOU: a slow contender can rename away a freshly
  created lock), removes it, and acquires fresh. A task stolen from a
  *straggler* (not just a corpse) may still run twice — the journal's
  first-commit-wins fold and the atomic part rename make that benign
  (journal module docs).

TTLs are wall-clock deadlines (``journal.wall_clock``): they must be
comparable across processes, so perf_counter cannot serve here. Workers
with badly skewed clocks steal too eagerly or too lazily, never
incorrectly — the O_EXCL create is the serialization point, not the clock.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from .journal import wall_clock


class LeaseLost(RuntimeError):
    """The lock was stolen (or vanished) while we believed we held it."""


@dataclass
class Lease:
    """A held lease; create via :meth:`LeaseBroker.acquire` only."""

    task_id: str
    path: str
    worker_id: str
    ttl: float
    stolen: bool = False

    def _body(self) -> str:
        return json.dumps(
            {
                "worker": self.worker_id,
                "deadline": round(wall_clock() + self.ttl, 6),
                "ts": round(wall_clock(), 6),
            },
            separators=(",", ":"),
        )

    def renew(self) -> None:
        """Heartbeat: push the deadline out by one TTL.

        Raises :class:`LeaseLost` when the lock no longer names us — the
        caller must stop working on the task (its result may still commit;
        the journal makes the duplicate benign).
        """
        holder = _read_lock(self.path)
        if holder is None or holder.get("worker") != self.worker_id:
            raise LeaseLost(
                f"lease {self.task_id} now held by "
                f"{holder.get('worker') if holder else 'nobody'}"
            )
        tmp = f"{self.path}.renew-{self.worker_id}-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self._body())
        os.replace(tmp, self.path)

    def release(self) -> None:
        """Drop the lock (idempotent; only removes our own lock)."""
        holder = _read_lock(self.path)
        if holder is not None and holder.get("worker") != self.worker_id:
            return  # stolen: the thief's lock is not ours to remove
        try:
            os.remove(self.path)
        except OSError:
            pass


def _read_lock(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    try:
        data = json.loads(text)
    except ValueError:
        return {}  # torn write from a dying holder: holder unknown
    return data if isinstance(data, dict) else {}


class LeaseBroker:
    """Acquire/steal leases for one worker against one ``leases/`` dir."""

    def __init__(self, leases_dir: str, worker_id: str, ttl: float = 30.0):
        self.dir = leases_dir
        self.worker_id = worker_id
        self.ttl = float(ttl)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, tid: str) -> str:
        return os.path.join(self.dir, f"{tid}.lock")

    def _try_create(self, tid: str, stolen: bool) -> Optional[Lease]:
        lease = Lease(
            task_id=tid, path=self._path(tid), worker_id=self.worker_id,
            ttl=self.ttl, stolen=stolen,
        )
        try:
            fd = os.open(lease.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None
        try:
            os.write(fd, lease._body().encode())
        finally:
            os.close(fd)
        return lease

    def _expired(self, holder: dict, path: str) -> bool:
        deadline = holder.get("deadline")
        if isinstance(deadline, (int, float)):
            return wall_clock() > float(deadline)
        # no parseable deadline: either a JUST-created lock whose body is
        # not written yet (a live holder — stealing it would double-run
        # the task and inflate the leased-event count) or permanent torn
        # debris from a holder that died mid-write. The file mtime + TTL
        # distinguishes them: fresh stays held, debris expires.
        try:
            return wall_clock() - os.stat(path).st_mtime > self.ttl
        except OSError:
            return True  # lock vanished; the create path sorts it out

    def acquire(self, tid: str) -> Optional[Lease]:
        """One attempt to hold ``tid``: fresh create, or steal if expired.

        Returns None when another worker holds an unexpired lease (or wins
        the steal race) — callers just move on to the next task.
        """
        lease = self._try_create(tid, stolen=False)
        if lease is not None:
            return lease
        path = self._path(tid)
        holder = _read_lock(path)
        if holder is None:
            # released between our create attempt and read: retry once
            return self._try_create(tid, stolen=False)
        if not self._expired(holder, path):
            return None
        # steal critical section: one O_EXCL intent file per task, so
        # exactly one contender proceeds; under it the lock is re-read
        # and must still be the SAME expired body first observed (guards
        # the TOCTOU where a fresh lock replaces the stale one between
        # our read and our removal)
        intent = f"{path}.steal"
        try:
            fd = os.open(intent, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self._reap_stale_intent(intent)
            return None
        try:
            os.write(fd, self.worker_id.encode())
            current = _read_lock(path)
            if current != holder or not self._expired(current, path):
                return None  # renewed, released+reacquired, or torn read
            try:
                os.remove(path)
            except OSError:
                return None
            return self._try_create(tid, stolen=True)
        finally:
            os.close(fd)
            try:
                os.remove(intent)
            except OSError:
                pass

    def _reap_stale_intent(self, intent: str) -> None:
        """Remove an intent file abandoned by a stealer that died mid-steal
        (bounded by one TTL; the next acquire round then proceeds)."""
        try:
            age = wall_clock() - os.stat(intent).st_mtime
        except OSError:
            return
        if age > max(self.ttl, 1.0):
            try:
                os.remove(intent)
            except OSError:
                pass

    def holder(self, tid: str) -> Optional[dict]:
        """The current lock body for ``tid`` (None when unlocked)."""
        return _read_lock(self._path(tid))
