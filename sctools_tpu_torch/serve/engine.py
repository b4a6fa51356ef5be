"""The resident serve worker: warm once, then pack and commit until drained.

The port of ``sctools_tpu.serve.engine``. A :class:`ServeWorker` is a
long-lived process over a scheduler journal. Its life has two phases:

1. **Warmup** (``@warmup_step``, before admission): on ``cuda``, build the
   worker's :class:`~.graphs.GraphSet` and drive one calibration job
   through the real gatherer at the real ``batch_records``, so the CUDA
   graph of every signature its buckets reach is captured before the first
   request. Then journal the warm announcement.
2. **Serving** (``@serve_entry``): replay the journal, admit claimable jobs
   through the per-tenant round-robin
   :class:`~.api.AdmissionController`, pack admitted jobs across tenants
   into shared padded buckets (:mod:`.packer`), and run each pack under
   the lease/heartbeat/commit discipline of
   :class:`~sctools_tpu_torch.sched.scheduler.WorkQueue`: a killed worker
   loses nothing (peers steal its expired leases and recompute), and every
   artifact publishes atomically with a journaled sha256.

The group runner mirrors WorkQueue's journal vocabulary event for event
(``leased``/``committed``/``failed``/``quarantined``, full-jitter backoff,
steal accounting) rather than wrapping ``WorkQueue.run``, because packing
holds N leases at once while WorkQueue drains one task at a time. The
events, the worker announcements and the commit extras are the JAX
worker's, so either package drains, or shows ``status`` for, a journal the
other wrote.

The device is ``cuda`` unless the caller asks for ``cpu``; a ``cuda``
request without a GPU raises in the constructor, before any lease is
taken. On ``cuda`` every pack runs on the graph set; nothing falls back to
eager dispatch. On the CPU the engine runs eagerly.

Telemetry is JAX's: the ``serve:wait`` and ``serve:pack`` spans, the
``sched_*`` counters, the slo probe's ``pack_start`` / ``pack_done`` marks
in the commit extras (``slo_marks``, under ``SCTOOLS_TPU_SLO=1``), and the
warmup's calibration run under the ``warmup`` exec id
(``obs.slo.WARMUP_EXEC``), so that its device time is never charged to a
tenant. Not ported, on purpose: the AOT manifest (the product of JAX's
static pass, which certifies JAX's jit sites) and steering (the worker
announces JAX's disabled controller, ``{"mode": "off"}``, whose accessors
are the identity). ``run_serve_task`` is the solo runner registered in
:mod:`sctools_tpu_torch.sched.runners`: ``python -m sctools_tpu_torch.sched
resume`` drains a serve journal one job at a time with no resident worker.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..device import DeviceLike, resolve
from ..metrics.gatherer import DEFAULT_BATCH_RECORDS, GatherCellMetrics
from ..obs import audit, slo
from ..sched import faults
from ..sched.commit import sha256_file
from ..sched.journal import Task, TaskState, wall_clock
from ..sched.lease import LeaseLost
from ..sched.scheduler import WorkQueue, backoff_delay
from .api import (
    DEFAULT_ADMISSION_DEPTH,
    SERVE_TASK_KIND,
    AdmissionController,
    ServeJob,
    group_open_jobs,
    serve_entry,
    warmup_step,
)
from .graphs import GraphSet
from .packer import PackTrace, plan_packs, run_packed, trace_task

#: the JAX worker's announcement of its disabled steering controller
STEER_OFF = {"mode": "off"}


class ServeWorker:
    """One resident replica: a warm graph set over a shared journal."""

    def __init__(
        self,
        journal_dir: str,
        worker_id: Optional[str] = None,
        max_depth: int = DEFAULT_ADMISSION_DEPTH,
        batch_records: int = DEFAULT_BATCH_RECORDS,
        compress: bool = True,
        lease_ttl: float = 30.0,
        poll_interval: float = 0.25,
        device: DeviceLike = None,
    ):
        # a cuda request without a GPU raises here, before any lease: inside
        # the loop it would fail every job into quarantine
        self.device = resolve(device)
        self._queue = WorkQueue(
            journal_dir,
            worker_id,
            lease_ttl=lease_ttl,
            poll_interval=poll_interval,
        )
        self._admission = AdmissionController(max_depth=max_depth)
        self._batch_records = batch_records
        self._compress = compress
        self.graphs: Optional[GraphSet] = None
        self._warm = False
        self._started = time.perf_counter()
        #: seconds from worker construction to the first committed result
        self.first_result_s: Optional[float] = None
        #: seconds the warmup took, and the graphs it captured
        self.warmup_s: Optional[float] = None
        self.warmup_captures = 0
        self.jobs_committed = 0
        self.packs_run = 0
        self.packs_degraded = 0

    @property
    def worker_id(self) -> str:
        return self._queue.worker_id

    def _announce(self, **extra) -> None:
        self._queue.journal.announce_worker(
            {"serve": self._admission.snapshot(), **extra}
        )

    # ------------------------------------------------------------ warmup

    @warmup_step
    def warmup(self, calibration_bam: Optional[str] = None) -> None:
        """Build the graph set and warm it, then announce the worker warm.

        Runs BEFORE admission: everything that captures or initializes
        lazily happens here. The calibration job goes through the real
        gatherer at the real ``batch_records``, so it captures the graphs
        of the bucketed signatures the serving path reaches.
        """
        begin = time.perf_counter()
        if self.device.type == "cuda":
            self.graphs = GraphSet(self.device)
        if calibration_bam:
            with tempfile.TemporaryDirectory(prefix="serve-warm-") as tmp:
                gatherer = GatherCellMetrics(
                    calibration_bam,
                    os.path.join(tmp, f"calibration-{self._batch_records}"),
                    batch_records=self._batch_records,
                    device=self.device,
                    compress=self._compress,
                    graphs=self.graphs,
                )
                # calibration heartbeats carry the warmup exec id, so slo
                # never reads them as unattributed tenant device time
                with trace_task(slo.WARMUP_EXEC):
                    gatherer.extract_metrics()
        if self.graphs is not None:
            self.warmup_captures = self.graphs.captures
        self.warmup_s = time.perf_counter() - begin
        self._warm = True
        self._announce(warm=True, steer=dict(STEER_OFF))

    def graph_stats(self) -> Dict[str, int]:
        """Graph captures at warmup and while serving, replays, and the
        keys held (all zero on the CPU, where no graph is built)."""
        if self.graphs is None:
            return {"captures_warmup": 0, "captures_serving": 0, "replays": 0, "keys": 0}
        return {
            "captures_warmup": self.warmup_captures,
            "captures_serving": self.graphs.captures - self.warmup_captures,
            "replays": self.graphs.replays,
            "keys": len(self.graphs),
        }

    # ----------------------------------------------------------- serving

    @serve_entry
    def serve_forever(
        self,
        max_jobs: Optional[int] = None,
        idle_timeout_s: Optional[float] = None,
        drain: bool = False,
    ) -> int:
        """Admit, pack, run, commit: until told (or drained) to stop.

        ``max_jobs`` stops after N committed jobs; ``idle_timeout_s`` stops
        after that long with nothing claimable; ``drain`` stops as soon as
        the journal holds no open serve task. Returns the number of jobs
        this worker committed.
        """
        if not self._warm:
            raise RuntimeError(
                "serve_forever before warmup(): replicas must warm their "
                "graph set before admitting work"
            )
        journal = self._queue.journal
        idle_since = time.perf_counter()
        while True:
            tasks, states = journal.replay()
            queued = group_open_jobs(tasks, states, wall_clock())
            group = self._admit_group(queued, tasks, states)
            # `worked` counts tasks actually held under a lease: an admitted
            # group whose leases are all live with a peer is idle time, not
            # progress, and must reach the sleep below
            worked = self._run_group(group) if group else 0
            if worked:
                idle_since = time.perf_counter()
                # worker meta is last-announcement-wins: every announcement
                # carries the steer snapshot, or the `sched status` steer
                # line would vanish behind a pack_plan announcement
                self._announce(warm=True, steer=dict(STEER_OFF))
            if max_jobs is not None and self.jobs_committed >= max_jobs:
                break
            if drain and not self._any_open(tasks, states):
                break
            if not worked:
                if (
                    idle_timeout_s is not None
                    and time.perf_counter() - idle_since > idle_timeout_s
                ):
                    break
                with obs.span("serve:wait"):
                    time.sleep(self._queue.poll_interval)
        return self.jobs_committed

    def _any_open(self, tasks: Dict[str, Task], states) -> bool:
        for tid, task in tasks.items():
            if task.kind != SERVE_TASK_KIND:
                continue
            state = states.get(tid) or TaskState()
            if not state.terminal:
                return True
        return False

    def _admit_group(
        self, queued: Dict[str, List[str]], tasks: Dict[str, Task], states
    ) -> List[Tuple[str, ServeJob]]:
        """Build one cross-tenant group under the admission bound.

        Round-robin over tenants with claimable work: each `select` call
        yields the next fair tenant with a free depth slot, and `admit`
        takes the slot, so a tenant with a deep backlog contributes at most
        ``max_depth`` jobs per group, however empty the others are.
        """
        queues = {tenant: list(ids) for tenant, ids in queued.items()}
        group: List[Tuple[str, ServeJob]] = []
        while True:
            tenant = self._admission.select(queues)
            if tenant is None:
                break
            tid = queues[tenant][0]
            job = ServeJob.from_payload(tasks[tid].payload)
            if not self._admission.admit(tenant):
                break
            queues[tenant].pop(0)
            group.append((tid, job))
        return group

    # -------------------------------------------------------- group runs

    def _heartbeat_all(self, leases, stop: threading.Event) -> None:
        interval = max(self._queue.broker.ttl / 3.0, 0.05)
        while not stop.wait(interval):
            for tid, lease in list(leases.items()):
                faults.fire("lease.renew", name=tid)
                try:
                    lease.renew()
                except LeaseLost:
                    obs.count("sched_lease_lost")
                    leases.pop(tid, None)
                except OSError:
                    continue  # transient fs hiccup; the TTL absorbs a few

    def _run_group(self, group: Sequence[Tuple[str, ServeJob]]) -> int:
        """Lease, pack, run, and commit one admitted group.

        Mirrors WorkQueue's discipline with N concurrent leases: acquire
        each task's lease, re-replay under the leases (never recompute a
        committed task, never bypass a racing peer's fresh backoff),
        journal ``leased``, heartbeat every held lease, then run each pack
        and journal per-task ``committed``/``failed``/``quarantined``. A
        pack failure fails only its members. Returns the number of tasks
        this call held a lease on (commits AND journaled failures both
        count as forward progress).
        """
        journal = self._queue.journal
        broker = self._queue.broker
        leases: Dict[str, object] = {}
        held: List[Tuple[str, ServeJob]] = []
        for tid, job in group:
            lease = broker.acquire(tid)
            if lease is None:
                self._admission.release(job.tenant)
                continue
            leases[tid] = lease
            held.append((tid, job))
        if not held:
            return 0
        _, fresh = journal.replay()
        attempts: Dict[str, int] = {}
        ready: List[Tuple[str, ServeJob]] = []
        now = wall_clock()
        for tid, job in held:
            state = fresh.get(tid) or TaskState()
            if state.terminal or state.not_before > now:
                leases.pop(tid).release()
                self._admission.release(job.tenant)
                continue
            attempts[tid] = state.attempts + 1
            journal.record(
                tid,
                "leased",
                attempt=attempts[tid],
                stolen=int(leases[tid].stolen),
            )
            obs.count("sched_attempts")
            ready.append((tid, job))
        stop = threading.Event()
        beat = threading.Thread(
            target=self._heartbeat_all,
            args=(leases, stop),
            name="serve-heartbeat",
            daemon=True,
        )
        beat.start()
        try:
            jobs = [job for _, job in ready]
            tid_of = {id(job): tid for (tid, job) in ready}
            for plan in plan_packs(jobs, self._batch_records):
                members = [(tid_of[id(job)], job) for job in plan.jobs]
                self._run_pack(journal, members, attempts)
        finally:
            stop.set()
            beat.join(timeout=5.0)
            for lease in leases.values():
                lease.release()
            for _, job in held:
                self._admission.release(job.tenant)
        return len(ready)

    def _run_pack(
        self,
        journal,
        members: Sequence[Tuple[str, ServeJob]],
        attempts: Dict[str, int],
    ) -> int:
        for tid, _ in members:
            faults.fire("task.claimed", name=tid)
        trace = PackTrace(tids=[tid for tid, _ in members])
        # announce the plan BEFORE running: if this worker dies mid-pack,
        # the journal still says which members the pack held
        self._announce(
            steer=dict(STEER_OFF),
            pack_plan={
                "exec_id": (
                    trace.exec_id() if len(members) > 1 else trace.tids[0]
                ),
                "tids": list(trace.tids),
            },
        )
        probe = slo.probe()
        try:
            with obs.span(
                "serve:pack",
                jobs=len(members),
                tenants=len({job.tenant for _, job in members}),
            ):
                probe.mark("pack_start")
                artifacts, packed = run_packed(
                    [job for _, job in members],
                    compress=self._compress,
                    batch_records=self._batch_records,
                    trace=trace,
                    device=self.device,
                    graphs=self.graphs,
                )
                probe.mark("pack_done")
        except Exception as error:  # noqa: BLE001 - every failure journals
            # half-counted audit ledgers from the failed executions must
            # not pollute the retry's conservation balance
            audit.discard(trace.exec_id())
            for tid in trace.tids:
                audit.discard(tid)
            self._fail_pack(journal, members, attempts, error)
            return 0
        self.packs_run += 1
        if len(members) > 1 and not packed:
            self.packs_degraded += 1
        degraded = trace.degrade_reason()
        marks = probe.marks()
        for (tid, _), artifact in zip(members, artifacts):
            faults.fire("task.commit", name=tid)
            # the committed event carries the packer's plan verbatim (the
            # journal's fold ignores the extras)
            segment = next(
                (
                    seg
                    for seg in trace.executed
                    if tid in seg["tids"] and not seg.get("aborted")
                ),
                None,
            )
            extra = {
                "pack": segment["exec_id"] if segment else None,
                "pack_members": list(trace.tids),
                "pack_rows": segment.get("rows") if segment else None,
                "pack_degraded": degraded,
                "pack_bucket": trace.bucket,
                "pack_execs": trace.executed,
            }
            if segment is not None:
                # this member's emitted-row count (and, for a packed run,
                # the claimed-entity count it must equal): the `sched
                # status` rows-balanced line reads these
                member_at = segment["tids"].index(tid)
                routed = segment.get("rows_routed")
                claimed = segment.get("rows_claimed")
                ledger = segment.get("ledger") or {}
                if routed is not None:
                    extra["audit"] = {
                        "rows_emitted": int(routed[member_at]),
                        "rows_claimed": (
                            int(claimed[member_at])
                            if claimed is not None
                            else None
                        ),
                        "records_streamed": (
                            int(segment["rows"][member_at])
                            if segment.get("rows")
                            else None
                        ),
                    }
                else:
                    # solo execution: the whole ledger belongs to this one
                    # member
                    extra["audit"] = {
                        "rows_emitted": int(ledger.get("rows.emitted", 0)),
                        "rows_claimed": None,
                        "records_streamed": ledger.get("records.decoded"),
                    }
            if marks:
                extra["slo_marks"] = marks
            journal.record(
                tid,
                "committed",
                attempt=attempts[tid],
                part=artifact,
                sha256=sha256_file(artifact),
                **extra,
            )
            obs.count("sched_commits")
            self.jobs_committed += 1
            if self.first_result_s is None:
                self.first_result_s = time.perf_counter() - self._started
        return len(members)

    def _fail_pack(
        self,
        journal,
        members: Sequence[Tuple[str, ServeJob]],
        attempts: Dict[str, int],
        error: Exception,
    ) -> None:
        message = f"{type(error).__name__}: {error}"
        _, states = journal.replay()
        for tid, _ in members:
            obs.count("sched_failures")
            failures = (states.get(tid) or TaskState()).failures + 1
            if failures >= self._queue.max_attempts:
                journal.record(
                    tid, "failed", attempt=attempts[tid], error=message
                )
                journal.record(tid, "quarantined", error=message)
                obs.count("sched_quarantined")
                continue
            delay = backoff_delay(
                failures,
                self._queue.backoff_base,
                self._queue.backoff_cap,
                self._queue._rng,
            )
            journal.record(
                tid,
                "failed",
                attempt=attempts[tid],
                error=message,
                not_before=round(wall_clock() + delay, 6),
            )

    def close(self) -> None:
        self._queue.close()

    def __enter__(self) -> "ServeWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_serve_task(task: Task, device: DeviceLike = None) -> Optional[str]:
    """Solo runner for ``sched resume``: one serve job, no resident worker,
    on ``cuda`` unless the caller asks for ``cpu`` (eagerly: no graph set)."""
    job = ServeJob.from_payload(task.payload)
    artifacts, _ = run_packed(
        [job], trace=PackTrace(tids=[task.id]), device=device
    )
    return artifacts[0]
