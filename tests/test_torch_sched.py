"""The port's scheduler (``sctools_tpu_torch.sched``) and chunk queue
(``sctools_tpu_torch.parallel.launch``) on the CPU, against the JAX package.

Every case of ``test_sched.py`` runs here against the port, under the same
name: the journal's fold, the leases, the fault grammar, backoff, the queue's
retry, steal and quarantine, the CLI, the merge's validation, and end to
end, worker processes running the port with ``device="cpu"`` (the script
``WORKER`` below) killed mid-chunk, failing, poisoned and terminated, whose
merged CSV equals a one-shot run byte for byte. The SIGTERM case lands
inside the guard's retry of an injected ``stall@gatherer.dispatch``, and
its flight record names the open retry (the audit of such a journal is
``test_torch_audit.py``'s).

Against the JAX package, on the same inputs: ``make_cell_metric_tasks``
gives JAX's task ids; ``parse_spec`` gives JAX's clauses; ``backoff_delay``
gives JAX's values under the same seeded ``random.Random``; a journal
written by either package replays to the same task states under the other;
``local_mesh(device="cpu")`` announces the mesh JAX's CPU worker announces; the
merged CSV of the port's run with crash and resume equals JAX's scheduled
run's on the same chunks (every column bit for bit but the six
``*_variance`` columns, rtol 1e-6 with no absolute slack, as
``test_torch_metrics`` explains); and ``collective_merge_parts`` gives
JAX's output and JAX's errors on ``test_collective_merge``'s four parts
cases.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import random
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from helpers import make_record, write_bam
from sctools_tpu.metrics.collective import collective_merge_parts as jax_collective_merge_parts
from sctools_tpu.metrics.writer import MetricCSVWriter as JaxMetricCSVWriter
from sctools_tpu.parallel import launch as jax_launch
from sctools_tpu.parallel.mesh import mesh_fingerprint as jax_mesh_fingerprint
from sctools_tpu.sched import Journal as JaxJournal
from sctools_tpu.sched import backoff_delay as jax_backoff_delay
from sctools_tpu.sched.faults import parse_spec as jax_parse_spec
from sctools_tpu_torch.metrics.collective import collective_merge_parts
from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics
from sctools_tpu_torch.metrics.writer import MetricCSVWriter
from sctools_tpu_torch.parallel import launch as port_launch
from sctools_tpu_torch.parallel import mesh_fingerprint
from sctools_tpu_torch.parallel.launch import merge_sorted_csv_parts
from sctools_tpu_torch.platform import GenericPlatform
from sctools_tpu_torch.sched import (
    COMMITTED,
    QUARANTINED,
    Journal,
    LeaseBroker,
    LeaseLost,
    QuarantinedTasksError,
    WorkQueue,
    atomic_output,
    backoff_delay,
    make_task,
    sha256_file,
    task_id,
)
from sctools_tpu_torch.sched import cli as sched_cli
from sctools_tpu_torch.sched import faults, runners
from sctools_tpu_torch.sched.faults import FaultSpecError, InjectedFault, parse_spec
from test_torch_metrics import assert_csv_match

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A worker process: the port's chunk queue on the CPU over
# <workdir>/chunks/*.bam, parts and journal at run_process_cell_metrics's defaults in
# <workdir>. Arguments: workdir process_id num_processes lease_ttl
# max_attempts backoff_base. Exit 0 on success, 3 when the queue converged
# with quarantined tasks, 86 on an injected crash.
WORKER = """
import glob, os, sys
from sctools_tpu_torch.parallel.launch import run_process_cell_metrics
from sctools_tpu_torch.sched import QuarantinedTasksError

workdir, process_id, num_processes = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
chunks = sorted(glob.glob(os.path.join(workdir, "chunks", "*.bam")))
assert chunks, "no chunk files prepared"
try:
    parts = run_process_cell_metrics(
        chunks, os.path.join(workdir, f"proc{process_id}"), num_processes, process_id,
        lease_ttl=float(sys.argv[4]), max_attempts=int(sys.argv[5]),
        backoff_base=float(sys.argv[6]), device="cpu",
    )
except QuarantinedTasksError as error:
    print(f"[p{process_id}] QUARANTINED: {error}", flush=True)
    sys.exit(3)
print(f"[p{process_id}] committed {len(parts)} part(s)", flush=True)
"""


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure("")
    yield
    faults.reset()


def _touch_runner(path: str, text: str = "done") -> str:
    with atomic_output(path) as tmp:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
    return path


def _simple_tasks(tmp_path, n=3, kind="touch"):
    return [
        make_task(kind, f"t{i:02d}", {"out": str(tmp_path / f"t{i:02d}.out")})
        for i in range(n)
    ]


def _gz_bytes(path) -> bytes:
    with gzip.open(str(path), "rb") as f:
        return f.read()


# ------------------------------------------------------------------ journal

def test_task_ids_are_content_hashed_and_stable():
    a = task_id("k", "n", {"x": 1})
    assert a == task_id("k", "n", {"x": 1})
    assert a != task_id("k", "n", {"x": 2})
    assert a != task_id("k", "m", {"x": 1})
    assert len(a) == 16


def test_journal_register_is_idempotent(tmp_path):
    journal = Journal(str(tmp_path / "j"), worker_id="w1")
    tasks = _simple_tasks(tmp_path)
    assert len(journal.register(tasks)) == 3
    assert journal.register(tasks) == []
    # a second worker registering the same specs adds nothing on replay
    other = Journal(str(tmp_path / "j"), worker_id="w2")
    assert other.register(tasks) == []
    known, states = other.replay()
    assert sorted(known) == sorted(t.id for t in tasks)
    assert all(st.state == "pending" for st in states.values())


def test_journal_fold_and_commit_precedence(tmp_path):
    journal = Journal(str(tmp_path / "j"), worker_id="w1")
    (task,) = journal.register(_simple_tasks(tmp_path, n=1))
    journal.record(task.id, "leased", attempt=1)
    journal.record(task.id, "failed", error="boom", not_before=0.0)
    journal.record(task.id, "leased", attempt=2, stolen=1)
    journal.record(task.id, "committed", part="p.csv.gz", sha256="abc")
    # late events after commit are ignored (first-commit-wins)
    journal.record(task.id, "failed", error="late straggler")
    _, states = journal.replay()
    st = states[task.id]
    assert st.state == COMMITTED
    assert st.attempts == 2
    assert st.steals == 1
    assert st.part == "p.csv.gz"


def test_journal_requeue_resets_quarantine(tmp_path):
    journal = Journal(str(tmp_path / "j"), worker_id="w1")
    (task,) = journal.register(_simple_tasks(tmp_path, n=1))
    journal.record(task.id, "leased", attempt=1)
    journal.record(task.id, "quarantined", error="poison")
    _, states = journal.replay()
    assert states[task.id].state == QUARANTINED
    journal.record(task.id, "requeued")
    _, states = journal.replay()
    assert states[task.id].state == "pending"
    assert states[task.id].attempts == 0


def test_journal_tolerates_torn_trailing_line(tmp_path):
    journal = Journal(str(tmp_path / "j"), worker_id="w1")
    (task,) = journal.register(_simple_tasks(tmp_path, n=1))
    journal.record(task.id, "leased", attempt=1)
    events = journal._worker_path("events")
    with open(events, "a", encoding="utf-8") as f:
        f.write('{"id": "' + task.id + '", "event": "comm')  # torn write
    _, states = journal.replay()
    assert states[task.id].state == "leased"


def _write_mixed_history(journal_cls, root, tmp_path):
    """One journal of every event kind, two workers, written with
    ``journal_cls``; returns the task ids in order."""
    tasks = [make_task("touch", f"t{i:02d}", {"i": i}) for i in range(5)]
    a = journal_cls(root, worker_id="wa")
    b = journal_cls(root, worker_id="wb")
    a.register(tasks)
    b.register(tasks[2:])
    a.announce_worker({"mesh": {"axes": ["shard"], "sizes": [1], "devices": 1, "device_kind": "cpu"}})
    a.record(tasks[0].id, "leased", attempt=1)
    a.record(tasks[0].id, "committed", attempt=1, part=str(tmp_path / "p0"), sha256="s0")
    a.record(tasks[1].id, "leased", attempt=1)
    a.record(tasks[1].id, "failed", attempt=1, error="boom", not_before=12.5)
    b.record(tasks[1].id, "leased", attempt=2, stolen=1)
    b.record(tasks[2].id, "leased", attempt=1)
    b.record(tasks[2].id, "failed", attempt=1, error="x")
    b.record(tasks[2].id, "quarantined", error="x")
    a.record(tasks[3].id, "quarantined", error="y")
    a.record(tasks[3].id, "requeued")
    b.record(tasks[0].id, "failed", error="late")
    a.close()
    b.close()
    return [t.id for t in tasks]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_the_same_under_both_packages(tmp_path, writer):
    """A journal written by either package folds to the same task specs,
    states and worker announcements under both."""
    root = str(tmp_path / "j")
    ids = _write_mixed_history(Journal if writer == "port" else JaxJournal, root, tmp_path)
    port_tasks, port_states = Journal(root, worker_id="probe").replay()
    jax_tasks, jax_states = JaxJournal(root, worker_id="probe").replay()
    assert set(port_tasks) == set(jax_tasks) == set(ids)
    for tid in ids:
        assert port_tasks[tid].to_json() == jax_tasks[tid].to_json()
        assert dataclasses.asdict(port_states[tid]) == dataclasses.asdict(jax_states[tid])
    assert [port_states[t].state for t in ids] == [COMMITTED, "leased", QUARANTINED, "pending", "pending"]
    assert Journal(root, worker_id="p").worker_meta() == JaxJournal(root, worker_id="p").worker_meta()


# ------------------------------------------------------------------- leases

def test_lease_exclusive_and_release(tmp_path):
    broker_a = LeaseBroker(str(tmp_path), "a", ttl=30)
    broker_b = LeaseBroker(str(tmp_path), "b", ttl=30)
    lease = broker_a.acquire("t1")
    assert lease is not None and not lease.stolen
    assert broker_b.acquire("t1") is None
    lease.release()
    assert broker_b.acquire("t1") is not None


def test_lease_steal_after_ttl_and_renew_extends(tmp_path):
    broker_a = LeaseBroker(str(tmp_path), "a", ttl=0.2)
    broker_b = LeaseBroker(str(tmp_path), "b", ttl=0.2)
    lease = broker_a.acquire("t1")
    time.sleep(0.12)
    lease.renew()  # heartbeat pushes the deadline out
    time.sleep(0.12)
    assert broker_b.acquire("t1") is None  # renewed: not expired yet
    time.sleep(0.25)
    stolen = broker_b.acquire("t1")
    assert stolen is not None and stolen.stolen


def test_lease_renew_after_steal_raises_and_release_is_safe(tmp_path):
    broker_a = LeaseBroker(str(tmp_path), "a", ttl=0.05)
    broker_b = LeaseBroker(str(tmp_path), "b", ttl=30)
    lease = broker_a.acquire("t1")
    time.sleep(0.1)
    stolen = broker_b.acquire("t1")
    assert stolen is not None
    with pytest.raises(LeaseLost):
        lease.renew()
    lease.release()  # must NOT remove the thief's lock
    assert broker_a.holder("t1")["worker"] == "b"


def test_lease_steal_race_has_one_winner(tmp_path):
    broker_a = LeaseBroker(str(tmp_path), "a", ttl=0.01)
    broker_a.acquire("t1")
    time.sleep(0.05)
    winners = []
    barrier = threading.Barrier(6)

    def contend(name):
        broker = LeaseBroker(str(tmp_path), name, ttl=30)
        barrier.wait()
        lease = broker.acquire("t1")
        if lease is not None:
            winners.append(name)

    threads = [
        threading.Thread(target=contend, args=(f"w{i}",)) for i in range(6)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(winners) == 1, winners


def test_lease_unwritten_body_not_stealable_while_fresh(tmp_path):
    # the open-then-write window of _try_create: lock exists, body empty.
    # A fresh empty lock must read as HELD (mtime fallback), only turning
    # stealable once it ages past the TTL (true torn-write debris)
    broker_a = LeaseBroker(str(tmp_path), "a", ttl=0.2)
    open(broker_a._path("t1"), "w").close()
    broker_b = LeaseBroker(str(tmp_path), "b", ttl=0.2)
    assert broker_b.acquire("t1") is None
    time.sleep(0.25)
    lease = broker_b.acquire("t1")
    assert lease is not None and lease.stolen


# ------------------------------------------------------------------- faults

def test_fault_spec_grammar():
    clauses = parse_spec(
        "crash@gatherer.batch:match=chunk0000,times=1;"
        "delay@lease.renew:secs=0.5;fail@task.claimed:match=x,times=2"
    )
    assert [c.kind for c in clauses] == ["crash", "delay", "fail"]
    assert clauses[0].site == "gatherer.batch"
    assert clauses[0].match == "chunk0000" and clauses[0].times == 1
    assert clauses[1].secs == 0.5 and clauses[1].times is None
    assert parse_spec("") == []


@pytest.mark.parametrize(
    "bad",
    ["explode@site", "crash", "fail@x:times=lots", "fail@x:nonsense=1",
     "fail@x:match"],
)
def test_fault_spec_errors(bad):
    with pytest.raises(FaultSpecError):
        parse_spec(bad)


@pytest.mark.parametrize(
    "spec",
    [
        "crash@gatherer.batch:match=chunk0000,times=1;fail@task.claimed:match=chunk0002,times=2",
        "delay@task.claimed:secs=0.4; corrupt@task.input:match=chunk0001",
        "crash@writer.commit:code=7;delay@lease.renew:secs=2.5,times=3",
        "device_oom@gatherer.dispatch:times=1;xla_transient@gatherer.dispatch",
        "stall@gatherer.dispatch:times=1,secs=600;corrupt_record@gatherer.dispatch:record=17,match=c",
        " ;fail@x: match = a , times = 0 ;",
    ],
)
def test_parse_spec_equals_jax(spec):
    """One spec drives both packages: the same clauses, all eight kinds."""
    assert [dataclasses.asdict(c) for c in parse_spec(spec)] == [
        dataclasses.asdict(c) for c in jax_parse_spec(spec)
    ]


def test_fault_fail_respects_match_and_times():
    faults.configure("fail@task.claimed:match=needle,times=2")
    faults.fire("task.claimed", name="haystack")  # no match: no fire
    for _ in range(2):
        with pytest.raises(InjectedFault):
            faults.fire("task.claimed", name="a-needle-task")
    faults.fire("task.claimed", name="a-needle-task")  # times exhausted


def test_fault_corrupt_consumes():
    faults.configure("corrupt@task.input:times=1")
    assert faults.should_corrupt("task.input", name="x")
    assert not faults.should_corrupt("task.input", name="x")
    assert faults.mangle(b"hello") != b"hello"


# ------------------------------------------------------------------ backoff

def test_backoff_grows_and_caps():
    rng = random.Random(0)
    delays = [backoff_delay(a, 0.5, 4.0, rng) for a in range(1, 8)]
    assert all(0.25 <= d <= 4.0 for d in delays)
    assert backoff_delay(20, 0.5, 4.0, rng) <= 4.0


def test_backoff_delay_equals_jax():
    port_rng, jax_rng = random.Random("proc0-of-2-1234"), random.Random("proc0-of-2-1234")
    for attempt in range(0, 25):
        for base, cap in ((0.25, 30.0), (0.05, 1.0), (2.0, 3.0)):
            assert backoff_delay(attempt, base, cap, port_rng) == jax_backoff_delay(attempt, base, cap, jax_rng)


# ---------------------------------------------------------------- the queue

def test_queue_runs_all_tasks_and_is_idempotent(tmp_path):
    tasks = _simple_tasks(tmp_path, n=4)
    queue = WorkQueue(str(tmp_path / "j"), worker_id="w1", lease_ttl=5)
    queue.register(tasks)
    summary = queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert len(summary.committed) == 4
    assert summary.all_committed == 4
    assert summary.attempts == 4 and summary.steals == 0
    # a re-launch replays the journal and recomputes nothing
    queue2 = WorkQueue(str(tmp_path / "j"), worker_id="w2", lease_ttl=5)
    summary2 = queue2.run(lambda t: _touch_runner(t.payload["out"]))
    assert summary2.attempts == 0 and summary2.all_committed == 4


def test_queue_retries_transient_failure_with_backoff(tmp_path):
    faults.configure("fail@task.claimed:match=t01,times=2")
    tasks = _simple_tasks(tmp_path, n=3)
    queue = WorkQueue(
        str(tmp_path / "j"), worker_id="w1", lease_ttl=5,
        max_attempts=4, backoff_base=0.05,
    )
    queue.register(tasks)
    summary = queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert summary.all_committed == 3 and not summary.quarantined
    _, states = queue.journal.replay()
    by_name = {t.name: states[t.id] for t in tasks}
    assert by_name["t01"].attempts == 3  # two injected failures + success
    assert by_name["t00"].attempts == 1 and by_name["t02"].attempts == 1


def test_queue_quarantines_poison_without_failing_run(tmp_path):
    faults.configure("fail@task.claimed:match=t01")  # unlimited: poison
    tasks = _simple_tasks(tmp_path, n=3)
    queue = WorkQueue(
        str(tmp_path / "j"), worker_id="w1", lease_ttl=5,
        max_attempts=2, backoff_base=0.05,
    )
    queue.register(tasks)
    summary = queue.run(lambda t: _touch_runner(t.payload["out"]))
    # the healthy tasks committed; the poison one is quarantined, not fatal
    assert summary.all_committed == 2
    assert list(summary.quarantined) == ["t01"]
    _, states = queue.journal.replay()
    by_name = {t.name: states[t.id] for t in tasks}
    assert by_name["t01"].state == QUARANTINED
    assert by_name["t01"].attempts == 2  # bounded by max_attempts
    # requeue + clean rerun commits it
    faults.configure("")
    assert sched_cli.main(["retry-quarantined", str(tmp_path / "j")]) == 0
    summary2 = queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert summary2.all_committed == 3 and not summary2.quarantined


def test_queue_steals_expired_lease_of_dead_worker(tmp_path):
    tasks = _simple_tasks(tmp_path, n=2)
    journal_dir = str(tmp_path / "j")
    seed = WorkQueue(journal_dir, worker_id="dead", lease_ttl=0.2)
    seed.register(tasks)
    # simulate a worker that died mid-task: journal says leased, lock held
    lease = seed.broker.acquire(tasks[0].id)
    assert lease is not None
    seed.journal.record(tasks[0].id, "leased", attempt=1)
    queue = WorkQueue(
        journal_dir, worker_id="live", lease_ttl=0.2, poll_interval=0.05
    )
    summary = queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert summary.all_committed == 2
    assert summary.steals == 1
    _, states = queue.journal.replay()
    assert states[tasks[0].id].attempts == 2  # dead attempt + steal


def test_interrupt_does_not_count_toward_quarantine(tmp_path):
    # leased events without a matching failed event (crashes, operator
    # interrupts) must not advance the quarantine threshold
    journal = Journal(str(tmp_path / "j"), worker_id="w1")
    (task,) = journal.register(_simple_tasks(tmp_path, n=1))
    journal.record(task.id, "leased", attempt=1)
    journal.record(task.id, "leased", attempt=2)  # two interrupted starts
    _, states = journal.replay()
    assert states[task.id].attempts == 2
    assert states[task.id].failures == 0
    queue = WorkQueue(
        str(tmp_path / "j"), worker_id="w2", lease_ttl=5,
        max_attempts=2, backoff_base=0.05,
    )
    faults.configure("fail@task.claimed:match=t00,times=1")
    summary = queue.run(lambda t: _touch_runner(t.payload["out"]))
    # one real failure < max_attempts=2 despite attempts now being 4
    assert not summary.quarantined
    assert summary.all_committed == 1


def test_queue_raises_quarantined_error_shape():
    error = QuarantinedTasksError({"chunk0001": "boom"})
    assert "chunk0001" in str(error)
    assert "retry-quarantined" in str(error)
    assert "python -m sctools_tpu_torch.sched" in str(error)


# ---------------------------------------------------------------------- CLI

def test_cli_status_exit_codes_and_table(tmp_path, capsys):
    journal_dir = str(tmp_path / "j")
    assert sched_cli.main(["status", journal_dir]) == 1  # nothing registered
    queue = WorkQueue(journal_dir, worker_id="w1", lease_ttl=5)
    queue.register(_simple_tasks(tmp_path, n=2))
    assert sched_cli.main(["status", journal_dir]) == 1  # open work
    queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert sched_cli.main(["status", journal_dir]) == 0  # all committed
    out = capsys.readouterr().out
    assert "committed=2" in out and "t00" in out
    (poison,) = queue.register(
        [make_task("touch", "t99", {"out": str(tmp_path / "t99.out")})]
    )
    queue.journal.record(poison.id, "quarantined", error="poison")
    assert sched_cli.main(["status", journal_dir]) == 2  # quarantine wins


def test_cli_resume_runs_open_tasks(tmp_path, monkeypatch):
    journal_dir = str(tmp_path / "j")
    queue = WorkQueue(journal_dir, worker_id="w1", lease_ttl=5)
    tasks = _simple_tasks(tmp_path, n=3)
    queue.register(tasks)
    queue.run(
        lambda t: _touch_runner(t.payload["out"]),
        only_ids=[tasks[0].id],  # leave two tasks pending
    )
    devices = []

    def touch(task, device=None):
        devices.append(device)
        return _touch_runner(task.payload["out"])

    monkeypatch.setattr(runners, "resolve", lambda kind: touch)
    assert sched_cli.main(["resume", journal_dir], device="cpu") == 0
    # the runners get the device the caller asked for, resolved
    assert [str(d) for d in devices] == ["cpu", "cpu"]
    _, states = Journal(journal_dir, worker_id="check").replay()
    assert all(st.state == COMMITTED for st in states.values())
    # resume again: everything terminal, status path, still success
    assert sched_cli.main(["resume", journal_dir], device="cpu") == 0


def test_cli_resume_defaults_to_cuda(tmp_path, monkeypatch):
    """``resume`` runs on cuda unless asked for cpu: without a GPU it
    raises before any task is leased, so no attempt is burned."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    journal_dir = str(tmp_path / "j")
    queue = WorkQueue(journal_dir, worker_id="w1", lease_ttl=5)
    queue.register(_simple_tasks(tmp_path, n=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sched_cli.main(["resume", journal_dir])
    _, states = Journal(journal_dir, worker_id="check").replay()
    assert [st.attempts for st in states.values()] == [0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_launch.local_mesh()


def test_second_status_call_reads_only_appended_bytes(tmp_path):
    """A reused Journal's replay is incremental: frame 2 of `status
    --watch` must parse exactly the bytes appended since frame 1."""
    journal_dir = str(tmp_path / "j")
    writer = Journal(journal_dir, worker_id="w1")
    tasks = [make_task("touch", f"t{i:02d}", {"i": i}) for i in range(4)]
    writer.register(tasks)
    for task in tasks[:2]:
        writer.record(task.id, "leased", attempt=1)

    reader = Journal(journal_dir, worker_id="cli-status")
    assert sched_cli._status(journal_dir, io.StringIO(), journal=reader) == 1
    baseline = reader.bytes_scanned
    assert baseline > 0

    # nothing appended: a second call must scan ZERO new bytes
    assert sched_cli._status(journal_dir, io.StringIO(), journal=reader) == 1
    assert reader.bytes_scanned == baseline

    # append one event: the third call scans exactly that line
    events_path = writer._worker_path("events")
    before = os.path.getsize(events_path)
    writer.record(tasks[0].id, "committed", attempt=1)
    appended = os.path.getsize(events_path) - before
    out = io.StringIO()
    assert sched_cli._status(journal_dir, out, journal=reader) == 1
    assert reader.bytes_scanned == baseline + appended
    assert "committed" in out.getvalue()


def test_watch_frame_shows_workers_leases_and_converges(tmp_path):
    journal_dir = str(tmp_path / "j")
    writer = Journal(journal_dir, worker_id="worker-A")
    tasks = [make_task("touch", f"t{i:02d}", {"i": i}) for i in range(3)]
    writer.register(tasks)
    writer.record(tasks[0].id, "leased", attempt=1)
    writer.record(tasks[0].id, "committed", attempt=1)
    writer.record(tasks[1].id, "leased", attempt=1, stolen=1)
    broker = LeaseBroker(writer.leases_dir, "worker-A", ttl=30)
    lease = broker.acquire(tasks[1].id)
    assert lease is not None

    reader = Journal(journal_dir, worker_id="cli-status")
    out = io.StringIO()
    assert sched_cli._render_watch_frame(reader, out) == 1  # work still open
    text = out.getvalue()
    assert "worker-A" in text
    assert "held leases" in text and "t01" in text
    assert "commit" in text  # per-worker progress header

    # converge and the watch loop exits 0 on its next frame
    lease.release()
    writer.record(tasks[1].id, "committed", attempt=1)
    writer.record(tasks[2].id, "leased", attempt=1)
    writer.record(tasks[2].id, "committed", attempt=1)
    out = io.StringIO()
    assert sched_cli._watch(journal_dir, interval=0.01, out=out, max_frames=5) == 0
    assert "committed=3" in out.getvalue()


def test_watch_on_empty_journal_exits_instead_of_looping(tmp_path):
    out = io.StringIO()
    # a mistyped dir must error like one-shot status, not refresh forever
    assert sched_cli._watch(str(tmp_path / "jorunal-typo"), interval=0.01, out=out) == 1
    assert "no tasks registered" in out.getvalue()


def test_cli_status_watch_flag_parses(tmp_path, capsys):
    journal_dir = str(tmp_path / "j")
    queue = WorkQueue(journal_dir, worker_id="w1", lease_ttl=5)
    queue.register(_simple_tasks(tmp_path, n=1))
    queue.run(lambda t: _touch_runner(t.payload["out"]))
    assert sched_cli.main(
        ["status", journal_dir, "--watch", "--interval", "0.01",
         "--frames", "3"]
    ) == 0
    capsys.readouterr()


def test_retry_quarantined_refuses_changed_chunk(tmp_path, capsys):
    """retry-quarantined re-verifies the chunk's content signature before
    requeueing: a task whose input changed (or vanished) since quarantine
    is REFUSED, not resurrected blind."""
    chunk = tmp_path / "chunk_0.bam"
    chunk.write_bytes(b"original chunk bytes")
    stat = os.stat(chunk)
    journal_dir = str(tmp_path / "j")
    journal = Journal(journal_dir, worker_id="w1")
    good = make_task(
        "cell_metrics", "chunk0000",
        {"chunk": str(chunk),
         "chunk_sig": f"{stat.st_size}:{stat.st_mtime_ns}",
         "index": 0, "out_dir": str(tmp_path)},
    )
    changed = make_task(
        "cell_metrics", "chunk0001",
        {"chunk": str(chunk), "chunk_sig": "1:1",
         "index": 1, "out_dir": str(tmp_path)},
    )
    gone = make_task(
        "cell_metrics", "chunk0002",
        {"chunk": str(tmp_path / "missing.bam"), "chunk_sig": "9:9",
         "index": 2, "out_dir": str(tmp_path)},
    )
    unsigned = make_task("other", "t-unsigned", {"x": 1})
    journal.register([good, changed, gone, unsigned])
    for task in (good, changed, gone, unsigned):
        journal.record(task.id, "leased", attempt=1)
        journal.record(task.id, "failed", attempt=1, error="boom")
        journal.record(task.id, "quarantined", error="boom")

    assert sched_cli.main(["retry-quarantined", journal_dir]) == 1
    out = capsys.readouterr().out
    assert "requeued chunk0000" in out
    assert "requeued t-unsigned" in out  # no signature -> no check
    assert "REFUSED chunk0001" in out and "changed since quarantine" in out
    assert "REFUSED chunk0002" in out and "gone" in out
    assert "2 task(s) requeued, 2 refused" in out

    _, states = Journal(journal_dir, worker_id="probe").replay()
    by_id = {tid: st.state for tid, st in states.items()}
    assert by_id[good.id] == "pending"
    assert by_id[unsigned.id] == "pending"
    assert by_id[changed.id] == QUARANTINED
    assert by_id[gone.id] == QUARANTINED


def test_retry_quarantined_unchanged_chunk_still_requeues(tmp_path, capsys):
    """The signature check must not break the happy path (exit 0)."""
    chunk = tmp_path / "chunk_0.bam"
    chunk.write_bytes(b"stable bytes")
    stat = os.stat(chunk)
    journal_dir = str(tmp_path / "j")
    journal = Journal(journal_dir, worker_id="w1")
    task = make_task(
        "cell_metrics", "chunk0000",
        {"chunk": str(chunk),
         "chunk_sig": f"{stat.st_size}:{stat.st_mtime_ns}",
         "index": 0, "out_dir": str(tmp_path)},
    )
    journal.register([task])
    journal.record(task.id, "quarantined", error="x")
    assert sched_cli.main(["retry-quarantined", journal_dir]) == 0
    assert "1 task(s) requeued, 0 refused" in capsys.readouterr().out


def test_worker_mesh_announcement(tmp_path):
    # a WorkQueue given a mesh fingerprint announces it, replay ignores the
    # meta event, and `sched status` renders one line per topology
    journal_dir = str(tmp_path / "journal")
    fp = {
        "axes": ["shard"], "sizes": [8], "devices": 8,
        "device_kind": "cpu",
    }
    queue = WorkQueue(journal_dir, worker_id="meshed-0", mesh=fp)
    queue.register([make_task("noop", "t0", {})])
    queue.run(lambda task: None)
    queue.close()
    meta = queue.journal.worker_meta()
    assert meta == {"meshed-0": {"mesh": fp}}
    # replay folds ONLY task events: the announcement must not create a
    # phantom task state
    tasks, states = queue.journal.replay()
    assert set(tasks) == set(states) and len(tasks) == 1
    out = io.StringIO()
    rc = sched_cli.main(["status", journal_dir], out=out)
    text = out.getvalue()
    assert rc == 0, text
    assert "mesh shard=8 (cpu): 1 worker(s)" in text, text


def test_worker_meta_empty_without_announcements(tmp_path):
    journal = Journal(str(tmp_path / "journal"), worker_id="plain")
    assert journal.worker_meta() == {}


def test_status_shows_quarantined_record_sidecars(tmp_path, capsys):
    """``sched status`` prints the poison-record sidecars that JAX's guard
    writes under ``<journal>/quarantine``, in stream order, past a torn
    last line."""
    import json

    from sctools_tpu_torch.guard import quarantine

    journal_dir = tmp_path / "j"
    queue = WorkQueue(str(journal_dir), worker_id="w1", lease_ttl=5)
    queue.register(_simple_tasks(tmp_path, n=1))
    queue.run(lambda t: _touch_runner(t.payload["out"]))
    (journal_dir / "quarantine").mkdir()
    entries = [{"task": "t00", "record_start": 17, "record_stop": 19, "reason": "PoisonData: bad"},
               {"task": "t00", "record_start": 3, "record_stop": 4, "reason": "PoisonData: worse"}]
    with open(journal_dir / "quarantine" / "records-w1.jsonl", "w") as f:
        f.write("".join(json.dumps(e) + "\n" for e in entries) + '{"torn')
    assert [e["record_start"] for e in quarantine.load_quarantine(str(journal_dir / "quarantine"))] == [3, 17]
    assert sched_cli.main(["status", str(journal_dir)]) == 0
    out = capsys.readouterr().out
    assert "guard: 3 poisoned record(s) quarantined across 2 range(s):" in out
    assert "t00  records [17, 19)  PoisonData: bad" in out


def test_local_mesh_announces_jax_cpu_workers_mesh():
    """A CPU worker's mesh is one shard, as JAX's ``local_mesh()`` is under
    ``JAX_PLATFORMS=cpu`` in a worker process (one host device)."""
    jax_mesh = jax.sharding.Mesh(np.asarray(jax.local_devices()[:1]), ("shard",))
    assert mesh_fingerprint(port_launch.local_mesh(device="cpu")) == jax_mesh_fingerprint(jax_mesh)


# ------------------------------------------------------- merge validation

def _write_part(path: str, rows) -> None:
    with gzip.open(path, "wt") as f:
        f.write(",a,b\n")
        for row in rows:
            f.write(row + "\n")


def test_merge_raises_listing_missing_part_indices(tmp_path):
    _write_part(str(tmp_path / "proc0.part0000.csv.gz"), ["AA,1,2"])
    _write_part(str(tmp_path / "proc0.part0003.csv.gz"), ["CC,5,6"])
    with pytest.raises(ValueError, match=r"missing\s+indices \[1, 2\]"):
        merge_sorted_csv_parts(
            str(tmp_path / "proc*.part*.csv.gz"), str(tmp_path / "m.csv.gz")
        )


def test_merge_expected_parts_catches_stale_higher_indices(tmp_path):
    _write_part(str(tmp_path / "metrics.part0000.csv.gz"), ["AA,1,2"])
    _write_part(str(tmp_path / "metrics.part0001.csv.gz"), ["BB,3,4"])
    # a re-run with fewer chunks reuses the directory: the stale higher
    # index is invisible to gap/duplicate checks but not to the count
    with pytest.raises(ValueError, match="exceed this run's 1 chunk"):
        merge_sorted_csv_parts(
            str(tmp_path / "metrics.part*.csv.gz"),
            str(tmp_path / "m.csv.gz"), expected_parts=1,
        )
    assert merge_sorted_csv_parts(
        str(tmp_path / "metrics.part*.csv.gz"),
        str(tmp_path / "m.csv.gz"), expected_parts=2,
    ) == 2


def test_merge_raises_on_duplicate_part_indices(tmp_path):
    _write_part(str(tmp_path / "proc0.part0000.csv.gz"), ["AA,1,2"])
    _write_part(str(tmp_path / "proc1.part0000.csv.gz"), ["BB,3,4"])
    with pytest.raises(ValueError, match="duplicate part indices"):
        merge_sorted_csv_parts(
            str(tmp_path / "proc*.part*.csv.gz"), str(tmp_path / "m.csv.gz")
        )


def test_merge_journal_validation_catches_stale_and_tampered(tmp_path):
    journal_dir = str(tmp_path / "j")
    journal = Journal(journal_dir, worker_id="w1")
    parts = []
    tasks = []
    for i in range(2):
        path = str(tmp_path / f"proc0.part{i:04d}.csv.gz")
        _write_part(path, [f"A{i},1,2"])
        task = make_task("touch", f"c{i}", {"i": i})
        tasks.append(task)
        parts.append(path)
    journal.register(tasks)
    for task, path in zip(tasks, parts):
        journal.record(
            task.id, "committed", part=path, sha256=sha256_file(path)
        )
    pattern = str(tmp_path / "proc*.part*.csv.gz")
    output = str(tmp_path / "merged.csv.gz")
    assert merge_sorted_csv_parts(pattern, output, journal_dir=journal_dir) == 2

    # a stale part from an aborted earlier run must refuse the merge
    stale = str(tmp_path / "proc9.part0002.csv.gz")
    _write_part(stale, ["ZZ,9,9"])
    with pytest.raises(ValueError, match="not committed in journal"):
        merge_sorted_csv_parts(pattern, output, journal_dir=journal_dir)
    os.remove(stale)

    # a part rewritten after commit (stale overwrite) fails the hash check
    _write_part(parts[0], ["A0,777,777"])
    with pytest.raises(ValueError, match="content hash"):
        merge_sorted_csv_parts(pattern, output, journal_dir=journal_dir)


def test_merge_journal_validation_blocks_quarantined(tmp_path):
    journal_dir = str(tmp_path / "j")
    journal = Journal(journal_dir, worker_id="w1")
    path = str(tmp_path / "proc0.part0000.csv.gz")
    _write_part(path, ["AA,1,2"])
    good = make_task("touch", "c0", {"i": 0})
    poison = make_task("touch", "c1", {"i": 1})
    journal.register([good, poison])
    journal.record(good.id, "committed", part=path, sha256=sha256_file(path))
    journal.record(poison.id, "quarantined", error="boom")
    with pytest.raises(ValueError, match="quarantined"):
        merge_sorted_csv_parts(
            str(tmp_path / "proc*.part*.csv.gz"),
            str(tmp_path / "m.csv.gz"),
            journal_dir=journal_dir,
        )


# ------------------------------------------------- the collective part merge

def _make_part(writer_cls, directory, index, names, seed):
    writer = writer_cls(str(directory / f"metrics.part{index:04d}"))
    rng = np.random.default_rng(seed)
    writer.write_header({"n_reads": 0, "quality_mean": 0.0})
    writer.write_block(
        sorted(names),
        [
            rng.integers(0, 1000, len(names)).astype(np.int64),
            (rng.random(len(names)) * 37).astype(np.float64),
        ],
    )
    writer.close()


def _parts_case(case, directory, writer_cls):
    """``test_collective_merge``'s four parts cases, written with either
    package's writer (their bytes are equal)."""
    directory.mkdir()
    if case == "byte_identical":
        _make_part(writer_cls, directory, 0, ["AAA", "CCC", "GGG"], 1)
        _make_part(writer_cls, directory, 1, ["ACG", "TTT"], 2)
        _make_part(writer_cls, directory, 2, ["CCA", "GTT", "TAC"], 3)
    elif case == "gap":
        _make_part(writer_cls, directory, 0, ["AAA"], 1)
        _make_part(writer_cls, directory, 2, ["CCC"], 2)
    else:
        text = ",n_reads\nAAA,007\n" if case == "non_canonical" else ",n_reads,quality_mean\nAAA,7\n"
        with gzip.open(directory / "metrics.part0000.csv.gz", "wt") as f:
            f.write(text)
    return str(directory / "metrics.part*.csv.gz")


def _merge_outcome(merge, pattern, output, **kwargs):
    try:
        n = merge(pattern, output, **kwargs)
    except ValueError as error:
        # a message names its own package's CLI
        text = str(error).replace(os.path.dirname(pattern), "<dir>")
        return "error", text.replace("sctools_tpu_torch.sched", "sctools_tpu.sched")
    return n, _gz_bytes(output)


@pytest.mark.parametrize("case", ["byte_identical", "gap", "non_canonical", "ragged"])
def test_collective_merge_parts_equals_jax(tmp_path, case):
    """The port's collective part merge on a 2-shard CPU mesh against JAX's
    on its 8 host devices: the same rows and bytes, or the same error; and
    on the happy path, the text merge's bytes."""
    port_pattern = _parts_case(case, tmp_path / "port", MetricCSVWriter)
    jax_pattern = _parts_case(case, tmp_path / "jax", JaxMetricCSVWriter)
    mesh = port_launch.make_mesh(2, device="cpu")
    port = _merge_outcome(collective_merge_parts, port_pattern, str(tmp_path / "port.csv.gz"), mesh=mesh)
    want = _merge_outcome(jax_collective_merge_parts, jax_pattern, str(tmp_path / "jax.csv.gz"))
    assert port == want
    if case == "byte_identical":
        assert port[0] == 8
        assert merge_sorted_csv_parts(port_pattern, str(tmp_path / "text.csv.gz")) == 8
        assert _gz_bytes(tmp_path / "text.csv.gz") == port[1]
    else:
        assert port[0] == "error"
        assert {"gap": "gaps", "non_canonical": "non-canonical", "ragged": "ragged"}[case] in port[1]


# ------------------------------------------------- end-to-end crash/resume

def _make_input(path: str, n_cells: int = 48) -> None:
    rng = random.Random(31)
    records = []
    for cb in sorted(
        "".join(rng.choice("ACGT") for _ in range(12)) for _ in range(n_cells)
    ):
        for ub in sorted(
            "".join(rng.choice("ACGT") for _ in range(6)) for _ in range(3)
        ):
            ge = rng.choice(["G1", "G2", "G3"])
            for i in range(2):
                records.append(
                    make_record(
                        name=f"{cb}{ub}{i}", cb=cb, cr=cb, cy="IIII",
                        ub=ub, ur=ub, uy="IIII", ge=ge, xf="CODING",
                        nh=1, pos=rng.randrange(1000),
                    )
                )
    write_bam(path, records)


def _split(bam: str, workdir) -> int:
    chunk_dir = workdir / "chunks"
    chunk_dir.mkdir()
    GenericPlatform.split_bam(
        ["-b", bam, "-p", str(chunk_dir / "chunk"), "-s", "0.002", "-t", "CB"], device="cpu"
    )
    return len(list(chunk_dir.glob("*.bam")))


def _worker_env(fault_spec):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SCTOOLS_TPU_FAULTS", None)
    if fault_spec:
        env["SCTOOLS_TPU_FAULTS"] = fault_spec
    return env


def _worker_args(workdir, process_id, ttl, num_processes=1):
    return [sys.executable, "-c", WORKER, str(workdir), str(process_id), str(num_processes), ttl, "3", "0.05"]


def _run_worker(workdir, process_id, fault_spec, timeout=240, ttl="2.0"):
    proc = subprocess.run(
        _worker_args(workdir, process_id, ttl),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_worker_env(fault_spec), timeout=timeout,
    )
    return proc.returncode, proc.stdout


@pytest.fixture(scope="module")
def crash_run(tmp_path_factory):
    """The two-phase fault-injected run on the port: one worker killed
    mid-chunk, then a relaunch in which chunk0002 fails twice."""
    workdir = tmp_path_factory.mktemp("crash_run")
    bam = str(workdir / "input.bam")
    _make_input(bam)
    single = workdir / "single.csv.gz"
    GatherCellMetrics(bam, str(single), device="cpu").extract_metrics()
    n_chunks = _split(bam, workdir)
    journal_dir = str(workdir / "sched-journal")
    # phase 1: the worker dies MID-CHUNK on its first claim (chunk_0 ->
    # task chunk0000), leaving a leased journal entry and a held lock
    crash = _run_worker(workdir, 0, "crash@gatherer.batch:match=chunk_0.bam,times=1")
    _, after_crash = Journal(journal_dir, worker_id="probe").replay()
    # phase 2: re-launch; chunk0002 transiently fails twice, the crashed
    # task's lease is stolen after TTL, everything converges
    resume = _run_worker(workdir, 0, "fail@task.claimed:match=chunk0002,times=2")
    return dict(workdir=workdir, single=single, n_chunks=n_chunks, journal_dir=journal_dir,
                crash=crash, after_crash=after_crash, resume=resume)


def test_crash_midchunk_then_resume_is_byte_identical(crash_run):
    """The acceptance scenario: a worker killed mid-chunk + a chunk that
    transiently fails twice; after resume the merged CSV is byte-identical
    to a clean single-process run and attempts match the journal."""
    workdir, journal_dir, n_chunks = crash_run["workdir"], crash_run["journal_dir"], crash_run["n_chunks"]
    assert n_chunks >= 3
    rc, out = crash_run["crash"]
    assert rc == 86, out
    assert "injected crash at gatherer.batch" in out
    assert sum(st.state == "leased" for st in crash_run["after_crash"].values()) == 1
    rc, out = crash_run["resume"]
    assert rc == 0, out

    tasks, states = Journal(journal_dir, worker_id="probe").replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    assert all(st.state == COMMITTED for st in by_name.values())
    # exactly one recompute of the crashed chunk; transient chunk took 3
    assert by_name["chunk0000"].attempts == 2
    assert by_name["chunk0000"].steals == 1
    assert by_name["chunk0002"].attempts == 3
    for name, st in by_name.items():
        if name not in ("chunk0000", "chunk0002"):
            assert st.attempts == 1, (name, st)

    # no in-flight debris got published; parts equal the journal exactly
    merged = workdir / "merged.csv.gz"
    n_rows = merge_sorted_csv_parts(
        str(workdir / "metrics.part*.csv.gz"), str(merged),
        journal_dir=journal_dir, expected_parts=n_chunks,
    )
    assert n_rows > 0
    assert _gz_bytes(merged) == _gz_bytes(crash_run["single"])


def test_scheduled_run_equals_jax_scheduled_run(crash_run, tmp_path):
    """The same chunks through JAX's chunk queue (one host device, as its
    CPU worker has): JAX's task ids are the port's for the same chunks and
    out dir, and its merged CSV is the port's crash-and-resume merge; the
    port's collective part merge gives the text merge's bytes."""
    workdir, n_chunks = crash_run["workdir"], crash_run["n_chunks"]
    chunks = sorted(str(p) for p in (workdir / "chunks").glob("*.bam"))
    port_ids = [t.id for t in port_launch.make_cell_metric_tasks(chunks, str(workdir), frozenset({"G2"}))]
    assert port_ids == [t.id for t in jax_launch.make_cell_metric_tasks(chunks, str(workdir), frozenset({"G2"}))]
    _, states = Journal(crash_run["journal_dir"], worker_id="probe").replay()
    assert {t.id for t in port_launch.make_cell_metric_tasks(chunks, str(workdir))} == set(states)

    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    mesh = jax.sharding.Mesh(np.asarray(jax.local_devices()[:1]), ("shard",))
    jax_launch.run_process_cell_metrics(chunks, str(jax_dir / "proc0"), 1, 0, mesh=mesh, lease_ttl=5.0)
    jax_merged = tmp_path / "jax_merged.csv.gz"
    jax_launch.merge_sorted_csv_parts(
        str(jax_dir / "metrics.part*.csv.gz"), str(jax_merged),
        journal_dir=str(jax_dir / "sched-journal"), expected_parts=n_chunks,
    )
    port_merged = tmp_path / "port_merged.csv.gz"
    merge_sorted_csv_parts(
        str(workdir / "metrics.part*.csv.gz"), str(port_merged),
        journal_dir=crash_run["journal_dir"], expected_parts=n_chunks,
    )
    assert_csv_match(port_merged, jax_merged)
    collective = tmp_path / "collective.csv.gz"
    collective_merge_parts(
        str(workdir / "metrics.part*.csv.gz"), str(collective),
        mesh=port_launch.local_mesh(device="cpu"), journal_dir=crash_run["journal_dir"], expected_parts=n_chunks,
    )
    assert _gz_bytes(collective) == _gz_bytes(port_merged)


def test_poison_chunk_quarantines_then_retry_succeeds(tmp_path):
    """A corrupt chunk exhausts its attempts into quarantine without
    failing the rest of the run; retry-quarantined + a clean relaunch
    completes and the merge validates against the journal."""
    bam = str(tmp_path / "input.bam")
    _make_input(bam, n_cells=24)
    n_chunks = _split(bam, tmp_path)
    assert n_chunks >= 2

    rc, out = _run_worker(tmp_path, 0, "corrupt@task.input:match=chunk0001")
    assert rc == 3, out  # QuarantinedTasksError exit
    journal_dir = str(tmp_path / "sched-journal")
    tasks, states = Journal(journal_dir, worker_id="probe").replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    assert by_name["chunk0001"].state == QUARANTINED
    committed = [n for n, st in by_name.items() if st.state == COMMITTED]
    assert len(committed) == n_chunks - 1  # the rest of the run completed

    # quarantined journal blocks the merge outright
    with pytest.raises(ValueError, match="quarantined"):
        merge_sorted_csv_parts(
            str(tmp_path / "metrics.part*.csv.gz"),
            str(tmp_path / "m.csv.gz"), journal_dir=journal_dir,
        )

    assert sched_cli.main(["retry-quarantined", journal_dir]) == 0
    rc, out = _run_worker(tmp_path, 0, None)
    assert rc == 0, out
    n_rows = merge_sorted_csv_parts(
        str(tmp_path / "metrics.part*.csv.gz"),
        str(tmp_path / "merged.csv.gz"), journal_dir=journal_dir,
    )
    assert n_rows > 0


def test_sigterm_during_guarded_stall_keeps_lease_semantics(tmp_path):
    """SIGTERM landing while a worker sits inside a guard retry (an injected
    ``stall`` at ``gatherer.dispatch``): the flight record captures the open
    guard retry, the journal shows the task leased with NO failed event (the
    stall burned no sched attempt), no partial part was published, and a
    clean relaunch converges byte-identically."""
    import json

    bam = str(tmp_path / "input.bam")
    _make_input(bam)
    single = tmp_path / "single.csv.gz"
    GatherCellMetrics(bam, str(single), device="cpu").extract_metrics()
    n_chunks = _split(bam, tmp_path)
    assert n_chunks >= 3

    proc = subprocess.Popen(
        _worker_args(tmp_path, 0, "5.0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(_worker_env("stall@gatherer.dispatch:times=1,secs=600"),
                 SCTOOLS_TPU_TRACE=str(tmp_path / "trace"), SCTOOLS_TPU_TRACE_WORKER="w0"),
    )
    journal_dir = str(tmp_path / "sched-journal")
    try:
        deadline = time.time() + 120
        leased = False
        probe = Journal(journal_dir, worker_id="probe")
        while time.time() < deadline and not leased:
            if os.path.isdir(journal_dir):
                _, states = probe.replay()
                leased = any(st.state == "leased" for st in states.values())
            time.sleep(0.2)
        assert leased, "worker never leased a task"
        time.sleep(1.5)  # let the first dispatch reach the injected stall
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGTERM, out

    # the flight record shows the guarded dispatch mid-recovery (named by
    # the journal worker id the scheduler put into the obs context)
    flights = sorted((tmp_path / "trace").glob("flight.*.jsonl"))
    assert flights, list((tmp_path / "trace").glob("*"))
    meta = json.loads(flights[0].read_text().splitlines()[0])
    assert "gatherer.dispatch" in ((meta.get("sections") or {}).get("guard_retries") or {}), meta.get("sections")

    # journal: the task is leased, and no failed event was recorded
    tasks, states = Journal(journal_dir, worker_id="probe2").replay()
    assert sum(st.state == "leased" for st in states.values()) == 1
    assert all(st.failures == 0 for st in states.values())
    # no part file exists for the leased (killed) task
    committed_parts = {
        os.path.abspath(st.part) for st in states.values()
        if st.state == COMMITTED and st.part
    }
    on_disk = {
        os.path.abspath(str(p))
        for p in tmp_path.glob("metrics.part*.csv.gz")
    }
    assert on_disk == committed_parts

    # clean relaunch: converges, byte-identical merge
    rc, out = _run_worker(tmp_path, 0, None, timeout=300)
    assert rc == 0, out
    merged = tmp_path / "merged.csv.gz"
    merge_sorted_csv_parts(
        str(tmp_path / "metrics.part*.csv.gz"), str(merged),
        journal_dir=journal_dir, expected_parts=n_chunks,
    )
    assert _gz_bytes(merged) == _gz_bytes(single)
