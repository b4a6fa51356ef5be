"""A durable, fault-tolerant, work-stealing task scheduler over a shared directory.

The port of ``sctools_tpu.sched`` (pure standard library there and here).
Workers pull tasks from one journaled queue instead of a static
assignment, so a lost, corrupt or straggling worker no longer stalls or
kills a run:

- **Journal** (:mod:`.journal`): content-hashed task ids over append-only
  JSONL logs (``pending -> leased -> committed | failed | quarantined``).
  A re-launch replays the journal and skips committed tasks. A journal
  written by either package replays to the same states under the other.
- **Leases** (:mod:`.lease`): ``O_CREAT|O_EXCL`` lock files with a TTL and
  heartbeat renewal; a worker steals the expired lease of a dead or
  straggling peer.
- **Retry** (:mod:`.scheduler`): exponential backoff with full jitter,
  bounded attempts, and quarantine of a task that keeps failing.
- **Atomic commit** (:mod:`.commit`): artifacts publish by temp file and
  rename, so a task killed mid-write leaves no partial part.
- **Fault injection** (:mod:`.faults`): ``SCTOOLS_TPU_FAULTS`` arms crash,
  delay, fail and corrupt behaviours at named sites, with the JAX
  package's grammar, so one spec drives both packages.
- **CLI** (:mod:`.cli`): ``python -m sctools_tpu_torch.sched
  status|resume|retry-quarantined <journal>``.

Not ported: the observability counters and spans and the audit ledger the
JAX scheduler records, and the device-boundary fault kinds' firing sites
(they fire inside the JAX guard ladder, which the port does not have).
"""

from .commit import atomic_output, inflight_path, sha256_file
from .faults import FaultSpecError, InjectedFault
from .journal import (
    COMMITTED,
    FAILED,
    LEASED,
    PENDING,
    QUARANTINED,
    Journal,
    Task,
    TaskState,
    make_task,
    task_id,
    wall_clock,
)
from .lease import Lease, LeaseBroker, LeaseLost
from .scheduler import (
    QuarantinedTasksError,
    RunSummary,
    WorkQueue,
    backoff_delay,
)

__all__ = [
    "COMMITTED",
    "FAILED",
    "FaultSpecError",
    "InjectedFault",
    "Journal",
    "LEASED",
    "Lease",
    "LeaseBroker",
    "LeaseLost",
    "PENDING",
    "QUARANTINED",
    "QuarantinedTasksError",
    "RunSummary",
    "Task",
    "TaskState",
    "WorkQueue",
    "atomic_output",
    "backoff_delay",
    "inflight_path",
    "make_task",
    "sha256_file",
    "task_id",
    "wall_clock",
]
