"""Serving-plane vocabulary: entry markers, jobs, admission control.

The port's copy of ``sctools_tpu.serve.api`` (standard library only there
and here), so either package can drain a journal the other's ``submit``
wrote:

- :func:`serve_entry` marks a function as a request-path root and
  :func:`warmup_step` one that runs before the worker admits work. They
  are runtime attributes that tests and the engine can read, and the
  roots of the static AOT pass (``python -m sctools_tpu_torch.analysis``,
  :mod:`sctools_tpu_torch.analysis.aotcheck`, SCX901-905).
- :class:`ServeJob` is one tenant request, the payload of a journal task
  of kind :data:`SERVE_TASK_KIND`.
- :class:`AdmissionController` is per-tenant round-robin selection with a
  bounded in-flight depth, so one tenant's backlog cannot starve the rest
  or grow the packing loop without bound.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, TypeVar

F = TypeVar("F", bound=Callable[..., Any])

#: journal task kind for one serve job (a per-tenant metrics request);
#: registered in sched.runners so `sched resume` can drain a serve
#: journal without the resident engine
SERVE_TASK_KIND = "serve_cell_metrics"

#: default per-tenant admission depth (jobs admitted into the packing
#: loop at once)
DEFAULT_ADMISSION_DEPTH = 4


def serve_entry(fn: F) -> F:
    """Mark ``fn`` as a serve request-path root."""
    fn.__scx_serve_entry__ = True  # type: ignore[attr-defined]
    return fn


def warmup_step(fn: F) -> F:
    """Mark ``fn`` as replica warmup (runs before admission)."""
    fn.__scx_warmup_step__ = True  # type: ignore[attr-defined]
    return fn


@dataclass(frozen=True)
class ServeJob:
    """One tenant request: a chunk of records in, one metrics part out.

    Jobs ride the scheduler journal (kind :data:`SERVE_TASK_KIND`) so
    lease/steal/quarantine give tenant isolation and crash recovery for
    free; the payload is exactly this record.

    ``submitted`` is the tenant-side wall timestamp stamped at submit
    time (``sched status`` reads the queue age from it).
    It rides the payload but NOT the task identity
    (:meth:`identity_payload`): resubmitting the same job later must
    still dedupe to the same content-hashed task id.
    """

    tenant: str
    bam: str
    out: str
    submitted: Optional[float] = None

    def identity_payload(self) -> Dict[str, Any]:
        """The payload slice that defines the job's content-hashed id."""
        return {"tenant": self.tenant, "bam": self.bam, "out": self.out}

    def payload(self) -> Dict[str, Any]:
        payload = self.identity_payload()
        if self.submitted is not None:
            payload["submitted"] = self.submitted
        return payload

    @staticmethod
    def from_payload(payload: Dict[str, Any]) -> "ServeJob":
        submitted = payload.get("submitted")
        return ServeJob(
            tenant=str(payload["tenant"]),
            bam=str(payload["bam"]),
            out=str(payload["out"]),
            submitted=(
                float(submitted)
                if isinstance(submitted, (int, float))
                else None
            ),
        )


@dataclass
class AdmissionController:
    """Per-tenant round-robin admission with a bounded depth.

    ``admit(tenant)`` says whether one more job from ``tenant`` may
    enter the packing loop; ``release(tenant)`` returns its slot.
    ``select(queued_by_tenant)`` picks the next tenant round-robin among
    those with queued work AND a free slot — a tenant with a deep
    backlog gets exactly one turn per cycle, so admission stays fair
    and the in-flight set stays bounded.
    """

    max_depth: int = DEFAULT_ADMISSION_DEPTH
    _in_flight: Dict[str, int] = field(default_factory=dict)
    _cursor: int = 0

    def depth(self, tenant: str) -> int:
        return self._in_flight.get(tenant, 0)

    def admit(self, tenant: str) -> bool:
        if self.depth(tenant) >= self.max_depth:
            return False
        self._in_flight[tenant] = self.depth(tenant) + 1
        return True

    def release(self, tenant: str) -> None:
        current = self.depth(tenant)
        if current <= 1:
            self._in_flight.pop(tenant, None)
        else:
            self._in_flight[tenant] = current - 1

    def select(
        self, queued_by_tenant: Dict[str, Sequence[str]]
    ) -> Optional[str]:
        """Next admissible tenant, round-robin; None when all blocked."""
        tenants = sorted(t for t, q in queued_by_tenant.items() if q)
        if not tenants:
            return None
        start = self._cursor % len(tenants)
        for offset in itertools.islice(range(len(tenants)), len(tenants)):
            tenant = tenants[(start + offset) % len(tenants)]
            if self.depth(tenant) < self.max_depth:
                self._cursor = (start + offset + 1) % len(tenants)
                return tenant
        return None

    def snapshot(self) -> Dict[str, Any]:
        """Announced to the journal; `sched status` renders it."""
        return {
            "max_depth": self.max_depth,
            "in_flight": dict(sorted(self._in_flight.items())),
        }


def group_open_jobs(
    tasks: Dict[str, Any], states: Dict[str, Any], now: float
) -> Dict[str, List[str]]:
    """Claimable serve-task ids grouped by tenant, stable order per tenant.

    A task is claimable when it is a serve job that is not terminal and
    past any backoff deadline.  A journal state of ``leased`` does NOT
    exclude it: the journal cannot see lease-file TTLs, so a dead
    worker's jobs would never be stolen — whether a lease is actually
    live is the broker's call (``acquire`` fails on live leases and
    steals expired ones).  Duck-typed against sched's folded
    ``TaskState`` (a missing state means never-touched, i.e. claimable)
    so this module stays stdlib-only.
    """
    queued: Dict[str, List[str]] = {}
    for tid in sorted(tasks, key=lambda t: tasks[t].name):
        task = tasks[tid]
        if task.kind != SERVE_TASK_KIND:
            continue
        state = states.get(tid)
        if state is not None and (
            state.terminal or state.not_before > now
        ):
            continue
        tenant = str(task.payload.get("tenant", "?"))
        queued.setdefault(tenant, []).append(tid)
    return queued
