"""Fault injection: deterministic failures at named pipeline sites.

The port's copy of ``sctools_tpu.sched.faults``: crash, delay, fail and
corrupt behaviours armed through the ``SCTOOLS_TPU_FAULTS`` environment
variable, with the JAX package's grammar, so that one spec drives both
packages. Production runs never set the variable; the check is one cached
list scan, and an empty spec short-circuits to a no-op.

Spec grammar::

    spec    := clause (';' clause)*
    clause  := kind '@' site [':' key '=' value (',' key '=' value)*]
    kind    := 'crash' | 'delay' | 'fail' | 'corrupt'
             | 'device_oom' | 'xla_transient' | 'stall' | 'corrupt_record'
    key     := 'match' | 'times' | 'secs' | 'code' | 'record'

Task-level kinds, fired by :func:`fire` (these burn scheduler attempts):

- ``crash`` -- ``os._exit(code)`` (default 86): the process dies without
  cleanup, like a preempted host. Its leases stay held until their TTL.
- ``delay`` -- sleep ``secs`` (default 1.0): stragglers and slow renewals.
- ``fail``  -- raise :class:`InjectedFault`: a transient task error the
  retry ladder must absorb.
- ``corrupt`` -- sites that produce bytes consult :func:`should_corrupt`
  and garble their output when told to: poison inputs and torn writes.

The four device-boundary kinds (``device_oom``, ``xla_transient``,
``stall``, ``corrupt_record``) parse, so a spec written for the JAX
package parses here too, but no site of the port fires them: the JAX
package fires them inside its guard ladder, which the port does not have.

``match=SUBSTR`` arms a clause only for sites whose ``name`` argument
contains SUBSTR (task names, chunk paths). ``times=N`` fires at most N
times per process (counts are in memory: a crash resets them, so a
relaunched process runs clean unless re-armed).

Example: kill the worker mid-chunk once, and fail one chunk twice::

    SCTOOLS_TPU_FAULTS='crash@gatherer.batch:match=chunk0000,times=1;\\
    fail@task.claimed:match=chunk0002,times=2'

Sites: ``task.claimed`` (scheduler, before the run), ``task.commit``
(scheduler, after the run and before the journal's commit),
``gatherer.batch`` (the sharded gatherer, per device batch: mid-chunk),
``lease.renew`` (heartbeat thread), ``writer.commit`` (CSV writer, before
the atomic rename), ``task.input`` (the chunk runner; ``corrupt`` makes
the task read a garbled copy of its chunk: the poison-task case).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

from ..analysis.witness import make_lock

ENV_VAR = "SCTOOLS_TPU_FAULTS"
KINDS = (
    "crash", "delay", "fail", "corrupt",
    "device_oom", "xla_transient", "stall", "corrupt_record",
)
DEFAULT_CRASH_CODE = 86


class FaultSpecError(ValueError):
    """The SCTOOLS_TPU_FAULTS spec does not parse."""


class InjectedFault(RuntimeError):
    """A ``fail`` clause fired (a synthetic transient task failure)."""


@dataclass
class Clause:
    kind: str
    site: str
    match: str = ""
    times: Optional[int] = None  # None = unlimited
    secs: float = 1.0
    code: int = DEFAULT_CRASH_CODE
    record: Optional[int] = None  # corrupt_record: absolute stream index

    def arm_check(self, site: str, name: str) -> bool:
        if self.site != site:
            return False
        if self.match and self.match not in name:
            return False
        return self.times is None or self.times > 0

    def consume(self) -> None:
        if self.times is not None:
            self.times -= 1


def parse_spec(text: str) -> List[Clause]:
    """Parse a fault spec; raises :class:`FaultSpecError` on bad grammar."""
    clauses: List[Clause] = []
    for raw in (text or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        head, _, options = raw.partition(":")
        kind, _, site = head.partition("@")
        kind, site = kind.strip(), site.strip()
        if kind not in KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r} in {raw!r}")
        if not site:
            raise FaultSpecError(f"missing @site in fault clause {raw!r}")
        clause = Clause(kind=kind, site=site)
        for pair in filter(None, (p.strip() for p in options.split(","))):
            key, sep, value = pair.partition("=")
            if not sep:
                raise FaultSpecError(f"expected key=value, got {pair!r}")
            key, value = key.strip(), value.strip()
            try:
                if key == "match":
                    clause.match = value
                elif key == "times":
                    clause.times = int(value)
                elif key == "secs":
                    clause.secs = float(value)
                elif key == "code":
                    clause.code = int(value)
                elif key == "record":
                    clause.record = int(value)
                else:
                    raise FaultSpecError(
                        f"unknown fault option {key!r} in {raw!r}"
                    )
            except ValueError as error:
                if isinstance(error, FaultSpecError):
                    raise
                raise FaultSpecError(
                    f"bad value for {key!r} in {raw!r}: {value!r}"
                ) from None
        clauses.append(clause)
    return clauses


_lock = make_lock("sched.faults")
_clauses: Optional[List[Clause]] = None  # None = env not parsed yet


def _active() -> List[Clause]:
    global _clauses
    with _lock:
        if _clauses is None:
            _clauses = parse_spec(os.environ.get(ENV_VAR, ""))
        return _clauses


def configure(spec: str) -> None:
    """Arm a spec programmatically (tests); overrides the environment."""
    global _clauses
    with _lock:
        _clauses = parse_spec(spec)


def reset() -> None:
    """Drop any armed spec; the next check re-reads the environment."""
    global _clauses
    with _lock:
        _clauses = None


def _take(site: str, name: str, kinds: tuple) -> Optional[Clause]:
    with _lock:
        for clause in _clauses or ():
            if clause.kind in kinds and clause.arm_check(site, name):
                clause.consume()
                return clause
    return None


def fire(site: str, name: str = "") -> None:
    """Fire any armed crash/delay/fail clause for ``site`` (no-op spec-less).

    ``delay`` clauses stack with a following ``crash``/``fail`` at the
    same site (each ``fire`` consumes at most one delay and one
    terminal clause).
    """
    if not _active():
        return
    delay = _take(site, name, ("delay",))
    if delay is not None:
        time.sleep(delay.secs)
    clause = _take(site, name, ("crash", "fail"))
    if clause is None:
        return
    if clause.kind == "fail":
        raise InjectedFault(f"injected failure at {site} ({name})")
    sys.stderr.write(f"sctools-tpu: injected crash at {site} ({name})\n")
    sys.stderr.flush()
    # no cleanup of any kind, like a real preemption: live threads, open
    # files and held leases are left as they are
    os._exit(clause.code)


def should_corrupt(site: str, name: str = "") -> bool:
    """Whether an armed ``corrupt`` clause fires for this site (consumes)."""
    if not _active():
        return False
    return _take(site, name, ("corrupt",)) is not None


def mangle(data: bytes) -> bytes:
    """Deterministically garble ``data`` (for sites that opted in)."""
    prefix = b"\x00CORRUPTED\x00"
    return prefix + bytes(b ^ 0xFF for b in data[: 1 << 12]) + data[1 << 12:]
