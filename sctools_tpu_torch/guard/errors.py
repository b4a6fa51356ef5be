"""The device-boundary error taxonomy: what an exception means for retry.

The port's copy of ``sctools_tpu.guard.errors``. Every exception crossing
the device boundary folds into one of four recovery classes:

- :class:`Transient` -- the work was fine, the attempt was unlucky (a
  dropped link of the gloo route, a store timeout). Retry in place with
  jittered backoff, under the same scheduler lease (no sched attempt
  burned).
- :class:`ResourceExhausted` -- the device ran out of memory for this
  batch shape. The batch bisects into halves down to a floor
  (:func:`sctools_tpu_torch.guard.run_batch`), merging partial results.
- :class:`PoisonData` -- the failure is attributable to the input bytes.
  Retrying cannot help; the offending record range is isolated,
  quarantined to a sidecar, and the remainder continues.
- :class:`Fatal` -- everything else: bugs, misconfiguration, injected
  task-level faults, and a dead CUDA context. Propagates unchanged so the
  scheduler's own retry and quarantine ladder (which burns attempts)
  takes over.

:func:`classify` maps a raw exception to one of the four kinds. It reads
type names and modules and never imports torch, so that the scheduler's
CLI and the fault grammar stay stdlib-only. The torch table:

===================================================  ====================
exception                                            kind
===================================================  ====================
``torch.OutOfMemoryError`` (``torch.cuda.``'s too)   resource_exhausted
``MemoryError``                                      resource_exhausted
``torch.AcceleratorError`` naming ``out of memory``  resource_exhausted
(a ``cudaErrorMemoryAllocation`` from an extension)
any other ``torch.AcceleratorError``                 fatal (sticky: the
(illegal address, launch failure, misaligned         CUDA context is dead
address, illegal instruction, device assert,         and every retry fails
uncorrectable ECC)                                   alike; only a new
                                                     process recovers)
``torch.distributed.DistNetworkError``               transient (the gloo
                                                     route's link)
``torch.distributed.DistStoreError``                 transient (the
                                                     rendezvous store)
``torch.distributed.DistBackendError``               fatal (an aborted
                                                     communicator, a dead
                                                     context, or a backend
                                                     watchdog timeout that
                                                     one rank may see
                                                     alone: retrying its
                                                     collectives there
                                                     would put the ranks
                                                     out of step)
===================================================  ====================

Anything else -- the scheduler's injected task faults, a ``RuntimeError``
from a kernel wrapper's status check, host bugs -- is fatal here: "not
the guard's call".
"""

from __future__ import annotations

from typing import Optional, Tuple

# classification kinds (classify() return values)
TRANSIENT = "transient"
RESOURCE_EXHAUSTED = "resource_exhausted"
POISON = "poison"
FATAL = "fatal"

KINDS = (TRANSIENT, RESOURCE_EXHAUSTED, POISON, FATAL)


class GuardError(RuntimeError):
    """Base of the typed taxonomy (raisable forms of the classes above)."""

    kind = FATAL


class Transient(GuardError):
    """Retry in place: the attempt failed, the work and the data are fine."""

    kind = TRANSIENT


class ResourceExhausted(GuardError):
    """Device OOM for this batch shape: bisect and merge partial results."""

    kind = RESOURCE_EXHAUSTED


class PoisonData(GuardError):
    """The input bytes are bad: isolate, quarantine, continue without them.

    ``record_range`` (absolute ``(start, stop)`` record indices in the
    task's decode stream) localizes the poison when the raiser knows it;
    the guard then quarantines exactly that range without bisecting.
    """

    kind = POISON

    def __init__(self, *args, record_range: Optional[Tuple[int, int]] = None):
        super().__init__(*args)
        self.record_range = record_range


class Fatal(GuardError):
    """Not recoverable at the batch boundary; the scheduler decides."""

    kind = FATAL


class Stall(Transient):
    """A watchdog deadline fired: the leg exceeded its configured budget.

    Raised asynchronously into the stalled thread by
    :mod:`sctools_tpu_torch.guard.watchdog`; a Transient, so the guard's
    retry ladder absorbs it instead of the lease hanging to its TTL.
    """


class NativeDecodeError(PoisonData):
    """The native decoder failed mid-stream, with its localization.

    ``batch_index`` is the ring batch that failed; ``record_offset`` the
    records the ring had yielded before it (where in the file the bytes
    went bad).
    """

    def __init__(
        self,
        message: str,
        batch_index: Optional[int] = None,
        record_offset: Optional[int] = None,
    ):
        detail = message
        if batch_index is not None or record_offset is not None:
            detail = f"{message} (batch_index={batch_index}, record_offset~={record_offset})"
        super().__init__(detail)
        self.batch_index = batch_index
        self.record_offset = record_offset


# the torch exception types, by name, that put an error on the device side
_OOM_TYPES = ("OutOfMemoryError",)
_ACCELERATOR_TYPES = ("AcceleratorError",)
_DIST_TRANSIENT_TYPES = ("DistNetworkError", "DistStoreError")
# what an allocation failure says inside an AcceleratorError
# (cudaErrorMemoryAllocation: "out of memory")
_OOM_MARKERS = ("out of memory", "cudaErrorMemoryAllocation")


def classify(error: BaseException) -> str:
    """Fold ``error`` into one of the four recovery kinds.

    Explicit taxonomy instances win; ``MemoryError`` is resource
    exhaustion wherever it happens; torch's errors follow the table of the
    module docstring, recognized by type name and module, never by import.
    Everything else is FATAL, meaning "not the guard's call": it
    propagates to the scheduler unchanged.
    """
    if isinstance(error, GuardError):
        return error.kind
    if isinstance(error, MemoryError):
        return RESOURCE_EXHAUSTED
    mro = type(error).__mro__
    if not any(cls.__module__.split(".", 1)[0] == "torch" for cls in mro):
        return FATAL
    names = {cls.__name__ for cls in mro}
    message = str(error)
    if names & set(_OOM_TYPES):
        return RESOURCE_EXHAUSTED
    if names & set(_DIST_TRANSIENT_TYPES):
        return TRANSIENT
    if names & set(_ACCELERATOR_TYPES):
        if any(marker in message for marker in _OOM_MARKERS):
            return RESOURCE_EXHAUSTED
        return FATAL
    return FATAL
