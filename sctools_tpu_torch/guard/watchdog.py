"""Stall watchdogs: deadline timers on the decode/upload/compute/pull legs.

The port's copy of ``sctools_tpu.guard.watchdog``. A hung leg (a decoder
thread wedged on a dead filesystem, a copy stuck behind a dropped link, a
collective waiting on a peer that never arrives) would hold its scheduler
lease until the TTL and then die as an anonymous steal. The watchdog turns
a stall into a diagnosed, retryable failure: when a leg exceeds its
deadline the timer thread

1. dumps a flight record (``stall@<leg>:<site>``: the span ring, counters,
   the stalled thread's open spans, ring and writeback slots and the open
   guard retries, through the flight sections), and
2. raises :class:`~sctools_tpu_torch.guard.errors.Stall` (a ``Transient``)
   asynchronously into the stalled thread, so the guard's retry ladder
   absorbs it in place instead of the lease expiring.

Deadlines are off by default (0) and set per leg::

    SCTOOLS_TPU_GUARD_TIMEOUT_DECODE=30   # ring frame pull, seconds
    SCTOOLS_TPU_GUARD_TIMEOUT_UPLOAD=30   # ingest.upload staging
    SCTOOLS_TPU_GUARD_TIMEOUT_COMPUTE=120 # guarded batch dispatch
    SCTOOLS_TPU_GUARD_TIMEOUT_PULL=60     # ingest.pull wait and copy

Limitation (as in JAX, and it holds on CUDA): the asynchronous raise lands
between Python bytecodes, so a leg blocked inside one long C call (an
``event.synchronize()``, an NCCL or gloo wait) sees its Stall only when
that call returns. The flight record and the ``guard_stalls`` counter still
fire on time, and the injected ``stall`` fault sleeps in 0.05 s ticks so
that the chaos tests exercise the prompt path.

:func:`shielded` marks a body that a Stall must never interrupt: a build
of the kernel or of the native layer, a CUDA graph capture (a capture cut
off mid-way leaves the stream capturing and every later launch fails). A
deadline that expires inside it still counts and dumps on time; its raise
is held until the shielded body ends, and lands then.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Iterable, Iterator, Optional, TypeVar

from .. import obs
from ..analysis.witness import make_lock
from .errors import Stall

T = TypeVar("T")

ENV_PREFIX = "SCTOOLS_TPU_GUARD_TIMEOUT_"
LEGS = ("decode", "upload", "compute", "pull")

# this thread's open deadlines, innermost last: what shielded() marks
_open = threading.local()


def leg_timeout(leg: str) -> float:
    """Configured deadline in seconds for ``leg`` (0 = watchdog off).

    Garbage or negative values fall back to 0 (disabled), the same
    forgiving contract as ``SCTOOLS_TPU_PREFETCH_DEPTH``.
    """
    raw = os.environ.get(ENV_PREFIX + leg.upper(), "")
    if not raw:
        return 0.0
    try:
        value = float(raw)
    except ValueError:
        return 0.0
    return value if value > 0 else 0.0


def _async_raise(thread_ident: int) -> bool:
    """Raise :class:`Stall` in the thread ``thread_ident`` (CPython API)."""
    result = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(Stall)
    )
    if result > 1:
        # more than one thread state modified: revoke (CPython contract)
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(thread_ident), None)
        return False
    return result == 1


@contextlib.contextmanager
def shielded():
    """Run the body with no Stall landing inside it.

    A deadline of this thread that fires meanwhile counts and dumps its
    flight record on time; its raise waits for the shield to end and lands
    then (at the next bytecode), unless the deadline has stood down by that
    time.
    """
    states = list(getattr(_open, "deadlines", ()))
    for state in states:
        with state["lock"]:
            state["shield"] += 1
    try:
        yield
    finally:
        deliver = False
        for state in states:
            with state["lock"]:
                state["shield"] -= 1
                if not state["shield"] and state["held"] and state["armed"]:
                    state["held"] = False
                    state["fired"] = True
                    deliver = True
        if deliver:
            _async_raise(threading.get_ident())


@contextlib.contextmanager
def deadline(leg: str, site: str = "", seconds: Optional[float] = None):
    """Run the body under a stall deadline for ``leg`` (no-op when off).

    ``seconds=None`` reads the leg's env knob. The timer thread checks an
    armed flag under a lock before raising, and the exit path clears the
    flag under the same lock, so a deadline that expires while the body
    is already unwinding cannot raise into unrelated code.
    """
    if seconds is None:
        seconds = leg_timeout(leg)
    if not seconds or seconds <= 0:
        yield
        return
    target = threading.get_ident()
    # the deadline's state, shared with the timer thread and with a
    # shielded() body on this thread, under one lock
    lock = make_lock("guard.watchdog.deadline")
    state = {"lock": lock, "armed": True, "fired": False, "shield": 0, "held": False}

    def fire() -> None:
        with lock:
            if not state["armed"]:
                return
            obs.count("guard_stalls")
            obs.count(f"guard_stalls_{leg}")
            try:
                obs.flight_dump(reason=f"stall@{leg}:{site}")
            except Exception:  # noqa: BLE001 - the raise must still happen
                pass
            if state["shield"]:
                state["held"] = True  # lands when the shield ends
                return
            state["fired"] = True
            _async_raise(target)

    outer = getattr(_open, "deadlines", ())
    _open.deadlines = (*outer, state)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        # the timer may have decided to raise, with the asynchronous
        # delivery landing at a bytecode boundary of this thread, possibly
        # only now, after the body finished. The whole teardown runs
        # inside the absorbing try, so a pending Stall delivered at the
        # flag clear, the cancel, the fired check or the spin loop is
        # swallowed: a finished body is never retried as a stall. A Stall
        # already delivered inside the body is in flight, not pending, and
        # the unwinding exception continues untouched.
        try:
            _open.deadlines = outer
            with lock:
                state["armed"] = False
            timer.cancel()
            if state["fired"]:
                for _ in range(100):
                    pass
        except Stall:
            pass


def guarded_iter(iterable: Iterable[T], leg: str = "decode", site: str = "") -> Iterator[T]:
    """Yield from ``iterable`` with each pull under the leg's deadline.

    The ring's decode watchdog: it wraps the consumer side of the prefetch
    ring, so a producer that stops feeding the queue without dying (the one
    case the prefetch's dead-producer check cannot see) surfaces as a
    Stall at the pull instead of hanging the consumer.
    """
    iterator = iter(iterable)
    try:
        while True:
            # the same late-delivery belt as the guard's attempt loops: a
            # Stall landing after next() returned must not drop the item
            pulled = False
            exhausted = False
            item = None
            try:
                with deadline(leg, site=site):
                    try:
                        item = next(iterator)
                        pulled = True
                    except StopIteration:
                        exhausted = True
            except Stall:
                if not pulled and not exhausted:
                    raise
            if exhausted:
                return
            yield item
    finally:
        # abandonment must reach the source promptly (the prefetch ring's
        # close hook releases the native stream handle)
        close = getattr(iterator, "close", None)
        if close is not None:
            close()
