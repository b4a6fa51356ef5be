"""Background-thread iterator prefetching.

The port's copy of ``sctools_tpu.utils.prefetch`` without its counters and
its steering override. While the consumer works on item k, one producer
thread makes item k+1 (the native decoder releases the GIL inside its
ctypes calls), at most ``depth`` items ahead through a bounded queue.

Failure contract:

- an exception in the producer is raised in the consumer at the item where
  it happened, and cannot be lost or hang the consumer, also when the queue
  is full; a producer thread that dies without handing over a result raises
  RuntimeError instead of leaving the consumer waiting;
- abandoning the iterator early (break, close, garbage collection) stops the
  producer promptly: the consumer drains the queue to free a producer
  blocked in ``put``, the producer closes the source iterable (releasing,
  for example, a native stream handle), and the thread is joined with a
  bounded wait, so a source blocked in I/O cannot hang the close.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()

# decode-ahead depth: items the producer may run ahead of the consumer.
# SCTOOLS_TPU_PREFETCH_DEPTH sets it for every bounded queue of the port (this
# iterator and the ingest ring, whose slot count follows from it). The window
# is 1..64: 0 would serialize producer and consumer, and past 64 the queue is
# no longer backpressure. Values outside it, or not integers, fall back to
# the default.
DEFAULT_PREFETCH_DEPTH = 2
_DEPTH_ENV = "SCTOOLS_TPU_PREFETCH_DEPTH"
MAX_PREFETCH_DEPTH = 64

# the consumer's poll period: bounds how late a producer death without a
# sentinel is noticed; items arriving normally are handed over at once
_GET_POLL_S = 0.5
# the bounded wait for the producer after abandonment; past it the source is
# taken to be stuck in I/O and the daemon thread is left behind
_ABANDON_JOIN_S = 10.0


def prefetch_depth() -> int:
    """The configured decode-ahead depth (SCTOOLS_TPU_PREFETCH_DEPTH, default 2)."""
    env = os.environ.get(_DEPTH_ENV)
    if env:
        try:
            value = int(env)
        except ValueError:
            return DEFAULT_PREFETCH_DEPTH
        if 1 <= value <= MAX_PREFETCH_DEPTH:
            return value
    return DEFAULT_PREFETCH_DEPTH


def prefetch_iterator(iterable: Iterable[T], depth: Optional[int] = None) -> Iterator[T]:
    """Yield from ``iterable``, made up to ``depth`` items ahead on a thread.

    ``depth=None`` reads ``prefetch_depth()``. The thread starts at the
    first ``next()``.
    """
    if depth is None:
        depth = prefetch_depth()
    items: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_until_stopped(item) -> bool:
        while not stop.is_set():
            try:
                items.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            try:
                for item in iterable:
                    if not put_until_stopped(item):
                        return
            except BaseException as error:  # raised again on the consumer's side
                put_until_stopped((_SENTINEL, error))
            else:
                put_until_stopped((_SENTINEL, None))
        finally:
            if stop.is_set():
                close = getattr(iterable, "close", None)
                if close is not None:
                    close()

    thread = threading.Thread(target=produce, name="sctools-prefetch", daemon=True)
    thread.start()

    def get_item():
        """The next queue item; never hangs on a dead producer."""
        while True:
            try:
                return items.get(timeout=_GET_POLL_S)
            except queue.Empty:
                if not thread.is_alive():
                    # one last look: the producer may have queued its final
                    # item between the timeout and the liveness check
                    try:
                        return items.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "prefetch producer thread died without delivering a result"
                        ) from None

    try:
        while True:
            item = get_item()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        # free a producer blocked in put() by draining, then join with a
        # bounded wait: a source stuck in I/O must not hang the close
        deadline = time.perf_counter() + _ABANDON_JOIN_S
        while thread.is_alive() and time.perf_counter() < deadline:
            try:
                items.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
