"""The ingest ring: decode ahead on a thread into recycled column arenas.

The port's copy of ``sctools_tpu.ingest.ring``. A producer thread (the
bounded queue of ``utils.prefetch.prefetch_iterator``) decodes batch k+1
into a ring slot's arena through the native stream while the consumer packs
and uploads batch k and the device computes on batch k-1. Backpressure is the
queue's bound: a consumer that stalls stops the producer after ``depth``
batches, so host memory stays at ``slots`` arenas for any file size. The
producer only decodes and fills numpy arenas; every upload stays on the
consumer's thread (``ingest.upload``).

Slot accounting (why ``slots = depth + 3``): at any time up to ``depth``
filled arenas wait in the queue, one is being filled, and the consumer may
hold two frames (the current one and one look-ahead). A frame of the ring is
therefore valid only until the consumer has pulled ``slots - depth - 1``
more frames; anything kept longer must be copied (``io.packed.copy_frame``).
The metrics gatherer and the count hold at most two ring frames and read
nothing of an older one later (``metrics.gatherer``, ``count``).

Failure contract:

- a native failure at the head of the file (bad magic, a truncated header)
  falls back to the Python decoder before any batch is yielded, as
  ``io.packed.iter_frames_from_bam`` does;
- a native failure mid-stream raises ``NativeDecodeError`` in the consumer,
  at the failed batch, naming the batch index and the record offset. There
  is no switch to the Python decoder mid-stream (the JAX package's guard
  ladder is not ported);
- a consumer that stops early, or raises, closes the ring: the producer
  closes its source (the native stream handle, or the fused sort's pipe and
  worker) and the thread is joined.

SAM inputs and custom tag keys take the Python decoder behind the same
queue; ``ring_frames(source=...)`` adds only the prefetch stage to frames
that are the source's own.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Iterable, Iterator, Optional

from ..io import bgzf
from ..io.packed import DEFAULT_TAG_KEYS, ReadFrame, _python_frames
from ..utils.prefetch import prefetch_depth, prefetch_iterator
from .arena import ColumnArena, arena_capacity

# frames the consumer may hold: the current one and one look-ahead
_CONSUMER_SLOTS = 2


class NativeDecodeError(RuntimeError):
    """The native decoder failed mid-stream; names where."""

    def __init__(self, message: str, batch_index: int, record_offset: int):
        super().__init__(f"{message} (batch_index={batch_index}, record_offset={record_offset})")
        self.batch_index = batch_index
        self.record_offset = record_offset


def ring_slots(depth: Optional[int] = None) -> int:
    """The arena slots for a decode-ahead ``depth`` (default: configured):
    ``depth`` queued, one being filled, ``_CONSUMER_SLOTS`` held."""
    if depth is None:
        depth = prefetch_depth()
    return depth + 1 + _CONSUMER_SLOTS


def _new_stats(stats: Optional[Dict[str, float]]) -> Dict[str, float]:
    stats = {} if stats is None else stats
    stats.setdefault("decode", 0.0)
    stats.setdefault("batches", 0)
    return stats


def _timed_source(source: Iterable[ReadFrame], stats: Dict[str, float]) -> Iterator[ReadFrame]:
    """``source``'s frames, each ``next()`` timed on the thread that runs
    it; closing this generator closes the source."""
    iterator = iter(source)
    try:
        while True:
            start = time.perf_counter()
            frame = next(iterator, None)
            if frame is None:
                return
            stats["decode"] += time.perf_counter() - start
            stats["batches"] += 1
            yield frame
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


def _produce_arena_frames(
    stream, arenas, batch_records: int, want_qname: bool, stats: Dict[str, float]
) -> Iterator[ReadFrame]:
    """Decode batch after batch, each into the next arena of the ring.

    Runs on the producer thread (the first batch on the consumer's, as the
    ring's head probe). A native failure raises NativeDecodeError with the
    batch index and the records yielded before it. Closes ``stream`` at the
    end, on a failure and when closed.
    """
    n_slots = len(arenas)
    for index, arena in enumerate(arenas):
        arena.slot = index
    consumed = 0
    try:
        for k in itertools.count():
            arena = arenas[k % n_slots]
            start = time.perf_counter()
            try:
                n = stream.next(batch_records)
                if n == 0:
                    return
                arena.fill(stream)
                frame = arena.frame(
                    n,
                    cell_names=stream.vocab("cell"),
                    umi_names=stream.vocab("umi"),
                    gene_names=stream.vocab("gene"),
                    qname_names=stream.vocab("qname") if want_qname else None,
                    batch_index=k,
                )
            except RuntimeError as error:
                raise NativeDecodeError(str(error), batch_index=k, record_offset=consumed) from error
            stats["decode"] += time.perf_counter() - start
            stats["batches"] += 1
            consumed += n
            yield frame
    finally:
        stream.close()


def ring_frames(
    bam_path: Optional[str] = None,
    batch_records: int = 1 << 20,
    want_qname: bool = False,
    tag_keys: Optional[tuple] = None,
    source: Optional[Iterable[ReadFrame]] = None,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[ReadFrame]:
    """ReadFrames of ``bam_path`` (or of ``source``) through the ring.

    A BGZF input with the default tag keys decodes through the native arena
    path: frames view recycled slots (see the module docstring for how long
    they stay valid) and carry ``flags`` and ``ps`` in their extras. SAM
    text and custom ``tag_keys`` stream the Python decoder behind the same
    queue. With ``source`` (an open frame iterable, e.g. the fused tag
    sort's merge), the ring adds only the prefetch stage. The queue's depth
    is ``prefetch_depth()``, and the ring has ``ring_slots()`` arenas.

    ``stats`` (a dict) receives the producer's seconds of decoding
    (``decode``, timed on its thread) and the frames it made (``batches``).
    Nothing is opened until the first ``next()``; a failed build of the
    native layer raises.
    """
    if source is not None and bam_path is not None:
        raise ValueError("pass bam_path or source, not both")
    if source is None and bam_path is None:
        raise ValueError("ring_frames needs a bam_path or a source")
    if batch_records < 1:
        raise ValueError(f"batch_records must be >= 1, got {batch_records}")
    depth = prefetch_depth()
    stats = _new_stats(stats)
    if source is not None:
        return prefetch_iterator(_timed_source(source, stats), depth)
    keys = tuple(tag_keys) if tag_keys is not None else DEFAULT_TAG_KEYS
    return _ring(bam_path, batch_records, want_qname, keys, depth, stats)


def _ring(bam_path, batch_records, want_qname, keys, depth, stats) -> Iterator[ReadFrame]:
    def python_frames():
        return _timed_source(_python_frames(bam_path, batch_records, keys), stats)

    if keys != DEFAULT_TAG_KEYS or not bgzf.is_gzip(bam_path):
        yield from prefetch_iterator(python_frames(), depth)
        return
    from .. import native

    native.library()  # a failed build or load raises here, never caught below
    try:
        stream = native.NativeBatchStream(bam_path, want_qname=want_qname)
    except RuntimeError:
        stream = None
    first = None
    if stream is not None:
        arenas = [ColumnArena(arena_capacity(batch_records)) for _ in range(ring_slots(depth))]
        produced = _produce_arena_frames(stream, arenas, batch_records, want_qname, stats)
        # the head probe, on this thread: a native failure before the first
        # batch (a malformed BGZF container, gzip that is not BGZF) decodes
        # the file with the Python reader instead, which gives its records
        # or its own exception
        try:
            first = next(produced, None)
        except RuntimeError:
            produced.close()
            stream = None
    if stream is None:
        yield from prefetch_iterator(python_frames(), depth)
        return
    if first is None:
        return

    def chained():
        # a generator, so that the producer's close on abandonment reaches
        # ``produced`` and releases the stream handle at once
        try:
            yield first
            yield from produced
        finally:
            produced.close()

    yield from prefetch_iterator(chained(), depth)
