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
- a native failure mid-stream raises ``NativeDecodeError`` (the guard's, a
  ``PoisonData``) in the consumer, at the failed batch, naming the batch
  index and the record offset. There is no switch to the Python decoder
  mid-stream (port rule 4: the JAX package's guard downgrades the ring's
  ``ingest.native`` site; the port's guard has no rungs);
- the consumer pulls each frame under the ``decode`` leg's stall deadline
  (``guard.watchdog.guarded_iter``, ``SCTOOLS_TPU_GUARD_TIMEOUT_DECODE``),
  so a producer that stops feeding the queue without dying surfaces as a
  ``Stall``;
- a consumer that stops early, or raises, closes the ring: the producer
  closes its source (the native stream handle, or the fused sort's pipe and
  worker) and the thread is joined.

SAM inputs and custom tag keys take the Python decoder behind the same
queue; ``ring_frames(source=...)`` adds only the prefetch stage to frames
that are the source's own.

Observability, at JAX's sites: each decoded batch is a ``decode`` span on
the producer's thread (the terminating poll one with ``eof=1``), its wall
interval a ``pulse.note_decode`` that the consuming batch's heartbeat
adopts, and each arena batch counts ``ingest_arena_batches``. The span is
the decode's one timer (``obs.timed``, range ``scx.ring.decode``): its
seconds go to the ``stats`` dict's ``decode``, the terminating poll's to
no key. On the arena path, of those seconds the arena's fill and frame go
to ``decode.fill`` (range ``scx.ring.decode.fill``) and the native
stream's own clocks to ``decode.read``, ``decode.inflate`` and
``decode.parse`` (``NativeBatchStream.timers``, read once a batch). The
Python decoder and a ``source`` note their intervals through
``pulse.iter_decode`` instead. Every frame handed off adds its records to
the audit ledger's ``records.ingested`` (``audited=False`` keeps an inner
ring that feeds another one off it), and the arena ring's live slot state
is the ``ring_slots`` flight section: a crash or SIGTERM postmortem shows
which slot was filling and how far each slot rotated.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Iterator, Optional

from .. import obs
from ..analysis.witness import make_lock
from ..guard.errors import NativeDecodeError
from ..guard.watchdog import guarded_iter
from ..io import bgzf
from ..io.packed import DEFAULT_TAG_KEYS, ReadFrame, _python_frames
from ..obs import audit, pulse
from ..sched import faults
from ..utils.prefetch import prefetch_depth, prefetch_iterator
from .arena import ColumnArena, arena_capacity

# frames the consumer may hold: the current one and one look-ahead
_CONSUMER_SLOTS = 2

# live ring state for flight records: ring id -> {slot, batches, phase, ...},
# updated by the producer (dict stores under one lock) and read through the
# obs flight-section registry
_state_lock = make_lock("ingest.ring_state")
_ring_state: dict = {}
_ring_ids = itertools.count()

# death-path safe (obs.bounded_snapshot): the dump may run inside a signal
# handler that interrupted a _set_ring_state holder on this very thread (the
# head probe fills on the consumer's thread)
_ring_snapshot = obs.bounded_snapshot(
    _state_lock,
    lambda: [dict(v, ring=k) for k, v in sorted(_ring_state.items())],
    [],
)

obs.register_flight_section("ring_slots", _ring_snapshot)


def _set_ring_state(ring_id: int, **fields) -> None:
    with _state_lock:
        _ring_state.setdefault(ring_id, {}).update(fields)


def _drop_ring_state(ring_id: int) -> None:
    with _state_lock:
        _ring_state.pop(ring_id, None)


def ring_slots(depth: Optional[int] = None) -> int:
    """The arena slots for a decode-ahead ``depth`` (default: configured):
    ``depth`` queued, one being filled, ``_CONSUMER_SLOTS`` held."""
    if depth is None:
        depth = prefetch_depth()
    return depth + 1 + _CONSUMER_SLOTS


# the parts of the arena path's decode in ``stats``: the native stream's
# clocks (NativeBatchStream.timers), then the arena's fill and frame
DECODE_PARTS = ("decode.read", "decode.inflate", "decode.parse", "decode.fill")


def _new_stats(stats: Optional[Dict[str, float]]) -> Dict[str, float]:
    stats = {} if stats is None else stats
    stats.setdefault("decode", 0.0)
    stats.setdefault("batches", 0)
    return stats


def _timed_source(
    source: Iterable[ReadFrame], stats: Dict[str, float], audited: bool = True
) -> Iterator[ReadFrame]:
    """``source``'s frames, each ``next()`` timed once on the thread that
    runs it (``obs.timed`` into ``stats["decode"]``, range
    ``scx.ring.decode``, a ``decode`` span when obs is on; the terminating
    poll is the span's ``eof=1`` and in no key) with a pulse decode note
    when pulse is on and, when ``audited``, added to ``records.ingested``;
    closing this generator closes the source."""
    iterator = iter(pulse.iter_decode(source))
    try:
        while True:
            with obs.timed(stats, "decode", "ring", span="decode") as sp:
                frame = next(iterator, None)
                if frame is None:
                    sp.add(eof=1)
                    sp.leave_out()
                else:
                    sp.add(records=frame.n_records)
            if frame is None:
                return
            stats["batches"] += 1
            if audited:
                audit.add("records.ingested", frame.n_records)
            yield frame
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


def _produce_arena_frames(
    stream, arenas, batch_records: int, want_qname: bool, stats: Dict[str, float],
    audited: bool = True,
) -> Iterator[ReadFrame]:
    """Decode batch after batch, each into the next arena of the ring.

    Runs on the producer thread (the first batch on the consumer's, as the
    ring's head probe). A native failure raises NativeDecodeError with the
    batch index and the records yielded before it. Closes ``stream`` at the
    end, on a failure and when closed. The ring's slot state is kept for
    the ``ring_slots`` flight section while it runs.
    """
    n_slots = len(arenas)
    ring_id = next(_ring_ids)
    for index, arena in enumerate(arenas):
        arena.slot = index
    _set_ring_state(ring_id, slots=n_slots, batches=0, phase="starting")
    consumed = 0
    native_clocks: Dict[str, float] = {}  # the stream's clocks at the last batch

    def _slot_state():
        # how far each slot rotated, and whether a FRAME_DEBUG run died
        # inside a poisoned refill window
        return {
            "generations": [a.generation for a in arenas],
            "poisoned": [a.poisoned for a in arenas],
        }

    try:
        for k in itertools.count():
            arena = arenas[k % n_slots]
            _set_ring_state(
                ring_id, slot=k % n_slots, batches=k, phase="filling",
                record_offset=consumed, **_slot_state(),
            )
            decode_start = pulse.clock() if pulse.enabled() else 0.0
            with obs.timed(stats, "decode", "ring", span="decode", slot=k % n_slots) as sp:
                # the fault site inside the timed decode window, as in JAX: a
                # delay here is the decode leg's, and a postmortem taken in it
                # finds the ring filling
                faults.fire("ingest.decode", name=str(k))
                try:
                    n = stream.next(batch_records)
                    if n == 0:
                        # the terminating poll, not a batch: in no key of stats
                        sp.add(eof=1)
                        sp.leave_out()
                        _set_ring_state(ring_id, phase="eof")
                        return
                    clocks = stream.timers()
                    for name, value in clocks.items():
                        key = "decode." + name
                        stats[key] = stats.get(key, 0.0) + value - native_clocks.get(name, 0.0)
                    native_clocks = clocks
                    with obs.timed(stats, "decode.fill", "ring"):
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
                    _set_ring_state(ring_id, phase="failed")
                    raise NativeDecodeError(str(error), batch_index=k, record_offset=consumed) from error
                sp.add(records=n)
            stats["batches"] += 1
            # the records the ring hands off: the consumer's records.decoded
            # must match exactly (a dropped or duplicated frame is audit skew)
            if audited:
                audit.add("records.ingested", n)
            if pulse.enabled():
                # the heartbeat of the batch that consumes this frame adopts
                # the interval (pulse.Heartbeat.decode_from_ring)
                pulse.note_decode(decode_start, pulse.clock(), slot=k % n_slots)
            obs.count("ingest_arena_batches")
            _set_ring_state(ring_id, phase="queued", **_slot_state())
            consumed += n
            yield frame
    finally:
        stream.close()
        _drop_ring_state(ring_id)


def ring_frames(
    bam_path: Optional[str] = None,
    batch_records: int = 1 << 20,
    mode: Optional[str] = None,
    want_qname: bool = False,
    tag_keys: Optional[tuple] = None,
    source: Optional[Iterable[ReadFrame]] = None,
    depth: Optional[int] = None,
    slots: Optional[int] = None,
    audited: bool = True,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[ReadFrame]:
    """ReadFrames of ``bam_path`` (or of ``source``) through the ring.

    A BGZF input with the default tag keys decodes through the native arena
    path: frames view recycled slots (see the module docstring for how long
    they stay valid) and carry ``flags`` and ``ps`` in their extras. SAM
    text, ``mode="r"`` and custom ``tag_keys`` stream the Python decoder
    behind the same queue, which opens the file in ``mode`` (None sniffs).
    With ``source`` (an open frame iterable, e.g. the fused tag sort's
    merge), the ring adds only the prefetch stage. The queue's depth is
    ``depth`` (default ``prefetch_depth()``), and the ring has ``slots``
    arenas (default ``ring_slots(depth)``; fewer shorten how long a frame
    stays valid).

    ``stats`` (a dict) receives the producer's seconds of decoding
    (``decode``, timed on its thread; on the arena path with its parts,
    ``DECODE_PARTS``) and the frames it made (``batches``).
    Nothing is opened until the first ``next()``; a failed build of the
    native layer raises.

    ``audited=False`` keeps this ring's frames off the audit ledger's
    ``records.ingested``: pass it when the frames feed another ring, so
    the handoff to the consumer is counted once, at the outer ring.
    """
    if source is not None and bam_path is not None:
        raise ValueError("pass bam_path or source, not both")
    if source is None and bam_path is None:
        raise ValueError("ring_frames needs a bam_path or a source")
    if batch_records < 1:
        raise ValueError(f"batch_records must be >= 1, got {batch_records}")
    if depth is None:
        depth = prefetch_depth()
    stats = _new_stats(stats)
    if source is not None:
        return guarded_iter(prefetch_iterator(_timed_source(source, stats, audited), depth), leg="decode")
    keys = tuple(tag_keys) if tag_keys is not None else DEFAULT_TAG_KEYS
    if slots is None:
        slots = ring_slots(depth)
    return guarded_iter(_ring(bam_path, batch_records, mode, want_qname, keys, depth, slots, stats, audited),
                        leg="decode")


def _ring(bam_path, batch_records, mode, want_qname, keys, depth, slots, stats, audited) -> Iterator[ReadFrame]:
    def python_frames():
        return _timed_source(_python_frames(bam_path, batch_records, keys, mode), stats, audited)

    if keys != DEFAULT_TAG_KEYS or mode == "r" or not bgzf.is_gzip(bam_path):
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
        arenas = [ColumnArena(arena_capacity(batch_records)) for _ in range(slots)]
        produced = _produce_arena_frames(stream, arenas, batch_records, want_qname, stats, audited)
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
