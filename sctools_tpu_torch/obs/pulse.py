"""scx-pulse for the port: per-batch heartbeats in an mmap'd ring.

The port's copy of ``sctools_tpu.obs.pulse``, with the same variables,
file names, binary layout and stage vocabulary, so that either package
parses the other's rings. The plane has four parts:

1. **Per-batch heartbeat records.** Each gatherer/count/sort dispatch
   appends ONE fixed-width 144-byte record (:data:`_RECORD`) into a
   preallocated struct ring — wall intervals for the four pipeline legs
   (decode / h2d / compute / d2h, on the worker's monotonic clock),
   real vs padded rows, entities produced, bytes each direction, the
   decode-ring slot and writeback phase, the owning task, and a
   retrace flag. The ring is an mmap'd file (``pulse.<worker>.ring``
   beside the trace capture) a reader can scrape WHILE the worker runs:
   each record carries its sequence number at both ends, so a torn
   (mid-write) record is detectable and skippable, and wraparound is
   just sequence arithmetic. Off means OFF: with :data:`ENV_FLAG` unset
   :func:`heartbeat` hands out a cached no-op singleton after one
   module-global bool check.

2. **Sliding-window aggregation.** :func:`fold_records` turns raw
   heartbeats into windowed rates (cells/sec, rows/sec, bytes/sec per
   direction, occupancy) and per-leg pow2-bucketed latency histograms
   (:class:`Pow2Histogram` — mergeable across workers: merge is
   associative and commutative by construction).

3. **Pull exporters.** ``python -m sctools_tpu_torch.obs pulse
   <run_dir>`` is the live TUI (per-worker lanes, ``--watch``);
   :mod:`.serve` adds an opt-in localhost HTTP endpoint
   (``SCTOOLS_TPU_PULSE_HTTP=<port>``) serving ``obs.render_metrics()``
   plus the pulse gauges in Prometheus exposition format, and an atomic
   textfile export (``pulse.<worker>.prom``) for scrape-less setups.
   ``sched status`` (and ``--watch``) print a one-line pulse summary
   when rings sit in the run dir.

4. **Bubble attribution.** :func:`attribute_bubbles` computes, from the
   interval overlap of the four legs, the pipeline **bubble fraction**
   — the share of the heartbeat window where the device leg (compute +
   d2h drain) is idle while decode/transfer runs uncovered — and names
   the **limiting stage** (the leg with the most exposed wall: time
   only it was running).

On CUDA the legs are host walls read with ``time.perf_counter``:
"compute" is the dispatch wall (the kernels are queued, not waited for),
and the device's work mostly lands in the "d2h" leg, the wait on the
batch's pull. No leg synchronizes the device.

The retrace flag reads :func:`.xprof.retrace_seq`: the port's retraces
are second CUDA graph captures of one signature (``serve.graphs``), and
each one flags exactly one heartbeat. Activation registers the ``pulse``
flight section: a dying worker's flight record names its ring and carries
its last heartbeats.

Enabling: ``SCTOOLS_TPU_PULSE=1`` writes the ring beside the
``SCTOOLS_TPU_TRACE`` capture (memory-only when no trace dir is set);
``SCTOOLS_TPU_PULSE=<dir>`` writes it under ``<dir>``.
``SCTOOLS_TPU_PULSE_CAPACITY`` sizes the ring (records, default 4096).

Pure stdlib (no torch/numpy at module load), like the rest of obs.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..analysis.witness import make_lock

__all__ = [
    "ENV_FLAG",
    "ENV_CAPACITY",
    "LEGS",
    "NOOP",
    "Heartbeat",
    "Pow2Histogram",
    "attribute_bubbles",
    "clock",
    "enabled",
    "fleet_pulse",
    "fold_records",
    "heartbeat",
    "iter_decode",
    "lane_bar",
    "live_records",
    "load_ring",
    "load_rings",
    "memory_records",
    "memory_session",
    "note_decode",
    "parse_ring_bytes",
    "render_pulse_metrics",
    "ring_now",
    "ring_path",
    "select_window",
    "worker_row",
]

ENV_FLAG = "SCTOOLS_TPU_PULSE"
ENV_CAPACITY = "SCTOOLS_TPU_PULSE_CAPACITY"

# the four pipeline legs a heartbeat carries wall intervals for, in
# record order. "compute" is the host-side dispatch wall (trace +
# enqueue; on sync backends the execution itself) and "d2h" the blocking
# drain of the staged writeback — together they are the DEVICE leg of
# bubble attribution; decode/h2d are the feed legs.
LEGS = ("decode", "h2d", "compute", "d2h")

# stage ids are fixed vocabulary (the record is fixed-width binary; the
# header meta carries this table so old readers stay compatible)
STAGES = {
    "gatherer.cell": 1,
    "gatherer.gene": 2,
    "gatherer.cell.sharded": 3,
    "gatherer.gene.sharded": 4,
    "count": 5,
    "count.sharded": 6,
    "sort": 7,
    "bench.pulse": 8,
}
_STAGE_NAMES = {v: k for k, v in STAGES.items()}

# writeback phases as one byte (JAX's ingest.wire vocabulary; the port's
# gatherer stamps "staged" once a batch's pull is queued and "draining"
# while it waits on it)
WB_PHASES = {"idle": 0, "staged": 1, "copying": 2, "draining": 3}
_WB_NAMES = {v: k for k, v in WB_PHASES.items()}

_FLAG_RETRACE = 1

# One heartbeat record, little-endian, 144 bytes:
#   seq      u64   1-based write sequence (0 = slot never written)
#   ts       f64   emit time, worker-monotonic seconds (perf_counter - T0)
#   batch    u32   per-stage batch counter
#   stage    u8    STAGES id (0 = unknown)
#   ring_slot u8   decode-ring arena slot (255 = none)
#   wb_phase u8    WB_PHASES id
#   flags    u8    bit 0: a steady-state RETRACE landed during this batch
#                  (a compile for an already-seen signature — warmup
#                  compiles do not set it)
#   real     u32   real rows dispatched
#   padded   u32   padded rows dispatched
#   bytes_h2d u64  bytes staged host->device for this batch
#   bytes_d2h u64  bytes drained device->host for this batch
#   legs     8*f64 (start, end) per leg in LEGS order (0,0 = leg unset)
#   task     16s   first 16 bytes of the owning task id ('' = none)
#   entities u32   result rows (cells/genes/molecules) this batch produced
#   _pad     u32
#   seq_echo u64   == seq; a mismatch marks a torn (mid-write) record
_RECORD = struct.Struct("<QdIBBBBIIQQ8d16sIIQ")
RECORD_SIZE = _RECORD.size  # 144

_MAGIC = b"SCXPULSE"
VERSION = 1
HEADER_SIZE = 4096
DEFAULT_CAPACITY = 4096

_T0 = time.perf_counter()

_lock = make_lock("obs.pulse")
_enabled = False
_ring_dir: Optional[str] = None
_writer = None  # _RingWriter, created lazily on first emit
_memory: Optional[List[dict]] = None  # memory-mode record list
# recent heartbeats kept in process for the live HTTP exporter and the
# textfile export (bounded; the ring file is the full record)
_recent: "deque[dict]" = deque(maxlen=256)
# decode intervals noted by the prefetch thread, drained by the consumer
# heartbeat of the batch that used them (FIFO; a dispatch that merged
# several decoded frames drains them all into one covering interval)
_decode_notes: "deque[Tuple[float, float, int]]" = deque(maxlen=64)
_stage_batches: Dict[str, int] = {}
_textfile_last = [0.0]
_TEXTFILE_PERIOD_S = 5.0
# highest retrace-counter value any emitted heartbeat has claimed: with
# several batches in flight, one retrace would otherwise flag every
# concurrently-open heartbeat; each retrace is claimed by exactly one
# heartbeat (the first to emit)
_retrace_claimed = 0


def clock() -> float:
    """Seconds on this process's pulse clock (monotonic, since import)."""
    return time.perf_counter() - _T0


def enabled() -> bool:
    """Whether heartbeat recording is on (latched at activation)."""
    return _enabled


def capacity() -> int:
    """Ring capacity in records (``SCTOOLS_TPU_PULSE_CAPACITY``)."""
    raw = os.environ.get(ENV_CAPACITY, "").strip()
    if raw:
        try:
            value = int(raw)
            if 16 <= value <= (1 << 20):
                return value
        except ValueError:
            pass
        sys.stderr.write(
            f"sctools-tpu pulse: ignoring invalid {ENV_CAPACITY}={raw!r} "
            f"(want 16..{1 << 20}); using {DEFAULT_CAPACITY}\n"
        )
    return DEFAULT_CAPACITY


def ring_path() -> Optional[str]:
    """Where this process's ring lands (None = memory-only)."""
    if _ring_dir is None:
        return None
    from . import configured_worker_name

    return os.path.join(_ring_dir, f"pulse.{configured_worker_name()}.ring")


# --------------------------------------------------------------- writer


class _RingWriter:
    """The preallocated mmap'd struct ring one worker appends into."""

    def __init__(self, path: str, n_slots: int):
        self.path = path
        self.capacity = n_slots
        self.seq = 0
        meta = {
            "worker": os.path.basename(path)[len("pulse."): -len(".ring")],
            "pid": os.getpid(),
            # cross-process anchor pair, the obs sink's clock meta shape
            "wall": round(time.time(), 6),  # scx-lint: disable=SCX109 -- cross-process anchor, not a duration
            "mono": round(clock(), 6),
            "stages": STAGES,
            "wb_phases": WB_PHASES,
            "legs": list(LEGS),
        }
        header = bytearray(HEADER_SIZE)
        header[:8] = _MAGIC
        struct.pack_into("<III", header, 8, VERSION, RECORD_SIZE, n_slots)
        blob = json.dumps(meta, separators=(",", ":")).encode()
        header[20: 20 + len(blob)] = blob
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(bytes(header))
            f.write(b"\0" * (n_slots * RECORD_SIZE))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._file = open(path, "r+b")
        self._mm = mmap.mmap(self._file.fileno(), 0)

    def append(self, packed_tail: tuple) -> None:
        """Write one record (fields AFTER seq; seq/seq_echo added here)."""
        self.seq += 1
        offset = (
            HEADER_SIZE + ((self.seq - 1) % self.capacity) * RECORD_SIZE
        )
        self._mm[offset: offset + RECORD_SIZE] = _RECORD.pack(
            self.seq, *packed_tail, self.seq
        )

    def close(self) -> None:
        try:
            self._mm.flush()
            self._mm.close()
            self._file.close()
        except (OSError, ValueError):
            pass


def _ensure_writer():
    """The lazy ring file: created on first emit, when the scheduler has
    already stamped the worker identity into the obs context (the ring
    filename carries it)."""
    global _writer
    if _writer is not None or _ring_dir is None:
        return _writer
    with _lock:
        if _writer is None:
            path = ring_path()
            try:
                os.makedirs(_ring_dir, exist_ok=True)
                _writer = _RingWriter(path, capacity())
            except OSError as error:
                sys.stderr.write(
                    f"sctools-tpu pulse: cannot create ring {path}: "
                    f"{error}; heartbeats stay in memory\n"
                )
                _writer = _MemoryOnly()
    return _writer


class _MemoryOnly:
    """Writer stub when the ring file cannot be created: the in-process
    ``_recent`` deque (which every emit feeds anyway) is the only sink."""

    path = None
    capacity = 0
    seq = 0

    def append(self, packed_tail: tuple) -> None:
        self.seq += 1

    def close(self) -> None:
        return None


# ------------------------------------------------------------ heartbeats


def note_decode(start: float, end: float, slot: int = -1) -> None:
    """Record one decoded batch's wall interval (prefetch-thread side)."""
    if not _enabled:
        return
    with _lock:
        _decode_notes.append((start, end, slot))


def iter_decode(iterable: Iterable) -> Iterator:
    """Yield from ``iterable``, noting each item's production interval.

    The Python-decoder fallback path's analog of the native ring's
    explicit :func:`note_decode` calls. Disabled -> yields straight
    through. Abandonment chains ``close()`` to the source (the
    prefetch_iterator contract).
    """
    if not _enabled:
        yield from iterable
        return
    iterator = iter(iterable)
    try:
        while True:
            start = clock()
            try:
                item = next(iterator)
            except StopIteration:
                return
            note_decode(start, clock())
            yield item
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


class Heartbeat:
    """One in-flight batch's telemetry, emitted as one ring record."""

    __slots__ = ("_stage", "_legs", "_fields", "_retraces0")

    def __init__(self, stage: str):
        self._stage = stage
        self._legs = {}
        self._retraces0 = _retrace_seq()
        self._fields = {
            "real_rows": 0, "padded_rows": 0, "entities": 0,
            "bytes_h2d": 0, "bytes_d2h": 0, "ring_slot": 255,
            "wb_phase": 0, "batch": None,
        }

    def begin(self, leg: str) -> None:
        self._legs[leg] = [clock(), 0.0]

    def end(self, leg: str) -> None:
        interval = self._legs.get(leg)
        if interval is not None:
            interval[1] = clock()

    def leg(self, name: str, start: float, end: float) -> None:
        self._legs[name] = [start, end]

    def decode_from_ring(self) -> None:
        """Adopt the decode interval(s) noted since the last heartbeat.

        A dispatch that concatenated several decoded frames (the entity
        carry) drains every queued note into one covering interval —
        the decode wall attributable to this batch.
        """
        with _lock:
            notes = list(_decode_notes)
            _decode_notes.clear()
        if not notes:
            return
        self._legs["decode"] = [
            min(n[0] for n in notes), max(n[1] for n in notes)
        ]
        self._fields["ring_slot"] = notes[-1][2] & 0xFF

    def add(self, **fields) -> "Heartbeat":
        for key, value in fields.items():
            if key in self._fields and value is not None:
                self._fields[key] = value
        return self

    def emit(self) -> None:
        """Finalize: one fixed-width record into the ring (and memory)."""
        fields = self._fields
        stage = self._stage
        task = ""
        from . import get_context

        context = get_context()
        raw_task = context.get("task_id")
        if isinstance(raw_task, str):
            task = raw_task[:16]
        with _lock:
            batch = fields["batch"]
            if batch is None:
                batch = _stage_batches.get(stage, 0)
                _stage_batches[stage] = batch + 1
        global _retrace_claimed
        with _lock:
            current = _retrace_seq()
            retrace = current > self._retraces0 and current > _retrace_claimed
            if retrace:
                _retrace_claimed = current
        intervals = []
        for name in LEGS:
            start, end = self._legs.get(name, (0.0, 0.0))
            if end < start:
                end = start
            intervals += [float(start), float(end)]
        record = {
            "ts": round(clock(), 6),
            "batch": int(batch),
            "stage": stage,
            "ring_slot": int(fields["ring_slot"]),
            "wb_phase": _WB_NAMES.get(int(fields["wb_phase"]), "idle"),
            "retrace": bool(retrace),
            "real_rows": int(fields["real_rows"]),
            "padded_rows": int(fields["padded_rows"]),
            "entities": int(fields["entities"]),
            "bytes_h2d": int(fields["bytes_h2d"]),
            "bytes_d2h": int(fields["bytes_d2h"]),
            "task_id": task,
            "legs": {
                name: (intervals[2 * i], intervals[2 * i + 1])
                for i, name in enumerate(LEGS)
            },
        }
        packed_tail = (
            record["ts"],
            record["batch"],
            STAGES.get(stage, 0),
            record["ring_slot"] & 0xFF,
            int(fields["wb_phase"]) & 0xFF,
            _FLAG_RETRACE if retrace else 0,
            record["real_rows"] & 0xFFFFFFFF,
            record["padded_rows"] & 0xFFFFFFFF,
            record["bytes_h2d"],
            record["bytes_d2h"],
            *intervals,
            task.encode("utf-8", "replace")[:16],
            record["entities"] & 0xFFFFFFFF,
            0,
        )
        writer = _ensure_writer()
        with _lock:
            if writer is not None:
                writer.append(packed_tail)
                record["seq"] = writer.seq
            _recent.append(record)
            if _memory is not None:
                _memory.append(record)
        _maybe_export_textfile()


class _NoopHeartbeat:
    """Cached do-nothing heartbeat handed out while pulse is off."""

    __slots__ = ()

    def begin(self, leg: str) -> None:
        return None

    def end(self, leg: str) -> None:
        return None

    def leg(self, name: str, start: float, end: float) -> None:
        return None

    def decode_from_ring(self) -> None:
        return None

    def add(self, **fields) -> "_NoopHeartbeat":
        return self

    def emit(self) -> None:
        return None


NOOP = _NoopHeartbeat()


def _retrace_seq() -> int:
    """The process-wide retrace counter (lockless read); 0 before
    ``xprof`` is imported, which keeps pulse importable on its own."""
    xprof = sys.modules.get(__package__ + ".xprof")
    if xprof is None:
        return 0
    return xprof.retrace_seq()


def heartbeat(stage: str):
    """A heartbeat for one batch at ``stage``.

    Off means OFF: with pulse disabled this returns the cached no-op
    singleton after ONE module-global bool check — the hot path (one
    call per dispatched batch) pays no allocation, no lock, no branch
    forest (pinned by tests).
    """
    if not _enabled:
        return NOOP
    return Heartbeat(stage)


def live_records() -> List[dict]:
    """Snapshot of this process's recent heartbeats (bounded)."""
    with _lock:
        return [dict(r) for r in _recent]


def memory_records() -> List[dict]:
    """The in-memory record list of the active memory session."""
    with _lock:
        return list(_memory) if _memory is not None else []


class memory_session:
    """Context: record heartbeats to an in-process list (tests, benches).

    Latches pulse ON for the block (no ring file unless one was already
    configured) and restores the previous state on exit — so a bench
    that measures the OFF-mode overhead after its instrumented run sees
    the env-driven state again.
    """

    def __enter__(self) -> List[dict]:
        global _enabled, _memory
        self._was_enabled = _enabled
        with _lock:
            _memory = []
            records = _memory
        _enabled = True
        return records

    def __exit__(self, exc_type, exc, tb) -> None:
        global _enabled, _memory
        _enabled = self._was_enabled
        with _lock:
            _memory = None


# --------------------------------------------------------------- parsing


def parse_ring_bytes(data: bytes) -> Tuple[dict, List[dict], int]:
    """Ring file bytes -> (meta, records sorted by seq, torn count).

    Tolerant by contract: a record whose leading and trailing sequence
    numbers disagree was torn mid-write (the writer died inside it, or
    the reader raced it) and is skipped, never fatal. Unwritten slots
    (seq 0) are skipped. Raises ``ValueError`` only for a file that is
    not a pulse ring at all.
    """
    if len(data) < HEADER_SIZE or data[:8] != _MAGIC:
        raise ValueError("not a pulse ring (bad magic)")
    version, record_size, n_slots = struct.unpack_from("<III", data, 8)
    if version != VERSION or record_size != RECORD_SIZE:
        raise ValueError(
            f"pulse ring version/layout mismatch: v{version} "
            f"record_size={record_size} (reader: v{VERSION}/{RECORD_SIZE})"
        )
    blob = data[20:HEADER_SIZE].split(b"\0", 1)[0]
    try:
        meta = json.loads(blob.decode("utf-8", "replace")) if blob else {}
    except ValueError:
        meta = {}
    stage_names = dict(_STAGE_NAMES)
    for name, sid in (meta.get("stages") or {}).items():
        stage_names[int(sid)] = name
    wb_names = dict(_WB_NAMES)
    for name, pid in (meta.get("wb_phases") or {}).items():
        wb_names[int(pid)] = name
    records: List[dict] = []
    torn = 0
    for index in range(n_slots):
        offset = HEADER_SIZE + index * RECORD_SIZE
        chunk = data[offset: offset + RECORD_SIZE]
        if len(chunk) < RECORD_SIZE:
            torn += 1
            break
        fields = _RECORD.unpack(chunk)
        seq, seq_echo = fields[0], fields[-1]
        if seq == 0 and seq_echo == 0:
            continue
        if seq != seq_echo:
            torn += 1
            continue
        (
            _, ts, batch, stage_id, ring_slot, wb_phase, flags,
            real_rows, padded_rows, bytes_h2d, bytes_d2h,
        ) = fields[:11]
        intervals = fields[11:19]
        task = fields[19].split(b"\0", 1)[0].decode("utf-8", "replace")
        entities = fields[20]
        records.append(
            {
                "seq": seq,
                "ts": ts,
                "batch": batch,
                "stage": stage_names.get(stage_id, f"stage{stage_id}"),
                "ring_slot": ring_slot,
                "wb_phase": wb_names.get(wb_phase, "idle"),
                "retrace": bool(flags & _FLAG_RETRACE),
                "real_rows": real_rows,
                "padded_rows": padded_rows,
                "entities": entities,
                "bytes_h2d": bytes_h2d,
                "bytes_d2h": bytes_d2h,
                "task_id": task,
                "legs": {
                    name: (intervals[2 * i], intervals[2 * i + 1])
                    for i, name in enumerate(LEGS)
                },
            }
        )
    records.sort(key=lambda r: r["seq"])
    return meta, records, torn


def load_ring(path: str) -> Optional[dict]:
    """One ring file -> ``{"path", "meta", "records", "torn"}`` or None."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        meta, records, torn = parse_ring_bytes(data)
    except (OSError, ValueError):
        return None
    worker = meta.get("worker")
    if not worker:
        base = os.path.basename(path)
        worker = base[len("pulse."): -len(".ring")] or "unknown"
    return {
        "path": path, "worker": str(worker), "meta": meta,
        "records": records, "torn": torn,
    }


def load_rings(run_dir: str) -> Dict[str, dict]:
    """Every parseable ``pulse.*.ring`` under ``run_dir`` (one dir deep),
    keyed by worker. Mirrors the fleet capture discovery walk."""
    import glob as globmod

    out: Dict[str, dict] = {}
    roots = [run_dir] + sorted(
        p
        for p in globmod.glob(os.path.join(run_dir, "*"))
        if os.path.isdir(p)
    )
    for root in roots:
        for path in sorted(globmod.glob(os.path.join(root, "pulse.*.ring"))):
            ring = load_ring(path)
            if ring is not None:
                out.setdefault(ring["worker"], ring)
    return out


# ----------------------------------------------------------- aggregation


class Pow2Histogram:
    """A pow2-bucketed latency histogram (microsecond buckets).

    Bucket ``b`` counts durations in ``[2**(b-1), 2**b)`` microseconds
    (bucket 0: sub-microsecond). Sparse dict storage; :meth:`merge` is
    plain per-bucket addition, so merging is associative and
    commutative by construction (property-tested) — per-worker
    histograms fold into fleet histograms in any order.
    """

    __slots__ = ("counts",)

    def __init__(self, counts: Optional[Dict[int, int]] = None):
        self.counts: Dict[int, int] = dict(counts or {})

    def add(self, seconds: float) -> None:
        us = max(int(seconds * 1e6), 0)
        self.counts[us.bit_length()] = self.counts.get(us.bit_length(), 0) + 1

    def merge(self, other: "Pow2Histogram") -> "Pow2Histogram":
        merged = dict(self.counts)
        for bucket, count in other.counts.items():
            merged[bucket] = merged.get(bucket, 0) + count
        return Pow2Histogram(merged)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def quantile_ms(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding quantile ``q``, in ms."""
        total = self.total
        if not total:
            return None
        rank = q * total
        seen = 0
        for bucket in sorted(self.counts):
            seen += self.counts[bucket]
            if seen >= rank:
                return (1 << bucket) / 1e3
        return (1 << max(self.counts)) / 1e3

    def to_json(self) -> Dict[str, int]:
        return {str(b): c for b, c in sorted(self.counts.items())}


def _leg_duration(record: dict, leg: str) -> float:
    start, end = record["legs"].get(leg, (0.0, 0.0))
    return max(0.0, end - start) if end > start else 0.0


def _window_bounds(
    records: List[dict], window_s: Optional[float], now: Optional[float]
) -> Tuple[float, float]:
    """(effective newest, trailing cut) — THE window definition, shared
    by rate folding, bubble windowing, and the TUI lane so the three can
    never select different record subsets."""
    newest = max(r["ts"] for r in records)
    if window_s and now is not None:
        newest = max(newest, now)
    cut = newest - window_s if window_s else min(r["ts"] for r in records)
    return newest, cut


def select_window(
    records: List[dict],
    window_s: Optional[float] = None,
    now: Optional[float] = None,
) -> List[dict]:
    """The heartbeats inside the trailing window (all when unwindowed)."""
    if not records or not window_s:
        return records
    _, cut = _window_bounds(records, window_s, now)
    return [r for r in records if r["ts"] >= cut]


def fold_records(
    records: List[dict],
    window_s: Optional[float] = None,
    now: Optional[float] = None,
) -> dict:
    """Sliding-window summary of one worker's heartbeats.

    ``window_s=None`` folds everything over the span the data covers.
    With a window, only heartbeats whose emit ``ts`` falls inside the
    trailing window survive, and ``now`` (reader time translated onto
    the WORKER's monotonic clock — :func:`fleet_pulse` derives it from
    the ring header's wall/mono anchor) anchors the window's trailing
    edge: a stalled worker's heartbeats age out and its rate FALLS to
    zero instead of freezing at the last healthy value. Without
    ``now``, the newest heartbeat anchors (an exited run's final rate).
    """
    out = {
        "heartbeats": 0,
        "window_s": 0.0,
        "cells_per_s": None,
        "rows_per_s": None,
        "occupancy": None,
        "h2d_Bps": None,
        "d2h_Bps": None,
        "retraces": 0,
        "hist": {},
        "latency_ms": {},
        "stages": [],
    }
    if not records:
        return out
    newest, cut = _window_bounds(records, window_s, now)
    selected = [r for r in records if r["ts"] >= cut]
    if not selected:
        return out
    oldest_start = min(
        min(
            (s for s, e in r["legs"].values() if e > s),
            default=r["ts"],
        )
        for r in selected
    )
    # rate denominator: whole-run folds span from the earliest leg start;
    # windowed folds use the trailing window, clamped DOWN to the span
    # the data actually covers (a 3-second run scraped with --window 30
    # must not report a 10x-diluted rate)
    if window_s:
        lower = max(cut, min(oldest_start, newest))
    else:
        lower = min(cut, oldest_start)
    span = max(newest - lower, 1e-9)
    hists = {leg: Pow2Histogram() for leg in LEGS}
    real = padded = entities = h2d = d2h = retraces = 0
    stages = set()
    for record in selected:
        real += record["real_rows"]
        padded += record["padded_rows"]
        entities += record["entities"]
        h2d += record["bytes_h2d"]
        d2h += record["bytes_d2h"]
        retraces += int(record["retrace"])
        stages.add(record["stage"])
        for leg in LEGS:
            duration = _leg_duration(record, leg)
            if duration > 0:
                hists[leg].add(duration)
    out.update(
        heartbeats=len(selected),
        window_s=round(span, 3),
        cells_per_s=round(entities / span, 2),
        rows_per_s=round(real / span, 1),
        occupancy=round(real / padded, 4) if padded else None,
        h2d_Bps=round(h2d / span, 1),
        d2h_Bps=round(d2h / span, 1),
        retraces=retraces,
        hist={leg: hists[leg].to_json() for leg in LEGS},
        latency_ms={
            leg: {
                "p50": hists[leg].quantile_ms(0.5),
                "p95": hists[leg].quantile_ms(0.95),
            }
            for leg in LEGS
            if hists[leg].total
        },
        stages=sorted(stages),
    )
    return out


# ----------------------------------------------------- bubble attribution


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted union of (start, end) intervals."""
    merged: List[List[float]] = []
    for start, end in sorted(i for i in intervals if i[1] > i[0]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _total(intervals: List[Tuple[float, float]]) -> float:
    return sum(end - start for start, end in intervals)


def _subtract(
    intervals: List[Tuple[float, float]],
    cover: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """``intervals`` minus ``cover`` (both pre-unioned, sorted)."""
    out: List[Tuple[float, float]] = []
    for start, end in intervals:
        cursor = start
        for c_start, c_end in cover:
            if c_end <= cursor:
                continue
            if c_start >= end:
                break
            if c_start > cursor:
                out.append((cursor, c_start))
            cursor = max(cursor, c_end)
            if cursor >= end:
                break
        if cursor < end:
            out.append((cursor, end))
    return out


def attribute_bubbles(records: List[dict]) -> dict:
    """Pipeline bubble fraction + limiting stage from interval overlap.

    The DEVICE leg is ``compute`` + ``d2h`` (dispatch wall plus the
    blocking writeback drain — when either runs, the device side of the
    pipeline is being fed or drained). The **bubble** is the wall time
    where a feed leg (``decode``/``h2d``) runs while the device leg is
    idle: feed work the pipeline failed to hide. ``bubble_fraction`` is
    that time over the whole heartbeat window.

    The **limiting stage** is the leg with the most EXPOSED wall — time
    only it was running (not overlapped by any other leg). A perfectly
    overlapped pipeline's limiting stage is the device leg that bounds
    it; a decode-bound run names ``decode``. This is what the next perf
    PR steers by: speed up (or overlap better) the named stage.
    """
    legs: Dict[str, List[Tuple[float, float]]] = {leg: [] for leg in LEGS}
    for record in records:
        for leg in LEGS:
            start, end = record["legs"].get(leg, (0.0, 0.0))
            if end > start:
                legs[leg].append((start, end))
    unions = {leg: _union(intervals) for leg, intervals in legs.items()}
    if not any(unions.values()):
        return {
            "window_s": 0.0,
            "bubble_fraction": None,
            "limiting_stage": None,
            "bubble_s": 0.0,
            "busy_s": {},
            "exposed_s": {},
        }
    window_start = min(u[0][0] for u in unions.values() if u)
    window_end = max(u[-1][1] for u in unions.values() if u)
    window = max(window_end - window_start, 1e-9)
    device = _union(unions["compute"] + unions["d2h"])
    feed = _union(unions["decode"] + unions["h2d"])
    bubble = _total(_subtract(feed, device))
    exposed = {}
    for leg in LEGS:
        others = _union(
            [i for other in LEGS if other != leg for i in unions[other]]
        )
        exposed[leg] = round(_total(_subtract(unions[leg], others)), 6)
    busy = {leg: round(_total(unions[leg]), 6) for leg in LEGS}
    limiting = max(LEGS, key=lambda leg: (exposed[leg], busy[leg]))
    return {
        "window_s": round(window, 6),
        "bubble_fraction": round(bubble / window, 4),
        "limiting_stage": limiting,
        "bubble_s": round(bubble, 6),
        "busy_s": busy,
        "exposed_s": exposed,
    }


def worker_row(
    records: List[dict],
    window_s: Optional[float] = None,
    now: Optional[float] = None,
) -> dict:
    """ONE worker's fold + bubble verdict as a flat row.

    The single assembly point every surface reads (fleet_pulse, the
    summarize --json sidecar, the fleet timeline, the live exporter) —
    so the row shape, the windowing, and the bubble semantics cannot
    drift between them. The window applies to BOTH halves: a `--watch`
    frame's bubble verdict is computed over the same trailing
    heartbeats as its rates, so a pipeline that re-serializes mid-run
    shows its live bubble, undiluted by hours of healthy history.
    """
    fold = fold_records(records, window_s=window_s, now=now)
    bubble = attribute_bubbles(select_window(records, window_s, now))
    return {
        **fold,
        "bubble_fraction": bubble["bubble_fraction"],
        "limiting_stage": bubble["limiting_stage"],
        "exposed_s": bubble["exposed_s"],
        "bubble_window_s": bubble["window_s"],
    }


def ring_now(ring: dict) -> Optional[float]:
    """Reader wall time translated onto the ring worker's mono clock.

    The header's wall/mono anchor pair exists for exactly this: a live
    scrape must know how STALE the newest heartbeat is, or a hung
    worker renders its last healthy rate forever.
    """
    meta = ring.get("meta") or {}
    wall = meta.get("wall")
    mono = meta.get("mono")
    if not isinstance(wall, (int, float)) or not isinstance(
        mono, (int, float)
    ):
        return None
    return (time.time() - wall) + mono  # scx-lint: disable=SCX109 -- cross-process anchor translation, not a duration


def mono_to_wall(ring: dict, t: float) -> Optional[float]:
    """Translate a ring-local monotonic timestamp onto the wall clock.

    The inverse companion of :func:`ring_now`: heartbeat leg intervals
    are recorded on the writing worker's monotonic clock, but journal
    events carry wall-clock timestamps — scx-slo stitches the two via
    the ring header's wall/mono anchor pair.  Returns None when the
    ring predates the anchor (older writer) — the trace then degrades
    to journal-only legs instead of guessing.
    """
    meta = ring.get("meta") or {}
    wall = meta.get("wall")
    mono = meta.get("mono")
    if not isinstance(wall, (int, float)) or not isinstance(
        mono, (int, float)
    ):
        return None
    return wall + (t - mono)


def fleet_pulse(
    run_dir: str,
    window_s: Optional[float] = None,
    rings: Optional[Dict[str, dict]] = None,
) -> dict:
    """Per-worker folds + bubble attribution, merged fleet-wide.

    The merge: fleet cells/sec is the sum of per-worker rates (workers
    run concurrently), the fleet bubble fraction is the window-weighted
    mean, and the fleet limiting stage is the argmax of summed exposed
    wall — one answer for "what do I fix next" across the whole run.
    ``rings`` skips the re-scan for callers that already loaded them.
    Windowed calls anchor each worker's window at READER time (via the
    ring's clock anchor), so a stalled worker's lane decays instead of
    freezing; whole-run calls (``window_s=None``) summarize the data as
    written — what exited-run consumers (the smoke, summaries) want.
    """
    if rings is None:
        rings = load_rings(run_dir)
    workers: Dict[str, dict] = {}
    exposed_total: Dict[str, float] = {leg: 0.0 for leg in LEGS}
    cells = rows = heartbeats = retraces = 0.0
    bubble_weighted = 0.0
    window_total = 0.0
    for worker, ring in sorted(rings.items()):
        row = worker_row(
            ring["records"],
            window_s=window_s,
            now=ring_now(ring) if window_s else None,
        )
        workers[worker] = {
            **row, "torn": ring["torn"], "path": ring["path"],
        }
        heartbeats += row["heartbeats"]
        retraces += row["retraces"]
        cells += row["cells_per_s"] or 0.0
        rows += row["rows_per_s"] or 0.0
        for leg, value in row["exposed_s"].items():
            exposed_total[leg] += value
        if row["bubble_fraction"] is not None:
            bubble_weighted += (
                row["bubble_fraction"] * row["bubble_window_s"]
            )
            window_total += row["bubble_window_s"]
    fleet = {
        "heartbeats": int(heartbeats),
        "retraces": int(retraces),
        "cells_per_s": round(cells, 2) if workers else None,
        "rows_per_s": round(rows, 1) if workers else None,
        "bubble_fraction": (
            round(bubble_weighted / window_total, 4) if window_total else None
        ),
        "limiting_stage": (
            max(LEGS, key=lambda leg: exposed_total[leg])
            if any(exposed_total.values())
            else None
        ),
        "exposed_s": {k: round(v, 6) for k, v in exposed_total.items()},
    }
    return {"run_dir": run_dir, "workers": workers, "fleet": fleet}


def lane_bar(records: List[dict], width: int = 48) -> str:
    """ASCII pipeline lane over one worker's own heartbeat window.

    The fleet timeline's gantt-cell idiom applied to the pulse legs:
    ``#`` device leg busy (compute/d2h), ``~`` feed running uncovered
    (the bubble — decode/h2d with the device idle), ``·`` idle.
    """
    legs: Dict[str, List[Tuple[float, float]]] = {leg: [] for leg in LEGS}
    for record in records:
        for leg in LEGS:
            start, end = record["legs"].get(leg, (0.0, 0.0))
            if end > start:
                legs[leg].append((start, end))
    unions = {leg: _union(v) for leg, v in legs.items()}
    if not any(unions.values()):
        return "·" * width
    start = min(u[0][0] for u in unions.values() if u)
    end = max(u[-1][1] for u in unions.values() if u)
    if end <= start:
        return "·" * width
    device = _union(unions["compute"] + unions["d2h"])
    bubble = _subtract(_union(unions["decode"] + unions["h2d"]), device)
    cells = [0] * width
    scale = width / (end - start)
    for weight, intervals in ((1, bubble), (2, device)):
        for lo, hi in intervals:
            for index in range(
                max(int((lo - start) * scale), 0),
                min(int((hi - start) * scale) + 1, width),
            ):
                cells[index] = max(cells[index], weight)
    return "".join("·~#"[c] for c in cells)


# ------------------------------------------------------------- exporters


def _sanitize_label(value: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in value)


def render_pulse_metrics(pulse_view: dict) -> str:
    """The pulse gauges in Prometheus text exposition format.

    ``pulse_view`` is a :func:`fleet_pulse`-shaped dict (or a
    single-worker equivalent). Series are labeled by worker; two
    distinct workers whose labels sanitize to the same string would
    silently merge into one series, so — the render_metrics collision
    discipline — that raises ``ValueError`` instead.
    """
    lines: List[str] = []
    claimed: Dict[str, str] = {}

    def claim(series: str, source: str) -> None:
        previous = claimed.setdefault(series, source)
        if previous != source:
            raise ValueError(
                f"pulse metric label collision after sanitizing: {previous} "
                f"and {source} both render as {series!r}"
            )

    def gauge(metric: str, worker: Optional[str], value) -> None:
        if value is None:
            return
        name = f"sctools_tpu_pulse_{metric}"
        if worker is None:
            claim(name, "(fleet)")
            lines.append(f"{name} {value}")
        else:
            label = _sanitize_label(worker)
            claim(f'{name}{{worker="{label}"}}', f"worker {worker!r}")
            lines.append(f'{name}{{worker="{label}"}} {value}')

    header_done = set()

    def typed(metric: str, kind: str) -> None:
        if metric not in header_done:
            header_done.add(metric)
            lines.append(f"# TYPE sctools_tpu_pulse_{metric} {kind}")

    for worker, row in sorted((pulse_view.get("workers") or {}).items()):
        for metric in (
            "heartbeats", "cells_per_s", "rows_per_s", "occupancy",
            "h2d_Bps", "d2h_Bps", "bubble_fraction",
        ):
            typed(metric, "gauge")
            gauge(metric, worker, row.get(metric))
    fleet = pulse_view.get("fleet") or {}
    for metric in ("cells_per_s", "bubble_fraction", "heartbeats"):
        typed(f"fleet_{metric}", "gauge")
        gauge(f"fleet_{metric}", None, fleet.get(metric))
    stage = fleet.get("limiting_stage")
    if stage:
        lines.append("# TYPE sctools_tpu_pulse_limiting_stage gauge")
        lines.append(
            f'sctools_tpu_pulse_limiting_stage{{stage="{_sanitize_label(stage)}"}} 1'
        )
    return "\n".join(lines) + "\n" if lines else ""


def live_pulse_view() -> dict:
    """A fleet_pulse-shaped view of THIS process's recent heartbeats
    (what the in-process HTTP exporter and textfile export serve)."""
    from . import configured_worker_name

    records = live_records()
    row = worker_row(records)
    worker = configured_worker_name()
    return {
        "run_dir": None,
        "workers": {worker: row} if records else {},
        "fleet": {
            "heartbeats": row["heartbeats"],
            "cells_per_s": row["cells_per_s"],
            "bubble_fraction": row["bubble_fraction"],
            "limiting_stage": row["limiting_stage"],
        },
    }


def textfile_path() -> Optional[str]:
    if _ring_dir is None:
        return None
    from . import configured_worker_name

    return os.path.join(_ring_dir, f"pulse.{configured_worker_name()}.prom")


def export_textfile(path: Optional[str] = None) -> Optional[str]:
    """Atomically write the exposition text (the scrape-less exporter)."""
    target = path if path is not None else textfile_path()
    if target is None:
        return None
    from . import render_metrics

    try:
        text = render_metrics() + render_pulse_metrics(live_pulse_view())
    except ValueError:
        return None
    if not text:
        return None
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, target)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return target


def _maybe_export_textfile() -> None:
    """Refresh the textfile export at most every few seconds (on emit)."""
    if _ring_dir is None:
        return
    now = time.perf_counter()
    if now - _textfile_last[0] < _TEXTFILE_PERIOD_S:
        return
    _textfile_last[0] = now
    export_textfile()


# ----------------------------------------------- env-driven activation


def _flight_section() -> dict:
    """Bounded pulse state for flight records: a SIGTERM'd worker's
    postmortem names its ring (still parseable on disk — torn final
    record at worst) and carries the last few heartbeats inline."""
    writer = _writer
    return {
        "path": getattr(writer, "path", None) or ring_path(),
        "seq": getattr(writer, "seq", 0),
        "capacity": getattr(writer, "capacity", 0),
        "recent": [dict(r) for r in list(_recent)[-8:]],
    }


def reset() -> None:
    """Clear in-process pulse state (tests). The ring file is untouched."""
    global _writer, _retrace_claimed
    with _lock:
        if _writer is not None:
            _writer.close()
            _writer = None
        _recent.clear()
        _decode_notes.clear()
        _stage_batches.clear()
        _retrace_claimed = 0


def _activate_from_env() -> None:
    global _enabled, _ring_dir
    raw = os.environ.get(ENV_FLAG, "").strip()
    if not raw or raw == "0":
        return
    from . import configured_trace_dir, register_flight_section

    if raw == "1":
        _ring_dir = configured_trace_dir()  # None -> memory-only
    else:
        _ring_dir = raw
    _enabled = True
    from . import bounded_snapshot

    register_flight_section(
        "pulse", bounded_snapshot(_lock, _flight_section, {})
    )
    import atexit

    def _at_exit() -> None:
        try:
            export_textfile()
        except Exception:  # noqa: BLE001 - exit hook must never raise
            pass
        writer = _writer
        if writer is not None:
            writer.close()

    atexit.register(_at_exit)
    from . import serve

    serve.start_from_env()


_activate_from_env()
