"""scx-trace for the port: spans, counters and the trace sink.

The port's copy of the time half of ``sctools_tpu.obs``, with the same
variables, file names, span and counter vocabulary and Prometheus names,
so that either package reads the other's captures. Nested, thread-safe
spans over the decode -> upload -> compute -> writeback stages of the
metrics and count commands (the ``native:*``, ``tagsort:*``, ``sched:*``,
``serve:*`` and ``distributed:*`` spans beside them), and Prometheus-style
counters and gauges.

Pure stdlib: no torch or numpy at module load, so the CLI reads captures
on a host with no card. Off by default with near-zero overhead:
``span()`` returns a cached no-op singleton after one module-global bool
check, so instrumentation is safe on serving paths.

Enabling:

- ``obs.enable()`` — in-process recording (ring buffer + counters).
- ``obs.enable(sink_path=...)`` — additionally append one JSON object per
  finished span to a JSON-lines file.
- ``SCTOOLS_TPU_TRACE=dir`` (env) — full capture: spans to
  ``dir/trace.jsonl`` (``trace.<worker>.jsonl`` under
  ``SCTOOLS_TPU_TRACE_WORKER``) and a counters snapshot to
  ``dir/metrics[.<worker>].prom`` at exit.
- ``SCTOOLS_TPU_OBS=1`` (env) — in-process recording only.

Reading a capture: ``python -m sctools_tpu_torch.obs summarize
trace.jsonl`` prints the per-stage time/records/bytes/throughput table.
The live half is :mod:`.pulse` (per-batch heartbeat rings, windowed rates,
the localhost exporter of :mod:`.serve`, pipeline bubble attribution),
the serve plane's per-job traces are :mod:`.slo`, and :mod:`.delta`
distills a run directory into a RunProfile and attributes the difference
between two of them.

The device side of the same capture is :mod:`.xprof` (per-site
occupancy, the transfer ledger, memory watermarks; dumped to
``xprof[.<worker>].json`` at exit), and :mod:`.fleet` merges every
worker's capture and the sched journal of a run directory into one
timeline.

A worker that dies mid-task leaves a flight record
(``flight.<worker>.jsonl``: the span ring, counters, the open span stack,
the sections subsystems register and the registry), written by
:func:`flight_dump` from an injected crash, the lock witness or the
SIGTERM handler of :func:`install_flight_recorder`; JAX's format, so
each package reads the other's. Where every module above accounts for
time, :mod:`.audit` accounts for records: a per-task conservation ledger
carried on the sched journal's commit events, read back by ``python -m
sctools_tpu_torch.obs audit <run_dir>`` and ``... explain``.

Not ported: ``install_jax_hooks`` and ``xla_trace`` observe JAX's
compiles and profiler, which the port has not (it has no jit).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

# the lock-witness factories (analysis.witness): raw
# threading primitives unless SCTOOLS_TPU_LOCK_DEBUG=1, in which case
# every named lock is an instrumented proxy recording acquisition order
# for validation against the static scx-race model (SCX401-404)
from ..analysis.witness import make_lock, make_rlock

__all__ = [
    "span",
    "iter_spans",
    "count",
    "gauge",
    "counters",
    "spans",
    "render_metrics",
    "enable",
    "disable",
    "enabled",
    "reset",
    "set_context",
    "get_context",
    "flight_dump",
    "flight_path",
    "register_flight_section",
    "bounded_snapshot",
    "install_flight_recorder",
    "configured_trace_dir",
    "configured_worker_name",
    "summarize_records",
    "render_summary",
]

# span records kept in process (oldest evicted); a full north-star run emits
# a few spans per batch, so 64k covers days of serving before eviction
RING_CAPACITY = 1 << 16

_T0 = time.perf_counter()

_enabled = False
_lock = make_rlock("obs.ring")
_ring: "deque[dict]" = deque(maxlen=RING_CAPACITY)
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
# per-span-name aggregates (count, total seconds) updated at span exit so
# render_metrics() needs no ring scan
_span_totals: Dict[str, List[float]] = {}
_sink_path: Optional[str] = None
_sink_file = None
_sink_lock = make_lock("obs.sink")
_tls = threading.local()
# process-level identity attrs (worker id, current task) stamped onto every
# span record so a merge of N workers' captures can attribute their spans
# without guessing. Copy-on-write: set_context() swaps in
# a fresh dict, so _record_span reads it without taking the lock.
_context: Dict[str, Any] = {}


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Span:
    """One recording span. Use via ``with obs.span("decode") as sp:``.

    ``sp.add(records=n, bytes=b)`` attaches/accumulates numeric attrs
    mid-span; ``sp.duration`` holds the elapsed seconds after exit.
    """

    __slots__ = ("name", "attrs", "duration", "_start", "_ts", "_depth")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.duration = 0.0
        self._start = 0.0
        self._ts = 0.0
        self._depth = 0

    def add(self, **attrs) -> "Span":
        for key, value in attrs.items():
            if key in self.attrs and isinstance(value, (int, float)):
                self.attrs[key] += value
            else:
                self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        stack = _stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._start = time.perf_counter()
        self._ts = self._start - _T0
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self._start
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        record = {
            "name": self.name,
            "ts": round(self._ts, 6),
            "dur": self.duration,
            "thread": threading.current_thread().name,
            "depth": self._depth,
        }
        if exc_type is not None:
            record["error"] = exc_type.__name__
        if self.attrs:
            record["attrs"] = self.attrs
        _record_span(record)


class _NoopSpan:
    """Cached do-nothing span handed out while observability is off."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    duration = 0.0

    def add(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """A context-managed span named ``name`` with optional numeric attrs.

    When observability is disabled this returns a cached no-op singleton:
    one global bool check, no allocation.
    """
    if not _enabled:
        return _NOOP
    return Span(name, attrs)


def iter_spans(
    name: str,
    iterable: Iterable,
    records: Optional[Callable[[Any], int]] = None,
    bytes_of: Optional[Callable[[Any], int]] = None,
) -> Iterator:
    """Yield from ``iterable``, timing the production of each item.

    Each ``next()`` gets its own span (so producer time is measured, not
    consumer time) carrying ``records``/``bytes`` attrs when the callables
    are given. Disabled -> yields straight through with zero wrapping.
    """
    if not _enabled:
        yield from iterable
        return
    iterator = iter(iterable)
    try:
        while True:
            with span(name) as current:
                try:
                    item = next(iterator)
                except StopIteration:
                    current.add(eof=1)
                    return
                if records is not None:
                    current.add(records=int(records(item)))
                if bytes_of is not None:
                    current.add(bytes=int(bytes_of(item)))
            yield item
    finally:
        # chain close() to the source: abandonment must release e.g. a
        # native stream handle deterministically (prefetch_iterator docs)
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


def set_context(**attrs: Any) -> None:
    """Attach identity attrs (``worker=``, ``task=``…) to every new span.

    Values merge into each span record at exit (existing record keys win);
    ``None`` removes a key. The scheduler sets ``worker`` once per process
    and ``task``/``task_id`` around each task body, which is what lets
    a run-level merge interleave scheduler journal events with pipeline spans
    on one run-level timeline. Process-global by design: a worker runs one
    task at a time, and spans recorded on helper threads (prefetch decode)
    must inherit the same task identity.
    """
    global _context
    fresh = dict(_context)
    for key, value in attrs.items():
        if value is None:
            fresh.pop(key, None)
        else:
            fresh[key] = value
    _context = fresh


def get_context() -> Dict[str, Any]:
    """Snapshot of the current identity attrs."""
    return dict(_context)


def _record_span(record: dict) -> None:
    context = _context
    if context:
        for key, value in context.items():
            record.setdefault(key, value)
    with _lock:
        _ring.append(record)
        total = _span_totals.setdefault(record["name"], [0.0, 0.0])
        total[0] += 1
        total[1] += record["dur"]
    sink = _sink_file
    if sink is not None:
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with _sink_lock:
            if _sink_file is not None:  # disable() may race the write
                _sink_file.write(line)
                _sink_file.flush()


# ----------------------------------------------------------- counters

def count(name: str, value: float = 1) -> None:
    """Increment counter ``name`` (monotonic; no-op while disabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value`` (last-write-wins; no-op disabled)."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value


def counters() -> Dict[str, float]:
    """Snapshot of the counter values."""
    with _lock:
        return dict(_counters)


def spans() -> List[dict]:
    """Snapshot of the in-process span ring (oldest first)."""
    with _lock:
        return list(_ring)


_PROM_PREFIX = "sctools_tpu_"


def _prom_name(name: str) -> str:
    out = "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )
    return _PROM_PREFIX + out


def render_metrics() -> str:
    """Counters + gauges + span aggregates in Prometheus text exposition.

    Counter samples get a ``_total`` suffix; per-span aggregates export as
    ``sctools_tpu_span_count_total{span="..."}`` and
    ``sctools_tpu_span_seconds_total{span="..."}``.

    Raises :class:`ValueError` when two distinct source names mangle to
    the same exposition metric (``a.b`` and ``a_b`` both become
    ``sctools_tpu_a_b_total``; a counter ``x`` and a counter ``x_total``
    do too): an aliased sample would silently merge two series, so the
    collision must fail loudly at render time instead.
    """
    with _lock:
        counter_items = sorted(_counters.items())
        gauge_items = sorted(_gauges.items())
        totals = sorted((k, v[0], v[1]) for k, v in _span_totals.items())
    sources: Dict[str, str] = {}

    def _claim(metric: str, source: str) -> None:
        previous = sources.setdefault(metric, source)
        if previous != source:
            raise ValueError(
                f"metric name collision after Prometheus mangling: "
                f"{previous} and {source} both render as {metric!r}"
            )

    lines: List[str] = []
    for name, value in counter_items:
        metric = _prom_name(name)
        if not metric.endswith("_total"):
            metric += "_total"
        _claim(metric, f"counter {name!r}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_prom_value(value)}")
    for name, value in gauge_items:
        metric = _prom_name(name)
        _claim(metric, f"gauge {name!r}")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_prom_value(value)}")
    if totals:
        _claim(f"{_PROM_PREFIX}span_count_total", "span aggregate export")
        _claim(f"{_PROM_PREFIX}span_seconds_total", "span aggregate export")
        lines.append(f"# TYPE {_PROM_PREFIX}span_count_total counter")
        for name, n, _ in totals:
            lines.append(
                f'{_PROM_PREFIX}span_count_total{{span="{name}"}} '
                f"{_prom_value(n)}"
            )
        lines.append(f"# TYPE {_PROM_PREFIX}span_seconds_total counter")
        for name, _, seconds in totals:
            lines.append(
                f'{_PROM_PREFIX}span_seconds_total{{span="{name}"}} '
                f"{seconds:.6f}"
            )
    return "\n".join(lines) + "\n" if lines else ""


def _prom_value(value: float) -> str:
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


# ------------------------------------------------------ enable/disable

def enabled() -> bool:
    return _enabled


def enable(sink_path: Optional[str] = None) -> None:
    """Turn recording on (idempotent); optionally attach a JSONL sink."""
    global _enabled, _sink_path, _sink_file
    with _lock:
        if sink_path is not None and sink_path != _sink_path:
            _close_sink()
            directory = os.path.dirname(os.path.abspath(sink_path))
            os.makedirs(directory, exist_ok=True)
            _sink_file = open(sink_path, "a", encoding="utf-8")
            _sink_path = sink_path
            # clock-sync anchor: maps this process's monotonic span
            # timestamps onto the shared wall clock, so a run-level merge
            # can place N workers' spans on one timeline even
            # when a worker journals no scheduler events to correlate with
            meta = {
                "meta": "clock",
                "wall": round(time.time(), 6),  # scx-lint: disable=SCX109 -- cross-process anchor, not a duration
                "mono": round(time.perf_counter() - _T0, 6),
            }
            _sink_file.write(json.dumps(meta, separators=(",", ":")) + "\n")
            _sink_file.flush()
        _enabled = True


def disable() -> None:
    """Stop recording and detach the sink (recorded data stays readable)."""
    global _enabled
    with _lock:
        _enabled = False
        _close_sink()


def _close_sink() -> None:
    global _sink_file, _sink_path
    with _sink_lock:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
        _sink_file = None
        _sink_path = None


def reset() -> None:
    """Clear the ring, counters, gauges, and span aggregates."""
    with _lock:
        _ring.clear()
        _counters.clear()
        _gauges.clear()
        _span_totals.clear()


# ------------------------------------------------------- capture names

def _sanitize_component(name: str) -> str:
    return "".join(
        c if c.isalnum() or c in "-_." else "_" for c in name
    ) or "unknown"


def configured_worker_name() -> str:
    """This process's worker name for capture filenames.

    Precedence: the ``worker`` context attr (the scheduler sets it to the
    journal worker id), then ``SCTOOLS_TPU_TRACE_WORKER``, then
    ``<hostname>-<pid>`` — always filesystem-safe.
    """
    worker = _context.get("worker") or os.environ.get(
        "SCTOOLS_TPU_TRACE_WORKER", ""
    ).strip()
    if not worker:
        import socket

        worker = f"{socket.gethostname()}-{os.getpid()}"
    return _sanitize_component(str(worker))


def configured_trace_dir() -> Optional[str]:
    """The SCTOOLS_TPU_TRACE capture directory, if set."""
    value = os.environ.get("SCTOOLS_TPU_TRACE", "").strip()
    return value or None


# extra named sections subsystems contribute to flight records: the ingest
# ring registers its slot states, the pulse its ring and last heartbeats —
# so a crash/SIGTERM postmortem shows not just WHERE the process was (open
# spans) but what the pipeline was doing.
# Providers must be cheap, lock-light, and safe to call from a signal
# handler's dump path; a provider that raises is skipped, never fatal.
_flight_sections: Dict[str, Callable[[], Any]] = {}


def register_flight_section(name: str, provider: Callable[[], Any]) -> None:
    """Attach ``provider()``'s value under ``name`` in every flight record."""
    _flight_sections[name] = provider


def bounded_snapshot(
    lock: Any, snapshot: Callable[[], Any], default: Any
) -> Callable[[], Any]:
    """Wrap a lock-guarded ``snapshot()`` for the flight-dump death path.

    The ONE place the death-path invariant lives: a provider may run
    inside a signal handler that interrupted a holder of ``lock`` on the
    same thread, so the acquire is bounded, and on timeout the snapshot
    degrades to a lockless best effort (``default`` if a concurrent
    mutation races the read) — never a self-deadlock, never a raise.
    """
    def provider():
        acquired = lock.acquire(timeout=0.5)
        try:
            try:
                return snapshot()
            except RuntimeError:  # lockless snapshot raced a mutation
                return default
        finally:
            if acquired:
                lock.release()

    return provider


def flight_path() -> Optional[str]:
    """Where this process's flight record lands (None when no trace dir)."""
    base = configured_trace_dir()
    if base is None:
        return None
    return os.path.join(base, f"flight.{configured_worker_name()}.jsonl")


def flight_dump(reason: str = "", path: Optional[str] = None) -> Optional[str]:
    """Persist the span ring + counters for a postmortem; returns the path.

    The crashed-worker story: the JSONL sink only holds spans that CLOSED
    before death, and a worker killed mid-task (``SCTOOLS_TPU_FAULTS``
    crash injection, preemption SIGTERM) exits with its current span still
    open. The flight record captures what the sink cannot: the ring buffer
    (bounded), counter/gauge snapshots, and the dumping thread's OPEN span
    stack — i.e. where the process actually was when it died. Fault
    injection calls this just before ``os._exit``;
    :func:`install_flight_recorder` wires SIGTERM. Written atomically
    (tmp + replace) so a half-written record never shadows a whole one.
    """
    target = path
    if target is None:
        target = flight_path()
    if target is None:
        return None
    # the dump may run inside a signal handler that interrupted THIS
    # thread while it held _lock (e.g. mid-_record_span): a plain `with
    # _lock` would deadlock the death path and the orchestrator's SIGKILL
    # escalation would lose the record. Bounded wait, then a lockless
    # best-effort snapshot.
    acquired = _lock.acquire(timeout=1.0)
    try:
        try:
            ring = list(_ring)
            counters_snapshot = dict(_counters)
            gauges_snapshot = dict(_gauges)
        except RuntimeError:  # lockless snapshot raced a mutation
            ring, counters_snapshot, gauges_snapshot = [], {}, {}
    finally:
        if acquired:
            _lock.release()
    meta = {
        "meta": "flight",
        "reason": reason,
        "worker": _context.get("worker") or configured_worker_name(),
        "pid": os.getpid(),
        "wall": round(time.time(), 6),  # scx-lint: disable=SCX109 -- cross-process anchor, not a duration
        "mono": round(time.perf_counter() - _T0, 6),
        "open_spans": list(_stack()),
        "counters": counters_snapshot,
        "gauges": gauges_snapshot,
    }
    sections = {}
    for section_name, provider in list(_flight_sections.items()):
        try:
            sections[section_name] = provider()
        except Exception:  # noqa: BLE001 - the death path must still write
            continue
    if sections:
        meta["sections"] = sections
    # a crashed worker's compile/occupancy/ledger registry dies with the
    # process unless the flight record carries it (the atexit xprof dump
    # never runs under os._exit); bounded by the registry's own caps
    xprof = sys.modules.get(__name__ + ".xprof")
    if xprof is not None:
        try:
            if xprof.has_data():  # lockless by design (death path)
                # bounded lock wait, same reasoning as the obs lock above:
                # the signal may have interrupted a holder of xprof's lock
                meta["xprof"] = xprof.snapshot(lock_timeout=1.0)
        except Exception:  # noqa: BLE001 - the death path must still write
            pass
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(meta, separators=(",", ":")) + "\n")
            for record in ring:
                f.write(json.dumps(record, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return target


_flight_signal_installed = False


def install_flight_recorder() -> bool:
    """Dump a flight record on SIGTERM (idempotent; main thread only).

    SIGTERM is what a preempting orchestrator sends before the kill; the
    handler persists the flight record and then defers to whatever
    handler/default was installed before, so termination semantics are
    unchanged. Requires a configured trace dir; returns whether the hook
    is active.
    """
    global _flight_signal_installed
    if _flight_signal_installed:
        return True
    if configured_trace_dir() is None:
        return False
    import signal

    previous = signal.getsignal(signal.SIGTERM)

    def _on_sigterm(signum, frame):
        try:
            flight_dump(reason="signal:SIGTERM")
        except Exception:  # noqa: BLE001 - dying anyway; never mask the signal
            pass
        if previous == signal.SIG_IGN:
            return  # SIGTERM was deliberately ignored: keep ignoring it
        if callable(previous):
            previous(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # not the main thread / exotic platform
        return False
    _flight_signal_installed = True
    return True



# ------------------------------------------------------------ summarize

def summarize_records(records: Iterable[dict]) -> List[dict]:
    """Aggregate span records into per-stage rows (sorted by total time).

    Each row: name, count, total_s, mean_ms, records, bytes, and derived
    rec_per_s / MB_per_s throughputs (None when the attr never appeared).
    """
    stages: Dict[str, dict] = {}
    for record in records:
        name = record.get("name")
        if not isinstance(name, str):
            continue
        row = stages.setdefault(
            name,
            {
                "name": name,
                "count": 0,
                "total_s": 0.0,
                "records": 0,
                "bytes": 0,
                "has_records": False,
                "has_bytes": False,
                "errors": 0,
            },
        )
        row["count"] += 1
        row["total_s"] += float(record.get("dur", 0.0))
        attrs = record.get("attrs") or {}
        if "records" in attrs:
            row["records"] += int(attrs["records"])
            row["has_records"] = True
        if "bytes" in attrs:
            row["bytes"] += int(attrs["bytes"])
            row["has_bytes"] = True
        if record.get("error"):
            row["errors"] += 1
    out = []
    for row in stages.values():
        total = row["total_s"]
        row["mean_ms"] = total / row["count"] * 1e3 if row["count"] else 0.0
        row["rec_per_s"] = (
            row["records"] / total if row["has_records"] and total > 0 else None
        )
        row["MB_per_s"] = (
            row["bytes"] / total / 1e6 if row["has_bytes"] and total > 0 else None
        )
        if not row.pop("has_records"):
            row["records"] = None
        if not row.pop("has_bytes"):
            row["bytes"] = None
        out.append(row)
    out.sort(key=lambda r: -r["total_s"])
    return out


def render_summary(rows: List[dict]) -> str:
    """The per-stage table ``python -m sctools_tpu_torch.obs summarize`` prints."""
    headers = (
        "stage", "count", "total_s", "mean_ms", "records", "rec/s",
        "bytes", "MB/s",
    )

    def fmt(value, kind: str) -> str:
        if value is None:
            return "-"
        if kind == "f3":
            return f"{value:.3f}"
        if kind == "f1":
            return f"{value:.1f}"
        if kind == "i":
            return str(int(value))
        return str(value)

    table = [headers]
    for row in rows:
        table.append(
            (
                row["name"],
                fmt(row["count"], "i"),
                fmt(row["total_s"], "f3"),
                fmt(row["mean_ms"], "f3"),
                fmt(row["records"], "i"),
                fmt(row["rec_per_s"], "f1"),
                fmt(row["bytes"], "i"),
                fmt(row["MB_per_s"], "f1"),
            )
        )
    widths = [max(len(r[i]) for r in table) for i in range(len(headers))]
    lines = []
    for index, row in enumerate(table):
        lines.append(
            "  ".join(
                cell.ljust(widths[i]) if i == 0 else cell.rjust(widths[i])
                for i, cell in enumerate(row)
            )
        )
        if index == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ----------------------------------------------- env-driven activation

def _activate_from_env() -> None:
    trace_dir = configured_trace_dir()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        # multi-worker runs share one capture dir: SCTOOLS_TPU_TRACE_WORKER
        # gives each process its own trace/metrics files (appending N
        # processes into one trace.jsonl would tear lines)
        worker = os.environ.get("SCTOOLS_TPU_TRACE_WORKER", "").strip()
        if worker:
            safe = _sanitize_component(worker)
            trace_name = f"trace.{safe}.jsonl"
            metrics_name = f"metrics.{safe}.prom"
            xprof_name = f"xprof.{safe}.json"
        else:
            trace_name = "trace.jsonl"
            metrics_name = "metrics.prom"
            xprof_name = "xprof.json"
        enable(sink_path=os.path.join(trace_dir, trace_name))
        install_flight_recorder()

        def _dump_metrics() -> None:
            text = render_metrics()
            if text:
                try:
                    with open(
                        os.path.join(trace_dir, metrics_name), "w"
                    ) as f:
                        f.write(text)
                except OSError:
                    pass
            # the device-efficiency registry rides the same capture, read
            # back by `obs efficiency <run_dir>`; a process that never
            # imported xprof dumps nothing
            xprof = sys.modules.get(__name__ + ".xprof")
            if xprof is not None and xprof.has_data():
                xprof.dump(
                    os.path.join(trace_dir, xprof_name),
                    worker=configured_worker_name(),
                )

        atexit.register(_dump_metrics)
    elif os.environ.get("SCTOOLS_TPU_OBS", "") not in ("", "0"):
        enable()


_activate_from_env()
