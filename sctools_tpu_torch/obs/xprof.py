"""scx-xprof for the port: per-site occupancy, the transfer ledger and
device-memory watermarks.

The port's copy of ``sctools_tpu.obs.xprof``, with the same site names,
registry schema, dump files, counters and reports, so that either
package's ``obs efficiency`` reads the other's run directory and ``obs
delta`` lines sites up across the two. All recording is keyed off the
trace switch (``obs.enabled()``) and is a no-op while it is off.

1. **Site registry.** :func:`instrument_site` marks the port's
   counterpart of each of JAX's ``instrument_jit`` sites (the names are
   the registry's keys, which ``obs delta``'s site diff and
   :func:`suggest_buckets` read). It declares the name once, at import,
   so a site that never ran still shows up; each call while recording
   adds to ``calls`` and to the ``dtype[dims]`` signature of its
   operands (a per-shard list of tensors renders as the stacked shape
   tagged ``@(shards)``), then runs the function unchanged. The port has
   no jit: eager sites record 0 compiles. The serve worker's CUDA graph
   captures are its compiles (:func:`record_compile`), and a second
   capture of a captured signature is a retrace.
2. **Occupancy.** Padded-batch producers call :func:`record_dispatch`
   with the real and the padded rows of each dispatch.
3. **Transfer ledger.** :func:`record_transfer` counts the bytes that
   ``ingest.upload`` / ``ingest.pull`` move, per site and direction: the
   one count of bytes moved, which the spans' and heartbeats' byte
   attributes reconcile with.
4. **Memory watermarks.** :func:`sample_memory` reads the caching
   allocator's bytes in use (``torch.cuda.memory_allocated``, a host-side
   read with no sync) summed over the CUDA devices it is given, and
   attributes the peak to the open span. On the CPU it records
   ``supported: False`` and stays silent: the port has no counterpart of
   JAX's ``jax.live_arrays()`` probe.

Not carried: ``instrument_jit``'s JAX machinery (``cost_analysis``, the
``NamedSharding`` tags, the jax.monitoring compile events behind
``observe_event``) and the serve plane's AOT executable store, so
``cost_per_signature`` stays empty and ``est_flops_total``,
``est_bytes_accessed_total`` and ``unattributed`` stay None or 0.

The trace capture (``SCTOOLS_TPU_TRACE``) dumps the registry to
``<dir>/xprof[.<worker>].json`` at exit; ``python -m
sctools_tpu_torch.obs efficiency <run_dir>`` merges every worker's dump
(and the ``xprof`` section of a flight record, written by a crashed
worker of either package) into the
per-site report. Pure stdlib at import: torch is imported only by
:func:`sample_memory`.
"""

from __future__ import annotations

import functools
import glob as _glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.witness import make_rlock
from . import _stack as _obs_stack
from . import count as _obs_count
from . import enabled as _obs_enabled
from . import gauge as _obs_gauge
from . import get_context as _obs_context

__all__ = [
    "instrument_site",
    "declared_sites",
    "signature",
    "record_call",
    "record_compile",
    "compile_seq",
    "retrace_seq",
    "record_dispatch",
    "record_transfer",
    "record_transfer_waste",
    "sample_memory",
    "ledger_totals",
    "snapshot",
    "has_data",
    "reset",
    "dump",
    "load_registries",
    "load_mesh_dumps",
    "merge_registries",
    "efficiency_report",
    "render_efficiency",
    "suggest_buckets",
    "render_suggestions",
]

_lock = make_rlock("obs.xprof")

# distinct signatures / retrace examples / stage peaks kept per site: the
# registry must stay flight-record-sized under shape flapping
_MAX_SIGNATURES = 64
_MAX_RETRACE_EXAMPLES = 8
_MAX_STAGE_PEAKS = 32

SIGNATURE_OVERFLOW = "(other signatures)"


class _Site:
    """Mutable per-call-site accumulator (guarded by the module lock)."""

    __slots__ = (
        "name", "calls", "compiles", "retraces", "compile_s",
        "signatures", "sig_calls", "retrace_examples",
        "dispatches", "real_rows", "padded_rows",
    )

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.retraces = 0
        self.compile_s = 0.0
        self.signatures: Dict[str, int] = {}  # sig -> compiles
        self.sig_calls: Dict[str, int] = {}
        self.retrace_examples: List[Dict[str, Any]] = []
        self.dispatches = 0
        self.real_rows = 0
        self.padded_rows = 0


# name -> _Site for sites that have recorded anything; _declared remembers
# every declaration so a site that never ran still shows up (absence from
# the report must mean "not instrumented")
_sites: Dict[str, _Site] = {}
_declared: Dict[str, int] = {}  # name -> times declared
# process-wide compile and retrace sequences (bumped under _lock, READ
# lockless): pulse diffs retrace_seq around each batch to stamp the
# heartbeat's retrace flag without taking the registry lock per batch
_compile_seq = 0
_retrace_seq = 0

# (direction, site) -> [bytes, seconds, events, wasted]
_ledger: Dict[Tuple[str, str], List[float]] = {}

_memory: Dict[str, Any] = {
    "supported": None,  # None = never sampled, False = no CUDA device
    "source": None,  # "memory_stats"
    "samples": 0,
    "peak_bytes": 0,
    "peak_stage": None,
    "stage_peaks": {},  # stage -> peak bytes
}


def _site(name: str) -> _Site:
    site = _sites.get(name)
    if site is None:
        with _lock:
            site = _sites.setdefault(name, _Site(name))
    return site


def declared_sites() -> List[str]:
    """Every site name declared in this process."""
    with _lock:
        return sorted(_declared)


# ---------------------------------------------------------- call sites

def _leaf(value) -> Optional[str]:
    """``dtype[dims]`` of an array or tensor, ``dtype[n,dims]@(shards)``
    of a per-shard list of tensors, else None."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype)
        return f"{name[6:] if name.startswith('torch.') else name}[{','.join(str(d) for d in shape)}]"
    if isinstance(value, list) and value:
        present = [v for v in value if v is not None]
        if present and all(getattr(v, "device", None) is not None for v in present):
            inner = _leaf(present[0])
            if inner is not None:
                dims = inner[inner.index("[") + 1 : -1]
                return f"{inner[: inner.index('[')]}[{len(value)}{',' if dims else ''}{dims}]@(shards)"
    return None


def _shard_dicts(value) -> bool:
    """A list of per-shard column dicts (None for another process's)."""
    if not isinstance(value, list):
        return False
    present = [v for v in value if v is not None]
    return bool(present) and all(isinstance(v, dict) and v.keys() == present[0].keys() for v in present)


def _flatten(value, out: List[str]) -> None:
    leaf = _leaf(value)
    if leaf is not None:
        out.append(leaf)
    elif isinstance(value, dict):
        for key in sorted(value):  # jax.tree_util's dict order
            _flatten(value[key], out)
    elif _shard_dicts(value):
        # per-shard column dicts: each column as one sharded operand
        for key in sorted(next(v for v in value if v is not None)):
            _flatten([None if v is None else v[key] for v in value], out)
    elif isinstance(value, (list, tuple)) and any(
        isinstance(item, (dict, list, tuple)) or _leaf(item) is not None for item in value
    ):
        for item in value:
            _flatten(item, out)
    else:
        out.append(repr(value))


def signature(args: tuple, kwargs: dict) -> str:
    """The abstract signature of one call, in JAX's grammar: operand
    leaves ``dtype[dims]`` (``@(shards)`` for a per-shard list), then the
    keyword arguments that hold no array, as ``{k=v}`` statics."""
    parts: List[str] = []
    static = []
    dynamic = {}
    for key, value in kwargs.items():
        if _leaf(value) is None and not isinstance(value, (dict, list, tuple)):
            static.append((key, value))
        else:
            dynamic[key] = value
    _flatten((args, dynamic), parts)
    sig = "(" + ", ".join(parts) + ")"
    if static:
        static.sort()
        sig += " {" + ", ".join(f"{k}={v!r}" for k, v in static) + "}"
    return sig


def _register_signature(site: _Site, sig: str) -> str:
    """``sig``, or the overflow bucket once the site holds too many
    (caller holds the lock)."""
    if sig not in site.signatures and len(site.signatures) >= _MAX_SIGNATURES:
        sig = SIGNATURE_OVERFLOW
    site.signatures.setdefault(sig, 0)
    return sig


def record_call(site_name: str, args: tuple = (), kwargs: Optional[dict] = None) -> None:
    """One call of a site on these operands (no-op while recording is off)."""
    if not _obs_enabled():
        return
    sig = signature(args, kwargs or {})
    site = _site(site_name)
    with _lock:
        site.calls += 1
        sig = _register_signature(site, sig)
        site.sig_calls[sig] = site.sig_calls.get(sig, 0) + 1


def instrument_site(name: str):
    """Decorator: declare ``name`` now and, while recording, count each
    call and its signature before running the function unchanged. Off,
    it costs one bool check a call."""

    def decorate(fn):
        with _lock:
            _declared[name] = _declared.get(name, 0) + 1

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _obs_enabled():
                record_call(name, args, kwargs)
            return fn(*args, **kwargs)

        call.site_name = name
        return call

    return decorate


def record_compile(site_name: str, sig: str, seconds: float = 0.0, retrace: bool = False) -> None:
    """One compile of ``site_name`` for ``sig`` (the serve worker's CUDA
    graph captures). ``retrace``: the site had compiled ``sig`` already,
    the thing that must stay zero in steady state."""
    global _compile_seq, _retrace_seq
    if not _obs_enabled():
        return
    site = _site(site_name)
    with _lock:
        sig = _register_signature(site, sig)
        site.compile_s += float(seconds)
        site.compiles += 1
        site.signatures[sig] += 1
        _compile_seq += 1
        if retrace:
            _retrace_seq += 1
            site.retraces += 1
            for example in site.retrace_examples:
                if example["signature"] == sig:
                    example["count"] += 1
                    break
            else:
                if len(site.retrace_examples) < _MAX_RETRACE_EXAMPLES:
                    site.retrace_examples.append({"signature": sig, "count": 1})
    _obs_count("xprof_compiles")
    if retrace:
        _obs_count("xprof_retraces")


def compile_seq() -> int:
    """Compiles recorded so far (lockless)."""
    return _compile_seq


def retrace_seq() -> int:
    """Steady-state retraces recorded so far (lockless int read).

    pulse diffs this around each batch to stamp the heartbeat's retrace
    flag. Compiles are recorded only while recording is on, so with obs
    off the flag stays 0.
    """
    return _retrace_seq


# -------------------------------------------------- occupancy telemetry

def record_dispatch(site_name: str, real_rows: int, padded_rows: int, bucket: Optional[int] = None) -> None:
    """One padded-batch dispatch: ``real_rows`` of ``padded_rows`` real.

    No-op while recording is off. ``bucket`` (the padded bucket size) is
    accepted for the call site's readability, as in the JAX package; the
    padded total already carries it. Feeds the per-site occupancy and the
    ``xprof_real_rows`` / ``xprof_padded_rows`` counters.
    """
    del bucket
    if not _obs_enabled():
        return
    site = _site(site_name)
    with _lock:
        site.dispatches += 1
        site.real_rows += int(real_rows)
        site.padded_rows += int(padded_rows)
    _obs_count("xprof_real_rows", int(real_rows))
    _obs_count("xprof_padded_rows", int(padded_rows))


# ------------------------------------------------------ transfer ledger

def record_transfer(
    direction: str, nbytes: int, seconds: float = 0.0, site: str = "",
    wasted: int = 0,
) -> None:
    """Count bytes (and, when timed, seconds) crossing the device link.

    ``direction`` is ``"h2d"`` or ``"d2h"``. ``wasted`` counts the pad
    bytes inside ``nbytes`` (result rows pulled only because the pull was
    sized to a bucket); bytes stay fully counted in ``nbytes``. No-op
    while recording is off.
    """
    if direction not in ("h2d", "d2h"):
        raise ValueError(f"direction must be 'h2d' or 'd2h', got {direction!r}")
    if not _obs_enabled():
        return
    with _lock:
        entry = _ledger.setdefault((direction, site), [0, 0.0, 0, 0])
        entry[0] += int(nbytes)
        entry[1] += float(seconds)
        entry[2] += 1
        entry[3] += int(wasted)
    _obs_count(f"xprof_transfer_bytes_{direction}", int(nbytes))
    if wasted:
        _obs_count(f"xprof_transfer_wasted_bytes_{direction}", int(wasted))


def record_transfer_waste(direction: str, site: str, wasted: int) -> None:
    """Attribute pad bytes to an already-recorded transfer, for pulls whose
    pad is host-knowable only once the bytes landed (the sharded
    writeback's per-shard entity counts). Bytes, seconds and events stay
    as they were."""
    if direction not in ("h2d", "d2h"):
        raise ValueError(f"direction must be 'h2d' or 'd2h', got {direction!r}")
    if not _obs_enabled() or not wasted:
        return
    with _lock:
        entry = _ledger.setdefault((direction, site), [0, 0.0, 0, 0])
        entry[3] += int(wasted)
    _obs_count(f"xprof_transfer_wasted_bytes_{direction}", int(wasted))


def ledger_totals() -> Dict[str, Dict[str, Any]]:
    """Ledger snapshot: per-direction totals with a per-site breakdown."""
    with _lock:
        return _ledger_totals_locked()


def _ledger_totals_locked() -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for (direction, site), entry in list(_ledger.items()):
        nbytes, seconds, events, wasted = entry
        total = out.setdefault(
            direction,
            {"bytes": 0, "seconds": 0.0, "events": 0, "wasted": 0, "by_site": {}},
        )
        total["bytes"] += int(nbytes)
        total["seconds"] += seconds
        total["events"] += events
        total["wasted"] += int(wasted)
        total["by_site"][site or "(unlabeled)"] = {
            "bytes": int(nbytes), "seconds": seconds, "events": events,
            "wasted": int(wasted),
        }
    return out


# -------------------------------------------------- memory watermarks

def sample_memory(stage: Optional[str] = None, devices=()) -> Optional[int]:
    """Sample the bytes in use on ``devices``; track the peak and its stage.

    Sums ``torch.cuda.memory_allocated`` (the caching allocator's
    ``allocated_bytes.all.current``, a host-side read that waits for
    nothing) over the CUDA devices among ``devices``. Where none is a
    CUDA device (a run on the CPU) it records the probe as unsupported
    and returns None: there is no CPU fallback. ``stage`` defaults to
    the innermost open obs span on this thread (else the obs context's
    ``task``), which attributes a peak to upload/compute/writeback.
    """
    if not _obs_enabled():
        return None
    indices = sorted({d.index for d in devices if d.type == "cuda"})
    if not indices:
        with _lock:
            if _memory["supported"] is None:
                _memory["supported"] = False
        return None
    import torch

    in_use = sum(torch.cuda.memory_allocated(index) for index in indices)
    if stage is None:
        open_spans = _obs_stack()
        stage = open_spans[-1] if open_spans else _obs_context().get("task")
    with _lock:
        _memory["supported"] = True
        _memory["source"] = "memory_stats"
        _memory["samples"] += 1
        if in_use > _memory["peak_bytes"]:
            _memory["peak_bytes"] = in_use
            _memory["peak_stage"] = stage
        if stage is not None:
            peaks = _memory["stage_peaks"]
            if stage in peaks or len(peaks) < _MAX_STAGE_PEAKS:
                peaks[stage] = max(peaks.get(stage, 0), in_use)
        peak = _memory["peak_bytes"]
    _obs_gauge("xprof_device_bytes_in_use", in_use)
    _obs_gauge("xprof_device_peak_bytes", peak)
    return in_use


# ------------------------------------------------------------ snapshot

def _site_row(site: _Site) -> Dict[str, Any]:
    occupancy = site.real_rows / site.padded_rows if site.padded_rows else None
    return {
        "calls": site.calls,
        "compiles": site.compiles,
        "retraces": site.retraces,
        "compile_s": round(site.compile_s, 6),
        "signatures": dict(site.signatures),
        "retrace_signatures": [dict(e) for e in site.retrace_examples],
        "cost_per_signature": {},
        "dispatches": site.dispatches,
        "real_rows": site.real_rows,
        "padded_rows": site.padded_rows,
        "occupancy": round(occupancy, 6) if occupancy is not None else None,
        "est_flops_total": None,
        "est_bytes_accessed_total": None,
    }


def snapshot(lock_timeout: Optional[float] = None) -> Dict[str, Any]:
    """The whole registry as one JSON-safe dict (flight-record sized).

    ``lock_timeout`` bounds the lock wait for a caller on a death path (a
    flight recorder's signal handler may have interrupted a thread that
    holds this very lock): on timeout the snapshot degrades to a lockless
    best effort, and a racing mutation degrades it to empty, never to a
    hang or a raise.
    """
    if lock_timeout is None:
        # scx-lint: disable=SCX402 -- death-path callers pass lock_timeout and take the bounded branch below; this branch serves ordinary snapshot/dump callers
        acquired = _lock.acquire()
    else:
        acquired = _lock.acquire(timeout=lock_timeout)
    try:
        try:
            rows = {name: _site_row(site) for name, site in _sites.items()}
            for name in list(_declared):
                if name not in rows:
                    rows[name] = _site_row(_Site(name))
            declared = sorted(_declared)
            ledger = _ledger_totals_locked()
            memory = dict(_memory)
            memory["stage_peaks"] = dict(memory["stage_peaks"])
        except RuntimeError:  # lockless snapshot raced a mutation
            rows, declared, ledger, memory = {}, [], {}, {}
    finally:
        if acquired:
            _lock.release()
    return {
        "version": 1,
        "sites": rows,
        "declared_sites": declared,
        "ledger": ledger,
        "memory": memory,
        "unattributed": {"compiles": 0, "compile_s": 0.0},
    }


def has_data() -> bool:
    """Whether anything at all has been recorded or declared (lockless,
    for a death path that must never block on the registry lock)."""
    return bool(_sites or _declared or _ledger or _memory["samples"])


def reset() -> None:
    """Clear the registry, ledger and watermarks (tests). Declarations
    stay cleared too, as JAX's ``reset`` clears them."""
    with _lock:
        _sites.clear()
        _declared.clear()
        _ledger.clear()
        _memory.update(
            supported=None, source=None, samples=0, peak_bytes=0,
            peak_stage=None, stage_peaks={},
        )


def dump(path: str, worker: Optional[str] = None) -> Optional[str]:
    """Persist the snapshot atomically (tmp + replace); returns the path."""
    data = snapshot()
    if worker:
        data["worker"] = worker
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, separators=(",", ":"))
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return path


def load_mesh_dumps(run_dir: str) -> Dict[str, Dict[str, Any]]:
    """``mesh.<worker>.json`` dumps under ``run_dir`` (and one level of
    subdirectories), keyed by worker: the collective-schedule witness's
    (``analysis.meshwitness.load_dumps``), which reads a port worker's and
    a JAX worker's alike. Unreadable dumps are skipped."""
    from ..analysis import meshwitness

    return meshwitness.load_dumps(run_dir)


# ------------------------------------------------- load / merge / report

def _filename_worker(path: str) -> Optional[str]:
    base = os.path.basename(path)
    for prefix in ("xprof.", "flight."):
        if base.startswith(prefix):
            inner = base[len(prefix):].rsplit(".", 1)[0]
            if inner and inner not in ("json", "jsonl"):
                return inner
    return None


def load_registries(run_dir: str) -> List[Dict[str, Any]]:
    """Every worker registry under a run dir (one level deep, like fleet).

    Reads ``xprof[.<worker>].json`` dumps and the ``xprof`` section of
    ``flight.<worker>.jsonl`` records (a crashed worker's only copy). A
    worker with both keeps the exit dump — it is a superset of the flight
    snapshot. Unreadable files are skipped, never fatal.
    """
    run_dir = os.path.abspath(run_dir)
    roots = [run_dir] + sorted(
        p
        for p in _glob.glob(os.path.join(run_dir, "*"))
        if os.path.isdir(p)
    )
    registries: List[Dict[str, Any]] = []
    seen_workers: Dict[str, int] = {}
    for root in roots:
        for path in sorted(_glob.glob(os.path.join(root, "xprof*.json"))):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(data, dict) or "sites" not in data:
                continue
            data.setdefault(
                "worker", _filename_worker(path) or "unknown"
            )
            data["path"] = path
            seen_workers[str(data["worker"])] = 1
            named = _filename_worker(path)
            if named:
                # dedup against a flight record by EITHER identity: the
                # capture filename and the registry's own worker field can
                # legitimately differ (explicit worker= on dump)
                seen_workers[named] = 1
            registries.append(data)
    for root in roots:
        for path in sorted(_glob.glob(os.path.join(root, "flight.*.jsonl"))):
            try:
                with open(path, encoding="utf-8") as f:
                    first = f.readline()
                meta = json.loads(first)
            except (OSError, ValueError):
                continue
            if not isinstance(meta, dict) or meta.get("meta") != "flight":
                continue
            data = meta.get("xprof")
            if not isinstance(data, dict) or "sites" not in data:
                continue
            worker = str(
                meta.get("worker") or _filename_worker(path) or "unknown"
            )
            named = _filename_worker(path)
            if worker in seen_workers or (named and named in seen_workers):
                continue  # the exit dump supersedes the flight copy
            data = dict(data)
            data["worker"] = worker
            data["path"] = path
            data["from_flight"] = True
            registries.append(data)
    return registries


def merge_registries(registries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum per-site stats, ledgers, and watermarks across workers."""
    sites: Dict[str, Dict[str, Any]] = {}
    ledger: Dict[str, Dict[str, Any]] = {}
    declared: set = set()
    memory = {"peak_bytes": 0, "peak_stage": None, "peak_worker": None,
              "samples": 0, "supported": False}
    unattributed = 0
    for registry in registries:
        declared.update(registry.get("declared_sites") or [])
        for name, row in (registry.get("sites") or {}).items():
            merged = sites.setdefault(
                name,
                {
                    "calls": 0, "compiles": 0, "retraces": 0,
                    "compile_s": 0.0, "dispatches": 0, "real_rows": 0,
                    "padded_rows": 0, "signatures": {},
                    "retrace_signatures": [], "est_flops_total": None,
                    "est_bytes_accessed_total": None, "workers": [],
                },
            )
            for key in ("calls", "compiles", "retraces", "dispatches",
                        "real_rows", "padded_rows"):
                merged[key] += int(row.get(key) or 0)
            merged["compile_s"] += float(row.get("compile_s") or 0.0)
            for sig, count in (row.get("signatures") or {}).items():
                merged["signatures"][sig] = (
                    merged["signatures"].get(sig, 0) + int(count)
                )
            merged["retrace_signatures"].extend(
                row.get("retrace_signatures") or []
            )
            for key in ("est_flops_total", "est_bytes_accessed_total"):
                value = row.get(key)
                if isinstance(value, (int, float)):
                    merged[key] = (merged[key] or 0.0) + float(value)
            worker = str(registry.get("worker", "unknown"))
            if worker not in merged["workers"]:
                merged["workers"].append(worker)
        for direction, total in (registry.get("ledger") or {}).items():
            out = ledger.setdefault(
                direction,
                {
                    "bytes": 0, "seconds": 0.0, "events": 0, "wasted": 0,
                    "by_site": {},
                },
            )
            out["bytes"] += int(total.get("bytes") or 0)
            out["seconds"] += float(total.get("seconds") or 0.0)
            out["events"] += int(total.get("events") or 0)
            out["wasted"] += int(total.get("wasted") or 0)
            for site, entry in (total.get("by_site") or {}).items():
                slot = out["by_site"].setdefault(
                    site,
                    {"bytes": 0, "seconds": 0.0, "events": 0, "wasted": 0},
                )
                slot["bytes"] += int(entry.get("bytes") or 0)
                slot["seconds"] += float(entry.get("seconds") or 0.0)
                slot["events"] += int(entry.get("events") or 0)
                slot["wasted"] += int(entry.get("wasted") or 0)
        mem = registry.get("memory") or {}
        memory["samples"] += int(mem.get("samples") or 0)
        memory["supported"] = memory["supported"] or bool(mem.get("supported"))
        peak = int(mem.get("peak_bytes") or 0)
        if peak > memory["peak_bytes"]:
            memory["peak_bytes"] = peak
            memory["peak_stage"] = mem.get("peak_stage")
            memory["peak_worker"] = registry.get("worker")
        unattributed += int(
            (registry.get("unattributed") or {}).get("compiles") or 0
        )
    for row in sites.values():
        padded = row["padded_rows"]
        row["occupancy"] = row["real_rows"] / padded if padded else None
    return {
        "sites": sites,
        "declared_sites": sorted(declared),
        "ledger": ledger,
        "memory": memory,
        "unattributed_compiles": unattributed,
    }


def efficiency_report(run_dir: str) -> Dict[str, Any]:
    """The merged device-efficiency view of one (traced) run directory."""
    registries = load_registries(run_dir)
    merged = merge_registries(registries)
    warnings: List[str] = []
    if not registries:
        warnings.append(
            f"no xprof registries under {run_dir}: run with "
            "SCTOOLS_TPU_TRACE set (the capture dumps xprof[.worker].json "
            "at exit)"
        )
    total_real = sum(r["real_rows"] for r in merged["sites"].values())
    total_padded = sum(r["padded_rows"] for r in merged["sites"].values())
    wasted_flops = 0.0
    for row in merged["sites"].values():
        flops = row.get("est_flops_total")
        occupancy = row.get("occupancy")
        if isinstance(flops, (int, float)) and occupancy is not None:
            wasted_flops += flops * (1.0 - occupancy)
    ledger = merged["ledger"]
    # measured link rate: TIMED entries only. Most ledger entries carry
    # bytes with seconds=0 (async dispatches are not honestly timeable);
    # dividing the whole direction's bytes by only the probes' seconds
    # would inflate the roofline by the untimed bulk.
    link = {}
    for direction, total in ledger.items():
        timed_bytes = sum(
            entry["bytes"]
            for entry in total["by_site"].values()
            if entry["seconds"] > 0
        )
        timed_seconds = sum(
            entry["seconds"]
            for entry in total["by_site"].values()
            if entry["seconds"] > 0
        )
        if timed_seconds > 0:
            link[f"{direction}_MBps"] = round(
                timed_bytes / timed_seconds / 1e6, 1
            )
    # scx-pulse bubble attribution rides the same report when the run
    # dir carries heartbeat rings: the device-efficiency story and the
    # pipeline-overlap story read from one CLI surface
    from . import pulse as _pulse

    pulse_view = _pulse.fleet_pulse(run_dir)
    pulse_section = (
        {
            "heartbeats": pulse_view["fleet"]["heartbeats"],
            "cells_per_s": pulse_view["fleet"]["cells_per_s"],
            "bubble_fraction": pulse_view["fleet"]["bubble_fraction"],
            "limiting_stage": pulse_view["fleet"]["limiting_stage"],
            "workers": {
                worker: {
                    "heartbeats": row["heartbeats"],
                    "bubble_fraction": row["bubble_fraction"],
                    "limiting_stage": row["limiting_stage"],
                }
                for worker, row in pulse_view["workers"].items()
            },
        }
        if pulse_view["workers"]
        else None
    )
    # scx-mesh collective-schedule witness dumps (mesh.<worker>.json):
    # per-worker collective counts/bytes so on-device merge cost reads
    # next to the transfer ledger; graceful absence when the run was not
    # armed (SCTOOLS_TPU_MESH_DEBUG=1)
    mesh_dumps = load_mesh_dumps(run_dir)
    collectives_section = None
    if mesh_dumps:
        fleet_counts: Dict[str, int] = {}
        fleet_bytes: Dict[str, int] = {}
        worker_rows: Dict[str, Any] = {}
        total_violations = 0
        for worker, dumped in sorted(mesh_dumps.items()):
            counts = {
                str(k): int(v)
                for k, v in (dumped.get("counts") or {}).items()
            }
            nbytes = {
                str(k): int(v)
                for k, v in (dumped.get("bytes") or {}).items()
            }
            violations = list(dumped.get("violations") or ())
            total_violations += len(violations)
            worker_rows[worker] = {
                "counts": counts,
                "bytes": nbytes,
                "violations": len(violations),
            }
            for name, count in counts.items():
                fleet_counts[name] = fleet_counts.get(name, 0) + count
            for name, value in nbytes.items():
                fleet_bytes[name] = fleet_bytes.get(name, 0) + value
        collectives_section = {
            "counts": fleet_counts,
            "bytes": fleet_bytes,
            "violations": total_violations,
            "workers": worker_rows,
        }
    return {
        "run_dir": os.path.abspath(run_dir),
        "pulse": pulse_section,
        "collectives": collectives_section,
        "workers": sorted(
            {str(r.get("worker", "unknown")) for r in registries}
        ),
        "registries": [
            {
                "worker": str(r.get("worker", "unknown")),
                "path": r.get("path"),
                "from_flight": bool(r.get("from_flight")),
            }
            for r in registries
        ],
        "sites": merged["sites"],
        "declared_sites": merged["declared_sites"],
        "ledger": ledger,
        "measured_link": link,
        "memory": merged["memory"],
        "totals": {
            "compiles": sum(
                r["compiles"] for r in merged["sites"].values()
            ),
            "retraces": sum(
                r["retraces"] for r in merged["sites"].values()
            ),
            "real_rows": total_real,
            "padded_rows": total_padded,
            "occupancy": (
                total_real / total_padded if total_padded else None
            ),
            "est_wasted_flops": wasted_flops,
            # pad rows x row bytes across every D2H pull that reported
            # its pad fraction (the compacted writeback): bytes the link
            # moved for rows nobody reads
            "wasted_d2h_bytes": int(
                (ledger.get("d2h") or {}).get("wasted") or 0
            ),
            "unattributed_compiles": merged["unattributed_compiles"],
        },
        "warnings": warnings,
    }


# dispatch sites sized by the ENTITY bucket vocabulary
# (ops.segments.entity_bucket / ENTITY_BUCKET_MIN); every other site
# rides the record vocabulary (bucket_size / RECORD_BUCKET_MIN)
ENTITY_BUCKET_SITES = frozenset({"metrics.compact_results_wire"})


def suggest_buckets(
    report: Dict[str, Any], target: float = 0.35
) -> List[Dict[str, Any]]:
    """Offline bucket/pad suggestions from recorded dispatch telemetry.

    ``obs efficiency --suggest`` renders these rows, ``--suggest --json``
    emits them verbatim, in JAX's schema, which the autotuner (``python
    -m sctools_tpu_torch.analysis --retune``) parses. Per
    site with occupancy telemetry: the smallest power-of-two pad that
    holds the site's mean real rows per dispatch. ``projected_occupancy``
    is what the mean dispatch would score at that pad; ``meets_target``
    compares it against ``target``; ``unit``/``constant`` name the bucket
    vocabulary the site dispatches under and the pinned constant of
    ``ops/segments.py`` the advice applies to.
    """
    rows: List[Dict[str, Any]] = []
    for name in sorted(report.get("sites") or {}):
        row = report["sites"][name]
        dispatches = int(row.get("dispatches") or 0)
        real = int(row.get("real_rows") or 0)
        padded = int(row.get("padded_rows") or 0)
        if not dispatches or not real or not padded:
            continue
        mean_real = real / dispatches
        suggested = 1
        while suggested < mean_real:
            suggested *= 2
        projected = mean_real / suggested
        unit = "entity" if name in ENTITY_BUCKET_SITES else "record"
        rows.append(
            {
                "site": name,
                "dispatches": dispatches,
                "mean_real_rows": round(mean_real, 1),
                "mean_padded_rows": round(padded / dispatches, 1),
                "occupancy": row.get("occupancy"),
                "suggested_pad": suggested,
                "projected_occupancy": round(projected, 4),
                "meets_target": projected >= target,
                "unit": unit,
                "constant": (
                    "ENTITY_BUCKET_MIN"
                    if unit == "entity"
                    else "RECORD_BUCKET_MIN"
                ),
            }
        )
    return rows


def render_suggestions(
    suggestions: List[Dict[str, Any]], target: float = 0.35
) -> str:
    """The human-facing ``obs efficiency --suggest`` report."""
    lines: List[str] = []
    lines.append(
        f"bucket/pad suggestions (occupancy target {100 * target:.0f}%; "
        "apply with `python -m sctools_tpu_torch.analysis --retune "
        "<run_dir>` "
        "— double-gated by shardcheck + shape-contract coverage):"
    )
    if not suggestions:
        lines.append(
            "  no sites with dispatch telemetry: run with SCTOOLS_TPU_TRACE "
            "set so record_dispatch feeds the registry"
        )
        return "\n".join(lines) + "\n"
    headers = (
        "call site", "dispatches", "mean real", "mean padded",
        "occupancy", "suggest pad_to", "projected",
    )
    table = [headers]
    for row in suggestions:
        occupancy = row.get("occupancy")
        table.append(
            (
                str(row["site"]),
                str(row["dispatches"]),
                f"{row['mean_real_rows']:.0f}",
                f"{row['mean_padded_rows']:.0f}",
                f"{100 * occupancy:.1f}%" if occupancy is not None else "-",
                str(row["suggested_pad"]),
                f"{100 * row['projected_occupancy']:.1f}%"
                + ("" if row["meets_target"] else " (!)"),
            )
        )
    widths = [max(len(r[i]) for r in table) for i in range(len(headers))]
    for index, row in enumerate(table):
        lines.append(
            "  ".join(
                cell.ljust(widths[i]) if i == 0 else cell.rjust(widths[i])
                for i, cell in enumerate(row)
            )
        )
        if index == 0:
            lines.append("  ".join("-" * w for w in widths))
    lines.append(
        "note: a lower pad floor raises occupancy but admits more distinct "
        "shapes to the compiler — check retraces stay 0 after any edit "
        "(the shape contract gate will catch a raw size)"
    )
    return "\n".join(lines) + "\n"


def _fmt_bytes(n: Optional[float]) -> str:
    if not n:
        return "-"
    return f"{n / 1e6:.1f}"


def _fmt_flops(n: Optional[float]) -> str:
    if n is None:
        return "-"
    for unit, scale in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if n >= scale:
            return f"{n / scale:.1f}{unit}"
    return f"{n:.0f}"


def render_efficiency(report: Dict[str, Any]) -> str:
    """The human-facing ``obs efficiency`` report."""
    lines: List[str] = []
    lines.append(f"device efficiency: {report['run_dir']}")
    workers = report["workers"]
    totals = report["totals"]
    lines.append(
        f"{len(workers)} worker registr{'y' if len(workers) == 1 else 'ies'}"
        f" ({', '.join(workers) or 'none'}); "
        f"{totals['compiles']} compile(s), {totals['retraces']} retrace(s)"
        + (
            f", {totals['unattributed_compiles']} unattributed compile(s)"
            if totals["unattributed_compiles"]
            else ""
        )
    )
    pulse_section = report.get("pulse")
    if pulse_section and pulse_section.get("heartbeats"):
        fraction = pulse_section.get("bubble_fraction")
        bubble = (
            f"{100 * fraction:.1f}%" if fraction is not None else "-"
        )
        lines.append(
            f"pulse: {pulse_section['heartbeats']} heartbeat(s), "
            f"bubble {bubble} limited by "
            f"{pulse_section.get('limiting_stage') or '-'} "
            "(`python -m sctools_tpu_torch.obs pulse` for the live view)"
        )
    lines.append("")
    sites = report["sites"]
    if sites:
        headers = (
            "call site", "calls", "compiles", "retraces", "compile_s",
            "occupancy", "wasted", "est FLOPs", "wasted FLOPs",
        )
        table = [headers]
        for name in sorted(
            sites, key=lambda n: -(sites[n].get("est_flops_total") or 0)
        ):
            row = sites[name]
            occupancy = row.get("occupancy")
            flops = row.get("est_flops_total")
            wasted = (
                flops * (1.0 - occupancy)
                if isinstance(flops, (int, float)) and occupancy is not None
                else None
            )
            table.append(
                (
                    name,
                    str(row["calls"]),
                    str(row["compiles"]),
                    str(row["retraces"]),
                    f"{row['compile_s']:.3f}",
                    f"{100 * occupancy:.1f}%" if occupancy is not None else "-",
                    (
                        f"{100 * (1 - occupancy):.1f}%"
                        if occupancy is not None
                        else "-"
                    ),
                    _fmt_flops(flops),
                    _fmt_flops(wasted),
                )
            )
        widths = [max(len(r[i]) for r in table) for i in range(len(headers))]
        for index, row in enumerate(table):
            lines.append(
                "  ".join(
                    cell.ljust(widths[i]) if i == 0 else cell.rjust(widths[i])
                    for i, cell in enumerate(row)
                )
            )
            if index == 0:
                lines.append("  ".join("-" * w for w in widths))
        lines.append("")
        for name in sorted(sites):
            for example in sites[name].get("retrace_signatures") or []:
                signature = str(example.get("signature", "?"))
                if len(signature) > 200:  # display only; registries are exact
                    signature = signature[:200] + "…"
                lines.append(
                    f"retrace: {name} x{example.get('count', 1)} "
                    f"triggered by {signature}"
                )
        if any(s.get("retrace_signatures") for s in sites.values()):
            lines.append("")
    ledger = report["ledger"]
    if ledger:
        lines.append("transfer ledger:")
        measured = report.get("measured_link") or {}
        for direction in sorted(ledger):
            total = ledger[direction]
            # rate from timed entries only (efficiency_report computes
            # it); untimed bulk bytes must not inflate the roofline
            rate = ""
            if f"{direction}_MBps" in measured:
                rate = f" @ {measured[f'{direction}_MBps']} MB/s measured"
            wasted_total = int(total.get("wasted") or 0)
            lines.append(
                f"  {direction}: {_fmt_bytes(total['bytes'])} MB in "
                f"{total['events']} transfer(s){rate}"
                + (
                    f"; {_fmt_bytes(wasted_total)} MB pad (wasted)"
                    if wasted_total
                    else ""
                )
            )
            for site in sorted(total["by_site"]):
                entry = total["by_site"][site]
                wasted = int(entry.get("wasted") or 0)
                lines.append(
                    f"    {site}: {_fmt_bytes(entry['bytes'])} MB "
                    f"({entry['events']})"
                    + (
                        f", {_fmt_bytes(wasted)} MB pad"
                        if wasted
                        else ""
                    )
                )
        lines.append("")
    collectives = report.get("collectives")
    if collectives:
        per_kind = ", ".join(
            f"{name} x{count} "
            f"({_fmt_bytes(collectives['bytes'].get(name, 0))} MB)"
            for name, count in sorted(collectives["counts"].items())
        ) or "none"
        lines.append(
            f"collectives (mesh witness, {len(collectives['workers'])} "
            f"worker dump(s), {collectives['violations']} violation(s)): "
            f"{per_kind}"
        )
        for worker in sorted(collectives["workers"]):
            row = collectives["workers"][worker]
            issued = sum(row["counts"].values())
            moved = sum(row["bytes"].values())
            lines.append(
                f"    {worker}: {issued} collective(s), "
                f"{_fmt_bytes(moved)} MB operand"
            )
        lines.append("")
    if totals["padded_rows"]:
        lines.append(
            f"overall occupancy: {100 * totals['occupancy']:.1f}% "
            f"({totals['real_rows']} real rows of {totals['padded_rows']} "
            f"dispatched; est {_fmt_flops(totals['est_wasted_flops'])} "
            "FLOPs spent on padding)"
        )
    memory = report["memory"]
    if memory.get("samples"):
        stage = memory.get("peak_stage") or "-"
        worker = memory.get("peak_worker") or "-"
        lines.append(
            f"device memory peak: {_fmt_bytes(memory['peak_bytes'])} MB "
            f"(stage {stage}, worker {worker}, "
            f"{memory['samples']} sample(s))"
        )
    elif memory.get("supported") is False:
        lines.append(
            "device memory: backend exposes no memory_stats/live_arrays; "
            "watermarks unavailable"
        )
    for warning in report["warnings"]:
        lines.append(f"warning: {warning}")
    return "\n".join(lines).rstrip() + "\n"
