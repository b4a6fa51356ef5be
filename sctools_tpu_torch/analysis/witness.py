"""Runtime lock witness: the dynamic half of the race pass's contract.

The port's copy of ``sctools_tpu.analysis.witness``, with the same
variables, semantics and snapshot format, so that one setting drives both
packages. The static pass (:mod:`.racecheck`) proves properties about a
model of the package's locks; this module checks the model against live
runs. Every inventoried lock of the port is created through
:func:`make_lock` / :func:`make_rlock` with a stable name — the name the
static pass reads from the call's string argument, so the two sides share
one vocabulary.

Off by default, and off means OFF: with ``SCTOOLS_TPU_LOCK_DEBUG`` unset
(or anything but ``1``) the factories return the raw ``threading.Lock``
/ ``RLock`` object — not a proxy, not a subclass — so the hot path holds
exactly the lock it held before this module existed.

With ``SCTOOLS_TPU_LOCK_DEBUG=1`` each factory returns a
:class:`WitnessLock` proxy that records, per acquisition:

- the **observed acquisition-order edge** ``held -> acquired`` for every
  lock the acquiring thread already holds (the runtime lock-order
  graph);
- a **cycle check**: a BLOCKING edge that closes a cycle of blocking
  edges in the observed graph is a real ABBA interleaving — recorded as
  a violation, announced on stderr, and flight-dumped at once (see below);
- a **static-graph check**: when ``SCTOOLS_TPU_LOCK_GRAPH`` points at a
  graph emitted by ``python -m sctools_tpu_torch.analysis
  --emit-lock-graph``, any observed BLOCKING edge missing from the static
  model is a violation — the model lied. Bounded (``timeout=``) acquires
  are recorded for diagnosis but exempt from both checks, mirroring the
  static SCX401 semantics: they cannot deadlock permanently;
- a **stall check**: a blocking acquire that waits longer than
  ``SCTOOLS_TPU_LOCK_DEBUG_STALL_S`` (default 30) records a violation
  and flight-dumps before continuing to wait, so a real deadlock leaves a
  diagnosis instead of a hung process.

The dump is ``$SCTOOLS_TPU_TRACE/locks.<worker>.json``, where the
directory and ``<worker>`` are :func:`sctools_tpu_torch.obs.configured_trace_dir`
and :func:`~sctools_tpu_torch.obs.configured_worker_name` (the scheduler's
worker id, else ``SCTOOLS_TPU_TRACE_WORKER``, else ``<hostname>-<pid>``):
``{"edges": [...], "violations": [...], "acquires": {...}, ...}``. It is
written at interpreter exit (when ``SCTOOLS_TPU_TRACE`` is set). A cycle
or a stall persists its postmortem at once, as a flight record
(``obs.flight_dump(reason="lock-witness:<kind>")``: the span ring, the
open spans and the registered sections of a process that may be about to
deadlock); the dump's own acquisitions are witnessed too, and a
thread-local guard stops a violation found there from recursing.

Like the rest of the analysis package this module is pure stdlib.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

ENV_FLAG = "SCTOOLS_TPU_LOCK_DEBUG"
ENV_GRAPH = "SCTOOLS_TPU_LOCK_GRAPH"
ENV_STALL = "SCTOOLS_TPU_LOCK_DEBUG_STALL_S"
DEFAULT_STALL_S = 30.0

__all__ = [
    "WitnessLock",
    "enabled",
    "make_lock",
    "make_rlock",
    "observed_edges",
    "violations",
    "acquire_counts",
    "snapshot",
    "dump",
    "reset",
]


def enabled() -> bool:
    """Whether lock witnessing is on (``SCTOOLS_TPU_LOCK_DEBUG=1``)."""
    return os.environ.get(ENV_FLAG, "") == "1"


def stall_seconds() -> float:
    """Blocking-acquire wait that counts as a stall (env knob, > 0).

    Garbage or non-positive values fall back to the default — the same
    forgiving env contract as the watchdog deadlines.
    """
    raw = os.environ.get(ENV_STALL, "")
    if raw:
        try:
            value = float(raw)
            if value > 0:
                return value
        except ValueError:
            pass
    return DEFAULT_STALL_S


# witness bookkeeping state. _meta is a RAW lock (never witnessed, held
# only for dict/set updates, never while acquiring a witnessed lock or
# firing a flight dump) so the witness itself cannot deadlock the code it
# observes. The WRITE paths (_record_acquired/_record_violation, which a
# signal handler's flight dump re-enters through its bounded WitnessLock
# acquires) take _meta with a bounded acquire and drop the record on
# timeout, as the JAX package's witness does.
_meta = threading.Lock()
_META_TIMEOUT_S = 1.0
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
_acquires: Dict[str, int] = {}
_violations: List[Dict[str, Any]] = []
_static_edges: Optional[Set[Tuple[str, str]]] = None
_static_path: Optional[str] = None
_static_loaded = False
_dump_registered = False
_tls = threading.local()


def _held_stack() -> List[Tuple[str, Any]]:
    """(name, proxy) entries this thread currently holds, oldest first."""
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _load_static() -> Optional[Set[Tuple[str, str]]]:
    global _static_edges, _static_loaded, _static_path
    if _static_loaded:
        return _static_edges
    if not _meta.acquire(timeout=_META_TIMEOUT_S):
        return _static_edges  # death-path safety: never block here
    try:
        if _static_loaded:
            return _static_edges
        path = os.environ.get(ENV_GRAPH, "").strip()
        edges: Optional[Set[Tuple[str, str]]] = None
        if path:
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                edges = {
                    (str(e["from"]), str(e["to"]))
                    for e in data.get("edges", ())
                }
                _static_path = path
            except (OSError, ValueError, KeyError, TypeError):
                # an unreadable graph must not crash the instrumented
                # process; the smoke comparing dumps will catch it
                edges = None
        _static_edges = edges
        _static_loaded = True
    finally:
        _meta.release()
    return _static_edges


def _has_path(start: str, goal: str) -> bool:
    """Whether the observed BLOCKING edges have a path start -> goal.

    Bounded edges are excluded: a cycle through a bounded acquire cannot
    deadlock permanently (the static SCX401 pass draws the same line).
    Called under ``_meta``; the graph is tiny (one node per named lock),
    so an iterative DFS is plenty.
    """
    seen = {start}
    frontier = [start]
    while frontier:
        node = frontier.pop()
        if node == goal:
            return True
        for (a, b), entry in _edges.items():
            if a == node and not entry["bounded"] and b not in seen:
                seen.add(b)
                frontier.append(b)
    return False


def _record_violation(kind: str, detail: Dict[str, Any]) -> None:
    entry = dict(detail)
    entry["kind"] = kind
    entry["thread"] = threading.current_thread().name
    if _meta.acquire(timeout=_META_TIMEOUT_S):
        try:
            _violations.append(entry)
        finally:
            _meta.release()
    try:
        sys.stderr.write(
            f"sctools-tpu lock-witness: {kind}: "
            f"{json.dumps(entry, sort_keys=True, default=str)}\n"
        )
        sys.stderr.flush()
    except OSError:
        pass
    if kind in ("cycle", "stall"):
        # a real inversion or a wedged blocking acquire: persist the
        # postmortem NOW (the process may be about to deadlock). The
        # flight dump's own acquisitions are re-witnessed; the guard
        # below stops a violation found there from recursing.
        if getattr(_tls, "announcing", False):
            return
        _tls.announcing = True
        try:
            from .. import obs

            obs.flight_dump(reason=f"lock-witness:{kind}")
        except Exception:  # noqa: BLE001 - diagnosis must never be fatal
            pass
        finally:
            _tls.announcing = False


def _record_acquired(proxy: "WitnessLock", bounded: bool) -> None:
    """Bookkeeping after a successful acquire (edge, cycle, subgraph)."""
    stack = _held_stack()
    name = proxy.name
    reentrant = proxy.reentrant and any(
        entry[1] is proxy for entry in stack
    )
    static = _load_static()
    check_edges: List[Tuple[str, str]] = []
    cycle_from: Optional[str] = None
    if not reentrant:
        held_names = []
        for held_name, held_proxy in stack:
            if held_proxy is proxy or held_name == name:
                continue
            if held_name not in held_names:
                held_names.append(held_name)
        if not _meta.acquire(timeout=_META_TIMEOUT_S):
            # a signal handler's bounded WitnessLock acquire may land
            # while the interrupted thread holds _meta — drop the record
            # rather than block (the held stack below stays consistent;
            # it is thread-local)
            stack.append((name, proxy))
            return
        try:
            _acquires[name] = _acquires.get(name, 0) + 1
            for held_name in held_names:
                key = (held_name, name)
                entry = _edges.get(key)
                if entry is None:
                    # cycle check BEFORE inserting: a path from the new
                    # edge's head back to its tail means two threads
                    # disagree about the order of these locks. BOUNDED
                    # acquires are recorded for diagnosis but face
                    # neither the cycle nor the static-graph check —
                    # they cannot deadlock permanently, and a death
                    # path's bounded acquire runs under whatever locks
                    # the interrupted thread happened to hold, which no
                    # static model can enumerate (same line the static
                    # SCX401 pass draws)
                    if not bounded and _has_path(name, held_name):
                        cycle_from = held_name
                    _edges[key] = {"count": 1, "bounded": bool(bounded)}
                    if not bounded:
                        check_edges.append(key)
                else:
                    entry["count"] += 1
                    if not bounded and entry["bounded"]:
                        # first BLOCKING observation of an edge so far
                        # seen only bounded: it now participates in
                        # deadlock analysis — run the checks it skipped
                        entry["bounded"] = False
                        if cycle_from is None and _has_path(
                            name, held_name
                        ):
                            cycle_from = held_name
                        check_edges.append(key)
        finally:
            _meta.release()
    else:
        if _meta.acquire(timeout=_META_TIMEOUT_S):
            try:
                _acquires[name] = _acquires.get(name, 0) + 1
            finally:
                _meta.release()
    stack.append((name, proxy))
    if cycle_from is not None:
        _record_violation(
            "cycle",
            {
                "edge": [cycle_from, name],
                "note": "observed acquisition order closes a cycle "
                "(potential ABBA deadlock)",
            },
        )
    if static is not None:
        for key in check_edges:
            if key not in static:
                _record_violation(
                    "unknown-edge",
                    {
                        "edge": list(key),
                        "graph": _static_path,
                        "note": "observed edge missing from the static "
                        "lock-order graph",
                    },
                )


class WitnessLock:
    """Instrumented stand-in for one named ``threading.Lock``/``RLock``.

    Same acquire/release/context-manager surface as the wrapped lock;
    every successful acquisition records order edges against the locks
    the thread already holds. Blocking acquires probe with a bounded
    wait first so a wedged lock is diagnosed (violation + flight dump) instead
    of silently hanging.
    """

    __slots__ = ("name", "reentrant", "_inner", "_owner_stack")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner_stack: Optional[List[Tuple[str, Any]]] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            got = self._inner.acquire(False)
            bounded = True
        elif timeout is not None and timeout >= 0:
            got = self._inner.acquire(True, timeout)
            bounded = True
        else:
            # bounded probe first: a wait past the stall threshold is a
            # diagnosable event, not a silent hang — record it, dump a
            # flight record, THEN block for real (semantics unchanged)
            got = self._inner.acquire(True, stall_seconds())
            if not got:
                _record_violation(
                    "stall",
                    {
                        "lock": self.name,
                        "waited_s": stall_seconds(),
                        "held": [n for n, _ in _held_stack()],
                    },
                )
                got = self._inner.acquire(True)
            bounded = False
        if got:
            try:
                _record_acquired(self, bounded)
            except BaseException:
                self._inner.release()
                raise
            if not self.reentrant:
                self._owner_stack = _held_stack()
        return got

    def release(self) -> None:
        stack = _held_stack()
        for index in range(len(stack) - 1, -1, -1):
            if stack[index][1] is self:
                del stack[index]
                break
        else:
            # threading.Lock permits release from a thread other than
            # the acquirer (handoff pattern); the held entry lives on
            # the ACQUIRING thread's stack and must go, or that thread's
            # next acquisition mints a phantom order edge. The identity
            # scan + remove both run under the GIL; a concurrent
            # same-entry removal by the owner surfaces as ValueError.
            owner = None if self.reentrant else self._owner_stack
            if owner is not None and owner is not stack:
                for entry in list(owner):
                    if entry[1] is self:
                        try:
                            owner.remove(entry)
                        except ValueError:
                            pass
                        break
        self._inner.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return inner_locked()
        # RLock has no locked(); approximate via a non-blocking probe
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name!r} reentrant={self.reentrant}>"


def _ensure_dump_registered() -> None:
    global _dump_registered
    if _dump_registered:
        return
    _dump_registered = True
    atexit.register(_dump_at_exit)


def make_lock(name: str):
    """A ``threading.Lock`` known to the race pass's inventory as ``name``.

    The raw lock when witnessing is off (a true no-op — the caller holds
    the very object ``threading.Lock()`` returns); the instrumented
    proxy when ``SCTOOLS_TPU_LOCK_DEBUG=1``. The static pass reads the
    same ``name`` from this call's source, so runtime edges and static
    edges share one vocabulary.
    """
    if not enabled():
        return threading.Lock()
    _ensure_dump_registered()
    return WitnessLock(name, reentrant=False)


def make_rlock(name: str):
    """:func:`make_lock` for ``threading.RLock`` (reentrant) locks."""
    if not enabled():
        return threading.RLock()
    _ensure_dump_registered()
    return WitnessLock(name, reentrant=True)


# ------------------------------------------------------------- read side

def observed_edges() -> Dict[Tuple[str, str], Dict[str, Any]]:
    """Snapshot of the observed order edges: (held, acquired) -> stats."""
    with _meta:
        return {key: dict(value) for key, value in _edges.items()}


def violations() -> List[Dict[str, Any]]:
    """Snapshot of recorded violations (cycle / unknown-edge / stall)."""
    with _meta:
        return [dict(v) for v in _violations]


def acquire_counts() -> Dict[str, int]:
    """Snapshot of per-lock acquisition counts."""
    with _meta:
        return dict(_acquires)


def snapshot() -> Dict[str, Any]:
    """The whole witness state as one JSON-safe dict (the dump payload)."""
    with _meta:
        edges = [
            {
                "from": a,
                "to": b,
                "count": entry["count"],
                "bounded": entry["bounded"],
            }
            for (a, b), entry in sorted(_edges.items())
        ]
        return {
            "enabled": enabled(),
            "edges": edges,
            "acquires": dict(_acquires),
            "violations": [dict(v) for v in _violations],
            "static_graph": _static_path,
        }


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the witness snapshot to ``path`` (default:
    ``$SCTOOLS_TPU_TRACE/locks.<worker>.json``).

    Returns the path written, or None when no destination is available.
    Atomic (tmp + replace).
    """
    target = path
    if target is None:
        from .. import obs

        base = obs.configured_trace_dir()
        if base is None:
            return None
        target = os.path.join(
            base, f"locks.{obs.configured_worker_name()}.json"
        )
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snapshot(), f, sort_keys=True, indent=1)
            f.write("\n")
        os.replace(tmp, target)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return target


def _dump_at_exit() -> None:
    try:
        dump()
    except Exception:  # noqa: BLE001 - exit hook must never raise
        pass


def reset() -> None:
    """Clear observed edges, counts, violations, and the graph cache
    (tests)."""
    global _static_edges, _static_loaded, _static_path
    with _meta:
        _edges.clear()
        _acquires.clear()
        _violations.clear()
        _static_edges = None
        _static_loaded = False
        _static_path = None
