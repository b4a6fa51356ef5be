"""The guard ladder: device-boundary fault domains.

The port's copy of ``sctools_tpu.guard``. It shrinks the blast radius of a
failure at the device boundary from the task to the batch or the record:

- **Taxonomy** (:mod:`.errors`): every exception crossing the device
  boundary classifies as ``Transient`` / ``ResourceExhausted`` /
  ``PoisonData`` / ``Fatal`` (the torch table is the module's), and
  recovery is decided by class, not by call site.
- **Batch-granular recovery** (:func:`run_batch`): transient errors retry
  in place with jittered backoff under the same scheduler lease (no sched
  attempt burned, no ``failed`` journal event); a device OOM bisects the
  batch at entity boundaries down to a floor and merges the partial
  results (a bisected piece pads to its own bucket, ``sub_pad_to``);
  poison isolates the offending record range by probe bisection,
  quarantines it to a sidecar (:mod:`.quarantine`) and continues with the
  remainder.
- **Stall watchdogs** (:mod:`.watchdog`): deadline timers on the
  decode/upload/compute/pull legs (``SCTOOLS_TPU_GUARD_TIMEOUT_*``) fire a
  flight record and a ``Transient``.
- **Strikes** (:mod:`.degrade`): a device failure that the ladder cannot
  absorb counts toward its site; the port has no rung to degrade to (port
  rule 4), so no site ever degrades.

Every recovery re-runs the same device path: a retry, a bisected half or a
filtered remainder goes back to the card and the same kernel, never to the
CPU or to a plain version. Call sites, at JAX's names: the streaming
gatherers (``gatherer.dispatch``, single and sharded), the count matrix
(``count.dispatch``), the distributed sort (``sort.dispatch``), the
whitelist kernel (``whitelist.correct``), ``ingest.upload`` and every
``ingest.pull``. Faults come from the ``SCTOOLS_TPU_FAULTS`` grammar
(``device_oom``, ``xla_transient``, ``stall``, ``corrupt_record``;
``sched.faults``). The README's guard section is the operator's guide.
"""

from __future__ import annotations

import os
import random
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from ..analysis.witness import make_lock
from ..obs import audit
from . import degrade, quarantine, watchdog
from .errors import (
    FATAL,
    POISON,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    Fatal,
    GuardError,
    NativeDecodeError,
    PoisonData,
    ResourceExhausted,
    Stall,
    Transient,
    classify,
)

__all__ = [
    "Fatal",
    "GuardError",
    "NativeDecodeError",
    "PoisonData",
    "ResourceExhausted",
    "Stall",
    "Transient",
    "classify",
    "degrade",
    "entity_splitter",
    "in_bisected_sub",
    "key_splitter",
    "quarantine",
    "retrying",
    "run_batch",
    "sub_pad_to",
    "watchdog",
]

ENV_RETRIES = "SCTOOLS_TPU_GUARD_RETRIES"
DEFAULT_RETRIES = 3
# transient backoff: full jitter over an exponential ceiling. Short on
# purpose — these are in-lease retries under a heartbeating lease, and a
# real transient (runtime hiccup, link reset) clears in well under a
# second or not at all.
BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 2.0

_rng = random.Random()


def configured_retries() -> int:
    """Bounded in-place retries per transient failure (env knob, >=0)."""
    raw = os.environ.get(ENV_RETRIES, "")
    if raw:
        try:
            value = int(raw)
            if value >= 0:
                return value
        except ValueError:
            pass
    return DEFAULT_RETRIES


def _backoff_sleep(attempt: int) -> None:
    ceiling = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2 ** max(0, attempt - 1)))
    delay = ceiling * (0.5 + 0.5 * _rng.random())
    obs.count("guard_backoff_seconds", delay)
    time.sleep(delay)


# ------------------------------------------------- open-retry flight state

# site -> state of the retry ladder currently executing there; captured
# into flight records so a SIGTERM/crash postmortem shows which guarded
# calls were mid-recovery when the process died
_open_lock = make_lock("guard.open_retries")
_open_retries: Dict[str, Dict[str, Any]] = {}


def _note_open(site: str, attempt: int, offset: int, records: int) -> None:
    with _open_lock:
        _open_retries[site] = {
            "attempt": attempt,
            "offset": int(offset),
            "records": int(records),
        }


def _clear_open(site: str) -> None:
    with _open_lock:
        _open_retries.pop(site, None)


# death-path safe (obs.bounded_snapshot): the flight dump may run inside
# a signal handler that interrupted a _note_open holder on this thread
open_retries = obs.bounded_snapshot(
    _open_lock,
    lambda: {site: dict(state) for site, state in _open_retries.items()},
    {},
)
open_retries.__doc__ = (
    "Snapshot of guarded calls currently in their attempt loop."
)


obs.register_flight_section("guard_retries", open_retries)
obs.register_flight_section("guard_degraded", degrade.degraded_sites)


# --------------------------------------------------------- fault plumbing

def _device_fault(site: str, name: str) -> None:
    # deferred import: sched.faults lazily imports guard.errors, so a
    # module-level import here would be a cycle
    from ..sched import faults

    faults.device_fault(site, name)


def _poison_check(site: str, name: str, start: int, stop: int) -> None:
    from ..sched import faults

    faults.poison_check(site, name, start, stop)


# ------------------------------------------------------------- retrying()

def retrying(
    fn: Callable[[], Any],
    *,
    site: str,
    name: str = "",
    retries: Optional[int] = None,
    leg: Optional[str] = None,
    degrade_site: Optional[str] = None,
) -> Any:
    """Run ``fn()`` under the transient retry ladder (no frame semantics).

    The lightweight guard for device crossings that have no record-range
    structure to bisect (uploads, pulls, the distributed sort's compiled
    step, whitelist kernels): transient failures retry in place with
    jittered backoff; resource exhaustion and exhausted retries note a
    device failure toward the site's degradation threshold and re-raise;
    fatal errors propagate untouched. ``leg`` names the stall-watchdog
    deadline ("upload"/"compute"/"pull") covering the attempt,
    INCLUDING any injected stall fault, which fires inside the deadline
    so the chaos grammar exercises the same interrupt path a real stall
    takes. ``degrade_site`` redirects the device-failure strikes to a
    different site's strike count (``ingest.pull`` counts a writeback
    failure toward the owning dispatch site while faults, retry counters,
    and the ledger stay on the pull site); default: the strikes land on
    ``site`` itself. Zero overhead on the
    no-fault path beyond one armed-faults check.
    """
    limit = configured_retries() if retries is None else retries
    timeout = watchdog.leg_timeout(leg) if leg else 0.0
    attempt = 0
    while True:
        done = False
        value = None
        try:
            if timeout > 0:
                with watchdog.deadline(leg, site=site, seconds=timeout):
                    _device_fault(site, name)
                    value = fn()
                    done = True
            else:
                _device_fault(site, name)
                value = fn()
                done = True
            return value
        except Exception as error:  # noqa: BLE001 - classified below
            if done and isinstance(error, Stall):
                return value  # the leg finished; the late Stall is noise
            kind = classify(error)
            if kind == TRANSIENT and attempt < limit:
                attempt += 1
                obs.count("guard_transient_retries")
                obs.count(f"guard_retries_{site.replace('.', '_')}")
                _backoff_sleep(attempt)
                continue
            if kind in (TRANSIENT, RESOURCE_EXHAUSTED):
                degrade.note_device_failure(degrade_site or site)
            raise


# ------------------------------------------------------------ run_batch()

def _slice(frame, start: int, stop: int):
    from ..io.packed import slice_frame

    return slice_frame(frame, start, stop)


def _kept_stretches(n: int, drops: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The complement of ``drops`` within [0, n) (frame-local ranges)."""
    kept: List[Tuple[int, int]] = []
    cursor = 0
    for start, stop in sorted(drops):
        if start > cursor:
            kept.append((cursor, min(start, n)))
        cursor = max(cursor, stop)
    if cursor < n:
        kept.append((cursor, n))
    return kept


def _drop_ranges(frame, ranges: List[Tuple[int, int]]):
    """``frame`` minus the frame-local record ``ranges`` (order preserved).

    Clean stretches are sliced and re-concatenated; slices share the
    parent's vocabularies, so codes stay valid and entities stay intact
    minus exactly the dropped records — the committed output equals a
    fault-free run over the input with those records removed.
    """
    from functools import reduce

    from ..io.packed import concat_frames

    kept = _kept_stretches(frame.n_records, ranges)
    if not kept:
        return _slice(frame, 0, 0)
    return reduce(concat_frames, [_slice(frame, a, b) for a, b in kept])


def key_splitter(key_of: Callable[[Any], Any]) -> Callable[[Any], Optional[int]]:
    """A bisection cut chooser that never splits a key group across batches.

    Returns the group boundary nearest the midpoint (preferring the last
    one at or below it), or None when the frame holds a single group —
    the bisection floor for pipelines whose per-batch results merge by
    group (entities for the gatherers, query names for counting).
    Splitting mid-group would resolve one group as two, so the floor is
    the smallest group-bounded range.
    """
    import numpy as np

    def split(frame) -> Optional[int]:
        key = key_of(frame)
        boundaries = np.nonzero(key[1:] != key[:-1])[0] + 1
        if boundaries.size == 0:
            return None
        half = frame.n_records // 2
        at_or_below = boundaries[boundaries <= half]
        return int(at_or_below[-1] if at_or_below.size else boundaries[0])

    return split


def entity_splitter(entity_kind: str) -> Callable[[Any], Optional[int]]:
    """The gatherers' cut chooser: entity boundaries only."""
    return key_splitter(
        lambda frame: frame.cell if entity_kind == "cell" else frame.gene
    )


# whether the fn invocation currently executing on this thread received a
# BISECTED piece (vs the top-level, possibly poison-filtered, frame) —
# the exact discriminator sub_pad_to needs: a filtered remainder keeps
# the parent's pinned shape (it never OOMed), while a bisected piece must
# never redispatch at the very padded shape that just OOMed
_sub_tls = threading.local()


def in_bisected_sub() -> bool:
    """True while fn runs on a piece produced by OOM/poison bisection."""
    return getattr(_sub_tls, "bisected", False)


def sub_pad_to(pad_to: int) -> int:
    """Pad target for the sub-frame ``run_batch`` handed to a call site.

    One policy, next to the mechanism that produces partial frames: the
    top-level frame (possibly a poison-filtered remainder) keeps the
    pinned ``pad_to`` — same compiled shape, no new bucket — while ANY
    bisected piece pads to its own existing bucket, whatever its size: a
    piece cut past the midpoint re-padded to the parent's shape would
    deterministically OOM again.
    """
    return 0 if in_bisected_sub() else pad_to


def _isolate_poison(
    site: str,
    name: str,
    frame,
    offset: int,
    validate: Optional[Callable[[Any, int], None]],
) -> List[Tuple[int, int, str]]:
    """Probe-bisect [offset, offset+n) for poisoned records (no dispatch).

    The probe is the armed ``corrupt_record`` fault check plus the
    caller's optional ``validate(sub_frame, sub_offset)``; neither
    touches the device, so bisection may cut at ANY record index — the
    isolation is record-exact and the clean remainder dispatches exactly
    once afterwards, entities intact. With no faults armed and no
    validator this is a single no-op check.
    """
    found: List[Tuple[int, int, str]] = []

    def scan(start: int, stop: int) -> None:
        try:
            _poison_check(site, name, start, stop)
            if validate is not None:
                validate(_slice(frame, start - offset, stop - offset), start)
        except PoisonData as error:
            localized = getattr(error, "record_range", None)
            if localized is not None:
                a = max(start, int(localized[0]))
                b = min(stop, int(localized[1]))
                if a < b:
                    found.append((a, b, f"{type(error).__name__}: {error}"))
                    # the raiser localized one range; the rest of the
                    # window may hold more
                    scan(start, a)
                    scan(b, stop)
                    return
            if stop - start <= 1:
                found.append(
                    (start, stop, f"{type(error).__name__}: {error}")
                )
                return
            mid = (start + stop) // 2
            scan(start, mid)
            scan(mid, stop)

    if frame.n_records:
        scan(offset, offset + frame.n_records)
    found.sort()
    return found


def run_batch(
    fn: Callable[[Any, int], Any],
    frame,
    *,
    site: str,
    name: str = "",
    offset: int = 0,
    splitter: Optional[Callable[[Any], Optional[int]]] = None,
    validate: Optional[Callable[[Any, int], None]] = None,
    retries: Optional[int] = None,
) -> List[Any]:
    """Dispatch one batch through the full recovery ladder.

    ``fn(sub_frame, sub_offset)`` performs the device work for a
    (possibly bisected/filtered) frame whose first record sits at
    absolute stream index ``sub_offset``. Returns the list of ``fn``
    results in record order — length 1 on the happy path, more after an
    OOM bisection, fewer (possibly empty) after quarantine.

    Ladder, in order:

    1. record-exact poison isolation by probe bisection (armed
       ``corrupt_record`` faults + ``validate``); isolated ranges are
       quarantined to sidecars and dropped from the frame;
    2. the attempt loop: transient errors retry in place (bounded,
       jittered, counted — and WITHOUT burning a scheduler attempt);
    3. ``ResourceExhausted`` bisects at ``splitter``'s cut (entity
       boundaries for the gatherers) and merges partial results; at the
       floor it notes a device failure and re-raises;
    4. a ``PoisonData`` raised by ``fn`` itself quarantines its
       localized range and retries the remainder, or bisects via
       ``splitter`` when unlocalized, quarantining the floor range;
    5. ``Fatal`` (and exhausted transients) propagate to the scheduler.
    """
    limit = configured_retries() if retries is None else retries
    if frame is None or frame.n_records == 0:
        return []
    # hot-path fast gate: with no validator and no armed faults the
    # poison probe cannot fire — skip the scan machinery entirely (the
    # ladder rides every batch; chip_smoke.py prints its idle cost)
    from ..sched import faults

    if validate is None and not faults.armed():
        poisoned = []
    else:
        poisoned = _isolate_poison(site, name, frame, offset, validate)
    drops: List[Tuple[int, int]] = []
    if poisoned:
        for start, stop, reason in poisoned:
            quarantine.record_quarantine(site, start, stop, reason, name=name)
        drops = [(a - offset, b - offset) for a, b, _ in poisoned]
    results: List[Any] = []
    _attempt_range(
        fn, frame, offset, results, site, name, splitter, limit, drops
    )
    return results


def _unfiltered_index(position: int, drops: List[Tuple[int, int]]) -> int:
    """Map a record index in the FILTERED frame back to the original.

    ``drops`` are original-local ranges already removed; every drop at or
    before the mapped position shifts it right by the drop's width. Also
    correct for CUT boundaries (index of the first right-hand record).
    """
    for start, stop in sorted(drops):
        if start <= position:
            position += stop - start
        else:
            break
    return position


def _attempt_range(
    fn, frame, offset: int, results: List[Any], site: str, name: str,
    splitter, limit: int, drops: Optional[List[Tuple[int, int]]] = None,
    bisected: bool = False,
) -> None:
    """The attempt loop over ONE original frame segment.

    ``frame`` is always the ORIGINAL (unfiltered) segment whose first
    record sits at stream-absolute index ``offset``; ``drops`` holds the
    original-local ranges already quarantined out of it. Keeping the
    original + drop list (instead of mutating the frame) means every
    coordinate that leaves this function — sidecar ranges, bisection
    offsets, localized-poison translations — stays stream-absolute even
    after mid-frame records were removed.
    """
    drops = list(drops or ())
    attempt = 0
    # hoisted: the compute deadline is env-fixed for the life of the
    # attempt loop, and entering the (generator-backed) context is pure
    # overhead when the watchdog is off
    compute_timeout = watchdog.leg_timeout("compute")
    while True:
        filtered = _drop_ranges(frame, drops) if drops else frame
        if filtered.n_records == 0:
            return
        _note_open(site, attempt, offset, filtered.n_records)
        # belt to the watchdog's own late-delivery suspenders: when a
        # Stall slips in AFTER fn returned (async delivery races the
        # deadline exit), the computed value must stand — retrying a
        # finished dispatch would append its results twice
        done = False
        value = None
        previous_bisected = getattr(_sub_tls, "bisected", False)
        _sub_tls.bisected = bisected
        try:
            if compute_timeout > 0:
                with watchdog.deadline(
                    "compute", site=site, seconds=compute_timeout
                ):
                    _device_fault(site, name)
                    value = fn(filtered, offset)
                    done = True
            else:
                _device_fault(site, name)
                value = fn(filtered, offset)
                done = True
            # conservation ledger: these records were ACTUALLY computed
            # (post poison-filter, post bisection) — counted only on
            # dispatch success, so a retried attempt never double-counts
            audit.add("records.computed", filtered.n_records)
            results.append(value)
            return
        except Exception as error:  # noqa: BLE001 - classified below
            if done and isinstance(error, Stall):
                audit.add("records.computed", filtered.n_records)
                results.append(value)
                return
            kind = classify(error)
            if kind == TRANSIENT:
                if attempt < limit:
                    attempt += 1
                    obs.count("guard_transient_retries")
                    obs.count(f"guard_retries_{site.replace('.', '_')}")
                    _backoff_sleep(attempt)
                    continue
                degrade.note_device_failure(site)
                raise
            if kind in (RESOURCE_EXHAUSTED, POISON):
                if kind == RESOURCE_EXHAUSTED:
                    obs.count("guard_oom_events")
                    # the failed attempt's tensors live on in its
                    # traceback's frames: clear their locals, so that the
                    # allocator has that memory back before the pieces run
                    # (the traceback itself stays for a re-raise)
                    traceback.clear_frames(error.__traceback__)
                else:
                    localized = getattr(error, "record_range", None)
                    if localized is not None:
                        # fn computed the range on the FILTERED frame
                        # (offset + filtered-local); translate through
                        # the drops so the sidecar names the records'
                        # true stream positions
                        local0 = max(0, int(localized[0]) - offset)
                        local1 = min(
                            filtered.n_records, int(localized[1]) - offset
                        )
                        if local0 < local1:
                            orig0 = _unfiltered_index(local0, drops)
                            orig1 = _unfiltered_index(local1 - 1, drops) + 1
                            # a translated range may STRADDLE earlier
                            # drops; emit one sidecar entry per still-kept
                            # stretch so already-quarantined records are
                            # never named (or counted) twice. Non-empty by
                            # construction: orig0 maps a kept record.
                            clamped = [
                                (max(a, orig0) - orig0, min(b, orig1) - orig0)
                                for a, b in drops
                                if b > orig0 and a < orig1
                            ]
                            fresh = [
                                (orig0 + a, orig0 + b)
                                for a, b in _kept_stretches(
                                    orig1 - orig0, clamped
                                )
                            ]
                            for a, b in fresh:
                                quarantine.record_quarantine(
                                    site, offset + a, offset + b,
                                    f"{type(error).__name__}: {error}",
                                    name=name,
                                )
                            drops.extend(fresh)
                            continue  # retry fn on the filtered remainder
                # bisect: the splitter chooses a cut on the FILTERED view
                # (group boundaries there are group boundaries), mapped
                # back to an original-coordinate cut so both halves keep
                # stream-absolute offsets and their share of the drops
                cut = splitter(filtered) if splitter is not None else None
                if cut:
                    if kind == RESOURCE_EXHAUSTED:
                        obs.count("guard_oom_bisections")
                    cut_orig = _unfiltered_index(cut, drops)
                    with obs.span(
                        "guard:bisect", site=site,
                        records=filtered.n_records, cut=int(cut_orig),
                    ):
                        pass
                    left_drops = [
                        (a, min(b, cut_orig))
                        for a, b in drops if a < cut_orig
                    ]
                    right_drops = [
                        (max(a, cut_orig) - cut_orig, b - cut_orig)
                        for a, b in drops if b > cut_orig
                    ]
                    _attempt_range(
                        fn, _slice(frame, 0, cut_orig), offset, results,
                        site, name, splitter, limit, left_drops,
                        bisected=True,
                    )
                    _attempt_range(
                        fn, _slice(frame, cut_orig, frame.n_records),
                        offset + cut_orig, results, site, name, splitter,
                        limit, right_drops, bisected=True,
                    )
                    return
                if kind == RESOURCE_EXHAUSTED:
                    degrade.note_device_failure(site)
                    raise
                # unsplittable poison floor: quarantine every kept
                # stretch of this segment and move on
                for start, stop in _kept_stretches(frame.n_records, drops):
                    quarantine.record_quarantine(
                        site, offset + start, offset + stop,
                        f"{type(error).__name__}: {error}", name=name,
                    )
                return
            raise
        finally:
            _sub_tls.bisected = previous_bisected
            _clear_open(site)
