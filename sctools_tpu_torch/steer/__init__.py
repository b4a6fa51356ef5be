"""Online steering: the serve worker's closed-loop occupancy controller.

The port of ``sctools_tpu.steer``. A per-worker controller over the
telemetry the plane already emits: it reads the worker's own pulse
heartbeats (occupancy, bubble_fraction, limiting_stage, retrace flag) over
a sliding window and, each decision epoch, moves at most one of three
knobs to hold occupancy above target and bubble_fraction below it:

1. **next-lease chunk sizing**: :meth:`SteerController.chunk_records`
   bounds how many estimated decoded rows the serve engine coalesces into
   one admitted group, so groups land near a bucket boundary instead of
   just past one;
2. **packer bucket selection**: :meth:`SteerController.batch_records`
   picks the cross-tenant packing capacity: deeper into a larger bucket
   when occupancy is high, and when it sags with ample windowed traffic,
   coalesce up (in a pow2-padding plane sagging occupancy is floor-padded
   fragmentation, and only a bigger bucket fixes it online; only thin
   traffic argues for a smaller bucket, which the pinned floor usually
   refuses, and that refusal is the journaled offline evidence);
3. **prefetch/ring depth**: when ``limiting_stage`` names ``decode`` or
   ``h2d``, :func:`sctools_tpu_torch.utils.prefetch.set_depth_override`
   deepens the ingest ring and the prefetch pipeline.

Every actuation is validated before it is applied: a proposed bucket must
be a power of two, at or above the pinned ``RECORD_BUCKET_MIN`` floor,
inside the graph manifest's shape contract
(:func:`~sctools_tpu_torch.analysis.shardcheck.dim_admissible`), and resident.
On the port a rung is resident when warmup captured its CUDA graphs (the
calibration job ran through the gatherer at that bucket), so a steered
pack replays graphs of the shapes warmup reached; a new entity bucket at a
steered rung captures while serving, as the static policy does, and a
second capture of one key raises (``serve/graphs.py``). On telemetry loss,
a torn ring or an observed retrace the controller degrades loudly to the
static policy (bucket back to static, prefetch override cleared) and
journals it; it re-arms when healthy telemetry returns. No other path
leads from an armed controller to the static policy.

Every decision (inputs, proposal, verdict, reason) is a plain dict, JAX's,
which the serve engine journals as worker meta (``announce_worker({"steer":
snapshot, "steer_decision": decision})``): ``sched status``, ``obs
efficiency --suggest``, the ``sctools_tpu_steer_*`` gauges and
:func:`suggest_from_decisions` read that record, and each package reads
the other's.

Off by default behind ``SCTOOLS_TPU_STEER``, read once at import:
disabled, :func:`controller` returns the shared :data:`NOOP`, whose
accessors are the identity and whose snapshot is ``{"mode": "off"}``.
SCX1001 (``unguarded-actuation``, ``analysis/torchlint.py``) refuses knob
writes outside this module's validated apply path.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

ENV_FLAG = "SCTOOLS_TPU_STEER"

#: decision epoch: at most one fold + decision per this many seconds
DEFAULT_EPOCH_S = 0.5
#: sliding heartbeat window the fold reads
DEFAULT_WINDOW_S = 10.0
#: occupancy below this proposes a bucket move: coalesce up when the
#: window carries enough real traffic to fill a bigger bucket, downshift
#: when the traffic is genuinely thin
DEFAULT_OCCUPANCY_LOW = 0.5
#: occupancy above this proposes an upshift — the hysteresis gap between
#: the two bands is what keeps the controller from flapping on noise
DEFAULT_OCCUPANCY_HIGH = 0.85
#: bubble_fraction above this (with decode/h2d limiting) deepens prefetch
DEFAULT_BUBBLE_CEILING = 0.35
#: bounded actuation rate: at most one applied change per this interval
DEFAULT_MIN_ACTION_INTERVAL_S = 2.0
#: stages whose limiting verdict the prefetch knob answers
PREFETCH_LIMITED_STAGES = ("decode", "h2d")
#: in-memory decision history bound (journaling keeps the full record)
DECISION_KEEP = 512

MODE_OFF = "off"
MODE_STEERING = "steering"
MODE_STATIC = "static"  # degraded: telemetry loss / torn ring / retrace


def _env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() in (
        "1", "true", "yes", "on",
    )


# read ONCE at import (the pulse/slo discipline): flipping the env var
# mid-process must not change behaviour behind the worker's back
_enabled = _env_enabled()


def enabled() -> bool:
    return _enabled


class _NoopController:
    """Cached do-nothing controller: every accessor is identity.

    ``__slots__ = ()`` and a module-level singleton, so the disabled hot
    path allocates nothing.
    """

    __slots__ = ()
    enabled = False

    def decide(self, now: Optional[float] = None) -> Optional[dict]:
        return None

    def batch_records(self, static: int) -> int:
        return static

    def chunk_records(self, static: Optional[int]) -> Optional[int]:
        return static

    def prefetch_depth(self, static: int) -> int:
        return static

    def ladder(self) -> List[int]:
        return []

    def note_resident(self, bucket: int) -> None:
        return None

    def snapshot(self) -> Dict[str, Any]:
        return {"mode": MODE_OFF}

    def decisions(self) -> List[dict]:
        return []


NOOP = _NoopController()


class force:
    """Context manager: force steering on/off for a block (tests).

    Restores the import-time state on exit, mirroring ``slo.force``.
    """

    def __init__(self, on: bool = True):
        self._on = on
        self._was: Optional[bool] = None

    def __enter__(self) -> "force":
        global _enabled
        self._was = _enabled
        _enabled = self._on
        return self

    def __exit__(self, *exc) -> None:
        global _enabled
        _enabled = bool(self._was)


def controller(
    static_batch_records: int,
    contract: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
):
    """The per-worker controller, or the no-op singleton when disabled."""
    if not _enabled:
        return NOOP
    return SteerController(static_batch_records, contract=contract, **kwargs)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class SteerController:
    """Hysteresis state machine over one worker's pulse heartbeats.

    ``records_fn`` supplies the heartbeat window — by default the
    process's own :func:`~sctools_tpu_torch.obs.pulse.live_records`; tests
    inject a canned sequence (and a fake ``clock``) for deterministic
    replay.  It may return either a record list or a
    ``(records, torn_count)`` pair (the ring-reader shape); torn
    records degrade the controller to the static policy.
    """

    enabled = True

    def __init__(
        self,
        static_batch_records: int,
        contract: Optional[Dict[str, Any]] = None,
        *,
        epoch_s: float = DEFAULT_EPOCH_S,
        window_s: float = DEFAULT_WINDOW_S,
        occupancy_low: float = DEFAULT_OCCUPANCY_LOW,
        occupancy_high: float = DEFAULT_OCCUPANCY_HIGH,
        bubble_ceiling: float = DEFAULT_BUBBLE_CEILING,
        min_action_interval_s: float = DEFAULT_MIN_ACTION_INTERVAL_S,
        records_fn: Optional[Callable[[], Any]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        # the bucket vocabulary lives beside the engine (torch); the
        # offline readers below (load_decisions, suggest_from_decisions,
        # render_steer_metrics) run without it, as obs does
        from ..ops.segments import RECORD_BUCKET_MIN, bucket_size

        self._floor = RECORD_BUCKET_MIN
        static = bucket_size(int(static_batch_records))
        if not _is_pow2(static) or static < RECORD_BUCKET_MIN:
            raise ValueError(
                f"static batch bucket {static} outside the bucket "
                f"vocabulary (pow2 >= {RECORD_BUCKET_MIN})"
            )
        if not occupancy_low < occupancy_high:
            raise ValueError(
                "hysteresis bands must leave a gap: "
                f"occupancy_low={occupancy_low} >= "
                f"occupancy_high={occupancy_high}"
            )
        self._static = static
        self._bucket = static
        self._contract = contract
        self._epoch_s = float(epoch_s)
        self._window_s = float(window_s)
        self._occ_low = float(occupancy_low)
        self._occ_high = float(occupancy_high)
        self._bubble_ceiling = float(bubble_ceiling)
        self._min_action_s = float(min_action_interval_s)
        self._records_fn = records_fn
        if clock is None:
            # heartbeat ts live on the pulse clock (perf_counter since
            # pulse import); windowing on any other monotonic domain
            # would silently age every beat out of the window
            from ..obs import pulse as _pulse

            clock = _pulse.clock
        self._clock = clock
        self._mode = MODE_STEERING
        self._resident = {static}
        self._prefetch_override: Optional[int] = None
        self._last_epoch: Optional[float] = None
        self._last_action: Optional[float] = None
        self._seen_beats = False
        self._seq = 0
        self._decisions: List[dict] = []
        self._counts = {
            "applied": 0, "refused": 0, "held": 0,
            "degraded": 0, "steady": 0,
        }

    # ------------------------------------------------------ residency

    def ladder(self) -> List[int]:
        """Candidate buckets warmup should calibrate (static included).

        One step down and one step up from the static point — a bounded
        graph set, each validated against the same contract the apply
        path checks.  Warmup runs the calibration gather once per rung
        (capturing its graphs) and calls :meth:`note_resident`; only
        resident rungs are ever applied.
        """
        rungs = [self._static]
        down = self._static // 2
        if self._admissible(down) is None:
            rungs.insert(0, down)
        up = self._static * 2
        if self._admissible(up) is None:
            rungs.append(up)
        return rungs

    def note_resident(self, bucket: int) -> None:
        """Mark ``bucket`` as calibrated: its graphs were captured at warmup."""
        self._resident.add(int(bucket))

    # ------------------------------------------------------- accessors

    def batch_records(self, static: int) -> int:
        """Knob 2: the packer's target bucket (static when degraded)."""
        if self._mode != MODE_STEERING:
            return static
        return self._bucket

    def chunk_records(self, static: Optional[int]) -> Optional[int]:
        """Knob 1: target decoded rows per admitted lease group."""
        if self._mode != MODE_STEERING:
            return static
        return self._bucket

    def prefetch_depth(self, static: int) -> int:
        if self._mode != MODE_STEERING or self._prefetch_override is None:
            return static
        return self._prefetch_override

    def snapshot(self) -> Dict[str, Any]:
        return {
            "mode": self._mode,
            "static": self._static,
            "bucket": self._bucket,
            "prefetch_override": self._prefetch_override,
            "resident": sorted(self._resident),
            "decisions": self._seq,
            **dict(self._counts),
        }

    def decisions(self) -> List[dict]:
        return list(self._decisions)

    # -------------------------------------------------------- the loop

    def _admissible(self, bucket: int) -> Optional[str]:
        """None when ``bucket`` is a valid actuation point, else why not."""
        if not _is_pow2(bucket):
            return f"bucket {bucket} is not a power of two"
        if bucket < self._floor:
            return (
                f"bucket {bucket} below the pinned RECORD_BUCKET_MIN "
                f"floor {self._floor}"
            )
        if self._contract is not None:
            from ..analysis.shardcheck import dim_admissible

            if not dim_admissible(bucket, self._contract):
                return f"bucket {bucket} outside the shape contract"
        return None

    def _validate(self, bucket: int) -> Optional[str]:
        reason = self._admissible(bucket)
        if reason is not None:
            return reason
        if bucket not in self._resident:
            return f"bucket {bucket} has no resident executable"
        return None

    def _read(self) -> tuple:
        """(records, torn) from the injected or live heartbeat source."""
        if self._records_fn is not None:
            raw = self._records_fn()
        else:
            from ..obs import pulse

            raw = pulse.live_records()
        if isinstance(raw, tuple):
            records, torn = raw
            return list(records or []), int(torn or 0)
        return list(raw or []), 0

    def _degrade(self, reason: str) -> None:
        if self._mode != MODE_STATIC:
            sys.stderr.write(
                f"sctools-tpu steer: degrading to static policy: "
                f"{reason}\n"
            )
        self._mode = MODE_STATIC
        self._bucket = self._static
        if self._prefetch_override is not None:
            self._prefetch_override = None
            from ..utils.prefetch import set_depth_override

            set_depth_override(None)

    def decide(self, now: Optional[float] = None) -> Optional[dict]:
        """One control epoch: fold, propose, validate, apply, record.

        Returns the decision dict (for journaling) or None when inside
        the current epoch — the inter-epoch hot path is one clock read
        and one compare.
        """
        t = self._clock() if now is None else now
        if (
            self._last_epoch is not None
            and t - self._last_epoch < self._epoch_s
        ):
            return None
        self._last_epoch = t
        try:
            records, torn = self._read()
        except Exception as error:  # noqa: BLE001 - degrade, never raise
            return self._record(
                t, None, None, "degraded",
                f"telemetry read failed: {type(error).__name__}: {error}",
            )
        # warmup calibration beats are synthetic traffic: folding them
        # would steer against the ladder, not the tenants
        records = [r for r in records if r.get("task_id") != "warmup"]
        if not records:
            if not self._seen_beats:
                # not-yet-telemetry is not telemetry LOSS: before the
                # first real dispatch the controller waits quietly at
                # the static point instead of degrading loudly
                return self._record(
                    t, None, None, "steady",
                    "no heartbeats yet: holding the static point",
                )
            return self._record(
                t, None, None, "degraded", "telemetry loss: no heartbeats"
            )
        self._seen_beats = True
        if torn:
            return self._record(
                t, None, None, "degraded",
                f"torn ring: {torn} torn record(s)",
            )
        from ..obs import pulse

        row = pulse.worker_row(records, window_s=self._window_s, now=t)
        selected = pulse.select_window(records, self._window_s, t)
        inputs = {
            "occupancy": row.get("occupancy"),
            "bubble_fraction": row.get("bubble_fraction"),
            "limiting_stage": row.get("limiting_stage"),
            "heartbeats": row.get("heartbeats"),
            "real_rows": sum(r.get("real_rows", 0) for r in selected),
            "padded_rows": sum(r.get("padded_rows", 0) for r in selected),
            "retraces": row.get("retraces"),
            "torn": torn,
        }
        if row.get("retraces"):
            return self._record(
                t, inputs, None, "degraded",
                f"steady-state retrace observed ({row['retraces']})",
            )
        occupancy = row.get("occupancy")
        if occupancy is None:
            return self._record(
                t, inputs, None, "degraded",
                "telemetry loss: window carries no padded rows",
            )
        # telemetry healthy again: a degraded controller re-arms here
        self._mode = MODE_STEERING
        proposal = self._propose(occupancy, row, inputs)
        if proposal is None:
            return self._record(t, inputs, None, "steady", None)
        if (
            self._last_action is not None
            and t - self._last_action < self._min_action_s
        ):
            return self._record(
                t, inputs, proposal, "held",
                f"actuation rate bound ({self._min_action_s:g}s)",
            )
        if proposal["knob"] == "bucket":
            reason = self._validate(proposal["to"])
            if reason is not None:
                return self._record(t, inputs, proposal, "refused", reason)
            self._bucket = proposal["to"]
        else:  # prefetch — the sanctioned apply site (SCX1001 owner)
            from ..utils.prefetch import MAX_PREFETCH_DEPTH, set_depth_override

            if not 1 <= proposal["to"] <= MAX_PREFETCH_DEPTH:
                return self._record(
                    t, inputs, proposal, "refused",
                    f"prefetch depth {proposal['to']} outside "
                    f"[1, {MAX_PREFETCH_DEPTH}]",
                )
            self._prefetch_override = proposal["to"]
            set_depth_override(proposal["to"])
        self._last_action = t
        return self._record(t, inputs, proposal, "applied", None)

    def _propose(
        self, occupancy: float, row: dict, inputs: dict
    ) -> Optional[dict]:
        """Hysteresis: pick at most one knob move for this epoch."""
        if occupancy < self._occ_low:
            # padding here is pow2-of-content clamped to the pinned
            # floor, so sagging occupancy means floor-padded fragments.
            # With enough windowed traffic to FILL a bigger bucket the
            # online fix is to coalesce UP (validated against the
            # residency set at apply time — a non-resident rung's
            # refusal is itself journaled evidence that warmup should
            # calibrate it). At the coalescing ceiling the controller
            # HOLDS: a downshift never helps pow2-of-content padding,
            # and proposing one here would flap against the upshift as
            # stale low-occupancy beats age out of the window.
            real_rows = inputs.get("real_rows") or 0
            if real_rows >= 2 * self._bucket:
                if self._bucket < self._static * 2:
                    return {
                        "knob": "bucket",
                        "from": self._bucket,
                        "to": self._bucket * 2,
                    }
                return None
            # genuinely thin traffic: the honest proposal is the
            # downshift — usually refused at the pinned floor, and that
            # journaled refusal is the offline floor evidence
            return {
                "knob": "bucket",
                "from": self._bucket,
                "to": self._bucket // 2,
            }
        if occupancy > self._occ_high and self._bucket < self._static * 2:
            candidate = self._bucket * 2
            if candidate <= max(self._resident, default=self._static):
                return {
                    "knob": "bucket",
                    "from": self._bucket,
                    "to": candidate,
                }
        bubble = row.get("bubble_fraction")
        limiting = row.get("limiting_stage")
        if (
            bubble is not None
            and bubble > self._bubble_ceiling
            and limiting in PREFETCH_LIMITED_STAGES
        ):
            from ..utils.prefetch import prefetch_depth

            current = (
                self._prefetch_override
                if self._prefetch_override is not None
                else prefetch_depth()
            )
            return {"knob": "prefetch", "from": current, "to": current + 1}
        return None

    def _record(
        self,
        t: float,
        inputs: Optional[dict],
        proposal: Optional[dict],
        verdict: str,
        reason: Optional[str],
    ) -> dict:
        if verdict == "degraded":
            self._degrade(reason or "telemetry loss")
        self._seq += 1
        self._counts[verdict] = self._counts.get(verdict, 0) + 1
        decision = {
            "seq": self._seq,
            "t": round(t, 6),
            "mode": self._mode,
            "bucket": self._bucket,
            "inputs": inputs,
            "proposal": proposal,
            "verdict": verdict,
            "reason": reason,
        }
        self._decisions.append(decision)
        if len(self._decisions) > DECISION_KEEP:
            del self._decisions[: len(self._decisions) - DECISION_KEEP]
        return decision


# ------------------------------------------------------------- offline

def load_decisions(run_dir: str) -> List[dict]:
    """Every journaled steer decision under ``run_dir``, replay-ordered.

    The serve engine journals each decision as worker meta
    (``steer_decision``); this reads them back through the same journal
    discovery the slo stitcher uses, so ``obs efficiency --suggest``
    consumes the online controller's record with no new file format (and
    JAX's ``--retune`` reads the port's journal as its own).
    """
    from ..obs import slo

    out: List[dict] = []
    for journal_dir in slo.find_journal_dirs(run_dir):
        _, events = slo.load_journal(journal_dir)
        for event in events:
            if event.get("event") != "worker":
                continue
            decision = event.get("steer_decision")
            if not isinstance(decision, dict):
                continue
            row = dict(decision)
            row["worker"] = event.get("worker", "?")
            row["ts"] = event.get("ts")
            out.append(row)
    return out


def latest_snapshots(run_dir: str) -> Dict[str, dict]:
    """Last announced steer snapshot per worker (the live gauge source)."""
    from ..obs import slo

    out: Dict[str, dict] = {}
    for journal_dir in slo.find_journal_dirs(run_dir):
        _, events = slo.load_journal(journal_dir)
        for event in events:
            if event.get("event") != "worker":
                continue
            snapshot = event.get("steer")
            if isinstance(snapshot, dict) and "mode" in snapshot:
                out[event.get("worker", "?")] = snapshot
    return out


def suggest_from_decisions(
    decisions: Sequence[dict], target: float = 0.35
) -> List[dict]:
    """Refused floor proposals as offline bucket suggestions.

    The online controller's refusals against the pinned
    ``RECORD_BUCKET_MIN`` floor are exactly the evidence the offline
    autotuner wants: the controller SAW sagging occupancy and proposed a
    smaller bucket the static contract would not allow.  Rows use the
    :func:`~sctools_tpu_torch.obs.xprof.suggest_buckets` schema verbatim
    (``site``/``dispatches``/means/``suggested_pad``/``constant``) so
    ``obs efficiency --suggest`` (and JAX's ``--retune``) merge them with
    the registry-derived rows — one vocabulary for both halves.
    """
    grouped: Dict[tuple, List[dict]] = {}
    for decision in decisions:
        if decision.get("verdict") != "refused":
            continue
        proposal = decision.get("proposal") or {}
        if proposal.get("knob") != "bucket":
            continue
        to = proposal.get("to")
        if not isinstance(to, int) or to >= proposal.get("from", 0):
            continue  # only downshift refusals argue for a lower floor
        grouped.setdefault(
            (decision.get("worker", "?"), to), []
        ).append(decision)
    rows: List[dict] = []
    for (worker, to), group in sorted(grouped.items()):
        reals: List[float] = []
        pads: List[float] = []
        occs: List[float] = []
        for decision in group:
            inputs = decision.get("inputs") or {}
            beats = inputs.get("heartbeats") or 0
            real = inputs.get("real_rows")
            padded = inputs.get("padded_rows")
            if beats and isinstance(real, (int, float)):
                reals.append(real / beats)
            if beats and isinstance(padded, (int, float)):
                pads.append(padded / beats)
            occupancy = inputs.get("occupancy")
            if isinstance(occupancy, (int, float)):
                occs.append(occupancy)
        if not reals or not pads:
            continue  # a refusal without fold inputs cannot argue means
        mean_real = sum(reals) / len(reals)
        mean_padded = sum(pads) / len(pads)
        occupancy = sum(occs) / len(occs) if occs else None
        projected = min(mean_real / to, 1.0)
        rows.append(
            {
                "site": f"steer:{worker}",
                "dispatches": len(group),
                "mean_real_rows": round(mean_real, 1),
                "mean_padded_rows": round(mean_padded, 1),
                "occupancy": (
                    round(occupancy, 4) if occupancy is not None else None
                ),
                "suggested_pad": to,
                "projected_occupancy": (
                    round(projected, 4) if projected is not None else None
                ),
                "meets_target": (
                    projected is not None and projected >= target
                ),
                "unit": "records",
                "constant": "RECORD_BUCKET_MIN",
            }
        )
    return rows


# ----------------------------------------------------------- rendering

_MODE_GAUGE = {MODE_STEERING: 1, MODE_STATIC: 0, MODE_OFF: -1}


def render_steer_metrics(run_dir: str) -> str:
    """``sctools_tpu_steer_*`` gauges from a run's journaled decisions.

    Per-worker, labeled with the pulse sanitize-and-claim collision
    discipline (two workers may not silently merge into one series).
    Empty when the run journaled no steering — the pulse exporter
    appends this to its scrape unconditionally.
    """
    from ..obs import pulse as _pulse

    snapshots = latest_snapshots(run_dir)
    if not snapshots:
        return ""
    lines: List[str] = []
    claimed: Dict[str, str] = {}
    header_done = set()

    def typed(metric: str) -> None:
        if metric not in header_done:
            header_done.add(metric)
            lines.append(f"# TYPE sctools_tpu_steer_{metric} gauge")

    def gauge(metric: str, worker: str, value) -> None:
        if value is None:
            return
        name = f"sctools_tpu_steer_{metric}"
        typed(metric)
        label = _pulse._sanitize_label(worker)
        series = f'{name}{{worker="{label}"}}'
        previous = claimed.setdefault(series, worker)
        if previous != worker:
            raise ValueError(
                f"steer metric label collision after sanitizing: "
                f"{previous!r} and {worker!r} both render as {series!r}"
            )
        lines.append(f"{series} {value}")

    for worker, snapshot in sorted(snapshots.items()):
        gauge("mode", worker, _MODE_GAUGE.get(snapshot.get("mode")))
        gauge("bucket_records", worker, snapshot.get("bucket"))
        gauge("static_records", worker, snapshot.get("static"))
        gauge("prefetch_depth", worker, snapshot.get("prefetch_override"))
        gauge("decisions_total", worker, snapshot.get("decisions"))
        gauge("applied_total", worker, snapshot.get("applied"))
        gauge("refused_total", worker, snapshot.get("refused"))
        gauge("held_total", worker, snapshot.get("held"))
        gauge("degraded_total", worker, snapshot.get("degraded"))
    return "\n".join(lines) + "\n" if lines else ""
