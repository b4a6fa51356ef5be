"""The port's capture CLI: ``python -m sctools_tpu_torch.obs``.

``summarize trace.jsonl [more.jsonl|'glob*']`` reads one or more span
captures (the JSON-lines files SCTOOLS_TPU_TRACE writes; globs expand)
and prints the combined per-stage time/records/bytes/throughput table. A
torn or truncated final line — a crashed or still-writing worker —
degrades to a warning, never an error. ``--json`` emits ONE
machine-readable object (stage rows + the counter snapshots and pulse
rows found next to the traces).

``timeline <run_dir>`` merges every worker's capture and the sched
journal under a run directory into one wall-clock timeline: per-worker
lanes with busy/wait/idle fractions and occupancy/transfer columns,
per-task stats and stragglers, the critical chain of tasks that bounded
the run, and crashed workers' flight records (:mod:`.fleet`).

``efficiency <run_dir>`` merges the workers' xprof registries into the
device-efficiency report: per call site, compiles and retraces, padding
occupancy, the H2D/D2H transfer ledger and the device-memory watermark
(:mod:`.xprof`). ``--suggest`` prints the bucket advice of
``xprof.suggest_buckets`` followed by the steering controller's journaled
refused downshifts (``steer.suggest_from_decisions``), in one schema.

``pulse <run_dir>`` renders the heartbeat rings: per-worker lanes,
windowed rates and the bubble verdict (``--watch``, ``--json``,
``--serve PORT``).

``slo <run_dir>`` stitches per-job traces (submit -> lease -> pack ->
device -> commit) out of the serve journal and the pulse rings, and
prints per-tenant SLO rows with pro-rata device-cost attribution.

``delta <A> <B>`` attributes the throughput/latency delta between two
runs: each side is a run directory, a RunProfile JSON, a bench-result
JSON, or a committed trajectory point; the report ranks suspects with an
explicit conservation check, refuses cross-platform pairs loudly (exit
3), and ``--trajectory`` walks the committed series instead.

``audit <run_dir>`` renders the record conservation report
(:mod:`.audit`): per-task and fleet-wide balance of records
ingested/decoded/computed/quarantined and rows computed/emitted/filtered,
with every loss named by reason (quarantine sidecar ranges, row filters,
merge collision folds). Exit 0 means EXACT — every record the run touched
is accounted for; any unexplained record exits 1, no journal exits 2.

``explain <run_dir> --barcode B | --record N | --job J`` traces one
entity's journey — chunk -> task -> attempts/steals -> pack membership ->
quarantine or output file:row — stitched from the journal, the quarantine
sidecars, the merge sidecar and the conservation ledger (exit 0 found, 1
no match, 2 no journal or no selector).

Pure stdlib — usable on any host with the capture files, no torch
required. The arguments, output and exit codes are JAX's.
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys
from typing import Dict, List, Optional

from . import render_summary, summarize_records
from . import pulse as pulsemod
from .fleet import analyze, discover, load_capture, render_timeline
from .xprof import (
    efficiency_report,
    load_registries,
    merge_registries,
    render_efficiency,
    render_suggestions,
    suggest_buckets,
)

def _expand(patterns: List[str]) -> List[str]:
    """Paths from path-or-glob arguments, order-preserving, deduped."""
    out: List[str] = []
    for pattern in patterns:
        matches = sorted(globmod.glob(pattern))
        for path in matches or [pattern]:
            if path not in out:
                out.append(path)
    return out


def _parse_prom(path: str) -> Dict[str, float]:
    """Prometheus text exposition -> {sample_name_or_labeled: value}."""
    out: Dict[str, float] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, value = line.rpartition(" ")
                try:
                    out[name] = float(value)
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def _sidecars(paths: List[str]):
    """Counter snapshots + xprof registries next to the given traces.

    The capture dir writes ``metrics[.<worker>].prom`` and
    ``xprof[.<worker>].json`` beside each ``trace[.<worker>].jsonl``;
    summarize --json folds them in so one invocation hands a dashboard
    the spans, the counters, and the compile registry together.
    """
    dirs = []
    for path in paths:
        directory = os.path.dirname(os.path.abspath(path))
        if directory not in dirs:
            dirs.append(directory)
    counters: Dict[str, Dict[str, float]] = {}
    registries = []
    rings: Dict[str, dict] = {}
    for directory in dirs:
        for prom in sorted(globmod.glob(os.path.join(directory, "metrics*.prom"))):
            parsed = _parse_prom(prom)
            if parsed:
                counters[prom] = parsed
        registries.extend(load_registries(directory))
        # scx-pulse heartbeat rings next to the traces: one summarize
        # --json covers spans + counters + compile registry + pulse.
        # First ring per worker wins — a worker's own ring is already
        # deduped against any flight-embedded copy by the fleet layer.
        for worker, ring in pulsemod.load_rings(directory).items():
            rings.setdefault(worker, ring)
    return counters, registries, rings


def _summarize(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    paths = _expand(args.traces)
    records = []
    files_read = 0
    bad = 0
    for path in paths:
        capture = load_capture(path, "trace")
        if not capture.records and not capture.metas and capture.torn:
            print(f"obs summarize: cannot read {path}", file=err)
            return 2
        if capture.torn:
            print(
                f"obs summarize: warning: {path} ends in a torn/"
                "truncated line (crashed or still-writing worker); "
                "summarizing the records that terminated",
                file=err,
            )
        if capture.bad_lines:
            bad += capture.bad_lines
        records.extend(capture.records)
        files_read += 1
    if not records:
        print(
            f"obs summarize: no span records in "
            f"{', '.join(paths) if paths else '(no files)'}",
            file=err,
        )
        return 1
    rows = summarize_records(records)
    if args.top:
        rows = rows[: args.top]
    if args.as_json:
        counters, registries, rings = _sidecars(paths)
        payload = {
            "stages": rows,
            "spans": len(records),
            "files": files_read,
            "counters": counters,
            "compile_registry": (
                merge_registries(registries)["sites"] if registries else {}
            ),
            "pulse": {
                worker: pulsemod.worker_row(ring["records"])
                for worker, ring in sorted(rings.items())
            },
        }
        print(json.dumps(payload, separators=(",", ":")), file=out)
    else:
        print(render_summary(rows), file=out)
        total = sum(r["total_s"] for r in rows)
        print(
            f"\n{len(records)} spans, {len(rows)} stages, "
            f"{total:.3f} span-seconds"
            + (f", {files_read} file(s)" if files_read > 1 else "")
            + (f" ({bad} malformed line(s) skipped)" if bad else ""),
            file=out,
        )
    return 0


def _timeline(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    run = discover(args.run_dir)
    if not run.captures and not run.tasks:
        print(
            f"obs timeline: nothing under {args.run_dir}: no trace/flight "
            "captures and no sched journal",
            file=err,
        )
        return 2
    analysis = analyze(run)
    if args.as_json:
        print(json.dumps(analysis, separators=(",", ":")), file=out)
    else:
        print(render_timeline(run, analysis), end="", file=out)
    return 0


def _efficiency(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    report = efficiency_report(args.run_dir)
    if not report["registries"]:
        for warning in report["warnings"]:
            print(f"obs efficiency: {warning}", file=err)
        return 2
    if args.suggest:
        suggestions = suggest_buckets(report, target=args.target)
        # the online controller's journaled refusals are a second evidence
        # source: a refused downshift means the loop saw sagging occupancy
        # and wanted a bucket the pinned floor forbids. Same row schema as
        # suggest_buckets, sites named steer:<worker>
        from .. import steer as steermod

        suggestions = suggestions + steermod.suggest_from_decisions(
            steermod.load_decisions(args.run_dir), target=args.target
        )
        if args.as_json:
            payload = {"target": args.target, "suggestions": suggestions}
            print(json.dumps(payload, separators=(",", ":")), file=out)
        else:
            print(
                render_suggestions(suggestions, target=args.target),
                end="", file=out,
            )
        return 0
    if args.as_json:
        print(json.dumps(report, separators=(",", ":")), file=out)
    else:
        print(render_efficiency(report), end="", file=out)
    return 0


def _render_pulse_view(
    view: dict, rings: Dict[str, dict], window_s: Optional[float]
) -> str:
    """The live-TUI frame: per-worker lanes + rates + bubble verdict."""
    lines = [
        f"pulse: {view['run_dir']}"
        + (f"  (window {window_s:g}s)" if window_s else "  (whole run)")
    ]
    workers = view["workers"]
    name_width = max((len(w) for w in workers), default=6)
    lines.append(
        f"{'worker'.ljust(name_width)}  "
        f"{'lane (#device ~bubble ·idle)'.ljust(48)}  "
        "beats  cells/s    rows/s   occ%  h2d MB/s  d2h MB/s  bub%  limiting"
    )
    for worker in sorted(workers):
        row = workers[worker]
        ring = rings[worker]
        # the lane draws the SAME windowed subset the row's numbers are
        # computed from — a 20-minute run watched at --window 30 shows
        # the live 30 seconds, not 20 minutes compressed into 48 chars
        bar = pulsemod.lane_bar(
            pulsemod.select_window(
                ring["records"], window_s,
                now=pulsemod.ring_now(ring) if window_s else None,
            )
        )
        occupancy = row.get("occupancy")
        bubble = row.get("bubble_fraction")
        occ = f"{100 * occupancy:5.1f}" if occupancy is not None else "    -"
        bub = f"{100 * bubble:4.1f}" if bubble is not None else "   -"
        lines.append(
            f"{worker.ljust(name_width)}  {bar}  "
            f"{row['heartbeats']:5d}  "
            f"{(row['cells_per_s'] or 0.0):8.1f}  "
            f"{(row['rows_per_s'] or 0.0):8.0f}  {occ}  "
            f"{(row['h2d_Bps'] or 0) / 1e6:8.1f}  "
            f"{(row['d2h_Bps'] or 0) / 1e6:8.1f}  {bub}  "
            f"{row.get('limiting_stage') or '-'}"
        )
    fleet = view["fleet"]
    bubble = fleet.get("bubble_fraction")
    lines.append("")
    lines.append(
        f"fleet: {fleet['heartbeats']} heartbeat(s), "
        f"{fleet['cells_per_s'] or 0.0:.1f} cells/s, "
        f"{fleet['retraces']} retrace(s), bubble "
        + (f"{100 * bubble:.1f}%" if bubble is not None else "-")
        + f" limited by {fleet.get('limiting_stage') or '-'}"
    )
    torn = sum(r["torn"] for r in rings.values())
    if torn:
        lines.append(
            f"warning: {torn} torn record(s) skipped "
            "(mid-write scrape or crashed worker; the ring stays readable)"
        )
    return "\n".join(lines) + "\n"


def _pulse(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    # default window: live surfaces (--watch/--serve) get the trailing
    # 30 s (reader-anchored, so a stalled worker decays); a one-shot
    # render summarizes the WHOLE run — a run that finished a minute ago
    # must not render as 0 heartbeats / all-idle lanes. An explicit
    # --window applies everywhere (0 = whole run).
    if args.window is None:
        window_s = (
            30.0 if (args.watch or args.serve is not None) else None
        )
    else:
        window_s = args.window if args.window > 0 else None

    def frame():
        rings = pulsemod.load_rings(args.run_dir)
        view = pulsemod.fleet_pulse(
            args.run_dir, window_s=window_s, rings=rings
        )
        return rings, view

    rings, view = frame()
    if not rings:
        print(
            f"obs pulse: no pulse.*.ring under {args.run_dir}: run with "
            f"{pulsemod.ENV_FLAG}=1 (the workers write heartbeat rings "
            "beside their trace captures)",
            file=err,
        )
        return 2
    if args.serve is not None:
        from .serve import PulseExporter

        exporter = PulseExporter(
            port=args.serve, run_dir=args.run_dir, window_s=window_s
        )
        port = exporter.start()
        print(
            f"obs pulse: serving /metrics on 127.0.0.1:{port} "
            "(Ctrl-C to stop)",
            file=out,
        )
        import time as _time

        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            exporter.stop()
        return 0
    if args.as_json:
        print(json.dumps(view, separators=(",", ":")), file=out)
        return 0
    if not args.watch:
        print(_render_pulse_view(view, rings, window_s), end="", file=out)
        return 0
    import time as _time

    frames = 0
    while True:
        frames += 1
        if hasattr(out, "isatty") and out.isatty():
            out.write("\x1b[2J\x1b[H")
        print(_render_pulse_view(view, rings, window_s), end="", file=out)
        if args.frames and frames >= args.frames:
            return 0
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        rings, view = frame()


def _slo(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    from . import slo as slomod

    window_s = (
        args.window if args.window is not None and args.window > 0 else None
    )
    if not slomod.find_journal_dirs(args.run_dir):
        print(
            f"obs slo: no sched journal under {args.run_dir} (serve runs "
            "journal their jobs; point this at the run/work directory)",
            file=err,
        )
        return 2

    def frame():
        return slomod.stitch_run(
            args.run_dir,
            window_s=window_s,
            target_s=args.target,
            objective=args.objective,
        )

    view = frame()
    if args.as_json:
        print(json.dumps(view, separators=(",", ":")), file=out)
        return 0
    if not args.watch:
        print(slomod.render_slo(view), end="", file=out)
        return 0
    import time as _time

    frames = 0
    while True:
        frames += 1
        if hasattr(out, "isatty") and out.isatty():
            out.write("\x1b[2J\x1b[H")
        print(slomod.render_slo(view), end="", file=out)
        if args.frames and frames >= args.frames:
            return 0
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        view = frame()


def _delta_side(path: str, err) -> Optional[dict]:
    """A RunProfile from one CLI operand (dir or any committed JSON).

    A run-dir operand is distilled here and now, so it is stamped with
    THIS host's fingerprint (rings record no platform of their own).
    To diff runs from different hosts, persist profiles on each host
    (serve workers' ``profile.<id>.json``) and
    diff the JSONs — those carry their original fingerprints and a
    cross-platform pair will refuse rather than fabricate.
    """
    from . import delta as deltamod
    from . import trajectory as trajmod

    if os.path.isdir(path):
        try:
            platform = trajmod.platform_fingerprint()
        except Exception:  # noqa: BLE001 - torch may be absent/broken
            platform = None
        return deltamod.profile_from_run_dir(
            path, source=path, platform=platform
        )
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"obs delta: cannot read {path}: {exc}", file=err)
        return None
    if not isinstance(data, dict):
        print(f"obs delta: {path} is not a JSON object", file=err)
        return None
    return deltamod.profile_from_result(
        data, source=os.path.basename(path)
    )


def _delta(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    from . import delta as deltamod

    if args.trajectory:
        repo_dir = args.paths[0] if args.paths else "."
        if not os.path.isdir(repo_dir):
            print(
                f"obs delta: --trajectory expects a repo directory, "
                f"got {repo_dir}",
                file=err,
            )
            return 2
        view = deltamod.trajectory_view(
            repo_dir,
            metric=args.metric,
            pattern=args.pattern,
            tolerance=args.tolerance,
        )
        if not view["points"]:
            print(
                f"obs delta: no {args.pattern} points under {repo_dir}",
                file=err,
            )
            return 2
        if args.as_json:
            print(json.dumps(view, separators=(",", ":")), file=out)
        else:
            print(deltamod.render_trajectory(view), end="", file=out)
        return 0
    if len(args.paths) != 2:
        print(
            "obs delta: expected exactly two operands <A> <B> "
            "(run dirs, profile JSONs, bench results, or trajectory "
            "points), or --trajectory [REPO_DIR]",
            file=err,
        )
        return 2
    a = _delta_side(args.paths[0], err)
    b = _delta_side(args.paths[1], err)
    if a is None or b is None:
        return 2
    view = deltamod.attribute_delta(a, b, tolerance=args.tolerance)
    if args.as_json:
        print(json.dumps(view, separators=(",", ":")), file=out)
    else:
        print(deltamod.render_delta(view), end="", file=out)
    # exit 3 = loud refusal: the pair does not compare (cross-platform
    # or stub profiles); distinct from 2 (unreadable operands) so
    # scripts can tell "can't read" from "won't fabricate"
    return 0 if view["comparable"] else 3


def _audit(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    from . import audit as auditmod

    try:
        report = auditmod.audit_run(args.run_dir)
    except FileNotFoundError as exc:
        print(f"obs audit: {exc}", file=err)
        return 2
    if args.as_json:
        print(json.dumps(report, separators=(",", ":")), file=out)
    else:
        print(auditmod.render_audit_report(report), end="", file=out)
    # nonzero on ANY unexplained record: the conservation contract is
    # exact or it is broken — there is no "mostly balanced"
    return 0 if report["fleet"]["exact"] else 1


def _explain(args, out=None, err=None) -> int:
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    from . import audit as auditmod

    if (
        args.barcode is None
        and args.record is None
        and args.job is None
    ):
        print(
            "obs explain: pass at least one of --barcode/--record/--job",
            file=err,
        )
        return 2
    try:
        result = auditmod.explain_run(
            args.run_dir,
            barcode=args.barcode,
            record=args.record,
            job=args.job,
        )
    except FileNotFoundError as exc:
        print(f"obs explain: {exc}", file=err)
        return 2
    if args.as_json:
        print(json.dumps(result, separators=(",", ":")), file=out)
    else:
        print(auditmod.render_explain(result), end="", file=out)
    return 0 if result["found"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.obs",
        description="scx-trace capture tools for the port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    summarize = sub.add_parser(
        "summarize", help="per-stage table from span capture JSONL file(s)"
    )
    summarize.add_argument(
        "traces", nargs="+",
        help="trace JSONL path(s); globs expand (quote them)",
    )
    summarize.add_argument(
        "--top", type=int, default=0,
        help="only the N most expensive stages (default: all)",
    )
    summarize.add_argument(
        "--json", action="store_true", dest="as_json",
        help="one machine-readable object (stage rows + adjacent counter "
        "snapshots + xprof compile registries + pulse rows) instead of "
        "the table",
    )
    timeline = sub.add_parser(
        "timeline",
        help="merged cross-worker run timeline: lanes, stragglers, "
        "critical path, flight records",
    )
    timeline.add_argument(
        "run_dir",
        help="run directory holding worker captures and the sched journal",
    )
    timeline.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the full analysis dict as one JSON object",
    )
    efficiency = sub.add_parser(
        "efficiency",
        help="per-jit-call-site device efficiency: compiles, retraces, "
        "padding occupancy, transfer ledger, memory watermarks",
    )
    efficiency.add_argument(
        "run_dir",
        help="run directory holding xprof[.<worker>].json registries "
        "(written at exit of every SCTOOLS_TPU_TRACE'd worker)",
    )
    efficiency.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the full report dict as one JSON object",
    )
    efficiency.add_argument(
        "--suggest", action="store_true",
        help="print suggested bucket/pad_to sizes per site (smallest "
        "power-of-two pad holding the mean dispatch) instead of the "
        "report; --json emits the same rows machine-readably — the "
        "exact rows the autotuner (python -m "
        "sctools_tpu_torch.analysis --retune) consumes",
    )
    efficiency.add_argument(
        "--target", type=float, default=0.35,
        help="occupancy target for --suggest (default: 0.35)",
    )
    pulse_cmd = sub.add_parser(
        "pulse",
        help="live streaming telemetry: per-worker heartbeat lanes, "
        "windowed rates, pipeline bubble attribution (scx-pulse)",
    )
    pulse_cmd.add_argument(
        "run_dir",
        help="run directory holding pulse.<worker>.ring heartbeat rings "
        f"(written live by every {pulsemod.ENV_FLAG}=1 worker)",
    )
    pulse_cmd.add_argument(
        "--window", type=float, default=None,
        help="trailing rate window in seconds (default: whole run for a "
        "one-shot render, 30 for --watch/--serve; 0 = whole run)",
    )
    pulse_cmd.add_argument(
        "--watch", action="store_true",
        help="refresh the view every --interval seconds (live TUI)",
    )
    pulse_cmd.add_argument(
        "--interval", type=float, default=2.0,
        help="--watch refresh period in seconds (default 2)",
    )
    pulse_cmd.add_argument(
        "--frames", type=int, default=0,
        help="stop --watch after N refreshes (0 = until interrupted)",
    )
    pulse_cmd.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the merged per-worker + fleet pulse view as one JSON object",
    )
    pulse_cmd.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="serve the merged view on 127.0.0.1:PORT/metrics in "
        "Prometheus exposition format instead of rendering (0 = any port)",
    )
    slo_cmd = sub.add_parser(
        "slo",
        help="per-job distributed traces + per-tenant SLO/cost "
        "attribution for a serve run (scx-slo)",
    )
    slo_cmd.add_argument(
        "run_dir",
        help="run/work directory holding the serve journal(s) and the "
        "workers' pulse.<worker>.ring heartbeat rings",
    )
    slo_cmd.add_argument(
        "--target", type=float, default=None,
        help="end-to-end latency target in seconds the error budget "
        "burns against (default: SCTOOLS_TPU_SLO_TARGET_S or 30)",
    )
    slo_cmd.add_argument(
        "--objective", type=float, default=0.99,
        help="SLO objective as a fraction of jobs inside the target "
        "(default 0.99; burn 1.0 = violations at the sustainable rate)",
    )
    slo_cmd.add_argument(
        "--window", type=float, default=None,
        help="trailing SLO window in seconds (default: whole run; "
        "0 = whole run)",
    )
    slo_cmd.add_argument(
        "--watch", action="store_true",
        help="refresh the view every --interval seconds (live TUI)",
    )
    slo_cmd.add_argument(
        "--interval", type=float, default=2.0,
        help="--watch refresh period in seconds (default 2)",
    )
    slo_cmd.add_argument(
        "--frames", type=int, default=0,
        help="stop --watch after N refreshes (0 = until interrupted)",
    )
    slo_cmd.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the stitched per-job/per-tenant/fleet view as one JSON "
        "object",
    )
    delta_cmd = sub.add_parser(
        "delta",
        help="run-over-run regression attribution between two runs, or "
        "the committed trajectory series (scx-delta)",
    )
    delta_cmd.add_argument(
        "paths", nargs="*",
        help="two sides <A> <B> (each a run dir, RunProfile JSON, bench "
        "result JSON, or committed BENCH_r*/MULTICHIP_r* point); with "
        "--trajectory, one optional repo directory (default: .)",
    )
    delta_cmd.add_argument(
        "--trajectory", action="store_true",
        help="trend mode: attribute each committed trajectory point "
        "against the previous same-fingerprint point with a complete "
        "profile, rendering the whole series (stub points included)",
    )
    delta_cmd.add_argument(
        "--metric", default=None,
        help="with --trajectory: only points for this metric "
        "(default: all; points with no parsed metric always render)",
    )
    delta_cmd.add_argument(
        "--pattern", default="BENCH_r*.json",
        help="with --trajectory: the point family glob "
        "(default: BENCH_r*.json; use MULTICHIP_r*.json for the "
        "mesh series)",
    )
    delta_cmd.add_argument(
        "--tolerance", type=float, default=0.10,
        help="conservation tolerance: attributed per-leg deltas must "
        "sum to the end-to-end delta within this fraction "
        "(default 0.10)",
    )
    delta_cmd.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the attribution view (or trajectory series) as one JSON "
        "object",
    )
    audit_cmd = sub.add_parser(
        "audit",
        help="record conservation report: per-task and fleet-wide "
        "balance with every loss named by reason; exit 0 only when "
        "EXACT (scx-audit)",
    )
    audit_cmd.add_argument(
        "run_dir",
        help="run/work directory holding the sched journal(s), "
        "quarantine sidecars, and commit-extra conservation ledgers",
    )
    audit_cmd.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the full conservation report as one JSON object",
    )
    explain_cmd = sub.add_parser(
        "explain",
        help="provenance trace for one entity: chunk -> task -> "
        "attempts/steals -> pack membership -> quarantine or "
        "output file:row (scx-audit)",
    )
    explain_cmd.add_argument(
        "run_dir",
        help="run/work directory holding the sched journal(s) and "
        "committed output parts",
    )
    explain_cmd.add_argument(
        "--barcode", default=None,
        help="entity index value (cell barcode / gene name) to locate "
        "in committed outputs and merge sidecars",
    )
    explain_cmd.add_argument(
        "--record", type=int, default=None,
        help="absolute input record number to resolve against the "
        "quarantine sidecar ranges (optionally scoped by --job)",
    )
    explain_cmd.add_argument(
        "--job", default=None,
        help="task/job name or id to narrate end-to-end from the journal",
    )
    explain_cmd.add_argument(
        "--json", action="store_true", dest="as_json",
        help="the match list as one JSON object",
    )
    args = parser.parse_args(argv)
    if args.command == "audit":
        return _audit(args)
    if args.command == "explain":
        return _explain(args)
    if args.command == "summarize":
        return _summarize(args)
    if args.command == "timeline":
        return _timeline(args)
    if args.command == "efficiency":
        return _efficiency(args)
    if args.command == "pulse":
        return _pulse(args)
    if args.command == "slo":
        return _slo(args)
    return _delta(args)


if __name__ == "__main__":
    sys.exit(main())
