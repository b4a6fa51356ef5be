"""The benchmark's runner: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (the manifest's ``file``);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  general generator and pass in ``kinds/<kind>.py``;
- ``metrics/<metric>.py``: a reader with ``read(run)``, which returns the
  metric's value or None when it finds nothing to read. Where there is no
  such file, the reader of the longest leading part of the name before a
  dot serves, as ``read(run, rest)`` with the rest of the name: one
  ``metrics/device_idle.py`` reads ``device_idle.fastq`` and
  ``device_idle.bam``, a quantity split by the end-to-end metric it moves.

A run builds the cell's state (``setup``), runs whole passes while the
window is open, reads the program's counters and, with ``--trace 1``, the
profiler's trace, then frees the program's state and checks every pass's
output against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the process may not hold once the window closes:
# JAX and the JAX package, which the port's name begins with
FORBIDDEN = ("jax", "jaxlib", "flax", "sctools_tpu")
# fixed cache directories inside the checkout (for a program that builds
# with torch's extension loader or Triton; the port's nvcc builds go to its
# own ``_build/`` beside its sources)
CACHE = ROOT / ".gpubench_cache"


class Refused(Exception):
    """The run cannot measure: no result is printed and the exit code is not 0."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark as a module, by path (names may hold dots)."""
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT)}")
    name = "gpubench._loaded." + path.relative_to(BENCH).with_suffix("").as_posix().replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_manifest(path: Path = ROOT / "BENCHMARK.json") -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, cell_name: str, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic, kind and
    metrics, from files alone."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise Refused(f"no cell {cell_name!r} in BENCHMARK.json")
    entry = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_file = root / configs[entry["config"]]["file"]
    traffic_file = BENCH / "traffic" / f"{entry['traffic']}.json"
    for path in (config_file, traffic_file):
        if not path.is_file():
            raise Refused(f"missing {path}")
    config = json.loads(config_file.read_text())
    traffic = json.loads(traffic_file.read_text())
    kind = load_module(BENCH / "kinds" / f"{traffic['kind']}.py")
    end_to_end = [m for m in manifest["end_to_end"] if _applies(m, cell_name)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, cell_name)]
    for metric in per_layer:
        metric["reader"], metric["part"] = find_reader(metric["name"])
    return Cell(cell_name, entry["chips"], config, traffic, kind, end_to_end, per_layer)


def find_reader(name: str):
    """(module, rest of the name) of the reader of the metric ``name``:
    ``metrics/<name>.py``, else that of the longest leading part before a
    dot, which reads the rest."""
    parts = name.split(".")
    for cut in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:cut]) + ".py")
        if path.is_file():
            return load_module(path), ".".join(parts[cut:])
    raise Refused(f"no reader for the metric {name!r} in {BENCH.name}/metrics/")


def read_metric(metric: dict, run) -> Optional[float]:
    reader, part = metric["reader"], metric.get("part", "")
    return reader.read(run, part) if part else reader.read(run)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``sctools_tpu_torch`` is not
    ``sctools_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in names if name.split(".", 1)[0] in FORBIDDEN})


def log(message: str) -> None:
    print(f"[gpubench] {message}", file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a kind's set-up is given."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    work: Path
    device: object
    trace: bool


@dataclass
class Run:
    """What a per-layer reader reads."""
    cell: str
    config: dict
    traffic: dict
    units: int
    passes: int
    window_s: float
    seconds: Dict[str, float]  # the program's own timers over the window
    launches: Dict[str, int]  # the program's kernel launch counts over the window
    counts: Dict[str, int]  # what the window's passes produced, by the kind's count (CSV rows)
    trace: Optional[object] = None  # trace.Summary of the traced window
    device_name: str = ""


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _bytes_written() -> Optional[int]:
    """Bytes this process passed to write calls so far (``wchar``)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            control: bool = False) -> dict:
    """One run of ``cell``: returns the result line's object. ``device`` is
    the card (or, in the CPU tests, the CPU); ``t0`` the process's start on
    ``time.perf_counter``."""
    import torch

    from . import spans
    from .trace import Tracer

    work = Path(tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR")))
    on_card = getattr(device, "type", str(device)) == "cuda"
    try:
        ctx = Context(cell.name, cell.config, cell.traffic, seed, work, device, trace)
        kind = cell.kind
        log(f"start: {time.perf_counter() - t0:.3f} s after the process began (torch imported, card found)")
        state = kind.setup(ctx)
        if trace:
            spans.install(kind.span_targets())
        if on_card:
            torch.cuda.synchronize()
        seconds_before = dict(kind.program_seconds(state))
        launches_before = dict(kind.program_launches())
        tracer = Tracer(work / "trace.json", on_card) if trace else None
        passes: List[dict] = []
        failed = 0
        setup_s = time.perf_counter() - t0
        if tracer:
            tracer.start()
        start = time.perf_counter()
        with spans.span("window"):
            while time.perf_counter() - start < seconds:
                begin = time.perf_counter()
                try:
                    with spans.span("pass"):
                        units = kind.run_pass(state, len(passes))
                except Exception as error:  # a pass that fails is counted, and the run is not correct
                    log(f"pass {len(passes)} failed: {error!r}")
                    failed += kind.units_per_pass(state)
                    break
                passes.append({"units": units, "seconds": time.perf_counter() - begin})
            if on_card:
                torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        if tracer:
            tracer.stop()
        spans.uninstall()
        memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        units = sum(p["units"] for p in passes)
        run = Run(cell.name, cell.config, cell.traffic, units, len(passes), window_s,
                  _delta(kind.program_seconds(state), seconds_before),
                  _delta(kind.program_launches(), launches_before),
                  {name: count * len(passes) for name, count in kind.pass_counts(state).items()},
                  device_name=torch.cuda.get_device_name(0) if on_card else "cpu")
        metrics: Dict[str, dict] = {}
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": run.device_name, "count": cell.chips if on_card else 0,
                       "memory_peak_bytes": memory_peak}
        breakdown = None
        if trace:
            summary = tracer.summary()
            run.trace = summary
            device_info["busy_s"] = summary.busy_s
            device_info["window_s"] = summary.window_s
            breakdown = {"device_ops": summary.device_ops(10), "idle_gaps": summary.idle_gaps(10)}
            for metric in cell.per_layer:
                value = read_metric(metric, run)
                if value is not None:
                    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        else:
            for metric in cell.end_to_end:
                if metric["name"] == "setup_s":
                    value = setup_s
                else:
                    value = kind.end_to_end(metric["name"], units, window_s)
                if value is not None:
                    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        pass_s = [p["seconds"] for p in passes]
        log(f"{cell.name} seed {seed}: setup {setup_s:.3f} s, window {window_s:.3f} s, {len(passes)} passes "
            f"({', '.join(f'{s:.3f}' for s in pass_s)} s), {units} {kind.UNITS}, "
            f"median pass {statistics.median(pass_s) if pass_s else float('nan'):.3f} s; "
            f"program seconds {run.seconds}; launches {run.launches}; peak memory {memory_peak} bytes; "
            f"bytes written by this process {_bytes_written()}")
        kind.release(state)
        if on_card:
            torch.cuda.empty_cache()
        compared = kind.check(state, passes)
        if control:
            for name, (value, limit) in kind.control(state).items():
                log(f"control {name}: {value!r} (limit {limit!r})")
        correct = failed == 0 and bool(passes) and all(value <= limit for value, limit in compared.values())
        result = {"correct": correct, "attempted": units + failed, "failed": failed, "metrics": metrics,
                  "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["compared"] = {name: {"value": value, "limit": limit} for name, (value, limit) in compared.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: List[str], t0: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0,
                        help="also print the control's readings (the reference below the stated precision)")
    args = parser.parse_args(argv)
    try:
        cell = resolve(load_manifest(), args.workload)
        import torch

        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card and does not fall back")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
        for sub in ("torch_extensions", "triton"):
            (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
        begin = time.perf_counter()
        cell.kind.build()
        # part of set-up, as the compilation of a checkout's first run is;
        # 0.0x s once the checkout has built
        log(f"build: {time.perf_counter() - begin:.3f} s")
        result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0,
                         control=bool(args.control))
    except Refused as refusal:
        log(f"refused: {refusal}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"refused: the process holds modules of JAX or the JAX package: {', '.join(found)}")
        return 4
    for name, item in result["compared"].items():
        print(f"{name}: {item['value']!r} (limit {item['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
