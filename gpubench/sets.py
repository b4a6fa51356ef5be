"""Run one cell on several seeds, one process a run, and summarise the spread.

    python3 gpubench/sets.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--trace 0|1] [--control 0|1] [--warmup <seed>] [--log <file>]

``--warmup`` runs one seed first and leaves it out of the summary: the run
that builds in a fresh checkout, whose set-up is recorded apart.

Each run is ``gpubench/run.py`` in a process of its own, one after the
other. The summary gives each run's result line, the card's name and power
limit, and for every metric its median and its spread: the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) over
the median. ``--log`` keeps every run's full standard output and error.
After each run a host probe times the same deflate work, so that a run
whose rates read low can be told from a slow host; the runs themselves do
not pay for it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def host_probe() -> str:
    """Seconds to deflate the same bytes at level 1, 4 MiB on one thread and
    16 MiB on eight."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    # bytes of a 16-letter alphabet: they deflate about as sequencing text does
    raw = np.random.default_rng(0).integers(0, 16, size=16 << 20, dtype=np.uint8) + ord("A")
    data = [raw[i << 20 : (i + 1) << 20].tobytes() for i in range(16)]
    begin = time.perf_counter()
    for chunk in data[:4]:
        zlib.compress(chunk, 1)
    one = time.perf_counter() - begin
    begin = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda chunk: zlib.compress(chunk, 1), data))
    return f"host probe: deflate 4 MiB on one thread {one:.4f} s, 16 MiB on eight {time.perf_counter() - begin:.4f} s"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--warmup", type=int, default=None)
    parser.add_argument("--log", default=None)
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    print(f"card: {card()}", flush=True)
    log = open(args.log, "a") if args.log else None
    results = []
    runs = ([(args.warmup, True)] if args.warmup is not None else []) + [(seed, False) for seed in seeds]
    for seed, warmup in runs:
        command = [sys.executable, "gpubench/run.py", "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.control:
            command += ["--control", "1"]
        begin = time.perf_counter()
        done = subprocess.run(command, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - begin
        last = done.stdout.strip().splitlines()[-1] if done.stdout.strip() else ""
        try:
            result = json.loads(last)
        except json.JSONDecodeError:
            result = None
        notes = [line for line in done.stderr.splitlines() if line.startswith("[gpubench]")]
        tail = done.stderr.strip().splitlines()[-8:]
        if log:
            log.write(f"=== {args.workload} seed {seed} rc {done.returncode} wall {wall:.3f} s\n")
            log.write(done.stdout[-20000:] + "\n--- stderr\n" + done.stderr[-40000:] + "\n")
            log.flush()
        print(f"--- {'warm-up ' if warmup else ''}seed {seed}: rc {done.returncode}, process wall {wall:.3f} s; {host_probe()}", flush=True)
        for line in notes:
            print("   ", line[:1500], flush=True)
        if result is None:
            print("    no result; stderr tail:", *tail, sep="\n      ", flush=True)
            continue
        print("    " + json.dumps(result)[:3000], flush=True)
        if not warmup:
            results.append(result)
    names = sorted({name for r in results for name in r["metrics"]})
    print(f"summary {args.workload}: {len(results)}/{len(seeds)} results, "
          f"{sum(r['correct'] for r in results)} correct", flush=True)
    for name in names:
        values = [r["metrics"][name]["value"] for r in results if name in r["metrics"]]
        print(f"  {name}: median {statistics.median(values)!r} spread {spread(values)!r} "
              f"min {min(values)!r} max {max(values)!r} values {values!r}", flush=True)
    compared = sorted({name for r in results for name in r.get("compared", {})})
    for name in compared:
        values = [r["compared"][name]["value"] for r in results if name in r.get("compared", {})]
        print(f"  compared {name}: max {max(values)!r} values {values!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
