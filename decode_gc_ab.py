#!/usr/bin/env python3
"""Time the metrics decode with and without the cyclic collector paused.

    python3 decode_gc_ab.py [--records N] [--seed N] [--rounds N]

Writes ``chip_smoke.py`` phase 5's synthetic 10x v2 BAM sorted by
(CB, UB, GE) (1,250,000 records by default) and decodes it with the port's
``iter_frames_from_bam`` into frames of 2^20 records, as the metrics
commands do. Runs alternate within one process, A B B A per round: A with
``io.packed``'s collector pause as it stands, B with the pause replaced by a
no-op. torch is imported first, as in the commands, so the collector walks
the same resident objects. Prints each run's seconds, the median of each arm
and the machine's first GPU as nvidia-smi names it. Needs no GPU itself.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".decode_gc_ab_work"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--records", type=int, default=1_250_000)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch  # noqa: F401  (resident, as in the metrics commands)

    import chip_smoke
    from sctools_tpu_torch.io import bgzf, packed

    try:
        stamp = chip_smoke.nvidia_smi("name,power.limit")
    except (OSError, subprocess.SubprocessError):
        stamp = "no GPU"
    WORK.mkdir(exist_ok=True)
    try:
        rng = np.random.default_rng(args.seed)
        reads = chip_smoke.sort_reads(chip_smoke.make_reads(rng, args.records), "cell")
        bam = WORK / "cell_sorted.bam"
        chip_smoke.write_tagged_bam(bam, rng, reads, bgzf)
        del reads
        paused = packed._cyclic_gc_paused
        times = {"A": [], "B": []}
        for _ in range(args.rounds):
            for arm in "ABBA":
                packed._cyclic_gc_paused = paused if arm == "A" else contextlib.nullcontext
                gc.collect()
                start = time.perf_counter()
                n = sum(f.n_records for f in packed.iter_frames_from_bam(str(bam), 1 << 20))
                seconds = time.perf_counter() - start
                packed._cyclic_gc_paused = paused
                if n != args.records:
                    raise AssertionError(f"decoded {n} records, wrote {args.records}")
                times[arm].append(seconds)
                print(f"[decode_gc_ab] {arm} ({'paused' if arm == 'A' else 'collector on'}): "
                      f"{n} records in {seconds:.2f} s = {n / seconds:.0f} records/s", flush=True)
        a, b = statistics.median(times["A"]), statistics.median(times["B"])
        print(f"[decode_gc_ab] {stamp} | median paused {a:.2f} s, collector on {b:.2f} s, "
              f"paused/on {a / b:.3f}", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
