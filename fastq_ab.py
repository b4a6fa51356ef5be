#!/usr/bin/env python3
"""Time the port's FASTQ commands and metrics CSV writer at two trees, in turns.

    python3 fastq_ab.py --parent DIR [--reads N] [--seed N] [--device cuda|cpu]

``DIR`` holds another tree of the repository (a ``git archive`` of an
earlier commit, unpacked). Both trees run the same inputs, generated once
from ``--seed`` with ``chip_smoke.py``'s generators at its phase 4 and 7
widths: 262,144 10x v2 triplets in two triplet files and a u2 BAM of as many
98 bp reads, the 737,280 x 16 bp synthetic whitelist, 131,072 slide-seq
pairs (8C18X6C9M1X) with a 100,000 x 14 bp whitelist, and a metrics block of
33,538 rows x 24 columns (the gene CSV's shape). Each tree runs in its own
process, in the order parent, tree, tree, parent, builds its native layer
and its kernels first, and times through the entry points: FastqProcess -w
(BAM and FASTQ shards, 4 shards), Attach10xBarcodes with and without -w,
SampleFastq, FastqMetrics, and ``MetricCSVWriter.write_block`` of the
block with its close. Prints each run's reads/s (rows/s for the CSV) and
seconds, the card's name and power limit, and checks that the two trees
wrote the same decompressed outputs; the last line of its output holds
all results as one JSON object. Work files go to ``.fastq_ab_work/`` and
are removed.
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".fastq_ab_work"
CSV_ROWS, CSV_COLUMNS = 33_538, 24
SLIDESEQ_WHITELIST = 100_000


def make_inputs(work: Path, reads: int, seed: int) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from sctools_tpu_torch.io import bgzf

    rng = np.random.default_rng(seed)
    whitelist = cs.make_whitelist(rng, cs.WHITELIST_SIZE, cs.CB_LEN)
    newline = np.full((len(whitelist), 1), ord("\n"), dtype=np.uint8)
    (work / "whitelist.txt").write_bytes(np.concatenate([whitelist, newline], axis=1).tobytes())
    cb, _, _ = cs.make_queries(rng, whitelist, reads)
    r1 = np.concatenate([cb, cs.LETTERS[rng.integers(0, 4, size=(reads, cs.R1_LEN - cs.CB_LEN))]], axis=1)
    rows = {
        "r1": r1,
        "r2": cs.LETTERS[rng.integers(0, 4, size=(reads, cs.R2_LEN))],
        "i1": cs.LETTERS[rng.integers(0, 4, size=(reads, cs.SAMPLE_LEN))],
    }
    names = [b"r%07d 1:N:0:1" % i for i in range(reads)]
    cuts = ((0, reads // 2), (reads // 2, reads))
    for kind, seqs in rows.items():
        quals = rng.integers(35, 75, size=seqs.shape, dtype=np.uint8)
        cs.write_fastq_files([str(work / f"{kind}_{t}.fastq.gz") for t in range(2)], names,
                             cs.full_rows(seqs), cs.full_rows(quals), cuts)
    cs.write_fastq_gz(work / "attach_r1.fastq.gz", cs.full_rows(r1),
                      cs.full_rows(rng.integers(35, 75, size=r1.shape, dtype=np.uint8)))
    cs.write_u2(work / "u2.bam", rng, reads, bgzf)

    pairs = reads // 2
    wl14 = cs.make_whitelist(rng, SLIDESEQ_WHITELIST, 14)
    (work / "whitelist14.txt").write_bytes(
        np.concatenate([wl14, np.full((len(wl14), 1), ord("\n"), np.uint8)], axis=1).tobytes())
    barcodes, _, _ = cs.make_queries(rng, wl14, pairs)
    s1 = np.concatenate([barcodes[:, :8], cs.LETTERS[rng.integers(0, 4, size=(pairs, 18))], barcodes[:, 8:],
                         cs.LETTERS[rng.integers(0, 4, size=(pairs, 10))]], axis=1)
    s_names = [b"s%07d" % i for i in range(pairs)]
    for kind, seqs in (("s1", s1), ("s2", cs.LETTERS[rng.integers(0, 4, size=(pairs, cs.R2_LEN))])):
        quals = rng.integers(35, 75, size=seqs.shape, dtype=np.uint8)
        cs.write_fastq_files([str(work / f"{kind}_{t}.fastq.gz") for t in range(2)], s_names,
                             cs.full_rows(seqs), cs.full_rows(quals), ((0, pairs // 3), (pairs // 3, pairs)))


def run_arm(root: Path, work: Path, out: Path, reads: int, device: str) -> dict:
    """One tree's timings, in this process (``root`` first on sys.path)."""
    sys.path.insert(0, str(root))
    import contextlib
    import io

    import torch

    from sctools_tpu_torch import kernels, native, platform
    from sctools_tpu_torch.metrics.writer import MetricCSVWriter

    # built before any timed run: the native layer, and on the card the kernels
    native.library()
    if device == "cuda":
        for name in kernels.launches:
            kernels.library(name)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kwargs = {} if device == "cuda" else {"device": "cpu"}
    out.mkdir(parents=True)
    triplets = {k: [str(work / f"{k}_{t}.fastq.gz") for t in range(2)] for k in ("r1", "r2", "i1")}
    total_bytes = sum(Path(p).stat().st_size for paths in triplets.values() for p in paths)
    bam_size = total_bytes / (3.5 * (1 << 30))  # ceil(3.5) = 4 shards
    commands = {}

    def timed(name, n, call):
        sync()
        start = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
            call()
        sync()
        seconds = time.perf_counter() - start
        commands[name] = {"seconds": seconds, "per_s": n / seconds}

    for fmt in ("BAM", "FASTQ"):
        args = ["--r1", *triplets["r1"], "--r2", *triplets["r2"], "--i1", *triplets["i1"],
                "-w", str(work / "whitelist.txt"), "--bam-size", repr(bam_size), "--sample-id", "ab",
                "--output-format", fmt, "-o", str(out / f"shard_{fmt.lower()}")]
        timed(f"FastqProcess -w {fmt}", reads, lambda: platform.TenXV2.fastq_process(args, **kwargs))
    attach = ["--r1", str(work / "attach_r1.fastq.gz"), "--u2", str(work / "u2.bam")]
    timed("Attach10xBarcodes -w", reads, lambda: platform.TenXV2.attach_barcodes(
        attach + ["-o", str(out / "tagged.bam"), "-w", str(work / "whitelist.txt")], **kwargs))
    timed("Attach10xBarcodes", reads, lambda: platform.TenXV2.attach_barcodes(
        attach + ["-o", str(out / "tagged_plain.bam")], **kwargs))
    pairs = reads // 2
    timed("SampleFastq", pairs, lambda: platform.GenericPlatform.sample_fastq(
        ["--R1", *(str(work / f"s1_{t}.fastq.gz") for t in range(2)),
         "--R2", *(str(work / f"s2_{t}.fastq.gz") for t in range(2)),
         "--white-list", str(work / "whitelist14.txt"), "--read-structure", "8C18X6C9M1X",
         "--output-prefix", str(out / "sampled")], **kwargs))
    timed("FastqMetrics", reads, lambda: platform.GenericPlatform.fastq_metrics(
        ["--R1", *triplets["r1"], "--read-structure", "16C10M", "--sample-id", str(out / "fastq_metrics")]))

    rng = np.random.default_rng(7)
    index = [f"GENE{i:05d}" for i in range(CSV_ROWS)]
    columns = [rng.integers(0, 10**6, CSV_ROWS) if c % 3 == 0 else rng.random(CSV_ROWS) * 10.0 ** (c % 7 - 3)
               for c in range(CSV_COLUMNS)]

    def write_csv():
        writer = MetricCSVWriter(str(out / "block"))
        writer.write_header({f"c{c}": 0 for c in range(CSV_COLUMNS)})
        writer.write_block(index, columns)
        writer.close()

    timed("MetricCSVWriter.write_block + close", CSV_ROWS, write_csv)
    return commands


def outputs(directory: Path) -> dict:
    """Every output file of an arm, decompressed where it is gzip."""
    files = {}
    for path in sorted(directory.iterdir()):
        data = path.read_bytes()
        files[path.name] = gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data
    return files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="the other tree's root")
    parser.add_argument("--reads", type=int, default=1 << 18)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--arm", type=Path, help=argparse.SUPPRESS)  # a child process: this tree's root
    parser.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.arm is not None:
        print(json.dumps(run_arm(args.arm, WORK, args.out, args.reads, args.device)))
        return 0
    if args.parent is None or not (args.parent / "sctools_tpu_torch").is_dir():
        raise SystemExit("fastq_ab: --parent must name a tree with a sctools_tpu_torch package")
    stamp = "no GPU (CPU run)"
    if args.device == "cuda":
        stamp = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    try:
        start = time.perf_counter()
        make_inputs(WORK, args.reads, args.seed)
        print(f"[ab] inputs made in {time.perf_counter() - start:.1f} s; {stamp}", flush=True)
        runs = []
        for k, (label, root) in enumerate((("parent", args.parent.resolve()), ("tree", REPO),
                                           ("tree", REPO), ("parent", args.parent.resolve()))):
            out = WORK / f"out_{k}_{label}"
            child = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--arm", str(root), "--out", str(out),
                 "--reads", str(args.reads), "--device", args.device],
                capture_output=True, text=True, cwd=str(root))
            if child.returncode != 0:
                raise SystemExit(f"fastq_ab: the {label} run failed:\n{child.stderr[-4000:]}")
            commands = json.loads(child.stdout.strip().splitlines()[-1])
            runs.append({"arm": label, "commands": commands})
            for name, result in commands.items():
                print(f"[ab] run {k + 1} {label}: {name} {result['seconds']:.3f} s = "
                      f"{result['per_s']:.0f} {'rows' if 'CSV' in name else 'reads'}/s", flush=True)
        same = outputs(WORK / "out_0_parent") == outputs(WORK / "out_1_tree")
        print(f"[ab] the two trees' outputs, decompressed, are {'equal' if same else 'DIFFERENT'}")
        result = {"device": stamp, "reads": args.reads, "runs": runs, "outputs_equal": same}
        print(json.dumps(result))
        return 0 if same else 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
