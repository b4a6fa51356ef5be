#!/usr/bin/env python3
"""Time the port's FASTQ and BAM commands and its CSV writer at two trees, in turns.

    python3 fastq_ab.py --parent DIR [--reads N] [--cell-records N]
        [--count-queries N] [--sort-records N] [--split-records N]
        [--only fastq|bam|split] [--seed N] [--device cuda|cpu]

``DIR`` holds another tree of the repository (a ``git archive`` of an
earlier commit, unpacked). Both trees run the same inputs, generated once
from ``--seed`` with ``chip_smoke.py``'s generators:

- FASTQ (its phase 4 and 7 widths): 262,144 10x v2 triplets in two triplet
  files and a u2 BAM of as many 98 bp reads, the 737,280 x 16 bp synthetic
  whitelist, 131,072 slide-seq pairs (8C18X6C9M1X) with a 100,000 x 14 bp
  whitelist, and a metrics block of 33,538 rows x 24 columns (the gene
  CSV's shape);
- BAM (its phase 5, 6 and 8 libraries): 6,500,000 records sorted by (CB,
  UB, GE), six full batches of the gatherer's 2^20 and a remainder, so that
  the ingest ring's slots are reused; a queryname-grouped library of
  2,100,000 queries (some 3.3 million records: six full batches of the
  count's 2^19 and a remainder) over a 33,538-gene GTF; and 1,250,000
  records in a random order for the fused sort (the size of the smoke's
  phase 8: its frames come from the sort's pipe, through no arena slot);
- split (the smoke's phase 10): SplitBam -t CB of a 1,250,000-record
  BAM sorted by (CB, UB, GE), the smoke's phase 5 library, with ``-s``
  its size over 4.5, so into 5 chunks. Which chunk a barcode lands in
  depends on ``PYTHONHASHSEED``, so every run's is ``--seed``.

Each tree runs in its own process, in the order parent, tree, tree,
parent, builds its native layer and its kernels first, and times through
the entry points: FastqProcess -w (BAM and FASTQ shards, 4 shards),
Attach10xBarcodes with and without -w, SampleFastq, FastqMetrics,
``MetricCSVWriter.write_block`` of the block with its close,
CalculateCellMetrics, CreateCountMatrix, TagSortBam -t CB UB GE
--cell-metrics-output -o and SplitBam. Prints each run's reads/s (rows/s for the CSV,
records/s for the BAM commands) and seconds, with the BAM commands' decode
split as each tree reports it (this tree: the ring's producer seconds on
its thread, ``decode``, beside the main thread's wait on the ring,
``decode_wait``, and the ring's batches), the card's name and power limit,
and checks that the two trees wrote the same outputs (decompressed; count
matrices by their arrays, as the ``.npz`` bytes hold the save's time). The
last line of its output holds all results as one JSON object. ``--only``
runs one of the three groups. Work files go to ``.fastq_ab_work/`` and are
removed.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
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
GROUPS = ("fastq", "bam", "split")


def make_inputs(work: Path, args) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from sctools_tpu_torch.io import bgzf

    rng = np.random.default_rng(args.seed)
    records = {}
    if "fastq" in args.groups:
        make_fastq_inputs(work, args.reads, rng, cs, bgzf)
    if "bam" in args.groups:
        cell = cs.sort_reads(cs.make_reads(rng, args.cell_records), "cell")
        cs.write_tagged_bam(work / "cell_sorted.bam", rng, cell, bgzf)
        del cell
        cs.write_mito_gtf(work / "mito.gtf")
        library = cs.make_count_library(rng, args.count_queries)
        cs.write_tagged_bam(work / "count.bam", rng, library, bgzf)
        cs.write_gene_gtf(work / "genes.gtf")
        reads = cs.make_reads(rng, args.sort_records)
        order = rng.permutation(args.sort_records)
        cs.write_tagged_bam(work / "shuffled.bam", rng, {k: v[order] for k, v in reads.items()}, bgzf)
        records.update({"cell_sorted.bam": args.cell_records, "count.bam": len(library["qname"]),
                        "shuffled.bam": args.sort_records})
    if "split" in args.groups:
        cs.write_tagged_bam(work / "split_cell.bam", rng,
                            cs.sort_reads(cs.make_reads(rng, args.split_records), "cell"), bgzf)
        records["split_cell.bam"] = args.split_records
    if records:
        (work / "records.json").write_text(json.dumps(records))


def make_fastq_inputs(work: Path, reads: int, rng, cs, bgzf) -> None:
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


@contextlib.contextmanager
def recording(module, name: str, into: list):
    """Within the block, ``module.name`` (a class) is a subclass that
    appends each instance to ``into``."""
    cls = getattr(module, name)

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            into.append(self)

    setattr(module, name, Recorded)
    try:
        yield
    finally:
        setattr(module, name, cls)


def run_arm(root: Path, work: Path, out: Path, reads: int, device: str, groups) -> dict:
    """One tree's timings, in this process (``root`` first on sys.path)."""
    sys.path.insert(0, str(root))
    import io

    import torch

    from sctools_tpu_torch import kernels, native, platform

    # built before any timed run: the native layer, and on the card the kernels
    native.library()
    if device == "cuda":
        for name in kernels.launches:
            kernels.library(name)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kwargs = {} if device == "cuda" else {"device": "cpu"}
    out.mkdir(parents=True)
    commands = {}

    def timed(name, n, call, record=None):
        made = []
        sync()
        start = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()), \
                (recording(platform, record, made) if record else contextlib.nullcontext()):
            call()
        sync()
        seconds = time.perf_counter() - start
        commands[name] = {"seconds": seconds, "per_s": n / seconds}
        if made:
            # the tree's own split; the ring's batches where it has a ring
            commands[name].update(split=dict(made[0].seconds),
                                  ring_batches=getattr(made[0], "ring_batches", None))

    if "fastq" in groups:
        time_fastq(work, out, reads, platform, kwargs, timed)
    if "bam" in groups:
        time_bam(work, out, platform, kwargs, timed)
    if "split" in groups:
        time_split(work, out, platform, timed)
    return commands


def time_fastq(work: Path, out: Path, reads: int, platform, kwargs, timed) -> None:
    from sctools_tpu_torch.metrics.writer import MetricCSVWriter

    triplets = {k: [str(work / f"{k}_{t}.fastq.gz") for t in range(2)] for k in ("r1", "r2", "i1")}
    total_bytes = sum(Path(p).stat().st_size for paths in triplets.values() for p in paths)
    bam_size = total_bytes / (3.5 * (1 << 30))  # ceil(3.5) = 4 shards

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


def time_bam(work: Path, out: Path, platform, kwargs, timed) -> None:
    records = json.loads((work / "records.json").read_text())
    cell, count, shuffled = (work / name for name in ("cell_sorted.bam", "count.bam", "shuffled.bam"))
    timed("CalculateCellMetrics", records[cell.name], lambda: platform.GenericPlatform.calculate_cell_metrics(
        ["-i", str(cell), "-o", str(out / "cell"), "-a", str(work / "mito.gtf")], **kwargs),
        record="GatherCellMetrics")
    timed("CreateCountMatrix", records[count.name], lambda: platform.GenericPlatform.bam_to_count_matrix(
        ["-b", str(count), "-a", str(work / "genes.gtf"), "-o", str(out / "count")], **kwargs),
        record="CountMatrix")
    timed("TagSortBam --cell-metrics-output -o", records[shuffled.name],
          lambda: platform.GenericPlatform.tag_sort_bam(
              ["-i", str(shuffled), "-t", "CB", "UB", "GE", "--cell-metrics-output", str(out / "fused"),
               "-a", str(work / "mito.gtf"), "-o", str(out / "fused_sorted.bam")], **kwargs),
          record="GatherCellMetrics")


def time_split(work: Path, out: Path, platform, timed) -> None:
    """SplitBam into ``out``, its scratch directories in ``out`` too."""
    bam = work / "split_cell.bam"
    records = json.loads((work / "records.json").read_text())[bam.name]

    def split():
        with contextlib.chdir(out):
            platform.GenericPlatform.split_bam(
                ["-b", str(bam), "-p", str(out / "chunk"), "-s", repr(bam.stat().st_size * 1e-6 / 4.5),
                 "-t", "CB"])

    timed("SplitBam -t CB", records, split)


def outputs(directory: Path) -> dict:
    """Every output file of an arm, decompressed where it is gzip; a
    ``.npz`` as its arrays' bytes (its zip members carry the save's time).
    ``gzip.open`` streams: ``gzip.decompress`` copies the rest of the data
    for each of a BGZF file's thousands of members."""
    files = {}
    for path in sorted(directory.iterdir()):
        if path.suffix == ".npz":
            with np.load(path) as arrays:
                files[path.name] = {key: (arrays[key].dtype.str, arrays[key].tobytes()) for key in arrays.files}
            continue
        with open(path, "rb") as f:
            gzipped = f.read(2) == b"\x1f\x8b"
        with (gzip.open if gzipped else open)(path, "rb") as f:
            files[path.name] = f.read()
    return files


def describe(name: str, result: dict) -> str:
    unit = "rows" if "CSV" in name else "reads" if "Fastq" in name or "Attach" in name else "records"
    line = f"{name} {result['seconds']:.3f} s = {result['per_s']:.0f} {unit}/s"
    split = result.get("split")
    if split:
        line += "; " + ", ".join(f"{key} {value:.3f} s" for key, value in split.items())
        if result.get("ring_batches") is not None:
            line += f"; ring batches {result['ring_batches']}"
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="the other tree's root")
    parser.add_argument("--reads", type=int, default=1 << 18)
    parser.add_argument("--cell-records", type=int, default=6_500_000)
    parser.add_argument("--count-queries", type=int, default=2_100_000)
    parser.add_argument("--sort-records", type=int, default=1_250_000)
    parser.add_argument("--split-records", type=int, default=1_250_000)
    parser.add_argument("--only", choices=GROUPS, help="time one group of commands")
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--arm", type=Path, help=argparse.SUPPRESS)  # a child process: this tree's root
    parser.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    args.groups = (args.only,) if args.only else GROUPS
    if args.arm is not None:
        print(json.dumps(run_arm(args.arm, WORK, args.out, args.reads, args.device, args.groups)))
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
        make_inputs(WORK, args)
        records = WORK / "records.json"
        sizes = f"; BAM records {records.read_text()}" if records.exists() else ""
        print(f"[ab] inputs made in {time.perf_counter() - start:.1f} s{sizes}; {stamp}", flush=True)
        runs = []
        for k, (label, root) in enumerate((("parent", args.parent.resolve()), ("tree", REPO),
                                           ("tree", REPO), ("parent", args.parent.resolve()))):
            out = WORK / f"out_{k}_{label}"
            child = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--arm", str(root), "--out", str(out),
                 "--reads", str(args.reads), "--device", args.device]
                + (["--only", args.only] if args.only else []),
                capture_output=True, text=True, cwd=str(root),
                env=dict(os.environ, PYTHONHASHSEED=str(args.seed)))
            if child.returncode != 0:
                raise SystemExit(f"fastq_ab: the {label} run failed:\n{child.stderr[-4000:]}")
            commands = json.loads(child.stdout.strip().splitlines()[-1])
            runs.append({"arm": label, "commands": commands})
            for name, result in commands.items():
                print(f"[ab] run {k + 1} {label}: {describe(name, result)}", flush=True)
        same = outputs(WORK / "out_0_parent") == outputs(WORK / "out_1_tree")
        print(f"[ab] the two trees' outputs, decompressed, are {'equal' if same else 'DIFFERENT'}")
        result = {"device": stamp, "reads": args.reads, "cell_records": args.cell_records,
                  "count_queries": args.count_queries, "sort_records": args.sort_records,
                  "split_records": args.split_records, "runs": runs,
                  "outputs_equal": same}
        print(json.dumps(result))
        return 0 if same else 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
