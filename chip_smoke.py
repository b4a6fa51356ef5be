#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``sctools_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--seed N] [--reads N]

Phases, in order; any failure exits non-zero before the last line:

1. device  -- requires ``torch.cuda.is_available()``; prints the card's name
              and power limit as nvidia-smi gives them, and the versions;
2. build   -- compiles every kernel of ``sctools_tpu_torch/csrc`` with nvcc
              and, at the same time, the native host layer
              (``sctools_tpu_torch/native``) with g++ against zlib; prints the
              toolchain (g++, which of zlib.h and libdeflate.h it finds, the
              libz it links, the cores), the native layer's thread count and
              the seconds;
3. kernel  -- the whitelist kernel against its plain torch version, exactly,
              at the 10x v2 shape (65,536 queries x a 737,280-barcode
              synthetic whitelist) and on edge cases; times the kernel, the
              plain version and two library score products alone (cuBLAS
              float32, and torch._int_mm on the int8 one-hot tables);
4. attach  -- ``TenXV2.attach_barcodes`` through the port's argparse entry
              on 262,144 synthetic reads (4 batches of 65,536) with the
              737,280-barcode whitelist; every record's tags are re-read and
              checked, CB against the plain version's answer for its CR; the
              run must take the native loop (``native.calls``);
5. metrics -- ``GenericPlatform.calculate_cell_metrics`` and
              ``calculate_gene_metrics`` on the card at the gatherer's
              2^20-record batch width: a synthetic 10x v2 library on GRCh38's
              25 primary sequences, 1,250,000 records sorted by (CB, UB, GE)
              and 1,150,000 of them by (GE, CB, UB), each one full batch, a
              remainder and a carried tail; the CSVs of the commands, of the
              same frames on the card and of the same frames on the CPU must
              be equal byte for byte (decompressed), and per cell n_reads,
              n_molecules, n_genes and n_mitochondrial_molecules must equal
              the generator's counts. Each command must decode through the
              ingest ring's native arena stream and render its CSV through
              the native block formatter (``native.calls``). Prints
              records/s, the wall split (the ring's producer seconds of
              decoding on its thread beside this thread's wait on the ring,
              and the ring's batches), device milliseconds per batch and the
              profiler's top device ops, and the decode alone: the port's Python decoder
              against the native stream over the first 2^18 records of the
              cell BAM, in turns, with equal frames. The metrics path has no
              hand kernel; the phase checks that none launched. The
              commands' CSVs stay for phase 6, the cell CSV and BAM for
              phase 8;
6. count   -- ``GenericPlatform.bam_to_count_matrix`` (CreateCountMatrix) on
              the card at the count's 2^19-record batch width: a
              queryname-grouped 10x v2 library of 750,000 queries (~1,180,000
              records: two full batches, a remainder, carried tails) over all
              33,538 genes of a GTF. The matrix must equal a numpy count of the
              reference's rule over the generator's columns, entry for entry
              and in row order; the file's frames, decoded again and counted
              on the card and on the CPU, must give the same files; the matrix
              split in two must merge back (MergeCountMatrices), and phase 5's
              CSVs must merge as they should (MergeCellMetrics of the cell CSV
              in two files, MergeGeneMetrics of the gene CSV with itself).
              The command must decode through the ingest ring's native
              arena stream. Prints records/s, the wall split (the ring's
              producer decode beside the wait on it), the idle share, and the count
              pass alone on one staged full batch with its top device ops. No
              hand kernel may launch;
7. fastq   -- ``TenXV2.fastq_process`` (FastqProcess -w) on 262,144 synthetic
              10x v2 triplets in two triplet files with the 737,280-barcode
              whitelist, 4 shards from ``--bam-size``, in BAM and in FASTQ
              mode: every shard re-read, every read once, its tags, bases and
              qualities equal to the generator's and its CB to the plain
              version's on the card, the counters, the same shard in both
              modes; ``check_barcode_partition`` 0 on the shards, 1 on a
              shard beside its copy; ``GenericPlatform.sample_fastq`` on
              131,072 slide-seq pairs (8C18X6C9M1X) with a 100,000 x 14 bp
              whitelist, every kept read's R1 rewrite and R2 exact;
              ``fastq_metrics`` on the R1 files against numpy counts. Each
              command must take its native loop (``native.calls``). Prints
              reads/s, the wall split, the BGZF pool's threads and the
              kernel launches of each command, which must equal its batches;
8. sort    -- ``GenericPlatform.tag_sort_bam`` (TagSortBam -t CB UB GE
              --cell-metrics-output -a -o) on the card: phase 5's 1,250,000
              cell records in a shuffled order, sorted on the host by the
              native sort in 3 partials of the default 500,000 records,
              merged through a pipe into the native decoder's 2^20-record
              frames, behind the ingest ring's prefetch stage, for the
              metrics pass on the card in one pass that also writes the
              sorted BAM (``native.calls`` must show that route).
              The CSV must equal
              phase 5's CalculateCellMetrics CSV byte for byte (decompressed)
              and the sorted BAM hold the input's record bodies in phase 5's
              order; ``verify_bam_sort`` 0 on it, SortError on the shuffled
              BAM. ``split_bam`` (-t CB CR, 4 chunks, 4 processes) on phase
              7's BAM shards: every record in exactly one chunk (byte for
              byte but the bin field, which the writer re-encodes), no scratch
              directory left, ``check_barcode_partition`` 0 on the chunks.
              ``group_qc_outputs`` of all five types on small Picard, HISAT2,
              RSEM and Core inputs, every value read back. Prints records/s,
              the sort's split by phase (read, chunk sort, partial writes,
              merge), the metrics pass's split and the idle share; no hand
              kernel may launch;
9. mesh    -- ``--devices 2`` on the card: CalculateCellMetrics and
              CalculateGeneMetrics on phase 5's BAMs, CreateCountMatrix on
              phase 6's, MergeCellMetrics / MergeGeneMetrics (the collective
              merges) on phase 6's merge inputs and the fused TagSortBam on
              phase 8's shuffled BAM, through their entry points on a
              2-shard mesh: two distinct cards where the machine has them,
              else [cuda:0, cuda:0] (then ``--devices 2`` alone must stop at
              the parser, and the commands get the one-card mesh in its
              place). Every CSV must equal its one-device phase's byte for
              byte (decompressed), the count matrix phase 6's, the merges
              the host merges'. ``collective_preflight``,
              ``distributed_metrics_step`` and ``distributed_sort`` on the
              card mesh, over the cell BAM's first 2^18 records, must equal
              the same on a 2-shard CPU mesh. Prints each command's wall
              and ``seconds``; no hand kernel may launch;
10. sched  -- the chunk queue (``sctools_tpu_torch.sched``,
              ``parallel.launch``) on the card: ``split_bam -t CB`` cuts
              phase 5's cell BAM into 5 chunks; two worker processes
              (``chip_smoke.py --sched-worker``, each its own CUDA context)
              run ``run_process_cell_metrics`` on cuda with a 2 s lease TTL:
              A is killed at its first batch of chunk0000 (exit 86), B, a
              straggler that fails chunk0002 twice, steals A's expired lease
              and drains the queue; a clean relaunch makes no attempt and
              ``python -m sctools_tpu_torch.sched status`` exits 0. The
              parts merged with ``merge_sorted_csv_parts`` (journal and
              sequence checks) and with ``collective_merge_parts`` on the
              card mesh must both equal phase 5's CalculateCellMetrics CSV
              byte for byte (decompressed). Prints each worker's wall,
              attempts, steals and exit code and both merges' seconds; no
              worker may launch a hand kernel. Its chunks stay for phase 11;
11. serve  -- the serving plane (``sctools_tpu_torch.serve``) on the card:
              phase 10's five chunks and six small 30,000-record libraries
              (two a tenant, which the planner's file-size estimate puts in
              the chunks' packs) submitted as three tenants' jobs
              (``python -m sctools_tpu_torch.serve submit``); worker
              processes (``chip_smoke.py --serve-worker``, each ``python -m
              sctools_tpu_torch.serve worker`` on cuda with a 2 s lease TTL
              at the 2^20-record batch width): wA leases one job a tenant
              and is SIGTERM'd inside its pack (an injected
              ``delay@task.claimed``); wB and its replacement wC, each warmed
              on phase 5's cell BAM (its CUDA graphs captured), drain the
              journal in cross-tenant packs. Every job must commit, none
              quarantined, a lease be stolen, a pack hold two tenants, no
              pack degrade and no graph key be captured twice; every served
              CSV must equal its input's solo CalculateCellMetrics CSV on
              the card and the chunks' merge the
              one-shot CSV of phase 5's cell BAM (without -a: a serve job
              carries no GTF), byte for byte (decompressed); ``python -m
              sctools_tpu_torch.sched status`` must exit 0 with the tenant,
              admission, steer and balanced rows lines. Prints each worker's
              warmup, first result, packs, graph captures and replays, the
              pack plans, jobs/s, and one full batch's device pass eager
              against graph replay (presorted and device-sorted); no worker
              may launch a hand kernel;
12. dist   -- processes joined into one mesh on the card: two worker
              processes (``chip_smoke.py --dist-worker``, each its own CUDA
              context) join one ``torch.distributed`` group with
              ``initialize_distributed``, on distinct cards over NCCL where
              the machine has two or more, else both on cuda:0 over gloo
              (the phase asserts the transport it expects). Tier 1: phase
              10's five chunks through ``run_process_cell_metrics`` on cuda
              under the group, ``sync_processes``, rank 0's
              ``merge_sorted_csv_parts``, equal to phase 5's
              CalculateCellMetrics CSV byte for byte (decompressed). Tier 2:
              phase 5's whole cell BAM (1,250,000 records) partitioned by
              cell into 2 shards of the gatherer's 2^20 width, one a process,
              through ``host_local_to_global`` into
              ``distributed_metrics_step`` on the 2-shard ``global_mesh``;
              every per-shard output must equal this process's in-process
              ``[cuda:0, cuda:0]`` step on the same stacked columns, bit for
              bit. Prints the transport, each worker's init seconds, the
              step's wall and device milliseconds (CUDA events) per process
              and the bytes its ``all_to_all`` sent across the process
              boundary; no worker may launch a hand kernel;
13. analysis -- the port's static checks and its runtime lock witness on
              this machine: ``python -m sctools_tpu_torch.analysis
              sctools_tpu_torch chip_smoke.py --json`` must exit 0 with no
              finding, and ``--emit-lock-graph`` writes the static lock
              graph. Two worker processes (``chip_smoke.py
              --analysis-worker``), unwitnessed and then under
              ``SCTOOLS_TPU_LOCK_DEBUG=1`` (with that graph),
              ``SCTOOLS_TPU_FRAME_DEBUG=1`` and ``SCTOOLS_TPU_TRACE``, each
              run attach -w on 131,072 new synthetic reads (2 kernel
              batches; the witnessed one's launches must equal its batches)
              and one sched worker draining phase 10's five chunks. The
              witnessed BAM must equal the unwitnessed one byte for byte and
              each merged CSV phase 5's (decompressed); the witnessed
              worker's ``locks.*.json`` must hold no violation, only
              blocking edges of the static graph, and an acquisition of
              every lock in it; the frame witness must have stamped frames
              and seen no stale read. Prints the passes' seconds and files,
              the locks, edges and entries, each lock's acquisitions and
              the witnessed walls beside the unwitnessed ones;
14. kernels -- one JSON line per the port's kernel contract; its launches are
              those of every main-path run (phases 4, 7 and 13).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The whitelist and the metrics library are synthetic, made from ``--seed``;
the whitelist has the size and length of Cell Ranger's
737K-august-2016.txt. Work files go to ``.chip_smoke_work/`` in the
checkout and are removed at the end.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import csv
import gzip
import io
import json
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke_work"
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
WHITELIST_SIZE = 737_280  # Cell Ranger's 737K-august-2016.txt
CB_LEN, UMI_LEN, SAMPLE_LEN = 16, 10, 8  # 10x v2 (sctools_tpu/platform.py:916-922)
R1_LEN, R2_LEN = 28, 98
BATCH = 1 << 16
# query mix: exact, one ACGT substitution, one N, two substitutions, random,
# lowercase or short
MIX = ("exact", "sub1", "n1", "sub2", "random", "odd")
MIX_P = (0.85, 0.08, 0.02, 0.02, 0.02, 0.01)
INT32_OPS_PER_CLOCK_PER_SM = 64  # Hopper: IADD3/LOP3/SHF/ISETP/SEL
POPC_PER_CLOCK_PER_SM = 16  # Hopper: POPC
# NVIDIA's published H100 SXM peaks (dense, at the 700 W power limit)
INT8_TENSOR_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def log(message: str) -> None:
    print(message, flush=True)


def nvidia_smi(query: str) -> str:
    result = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return result.stdout.strip().splitlines()[0]


def to_card(array: np.ndarray, device):
    """``array`` on ``device`` through the port's host->device seam."""
    import torch

    from sctools_tpu_torch import ingest

    return ingest.upload(array, torch.device(device))


def cuda_ms(fn, repeats: int, warmup: int = 2, groups: int = 3) -> float:
    """Device milliseconds per call of ``fn``.

    ``repeats`` calls are queued back to back between two CUDA events, so
    the host's work to enqueue one call runs while the card executes the
    one before and stays out of the window; the median over ``groups``
    such windows.
    """
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeats)
    return statistics.median(times)


# ---------------------------------------------------------------- inputs


def make_whitelist(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """[n, length] ASCII letters of a random whitelist."""
    return LETTERS[rng.integers(0, 4, size=(n, length), dtype=np.uint8)]


def make_queries(rng, whitelist: np.ndarray, n: int):
    """Barcodes drawn from ``whitelist`` in the MIX proportions.

    Returns ([n, L] ASCII array, lengths, kinds). An "odd" query is all
    lowercase or cut short by 6 bases (its length says which).
    """
    length = whitelist.shape[1]
    kinds = rng.choice(len(MIX), size=n, p=MIX_P)
    out = whitelist[rng.integers(0, whitelist.shape[0], size=n)].copy()
    rows = np.arange(n)
    pos = rng.integers(0, length, size=(n, 2))
    if length > 1:  # a second position, distinct from the first
        pos[:, 1] = (pos[:, 0] + 1 + rng.integers(0, length - 1, size=n)) % length

    def substitute(mask, p):
        codes = np.searchsorted(LETTERS, out[mask, p[mask]])
        out[mask, p[mask]] = LETTERS[(codes + rng.integers(1, 4, size=mask.sum())) % 4]

    sub1, n1, sub2 = (kinds == MIX.index(k) for k in ("sub1", "n1", "sub2"))
    substitute(sub1, pos[:, 0])
    out[rows[n1], pos[n1, 0]] = ord("N")
    substitute(sub2, pos[:, 0])
    substitute(sub2, pos[:, 1])
    random_rows = kinds == MIX.index("random")
    out[random_rows] = LETTERS[rng.integers(0, 4, size=(random_rows.sum(), length))]
    lengths = np.full(n, length)
    odd = np.flatnonzero(kinds == MIX.index("odd"))
    lower, short = odd[::2], odd[1::2]
    out[lower] += ord("a") - ord("A")
    lengths[short] = max(0, length - 6)
    return out, lengths, kinds


def as_bytes(ascii_rows: np.ndarray, lengths: np.ndarray):
    rows = ascii_rows.tobytes()
    width = ascii_rows.shape[1]
    return [rows[i * width : i * width + int(k)] for i, k in enumerate(lengths)]


def write_fastq_gz(path: Path, sequences, qualities) -> None:
    lines = []
    for i, (seq, qual) in enumerate(zip(sequences, qualities)):
        lines.append(b"@r%07d\n%s\n+\n%s\n" % (i, seq, qual))
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(b"".join(lines))


def write_u2(path: Path, rng, n: int, bgzf) -> list:
    """An unaligned BAM of ``n`` 98 bp reads; returns the record bodies."""
    nt16 = np.zeros(256, dtype=np.uint8)
    nt16[list(b"ACGT")] = (1, 2, 4, 8)
    seq = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    packed = (nt16[seq[:, 0::2]] << 4) | nt16[seq[:, 1::2]]
    qual = rng.integers(2, 41, size=(n, R2_LEN), dtype=np.uint8)
    packed_rows, qual_rows = packed.tobytes(), qual.tobytes()
    pw, qw = packed.shape[1], R2_LEN
    fixed = struct.Struct("<iiBBHHHiiii")
    bodies = []
    for i in range(n):
        name = b"r%07d\0" % i
        bodies.append(
            fixed.pack(-1, -1, len(name), 0, 4680, 0, 4, R2_LEN, -1, -1, 0)
            + name + packed_rows[i * pw : (i + 1) * pw] + qual_rows[i * qw : (i + 1) * qw]
        )
    text = b"@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:smoke\n"
    header = b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 0)
    with bgzf.BgzfWriter(str(path)) as out:
        out.write(header)
        out.write(b"".join(struct.pack("<I", len(b)) + b for b in bodies))
    return bodies


# GRCh38's 25 primary sequences (1-22, X, Y, MT) and their lengths
GRCH38 = [
    ("1", 248956422), ("2", 242193529), ("3", 198295559), ("4", 190214555),
    ("5", 181538259), ("6", 170805979), ("7", 159345973), ("8", 145138636),
    ("9", 138394717), ("10", 133797422), ("11", 135086622), ("12", 133275309),
    ("13", 114364328), ("14", 107043718), ("15", 101991189), ("16", 90338345),
    ("17", 83257441), ("18", 80373285), ("19", 58617616), ("20", 64444167),
    ("21", 46709983), ("22", 50818468), ("X", 156040895), ("Y", 57227415), ("MT", 16569),
]
N_GENES, N_MITO_GENES, N_CELLS = 33_538, 37, 1_000  # Cell Ranger's GRCh38-2020-A gene count
METRICS_BATCH = 1 << 20  # the gatherer's DEFAULT_BATCH_RECORDS, never cut
# depth, cut so that the phase's four decodes stay near four minutes on the
# card: each axis keeps one full 2^20-record batch, a cut remainder and the
# carried tail (three device passes)
CELL_RECORDS = 1_250_000
GENE_RECORDS = 1_150_000
XF_VALUES = (b"CODING", b"INTRONIC", b"UTR", b"INTERGENIC", b"")  # b"": no XF tag
XF_P = (0.6, 0.15, 0.1, 0.1, 0.05)


def gene_names() -> np.ndarray:
    """33,538 names of 10 bytes; the last 37 are MT- genes."""
    names = [b"GENE%06d" % i for i in range(N_GENES - N_MITO_GENES)]
    names += [b"MT-G%06d" % i for i in range(N_MITO_GENES)]
    return np.array(names, dtype="S10")


def make_reads(rng, n: int) -> dict:
    """Per-read columns of a synthetic 10x v2 library, in molecule order.

    About 2.4 reads a molecule over ~1,000 cells (lognormal sizes), genes
    Zipf-like over the vocabulary with 5% of molecules on MT- genes; 98 bp
    reads, ~5% unmapped, ~10% duplicates, ~10% spliced (49M1000N49M); XF
    over CODING/INTRONIC/UTR/INTERGENIC/missing with GE only on the first
    three; ~0.5% of GE tags name two genes; NH in {1, 1, 1, 2, 3}; CR = CB
    and UR = UB for 95% of reads.
    """
    cells = np.unique(LETTERS[rng.integers(0, 4, size=(N_CELLS + 64, CB_LEN))].view(f"S{CB_LEN}").ravel())
    cells = np.sort(rng.choice(cells, N_CELLS, replace=False))
    n_mol = int(n / 2.4 * 1.05)  # 2.4 reads a molecule on average; the surplus is cut
    sizes = rng.lognormal(0, 0.6, N_CELLS)
    mol_cell = rng.choice(N_CELLS, n_mol, p=sizes / sizes.sum())
    mol_umi = LETTERS[rng.integers(0, 4, size=(n_mol, UMI_LEN))]
    weights = 1.0 / (np.arange(N_GENES - N_MITO_GENES) + 10.0)
    mol_gene = rng.choice(N_GENES - N_MITO_GENES, n_mol, p=weights / weights.sum())
    mito = rng.random(n_mol) < 0.05
    mol_gene[mito] = N_GENES - N_MITO_GENES + rng.integers(0, N_MITO_GENES, mito.sum())
    mol_ref = np.where(mito, 24, mol_gene % 24)
    lengths = np.array([length for _, length in GRCH38])
    mol_pos = (rng.random(n_mol) * (lengths[mol_ref] - 2000)).astype(np.int64)
    per_mol = 1 + rng.poisson(1.4, n_mol)
    mol = np.repeat(np.arange(n_mol), per_mol)[:n]
    if mol.size < n:
        raise AssertionError("too few molecules for the record count")
    unmapped = rng.random(n) < 0.05
    xf = rng.choice(len(XF_VALUES), n, p=XF_P)
    xf[unmapped] = len(XF_VALUES) - 1
    names = gene_names()
    ge = names[mol_gene[mol]].astype("S21")
    multi = (rng.random(n) < 0.005) & (mol_gene[mol] < N_GENES - N_MITO_GENES - 1)
    ge[multi] = np.char.add(np.char.add(names[mol_gene[mol][multi]], b","), names[mol_gene[mol][multi] + 1])
    ge[xf >= 3] = b""
    cb = cells[mol_cell[mol]]
    cr = cb.view(np.uint8).reshape(n, CB_LEN).copy()
    bad = np.flatnonzero(rng.random(n) < 0.05)
    cr[bad, rng.integers(0, CB_LEN, bad.size)] = ord("N")
    ub = mol_umi[mol]
    ur = ub.copy()
    bad = np.flatnonzero(rng.random(n) < 0.05)
    ur[bad, rng.integers(0, UMI_LEN, bad.size)] = ord("N")
    return dict(
        cell=mol_cell[mol], cb=cb.view(np.uint8).reshape(n, CB_LEN), cr=cr, ub=ub, ur=ur,
        ge=ge, xf=xf, unmapped=unmapped,
        ref=np.where(unmapped, -1, mol_ref[mol]),
        pos=np.where(unmapped, -1, mol_pos[mol] + rng.integers(0, 6, n)),
        reverse=rng.random(n) < 0.5, duplicate=(rng.random(n) < 0.1) & ~unmapped,
        spliced=(rng.random(n) < 0.1) & ~unmapped,
        nh=np.where(unmapped, 0, rng.choice([1, 1, 1, 2, 3], n)),
    )


def sort_reads(reads: dict, order: str) -> dict:
    """The reads sorted by (CB, UB, GE) for ``order="cell"``, else by
    (GE, CB, UB); ties keep their order. A missing GE sorts first."""
    _, ge_code = np.unique(reads["ge"], return_inverse=True)
    umi = (np.searchsorted(LETTERS, reads["ub"]).astype(np.int64) * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    keys = (ge_code, umi, reads["cell"]) if order == "cell" else (umi, reads["cell"], ge_code)
    perm = np.lexsort(keys)
    return {name: column[perm] for name, column in reads.items()}


def _u8(values, dtype) -> np.ndarray:
    return np.ascontiguousarray(values.astype(dtype)).view(np.uint8).reshape(len(values), np.dtype(dtype).itemsize)


def _z_tag(key: bytes, values: np.ndarray) -> np.ndarray:
    head = np.frombuffer(key + b"Z", dtype=np.uint8)
    n = len(values)
    return np.concatenate(
        [np.broadcast_to(head, (n, 3)), values, np.zeros((n, 1), np.uint8)], axis=1
    )


def write_tagged_bam(path: Path, rng, reads: dict, bgzf) -> None:
    """The reads as raw BAM records (tags [CB] CR CY [UB] UR UY [GE] [XF]
    [NH]), built with numpy one layout group at a time, BGZF level 1.
    Optional columns: ``qname`` (the number in each record's name; by
    default its position) and ``has_cb`` / ``has_ub`` (False leaves out the
    CB / UB tag)."""
    n = len(reads["cell"])
    qname = reads.get("qname", np.arange(n))
    has_cb = reads.get("has_cb", np.ones(n, dtype=bool))
    has_ub = reads.get("has_ub", np.ones(n, dtype=bool))
    qual_q = rng.integers(2, 42, size=(n, R2_LEN), dtype=np.uint8)
    seq = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    nt16 = np.zeros(256, dtype=np.uint8)
    nt16[list(b"ACGT")] = (1, 2, 4, 8)
    packed = (nt16[seq[:, 0::2]] << 4) | nt16[seq[:, 1::2]]
    ge_len = np.char.str_len(reads["ge"])
    xf_len = np.array([len(v) for v in XF_VALUES])[reads["xf"]]
    n_cigar = np.where(reads["unmapped"], 0, np.where(reads["spliced"], 3, 1))
    flag = (np.where(reads["unmapped"], 4, 0) | np.where(reads["reverse"], 16, 0)
            | np.where(reads["duplicate"], 1024, 0))
    rows = [None] * n
    layout = np.stack([n_cigar, ge_len, reads["xf"], reads["nh"] > 0, has_cb, has_ub], axis=1)
    groups, group_of = np.unique(layout, axis=0, return_inverse=True)
    for g, (cig, glen, xf_code, has_nh, cb_on, ub_on) in enumerate(groups):
        idx = np.flatnonzero(group_of.ravel() == g)
        m = idx.size
        cigar = {0: [], 1: [R2_LEN << 4], 3: [49 << 4, (1000 << 4) | 3, 49 << 4]}[int(cig)]
        parts = [
            None,  # block_size, filled in below
            _u8(reads["ref"][idx], "<i4"), _u8(reads["pos"][idx], "<i4"),
            np.broadcast_to(np.array([11, 0 if cig == 0 else 255], np.uint8), (m, 2)),
            np.zeros((m, 2), np.uint8), np.broadcast_to(_u8(np.array([cig]), "<u2")[0], (m, 2)),
            _u8(flag[idx], "<u2"), np.broadcast_to(_u8(np.array([R2_LEN]), "<i4")[0], (m, 4)),
            np.broadcast_to(_u8(np.array([-1, -1, 0]), "<i4").ravel(), (m, 12)),
            np.frombuffer(b"".join(b"r%09d\0" % i for i in qname[idx]), np.uint8).reshape(m, 11),
            np.broadcast_to(_u8(np.array(cigar, np.uint32), "<u4").ravel(), (m, 4 * int(cig))),
            packed[idx], qual_q[idx],
            _z_tag(b"CB", reads["cb"][idx]) if cb_on else None, _z_tag(b"CR", reads["cr"][idx]),
            _z_tag(b"CY", qual_q[idx, :CB_LEN] + 33),
            _z_tag(b"UB", reads["ub"][idx]) if ub_on else None, _z_tag(b"UR", reads["ur"][idx]),
            _z_tag(b"UY", qual_q[idx, CB_LEN : CB_LEN + UMI_LEN] + 33),
        ]
        parts = parts[:1] + [part for part in parts[1:] if part is not None]
        if glen:
            parts.append(_z_tag(b"GE", reads["ge"][idx].astype(f"S{glen}").view(np.uint8).reshape(m, glen)))
        if XF_VALUES[xf_code]:
            parts.append(_z_tag(b"XF", np.broadcast_to(np.frombuffer(XF_VALUES[xf_code], np.uint8), (m, len(XF_VALUES[xf_code])))))
        if has_nh:
            parts.append(np.concatenate([np.broadcast_to(np.frombuffer(b"NHC", np.uint8), (m, 3)),
                                         reads["nh"][idx].astype(np.uint8)[:, None]], axis=1))
        width = sum(p.shape[1] for p in parts[1:])
        parts[0] = np.broadcast_to(_u8(np.array([width]), "<i4")[0], (m, 4))
        blob = np.concatenate(parts, axis=1).tobytes()
        size = width + 4
        for j, i in enumerate(idx):
            rows[i] = blob[j * size : (j + 1) * size]
    text = b"@HD\tVN:1.6\tSO:unsorted\n" + b"".join(b"@SQ\tSN:%s\tLN:%d\n" % (name.encode(), length) for name, length in GRCH38)
    header = b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", len(GRCH38))
    for name, length in GRCH38:
        header += struct.pack("<I", len(name) + 1) + name.encode() + b"\0" + struct.pack("<I", length)
    with bgzf.BgzfWriter(str(path), level=1) as out:
        out.write(header)
        for start in range(0, n, 1 << 16):
            out.write(b"".join(rows[start : start + (1 << 16)]))


def write_mito_gtf(path: Path) -> None:
    """A GTF declaring the 37 MT- genes (gene_id = gene_name, as in the BAM's
    GE tags) and a few others."""
    names = gene_names()
    lines = ["#!genome-build synthetic\n"]
    for i, name in enumerate(list(names[:50]) + list(names[-N_MITO_GENES:])):
        chrom = "MT" if name.startswith(b"MT-") else "1"
        lines.append(f'{chrom}\tsmoke\tgene\t{100 * i + 1}\t{100 * i + 90}\t.\t+\t.\t'
                     f'gene_id "{name.decode()}"; gene_name "{name.decode()}";\n')
    path.write_text("".join(lines))


def expected_cell_counts(reads: dict) -> dict:
    """Per cell barcode, (n_reads, n_molecules, n_genes,
    n_mitochondrial_molecules) counted from the generator's columns: a
    molecule is a distinct (CB, UB, GE), a gene a distinct GE (a missing GE
    included), mitochondrial molecules the reads on an MT- gene."""
    cell = reads["cell"]
    _, ge_code = np.unique(reads["ge"], return_inverse=True)
    umi = (np.searchsorted(LETTERS, reads["ub"]).astype(np.int64) * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    molecule = np.unique(np.stack([cell, umi, ge_code], axis=1), axis=0)[:, 0]
    gene = np.unique(np.stack([cell, ge_code], axis=1), axis=0)[:, 0]
    mito = np.char.startswith(reads["ge"], b"MT-")
    counts = np.stack([
        np.bincount(cell, minlength=N_CELLS), np.bincount(molecule, minlength=N_CELLS),
        np.bincount(gene, minlength=N_CELLS), np.bincount(cell, weights=mito, minlength=N_CELLS),
    ], axis=1).astype(np.int64)
    first = np.zeros(N_CELLS, np.int64)
    first[cell] = np.arange(len(cell))
    return {reads["cb"][first[c]].tobytes().decode(): tuple(counts[c]) for c in np.unique(cell)}


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    log(nvidia_smi("name,power.limit"))
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(
        f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"{props.multi_processor_count} SMs, max SM clock {clock_mhz:.0f} MHz, "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}"
    )
    # the plain version runs on the card here: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return props.multi_processor_count, clock_mhz * 1e6


def toolchain_probe() -> str:
    """The host toolchain the native layer builds with: g++'s version, which
    of zlib.h and libdeflate.h its preprocessor finds, the libz and
    libdeflate the linker's cache lists, and the cores."""
    def run(*command, stdin=""):
        result = subprocess.run(command, input=stdin, capture_output=True, text=True)
        return result.returncode, result.stdout

    found = [header for header in ("zlib.h", "libdeflate.h")
             if run("g++", "-E", "-x", "c++", "-", stdin=f"#include <{header}>\n")[0] == 0]
    libraries = [line.split()[0] for line in run("ldconfig", "-p")[1].splitlines()
                 if line.strip().startswith(("libz.so", "libdeflate"))]
    return (f"{run('g++', '--version')[1].splitlines()[0]}; headers found: {', '.join(found) or 'none'}; "
            f"libraries: {', '.join(libraries) or 'none'}; nproc {run('nproc')[1].strip()}")


def phase_build(kernels, native):
    """nvcc for each kernel and g++ for the native layer, all at once."""
    import threading

    log(f"[build] toolchain: {toolchain_probe()}")
    start = time.perf_counter()
    native_seconds, native_error = [], []

    def build_native():
        try:
            native.library()
            native_seconds.append(time.perf_counter() - start)
        except BaseException as error:  # re-raised below, on the main thread
            native_error.append(error)

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    for name in kernels.launches:
        kernels.library(name)
    seconds = time.perf_counter() - start
    native_thread.join()
    if native_error:
        raise native_error[0]
    for name, output in kernels.build_output.items():
        for line in output.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(kernels.launches)} kernel(s) built and loaded in {seconds:.2f} s; the native "
        f"layer ({', '.join(native.SOURCES)}, {' '.join(native.CXX_FLAGS + native.LINK_FLAGS)}) in "
        f"{native_seconds[0]:.2f} s as {native.library_path().name}; native threads "
        f"{native.default_threads()} (decoder), {native.pool_threads()} (FASTQ loops' BGZF pool)")


def kernel_bound_ms(n_q: int, n_w: int, length: int):
    """The least time the card could take for one batch: (ms, "operations" or "bytes").

    Counted from the function: the TPU kernel's one-hot score product,
    [n_q, 4L] x [4L, n_w], whose 0/1 values are exact in int8, at the
    published int8 tensor-core peak (two operations per multiply-add); the
    threshold and the max run beside it and are not counted. Bytes: the
    query codes and the int8 one-hot whitelist table read once, the int32
    indices written once.
    """
    ops_s = 2.0 * n_q * n_w * 4 * length / INT8_TENSOR_OPS_PER_S
    kpad = 32 * -(-4 * length // 32)
    bytes_s = (n_q * length + n_w * kpad + n_q * 4) / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


def int32_issue_floor_ms(n_q: int, n_w: int, length: int, sms: int, clock_hz: float) -> float:
    """The floor of the kernel's first, popc design: its instruction mix at issue rate.

    That design (2-bit packed barcodes on the CUDA cores) spent, per pair and
    per 16-base word, an xor, a shift and two 3-input logic ops (LOP3) on the
    mismatch mask and one POPC to count it; per pair a compare and a select
    kept the best index, and an add per extra word summed the counts. INT32
    ops issue at 64 and POPC at 16 per clock per SM. Kept as the line the
    tensor-core kernel has to come in under, on the same card in the same
    run; not the function's bound.
    """
    words = -(-length // 16)
    pairs = float(n_q) * n_w
    alu = pairs * (4 * words + 2 + (words - 1))
    popc = pairs * words
    seconds = max(alu / INT32_OPS_PER_CLOCK_PER_SM, popc / POPC_PER_CLOCK_PER_SM) / (sms * clock_hz)
    return seconds * 1e3


def check_exact(name: str, got, expected) -> None:
    got, expected = got.cpu().numpy(), expected.cpu().numpy()
    if got.shape != expected.shape or not np.array_equal(got, expected):
        bad = np.flatnonzero(got != expected)[:5]
        raise AssertionError(
            f"{name}: kernel != plain at {bad.tolist()}: "
            f"{got[bad].tolist()} vs {expected[bad].tolist()}"
        )


def edge_case(wl_ops, device, wl_ascii, q_ascii, q_len):
    """(kernel, plain) indices for an ASCII whitelist and ASCII queries."""
    import torch

    length = wl_ascii.shape[1]
    table = wl_ops.make_table(to_card(wl_ops.barcode_codes(
        as_bytes(wl_ascii, np.full(len(wl_ascii), length)), length), device))
    q = to_card(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), length), device)
    got, plain = wl_ops.correct_codes(q, table), wl_ops.correct_plain(q, table)
    torch.cuda.synchronize()
    return got, plain


def phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops):
    import torch

    device = torch.device("cuda")
    table = wl_ops.make_table(
        to_card(wl_ops.barcode_codes(as_bytes(whitelist_ascii, np.full(len(whitelist_ascii), CB_LEN)), CB_LEN), device)
    )
    q_ascii, q_len, _ = make_queries(rng, whitelist_ascii, BATCH)
    queries = to_card(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), CB_LEN), device)

    got = wl_ops.correct_codes(queries, table)
    plain = wl_ops.correct_plain(queries, table)
    torch.cuda.synchronize()
    check_exact("10x v2 batch", got, plain)
    max_abs_err = int((got.long() - plain.long()).abs().max().item())
    hits = int((plain >= 0).sum().item())
    log(f"[kernel] {BATCH} x {table.codes.shape[0]} x L={CB_LEN}: exact "
        f"({hits} hits, max_abs_err {max_abs_err})")

    # edge cases: L = 1 to 64 across every Kpad step, duplicates, N in the
    # whitelist, ragged sizes, n_q = 1 and 129
    edge_rng = np.random.default_rng(7)
    edges = ((1, 5, 3001), (14, 5003, 3001), (16, 2049, 257), (17, 1025, 999), (24, 1000, 300),
             (32, 1000, 300), (33, 777, 555), (49, 1031, 611), (64, 1537, 700), (16, 3000, 1),
             (16, 3000, 129))
    for length, n_w, n_q in edges:
        wl = make_whitelist(edge_rng, n_w, length)
        wl[3, 0] = ord("N")
        wl[-1] = wl[1]  # duplicate: the last copy wins
        qa, ql, _ = make_queries(edge_rng, wl, n_q)
        head = min(4, n_q)
        qa[:head], ql[:head] = wl[[1, 3, -1, 0][:head]], length
        got_e, plain_e = edge_case(wl_ops, device, wl, qa, ql)
        check_exact(f"edge L={length} n_w={n_w} n_q={n_q}", got_e, plain_e)
        if length > 1 and got_e[0].item() != n_w - 1:
            raise AssertionError(f"duplicate entry: got {got_e[0].item()}, want the last ({n_w - 1})")
    # the only reachable entry in the kernel's last, partial 512-row slice
    for length in (1, 16, 64):
        n_w = 2 * 512 + 77
        wl = np.full((n_w, length), ord("N"), dtype=np.uint8)
        wl[-1] = make_whitelist(edge_rng, 1, length)[0]
        qa, ql, _ = make_queries(edge_rng, wl[-1:], 300)
        got_e, plain_e = edge_case(wl_ops, device, wl, qa, ql)
        check_exact(f"last-slice hit L={length}", got_e, plain_e)
        if not bool((got_e[ql == length] == n_w - 1).any()):
            raise AssertionError(f"last-slice hit L={length}: no query found entry {n_w - 1}")
    log(f"[kernel] edge cases exact: L={', '.join(str(e[0]) for e in edges[:9])}; duplicates; "
        "N in whitelist; ragged n_q/n_w; n_q = 1 and 129; the only hit in the last partial slice")

    ms = cuda_ms(lambda: wl_ops.correct_codes(queries, table), repeats=15)
    plain_ms = cuda_ms(lambda: wl_ops.correct_plain(queries, table), repeats=3, warmup=1)
    # yardsticks only, never called by the port: the one-hot score product
    # alone, chunked like the plain version (the full [65,536 x 737,280]
    # score matrix would be 193 GB), by cuBLAS in float32 and by
    # torch._int_mm on the int8 one-hot tables (the tensor cores' own rate
    # on this shape)
    chunk = wl_ops.PLAIN_CHUNK

    def score_product(q_onehot, w_onehot, matmul, dtype):
        scores = torch.empty(BATCH * chunk, dtype=dtype, device=device)

        def run():
            for start in range(0, w_onehot.shape[0], chunk):
                w = w_onehot[start : start + chunk]
                matmul(q_onehot, w.T, out=scores[: BATCH * w.shape[0]].view(BATCH, -1))

        return run

    library_ms = cuda_ms(score_product(wl_ops.onehot_codes(queries), wl_ops.onehot_codes(table.codes),
                                       torch.matmul, torch.float32), repeats=3, warmup=1)
    library_int8_ms = cuda_ms(score_product(wl_ops.onehot_int8(queries), table.onehot,
                                            torch._int_mm, torch.int32), repeats=3, warmup=1)
    torch.cuda.empty_cache()
    n_w = table.codes.shape[0]
    bound_ms, bound_by = kernel_bound_ms(BATCH, n_w, CB_LEN)
    floor_ms = int32_issue_floor_ms(BATCH, n_w, CB_LEN, sms, clock_hz)
    log(f"[kernel] per {BATCH}-query batch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: int8 tensor-core one-hot product at the "
        f"published peak, {bound_ms / ms:.0%} of it reached), the first (popc) design's INT32 issue "
        f"floor {floor_ms:.3f} ms (kernel {'under' if ms < floor_ms else 'NOT under'} it), "
        f"score product only: cuBLAS float32 {library_ms:.3f} ms, torch._int_mm int8 "
        f"{library_int8_ms:.3f} ms")
    if ms >= floor_ms:
        raise AssertionError(f"kernel {ms:.3f} ms is not under the popc design's INT32 issue "
                             f"floor {floor_ms:.3f} ms")
    return table, dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                       library_int8_ms=library_int8_ms, int32_issue_floor_ms=floor_ms)


def parse_z_tags(tail: bytes):
    tags = []
    for field in tail.split(b"\0")[:-1]:
        if field[2:3] != b"Z":
            raise AssertionError(f"unexpected tag {field[:3]!r}")
        tags.append((field[:2].decode(), field[3:]))
    return tags


def check_calls(native, what: str, **want) -> None:
    """``native.calls`` must hold ``want`` (a count, or None for at least
    one call) and 0 for every other route."""
    got = dict(native.calls)
    for name, count in want.items():
        calls = got.pop(name)
        if calls < 1 if count is None else calls != count:
            raise AssertionError(f"{what} did not take the native route: {native.calls}")
    if any(got.values()):
        raise AssertionError(f"{what} took another native route too: {native.calls}")


def write_attach_inputs(rng, whitelist_ascii, n_reads: int, bgzf, directory: Path):
    """Attach's inputs in ``directory``: the whitelist, ``n_reads`` synthetic
    10x v2 R1 and I1 reads (gz FASTQ) and a u2 BAM. Returns the R1 and I1
    sequences and qualities and the u2 record bodies."""
    newline = np.full((whitelist_ascii.shape[0], 1), ord("\n"), dtype=np.uint8)
    (directory / "whitelist.txt").write_bytes(np.concatenate([whitelist_ascii, newline], axis=1).tobytes())
    cb_ascii, cb_len, _ = make_queries(rng, whitelist_ascii, n_reads)
    tail = LETTERS[rng.integers(0, 4, size=(n_reads, R1_LEN - CB_LEN))]
    r1_ascii = np.concatenate([cb_ascii, tail], axis=1)
    r1_len = np.where(cb_len < CB_LEN, cb_len, R1_LEN)  # a short barcode is a short read
    r1_seq = as_bytes(r1_ascii, r1_len)
    r1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, R1_LEN), dtype=np.uint8), r1_len)
    i1_seq = as_bytes(LETTERS[rng.integers(0, 4, size=(n_reads, SAMPLE_LEN))], np.full(n_reads, SAMPLE_LEN))
    i1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, SAMPLE_LEN), dtype=np.uint8), np.full(n_reads, SAMPLE_LEN))
    write_fastq_gz(directory / "r1.fastq.gz", r1_seq, r1_qual)
    write_fastq_gz(directory / "i1.fastq.gz", i1_seq, i1_qual)
    u2_bodies = write_u2(directory / "u2.bam", rng, n_reads, bgzf)
    return r1_seq, r1_qual, i1_seq, i1_qual, u2_bodies


def attach_args(directory: Path, output: Path) -> list:
    """``Attach10xBarcodes -w`` over ``write_attach_inputs``' files."""
    return ["--r1", str(directory / "r1.fastq.gz"), "--u2", str(directory / "u2.bam"),
            "--i1", str(directory / "i1.fastq.gz"), "-o", str(output), "-w", str(directory / "whitelist.txt")]


def phase_attach(rng, whitelist_ascii, n_reads, table, kernel_ms, stamp: str, modules):
    import torch

    kernels, native, wl_ops, port_platform, bgzf, sam = modules
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    start = time.perf_counter()
    r1_seq, r1_qual, i1_seq, i1_qual, u2_bodies = write_attach_inputs(rng, whitelist_ascii, n_reads, bgzf, WORK)
    log(f"[attach] inputs: {n_reads} reads (R1 {R1_LEN} bp gz, I1 {SAMPLE_LEN} bp gz, "
        f"u2 {R2_LEN} bp BAM), whitelist {whitelist_ascii.shape[0]} x {CB_LEN}, "
        f"made in {time.perf_counter() - start:.1f} s")

    output = WORK / "tagged.bam"
    args = attach_args(WORK, output)
    stderr = io.StringIO()
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()  # the main path's run starts here
    start = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = port_platform.TenXV2.attach_barcodes(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launches)  # ... and ends here
    if rc != 0:
        raise AssertionError(f"attach returned {rc}")
    check_calls(native, "attach", attach=1)
    batches = -(-n_reads // BATCH)
    if launches["whitelist_correct"] != batches:
        raise AssertionError(f"{launches['whitelist_correct']} kernel launches, want {batches}")
    summary = stderr.getvalue()
    log(f"[attach] {stamp} | {n_reads} reads in {seconds:.2f} s = {n_reads / seconds:.0f} reads/s "
        f"(native loop, BGZF pool of {native.pool_threads()} threads), {batches} batches, "
        f"{launches['whitelist_correct']} kernel launches")
    for line in summary.strip().splitlines():
        log(f"[attach] {line.strip()}")

    # expected CB: the plain version, beside the table, for every CR
    cr = [s[:CB_LEN] for s in r1_seq]
    expected = []
    for lo in range(0, n_reads, BATCH):
        q = to_card(wl_ops.barcode_codes(cr[lo : lo + BATCH], CB_LEN), table.codes.device)
        expected.append(wl_ops.correct_plain(q, table).cpu().numpy())
    expected = np.concatenate(expected)
    expected[np.array([len(c) for c in cr]) != CB_LEN] = -1
    whitelist_rows = whitelist_ascii.tobytes()

    counts = {"correct": 0, "corrected": 0, "uncorrectible": 0}
    with bgzf.open_bgzf_reader(str(output)) as fh:
        if sam.read_raw_header(fh)[:4] != b"BAM\1":
            raise AssertionError("output is not a BAM")
        n_out = 0
        for i, body in enumerate(sam.iter_raw_records(fh)):
            n_out += 1
            u2 = u2_bodies[i]
            if body[: len(u2)] != u2:
                raise AssertionError(f"record {i}: u2 bytes changed")
            tags = parse_z_tags(body[len(u2):])
            want = [("CR", cr[i]), ("CY", r1_qual[i][:CB_LEN])]
            if expected[i] >= 0:
                cb = whitelist_rows[expected[i] * CB_LEN : (expected[i] + 1) * CB_LEN]
                want.append(("CB", cb))
                counts["correct" if cb == cr[i] else "corrected"] += 1
            else:
                counts["uncorrectible"] += 1
            want += [("UR", r1_seq[i][CB_LEN : CB_LEN + UMI_LEN]),
                     ("UY", r1_qual[i][CB_LEN : CB_LEN + UMI_LEN]),
                     ("SR", i1_seq[i]), ("SY", i1_qual[i])]
            if tags != want:
                raise AssertionError(f"record {i}: tags {tags} != {want}")
    if n_out != n_reads:
        raise AssertionError(f"{n_out} records written, want {n_reads}")
    want_summary = (
        f"Total barcodes:{n_reads}\n correct:{counts['correct']}\n"
        f"corrected:{counts['corrected']}\nuncorrectible:{counts['uncorrectible']}\n"
        f"uncorrected:{counts['uncorrectible'] / n_reads * 100.0:f}\n"
    )
    if summary != want_summary:
        raise AssertionError(f"summary {summary!r} != {want_summary!r}")
    log(f"[attach] all {n_out} records checked: CR/CY/UR/UY/SR/SY slices and every CB "
        f"against the plain version ({counts})")

    # the same run without -w (no whitelist load, no kernel, no CB): what
    # correction adds to the command's time
    native.reset_calls()
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        port_platform.TenXV2.attach_barcodes(args[:-2])
    plain_seconds = time.perf_counter() - start
    check_calls(native, "attach without -w", attach=1)
    log(f"[attach] without -w: {n_reads} reads in {plain_seconds:.2f} s = "
        f"{n_reads / plain_seconds:.0f} reads/s; correction adds "
        f"{seconds - plain_seconds:.2f} s, of which the kernel "
        f"~{launches['whitelist_correct'] * kernel_ms / 1e3:.3f} s (launches x kernel ms)")
    shutil.rmtree(WORK)
    return launches


DECODE_AB_RECORDS = 1 << 18


def same_frames(a, b, packed) -> bool:
    """Every column, dtype and vocabulary of two ReadFrames equal."""
    return all(
        getattr(a, f).dtype == getattr(b, f).dtype and np.array_equal(getattr(a, f), getattr(b, f))
        for f in packed._PER_RECORD_FIELDS
    ) and all(getattr(a, f"{f}_names") == getattr(b, f"{f}_names") for f in packed._CODED_FIELDS)


def decode_ab(path: Path, packed, native, stamp: str) -> None:
    """The first DECODE_AB_RECORDS records of ``path`` decoded by the port's
    Python decoder and by the native stream (query names included, as the
    Python decoder always reads them), in the order Python, native, native,
    Python; every run's frame must be the same."""
    runs = []
    for arm in ("python", "native", "native", "python"):
        begin = time.perf_counter()
        if arm == "python":
            frames = packed._python_frames(str(path), DECODE_AB_RECORDS, packed.DEFAULT_TAG_KEYS)
        else:
            frames = native.stream_frames(str(path), DECODE_AB_RECORDS, want_qname=True)
        frame = next(frames)
        frames.close()
        runs.append((arm, time.perf_counter() - begin, frame))
    if any(f.n_records != DECODE_AB_RECORDS or not same_frames(f, runs[0][2], packed) for _, _, f in runs):
        raise AssertionError("decode A/B: the Python and native frames differ")
    rates = {arm: [DECODE_AB_RECORDS / sec for a, sec, _ in runs if a == arm] for arm in ("python", "native")}
    log(f"[metrics] {stamp} | decode A/B over the first {DECODE_AB_RECORDS} records of the cell BAM "
        f"(Python, native, native, Python; equal frames): Python decoder "
        f"{' / '.join(f'{r:.0f}' for r in rates['python'])} records/s, native stream "
        f"({native.default_threads()} threads) {' / '.join(f'{r:.0f}' for r in rates['native'])} records/s; "
        f"native/Python {statistics.median(rates['native']) / statistics.median(rates['python']):.1f}x")


@contextlib.contextmanager
def recording(module, name: str, into: list):
    """Within the block, ``module.name`` (a gatherer class) is a subclass
    that appends each instance to ``into``, so a command's gatherer can be
    read after the command returns."""
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


def read_csv(path: Path):
    """(decompressed bytes, header, {index: fields}) of a metrics CSV."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    lines = data.decode().strip().split("\n")
    rows = {}
    for line in lines[1:]:
        name, _, rest = line.partition(",")
        if name in rows:
            raise AssertionError(f"{path.name}: row {name} written twice")
        rows[name] = rest.split(",")
    return data, lines[0].split(",")[1:], rows


def check_cell_rows(header, rows, expected: dict) -> None:
    """Per cell, the CSV's n_reads, n_molecules, n_genes and
    n_mitochondrial_molecules equal the generator's counts."""
    columns = [header.index(c) for c in ("n_reads", "n_molecules", "n_genes", "n_mitochondrial_molecules")]
    if set(rows) != set(expected):
        raise AssertionError(f"cells: {len(rows)} rows, {len(expected)} expected; "
                             f"e.g. {sorted(set(rows) ^ set(expected))[:3]}")
    for cell, want in expected.items():
        got = tuple(int(rows[cell][i]) for i in columns)
        if got != tuple(int(v) for v in want):
            raise AssertionError(f"cell {cell}: (n_reads, n_molecules, n_genes, n_mito) {got} != {want}")


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def device_events(prof) -> list:
    """The profile's device-side entries (kernels, copies, fills) with their
    device time. An aten op's device time is its kernels' again, so only
    the device-side level is kept: counting both would count each twice."""
    import torch

    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    typed = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return typed or events


def device_busy_ms(prof) -> float:
    """Milliseconds the device spent in the profile's kernels and copies (one
    stream: they do not overlap)."""
    return sum(_device_us(e) for e in device_events(prof)) / 1e3


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name if len(name) <= 110 else name[:107] + "..."


def top_device_ops(fn, n: int = 10):
    """The ``n`` kernels of one call of ``fn`` with the most device time,
    from ``torch.profiler``: [(name, calls, device ms)] and the total."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof), key=_device_us, reverse=True)
    return [(_short(e.key), e.count, _device_us(e) / 1e3) for e in events[:n]], device_busy_ms(prof)


def phase_metrics(rng, stamp: str, modules) -> None:
    """CalculateCellMetrics and CalculateGeneMetrics on the card at the
    2^20-record batch width; the CSVs against the same port on the CPU and
    against the generator's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf, packed = modules
    if port_gatherer.DEFAULT_BATCH_RECORDS != METRICS_BATCH:
        raise AssertionError("the smoke's batch width is not the gatherer's default")
    WORK.mkdir(exist_ok=True)
    start = time.perf_counter()
    reads = make_reads(rng, CELL_RECORDS)
    axes = {
        "cell": sort_reads(reads, "cell"),
        "gene": sort_reads({k: v[:GENE_RECORDS] for k, v in reads.items()}, "gene"),
    }
    paths = {axis: WORK / f"{axis}_sorted.bam" for axis in axes}
    for axis, sorted_reads in axes.items():
        write_tagged_bam(paths[axis], rng, sorted_reads, bgzf)
    gtf_path = WORK / "mito.gtf"
    write_mito_gtf(gtf_path)
    expected = expected_cell_counts(axes["cell"])
    gene_axis_names = set(np.unique(axes["gene"]["ge"]).astype(str))
    want_genes = {name or "None" for name in gene_axis_names if "," not in name}
    log(f"[metrics] inputs: {CELL_RECORDS} records sorted by (CB, UB, GE), {GENE_RECORDS} by "
        f"(GE, CB, UB); {len(expected)} cells, {len(gene_axis_names)} GE values "
        f"({sum(',' in n for n in gene_axis_names)} multi-gene), {N_GENES} genes in the "
        f"vocabulary ({N_MITO_GENES} MT-), 25 GRCh38 references, {R2_LEN} bp; made in "
        f"{time.perf_counter() - start:.1f} s")

    # the profiler's first start in a process takes seconds (CUPTI set-up):
    # take it here, outside the timed commands
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    launches_before = dict(kernels.launches)
    entry = {"cell": "calculate_cell_metrics", "gene": "calculate_gene_metrics"}
    cls_name = {"cell": "GatherCellMetrics", "gene": "GatherGeneMetrics"}
    cli_csv = {}
    # each command runs alone: nothing else decodes or unpickles meanwhile
    for axis in ("cell", "gene"):
        out = WORK / f"cli_{axis}"
        args = ["-i", str(paths[axis]), "-o", str(out)] + (["-a", str(gtf_path)] if axis == "cell" else [])
        made = []
        torch.cuda.synchronize()
        native.reset_calls()
        begin = time.perf_counter()
        # the device-side profile (no host ops) gives the command's busy time
        with recording(port_platform, cls_name[axis], made), profile(
            activities=[ProfilerActivity.CUDA]
        ) as prof:
            getattr(port_platform.GenericPlatform, entry[axis])(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        check_calls(native, entry[axis], batch_stream=1, format_csv_block=None)
        busy_ms = device_busy_ms(prof)
        gatherer = made[0]
        device_ms = gatherer.device_ms()
        split = gatherer.seconds
        # the ring's decode runs on its own thread, beside the rest
        other = wall - sum(v for k, v in split.items() if k != "decode")
        n = len(axes[axis]["cell"])
        log(f"[metrics] {stamp} | {entry[axis]} on cuda: {n} records in {wall:.2f} s = "
            f"{n / wall:.0f} records/s; ring: {gatherer.ring_batches} batches decoded into the native "
            f"arena on its thread in {split['decode']:.2f} s, this thread waited on it "
            f"{split['decode_wait']:.2f} s; pack {split['pack']:.2f} s, upload+enqueue {split['dispatch']:.2f} s, waiting on "
            f"pulls {split['wait']:.2f} s, CSV {split['csv']:.2f} s, other {other:.2f} s; "
            f"per batch, upload to pull on the stream (CUDA events, host gaps included) "
            f"{' + '.join(f'{ms:.2f}' for ms in device_ms)} ms; device busy (torch.profiler, "
            f"kernels and copies) {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
        for i, batch in enumerate(gatherer.batches):
            log(f"[metrics] {axis} batch {i}: {batch['records']} records padded to "
                f"{batch['padded']}, {batch['entities']} entities, "
                f"{'prepacked' if batch['prepacked'] else 'plain'}, "
                f"{'run-keyed' if batch['run_keyed'] else 'dense keys'}, "
                f"{'presorted' if batch['presorted'] else 'device-sorted'}, "
                f"{batch['h2d_bytes']} bytes up")
        if len(gatherer.batches) < 3 or gatherer.batches[0]["padded"] != METRICS_BATCH:
            raise AssertionError(f"{axis}: want a full {METRICS_BATCH}-record batch, a "
                                 f"remainder and a tail")
        cli_csv[axis] = read_csv(out.with_name(out.name + ".csv.gz"))

    decode_ab(paths["cell"], packed, native, stamp)
    # the frames for the cuda/cpu comparison, decoded as the commands decode
    frames = {axis: list(packed.iter_frames_from_bam(str(path), METRICS_BATCH, want_qname=False))
              for axis, path in paths.items()}

    mito = port_gtf.get_mitochondrial_gene_names(str(gtf_path))
    if len(mito) != N_MITO_GENES:
        raise AssertionError(f"{len(mito)} mitochondrial genes read from the GTF")
    for axis in ("cell", "gene"):
        cls = getattr(port_gatherer, cls_name[axis])
        data = {}
        for device in ("cuda", "cpu"):
            out = WORK / f"frames_{axis}_{device}"
            gatherer = cls(str(paths[axis]), str(out), mito if axis == "cell" else set(),
                           frame_source=lambda: iter(frames[axis]), device=device)
            begin = time.perf_counter()
            gatherer.extract_metrics()
            log(f"[metrics] {axis} from decoded frames on {device}: {time.perf_counter() - begin:.2f} s")
            data[device] = read_csv(out.with_name(out.name + ".csv.gz"))
        if not (data["cuda"][0] == data["cpu"][0] == cli_csv[axis][0]):
            raise AssertionError(f"{axis}: the cuda, cpu and command CSVs differ")
        _, header, rows = data["cuda"]
        if axis == "cell":
            check_cell_rows(header, rows, expected)
        elif set(rows) != want_genes:
            raise AssertionError(f"genes: {len(rows)} rows, {len(want_genes)} single-gene GE values")
        log(f"[metrics] {axis}: decompressed CSVs equal on cuda, cpu and through the command "
            f"({len(rows)} rows, {len(data['cuda'][0])} bytes)"
            + ("; n_reads, n_molecules, n_genes, n_mitochondrial_molecules equal the generator's "
               "for every cell" if axis == "cell" else "; no multi-gene row"))

    # the device pass alone, on one staged full batch of each axis
    for axis in ("cell", "gene"):
        frame = frames[axis][0]
        key = frame.cell if axis == "cell" else frame.gene
        cut = int(np.nonzero(key[1:] != key[:-1])[0][-1]) + 1
        batch = port_gatherer.slice_frame(frame, 0, cut)
        gatherer = getattr(port_gatherer, cls_name[axis])(
            str(paths[axis]), str(WORK / "unused"), mito if axis == "cell" else set(), device="cuda")
        gatherer.start_stream()
        cols, kwargs, decisions = gatherer.pack_batch(batch, pad_to=METRICS_BATCH)
        staged = {name: to_card(array, gatherer._device) for name, array in cols.items()}
        int_names, float_names = port_gatherer.wire_result_names(gatherer.columns)
        n_entities = int(np.count_nonzero(key[1:cut] != key[: cut - 1])) + 1
        k = port_seg.entity_bucket(n_entities, METRICS_BATCH)

        def one_batch():
            result = port_device.compute_entity_metrics(staged, **kwargs)
            return port_device.compact_results_wire(result, int_names, float_names, k)

        ms = cuda_ms(one_batch, repeats=5)
        ops, profiled_ms = top_device_ops(one_batch)
        log(f"[metrics] {stamp} | {axis} device pass (compute_entity_metrics + "
            f"compact_results_wire) per full batch ({decisions['records']} records padded to "
            f"{kwargs['num_segments']}, {'run-keyed' if decisions['run_keyed'] else 'dense'}): "
            f"{ms:.3f} ms (CUDA events, 5 calls queued back to back); torch.profiler device "
            f"total {profiled_ms:.3f} ms; top ops:")
        for name, count, op_ms in ops:
            log(f"[metrics]   {op_ms:8.3f} ms  x{count:<4d} {name}")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the metrics phase: {kernels.launches}")
    log("[metrics] no hand kernel launched (kernels.launches unchanged)")
    # the commands' CSVs stay for the count phase's merges, the cell CSV and
    # the cell BAM for the sort phase
    clear_work("cli_cell.csv.gz", "cli_gene.csv.gz", "cell_sorted.bam")
    return {axis: WORK / f"cli_{axis}.csv.gz" for axis in ("cell", "gene")}


COUNT_BATCH = 1 << 19  # the count's DEFAULT_BATCH_RECORDS, never cut
# depth: ~1,180,000 records, two full 2^19 batches, a remainder and the
# carried tails at each cut
COUNT_QUERIES = 750_000
ELIGIBLE_XF = (0, 1, 2)  # CODING, INTRONIC, UTR in XF_VALUES
INTERGENIC = 3


def make_count_library(rng, n_queries: int) -> dict:
    """Per-record columns of a queryname-grouped 10x v2 library.

    ~2.4 queries a molecule (cell, UMI, gene as in ``make_reads``); a query
    has NH = k alignments (k = 1, 2, 3 at 57/30/13%) with its molecule's CB
    and UB. The first alignment carries the molecule's gene (5% of them
    INTERGENIC, with no GE); each other one the same gene (60%), another
    gene (25%) or INTERGENIC with no GE (15%). ~0.5% of queries lack CB and
    ~0.5% lack UB; ~0.5% of GE tags name two genes. Queries come in random
    molecule order under increasing zero-padded names, as a queryname sort
    leaves them, so a molecule's queries fall in different batches.
    """
    cells = np.unique(LETTERS[rng.integers(0, 4, size=(N_CELLS + 64, CB_LEN))].view(f"S{CB_LEN}").ravel())
    cells = np.sort(rng.choice(cells, N_CELLS, replace=False))
    n_mol = int(n_queries / 2.4)
    sizes = rng.lognormal(0, 0.6, N_CELLS)
    mol_cell = rng.choice(N_CELLS, n_mol, p=sizes / sizes.sum())
    mol_umi = LETTERS[rng.integers(0, 4, size=(n_mol, UMI_LEN))]
    weights = 1.0 / (np.arange(N_GENES - N_MITO_GENES) + 10.0)
    mol_gene = rng.choice(N_GENES - N_MITO_GENES, n_mol, p=weights / weights.sum())
    mito = rng.random(n_mol) < 0.05
    mol_gene[mito] = N_GENES - N_MITO_GENES + rng.integers(0, N_MITO_GENES, mito.sum())
    query_mol = rng.integers(0, n_mol, n_queries)
    hits = rng.choice([1, 2, 3], n_queries, p=[0.57, 0.30, 0.13])
    query = np.repeat(np.arange(n_queries), hits)
    n = query.size
    first = np.ones(n, dtype=bool)
    first[1:] = query[1:] != query[:-1]
    mol = query_mol[query]
    gene = mol_gene[mol].copy()
    draw = rng.random(n)
    other = ~first & (draw >= 0.6) & (draw < 0.85)
    gene[other] = rng.integers(0, N_GENES, other.sum())
    intergenic = np.where(first, draw < 0.05, draw >= 0.85)
    xf = np.where(intergenic, INTERGENIC, rng.choice(ELIGIBLE_XF, n, p=[0.7, 0.2, 0.1]))
    names = gene_names()
    ge = names[gene].astype("S21")
    multi = ~intergenic & (rng.random(n) < 0.005) & (gene < N_GENES - 1)
    ge[multi] = np.char.add(np.char.add(names[gene[multi]], b","), names[gene[multi] + 1])
    ge[intergenic] = b""
    cb = cells[mol_cell[mol]].view(np.uint8).reshape(n, CB_LEN)
    ub = mol_umi[mol]
    ref = np.where(gene >= N_GENES - N_MITO_GENES, 24, gene % 24)
    lengths = np.array([length for _, length in GRCH38])
    return dict(
        cell=mol_cell[mol], cb=cb, cr=cb, ub=ub, ur=ub, ge=ge, xf=xf,
        unmapped=np.zeros(n, dtype=bool), ref=ref,
        pos=(rng.random(n) * (lengths[ref] - 2000)).astype(np.int64),
        reverse=rng.random(n) < 0.5, duplicate=np.zeros(n, dtype=bool),
        spliced=np.zeros(n, dtype=bool), nh=hits[query],
        qname=query, has_cb=np.repeat(rng.random(n_queries) >= 0.005, hits),
        has_ub=np.repeat(rng.random(n_queries) >= 0.005, hits),
        gene=gene, eligible=~intergenic & ~multi,
    )


def expected_count_matrix(library: dict):
    """(row names, CSR matrix) by the reference's rule (count.py:156-169),
    counted with numpy from the generator's own columns: a query counts iff
    its first alignment has CB and UB and its alignments name exactly one
    eligible gene; each (CB, UB, gene) counts once; rows in order of each
    cell's first counted query (count.py:319-329)."""
    import scipy.sparse as sp

    query, eligible, gene = library["qname"], library["eligible"], library["gene"]
    starts = np.flatnonzero(np.r_[True, query[1:] != query[:-1]])
    lowest = np.minimum.reduceat(np.where(eligible, gene, N_GENES), starts)
    highest = np.maximum.reduceat(np.where(eligible, gene, -1), starts)
    counted = (highest >= 0) & (lowest == highest) & library["has_cb"][starts] & library["has_ub"][starts]
    rows = starts[counted]  # each counted query's first record, in file order
    umi = (np.searchsorted(LETTERS, library["ub"][rows]).astype(np.int64)
           * (4 ** np.arange(UMI_LEN - 1, -1, -1))).sum(1)
    cell = library["cell"][rows]
    key = (cell.astype(np.int64) * 4 ** UMI_LEN + umi) * N_GENES + lowest[counted]
    _, first = np.unique(key, return_index=True)  # each triple's first query
    cell, triple_gene, first_row = cell[first], lowest[counted][first], rows[first]
    present = np.unique(cell)
    cell_first = np.full(N_CELLS, np.iinfo(np.int64).max)
    np.minimum.at(cell_first, cell, first_row)
    order = present[np.argsort(cell_first[present], kind="stable")]
    rank = np.empty(N_CELLS, dtype=np.int64)
    rank[order] = np.arange(order.size)
    matrix = sp.coo_matrix(
        (np.ones(cell.size, dtype=np.uint32), (rank[cell], triple_gene)),
        shape=(order.size, N_GENES), dtype=np.uint32,
    ).tocsr()
    first_record = np.zeros(N_CELLS, dtype=np.int64)
    first_record[library["cell"][::-1]] = np.arange(len(library["cell"]))[::-1]
    names = [library["cb"][first_record[c]].tobytes().decode() for c in order]
    return names, matrix


def write_gene_gtf(path: Path) -> None:
    """A GTF declaring all 33,538 genes (gene_id = gene_name)."""
    lines = ["#!genome-build synthetic\n"]
    for i, name in enumerate(gene_names().astype(str)):
        chrom = "MT" if name.startswith("MT-") else "1"
        lines.append(f'{chrom}\tsmoke\tgene\t{100 * i + 1}\t{100 * i + 90}\t.\t+\t.\t'
                     f'gene_id "{name}"; gene_name "{name}";\n')
    path.write_text("".join(lines))


def canonical(matrix):
    """The CSR matrix with duplicates summed and column indices sorted."""
    matrix = matrix.tocsr(copy=True)
    matrix.sum_duplicates()
    matrix.sort_indices()
    return matrix


def check_same_matrix(name: str, got, want_rows, want) -> None:
    """Entry for entry, in the same row order, with the same row index."""
    if list(map(str, got.row_index)) != list(want_rows):
        raise AssertionError(f"{name}: row index differs ({len(got.row_index)} rows, want {len(want_rows)})")
    a, b = canonical(got.matrix), canonical(want)
    if a.shape != b.shape or a.dtype != b.dtype or not all(
        np.array_equal(getattr(a, attr), getattr(b, attr)) for attr in ("indptr", "indices", "data")
    ):
        raise AssertionError(f"{name}: matrix differs ({a.shape} {a.dtype}, nnz {a.nnz}; want {b.shape} "
                             f"{b.dtype}, nnz {b.nnz})")


def same_files(prefix_a: Path, prefix_b: Path) -> bool:
    """Index files equal byte for byte, the .npz arrays equal."""
    for suffix in ("_row_index.npy", "_col_index.npy"):
        if Path(f"{prefix_a}{suffix}").read_bytes() != Path(f"{prefix_b}{suffix}").read_bytes():
            return False
    with np.load(f"{prefix_a}.npz") as a, np.load(f"{prefix_b}.npz") as b:
        return sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)


def write_csv_gz(path: Path, lines) -> Path:
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(("\n".join(lines) + "\n").encode())
    return path


def as_pandas_reads(port_merge, text: str) -> float:
    """A CSV field as the merge reads it (pandas' NA spellings are NaN)."""
    return float("nan") if text in port_merge._NA_VALUES else port_merge._parse_float(text)


def check_metric_merges(port_platform, port_merge, csvs: dict) -> str:
    """MergeCellMetrics on the cell CSV split in two gives its rows back;
    MergeGeneMetrics on the gene CSV and a copy doubles every count, keeps
    every ratio and every read-weighted mean (rtol 1e-12)."""
    _, header, rows = read_csv(csvs["cell"])
    names = list(rows)
    half = len(names) // 2
    parts = [write_csv_gz(WORK / f"cell_part{i}.csv.gz",
                          ["," + ",".join(header)] + [f"{n},{','.join(rows[n])}" for n in chunk])
             for i, chunk in enumerate((names[:half], names[half:]))]
    out = WORK / "merged_cell"
    port_platform.GenericPlatform.merge_cell_metrics([*map(str, parts), "-o", str(out)])
    _, merged_header, merged = read_csv(out.with_name(out.name + ".csv.gz"))
    # the merge reads as pandas does: "None" is NA (written empty), and a
    # float is pandas' parse of its text
    want_names = ["" if n == "None" else n for n in names]
    if merged_header != header or list(merged) != want_names:
        raise AssertionError("merged cell CSV: header or row order differs")
    for name, want_name in zip(names, want_names):
        for got, text in zip(merged[want_name], rows[name]):
            # the merge writes the shortest text of what it read
            if got != text and not np.isclose(float(got or "nan"), as_pandas_reads(port_merge, text),
                                              rtol=0, atol=0, equal_nan=True):
                raise AssertionError(f"merged cell {name}: {got!r} is not {text!r}")

    _, gene_header, gene_rows = read_csv(csvs["gene"])
    out = WORK / "merged_gene"
    port_platform.GenericPlatform.merge_gene_metrics([str(csvs["gene"]), str(csvs["gene"]), "-o", str(out)])
    _, header, merged = read_csv(out.with_name(out.name + ".csv.gz"))
    if set(merged) != set(gene_rows) - {"None"} or list(merged) != sorted(merged):
        raise AssertionError("merged gene CSV: genes differ from the input's, or unsorted")
    counts = port_merge.MergeGeneMetrics.COUNT_COLUMNS_TO_SUM
    weighted = port_merge.MergeGeneMetrics.READ_WEIGHTED_COLUMNS
    ratios = {"reads_per_molecule": ("n_reads", "n_molecules"),
              "fragments_per_molecule": ("n_fragments", "n_molecules"),
              "reads_per_fragment": ("n_reads", "n_fragments")}
    for gene, fields in merged.items():
        got = dict(zip(header, fields))
        src = dict(zip(gene_header, gene_rows[gene]))
        for column in counts:
            if int(got[column]) != 2 * int(src[column]):
                raise AssertionError(f"merged gene {gene}: {column} {got[column]} is not 2 x {src[column]}")
        for column, (top, bottom) in ratios.items():
            with np.errstate(divide="ignore", invalid="ignore"):
                want = np.float64(int(src[top])) / np.float64(int(src[bottom]))
            value = float(got[column]) if got[column] else float("nan")
            if not (value == want or (np.isnan(value) and np.isnan(want))):
                raise AssertionError(f"merged gene {gene}: {column} {value} is not {want}")
        for column in weighted:
            want, value = as_pandas_reads(port_merge, src[column]), float(got[column] or "nan")
            if not np.isclose(value, want, rtol=1e-12, atol=0, equal_nan=True):
                raise AssertionError(f"merged gene {gene}: {column} {value} is not {want}")
    return (f"MergeCellMetrics of the cell CSV in two files gave its {len(names)} rows back; "
            f"MergeGeneMetrics of the gene CSV with itself: {len(merged)} genes, counts doubled, "
            f"ratios kept, read-weighted means within rtol 1e-12")


def phase_count(rng, stamp: str, modules, csvs: dict) -> None:
    """CreateCountMatrix on the card at the count's 2^19-record batch width
    against a numpy count of the generator's columns, the same frames on the
    card and on the CPU, and the three merges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_count, port_counting, port_merge, port_gtf, bgzf, packed = modules
    if port_count.DEFAULT_BATCH_RECORDS != COUNT_BATCH:
        raise AssertionError("the smoke's batch width is not the count's default")
    phase_start = start = time.perf_counter()
    library = make_count_library(rng, COUNT_QUERIES)
    bam, gtf_path = WORK / "count.bam", WORK / "genes.gtf"
    write_tagged_bam(bam, rng, library, bgzf)
    write_gene_gtf(gtf_path)
    want_rows, want = expected_count_matrix(library)
    n = len(library["qname"])
    log(f"[count] inputs: {COUNT_QUERIES} queries, {n} records grouped by query name, "
        f"{len(want_rows)} cells, {N_GENES} genes in the GTF; made in {time.perf_counter() - start:.1f} s")

    launches_before = dict(kernels.launches)
    made = []
    out = WORK / "cli_count"
    torch.cuda.synchronize()
    native.reset_calls()
    begin = time.perf_counter()
    with recording(port_platform, "CountMatrix", made), profile(activities=[ProfilerActivity.CUDA]) as prof:
        port_platform.GenericPlatform.bam_to_count_matrix(
            ["-b", str(bam), "-a", str(gtf_path), "-o", str(out)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    check_calls(native, "bam_to_count_matrix", batch_stream=1)
    busy_ms = device_busy_ms(prof)
    command = made[0]
    split = command.seconds
    # the ring's decode runs on its own thread, beside the rest
    other = wall - sum(v for k, v in split.items() if k != "decode")
    log(f"[count] {stamp} | bam_to_count_matrix on cuda: {n} records in {wall:.2f} s = "
        f"{n / wall:.0f} records/s; ring: {command.ring_batches} batches decoded into the native arena "
        f"on its thread in {split['decode']:.2f} s, this thread waited on it {split['decode_wait']:.2f} s; "
        f"carried tails (concat, "
        f"compact, copy) {split['carry']:.2f} s, pack {split['pack']:.2f} s, "
        f"upload+enqueue {split['dispatch']:.2f} s, waiting on pulls {split['wait']:.2f} s, "
        f"accumulate {split['accumulate']:.2f} s, assemble {split['assemble']:.2f} s, save "
        f"{split['save']:.2f} s, other (GTF, CLI, profiler) {other:.2f} s; device busy (torch.profiler, kernels "
        f"and copies) {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
    for i, batch in enumerate(command.batches):
        log(f"[count] batch {i}: {batch['records']} records padded to {batch['padded']}, "
            f"{batch['molecules']} molecules, {batch['h2d_bytes']} bytes up")
    if len(command.batches) < 3 or [b["padded"] for b in command.batches[:2]] != [COUNT_BATCH] * 2:
        raise AssertionError(f"want two full {COUNT_BATCH}-record batches and a remainder")
    check_same_matrix("command", port_count.CountMatrix.load(str(out)), want_rows, want)
    log(f"[count] the command's matrix equals the generator's count: {want.shape[0]} cells x "
        f"{want.shape[1]} genes, {want.nnz} entries, {int(want.sum())} molecules, same row order")

    # the frames for the cuda/cpu comparison, decoded as the command decodes
    kept = list(packed.iter_frames_from_bam(str(bam), COUNT_BATCH, want_qname=True))
    for device in ("cuda", "cpu"):
        prefix = WORK / f"frames_count_{device}"
        begin = time.perf_counter()
        port_count.CountMatrix.from_sorted_tagged_bam(
            str(bam), port_gtf.extract_gene_names(str(gtf_path)),
            frame_source=lambda: iter(kept), device=device).save(str(prefix))
        log(f"[count] from the decoded frames on {device}: {time.perf_counter() - begin:.2f} s")
        if not same_files(prefix, out):
            raise AssertionError(f"the count of the decoded frames on {device} differs from the command's")
    log("[count] the decoded frames counted on cuda and on cpu give the command's .npy bytes and .npz arrays")

    # the count pass alone, on one staged full batch
    frame = kept[0]
    cut = int(np.nonzero(frame.qname[1:] != frame.qname[:-1])[0][-1]) + 1
    block = port_count.pack_count_block(packed.slice_frame(frame, 0, cut), pad_to=COUNT_BATCH)
    staged = to_card(block, "cuda")

    def one_pass():
        return port_counting.count_molecules(dict(zip(port_count.UPLOAD_COLUMNS, staged)),
                                             num_segments=COUNT_BATCH)

    ms = cuda_ms(one_pass, repeats=5)
    ops, profiled_ms = top_device_ops(one_pass)
    log(f"[count] {stamp} | count_molecules per full batch ({cut} records padded to {COUNT_BATCH}): "
        f"{ms:.3f} ms (CUDA events, 5 calls queued back to back); torch.profiler device total "
        f"{profiled_ms:.3f} ms; top ops:")
    for name, count, op_ms in ops:
        log(f"[count]   {op_ms:8.3f} ms  x{count:<4d} {name}")

    # MergeCountMatrices of the matrix split by rows gives it back
    whole = port_count.CountMatrix.load(str(out))
    half = whole.matrix.shape[0] // 2
    parts = []
    for i, rows in enumerate((slice(0, half), slice(half, None))):
        parts.append(str(WORK / f"count_part{i}"))
        port_count.CountMatrix(whole.matrix[rows].tocsr(), whole.row_index[rows], whole.col_index).save(parts[-1])
    port_platform.GenericPlatform.merge_count_matrices(["-i", *parts, "-o", str(WORK / "merged_count")])
    check_same_matrix("MergeCountMatrices", port_count.CountMatrix.load(str(WORK / "merged_count")),
                      want_rows, want)
    log(f"[count] MergeCountMatrices of the matrix in two row chunks ({half} + "
        f"{whole.matrix.shape[0] - half} cells) gave it back exactly")
    log(f"[count] {check_metric_merges(port_platform, port_merge, csvs)}")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the count phase: {kernels.launches}")
    log("[count] no hand kernel launched (kernels.launches unchanged)")
    clear_work(*KEPT_FOR_SORT)
    log(f"[count] phase 6 took {time.perf_counter() - phase_start:.1f} s")


FASTQ_READS = 4 * BATCH  # FastqProcess triplets, in two triplet files
FASTQ_SHARDS = 4
SLIDESEQ_READS = 2 * BATCH
SLIDESEQ_WHITELIST = 100_000
SLIDESEQ_STRUCTURE = "8C18X6C9M1X"  # 14-base cell barcode around an 18-base linker
IUPAC = np.frombuffer(b"RYKMSWBDHVN", dtype=np.uint8)
# BAM base codes as FastqProcess writes them: ACGT in either case, else 15
NIBBLE = np.full(256, 15, dtype=np.uint8)
NIBBLE[list(b"ACGTacgt")] = (1, 2, 4, 8, 1, 2, 4, 8)


def full_rows(rows: np.ndarray) -> list:
    """Each row of a 2-D uint8 array as bytes."""
    return as_bytes(rows, np.full(len(rows), rows.shape[1]))


def write_fastq_files(paths, names, sequences, qualities, cuts) -> None:
    """Records [lo, hi) of each cut into its own gzipped FASTQ file."""
    for path, (lo, hi) in zip(paths, cuts):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (names[i], sequences[i], qualities[i])
                             for i in range(lo, hi)))


def expected_indices(wl_ops, table, barcodes, length) -> np.ndarray:
    """The plain version's whitelist index per barcode, on the card, batch by
    batch; -1 for a barcode of another length."""
    out = []
    for lo in range(0, len(barcodes), BATCH):
        q = to_card(wl_ops.barcode_codes(barcodes[lo : lo + BATCH], length), table.codes.device)
        out.append(wl_ops.correct_plain(q, table).cpu().numpy())
    out = np.concatenate(out)
    out[np.array([len(b) for b in barcodes]) != length] = -1
    return out


def read_bam_shard(path: str, bgzf, sam) -> list:
    """(name, packed bases, qualities, [(tag, value)]) of each record of an
    unaligned shard, in order."""
    text = b"@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:smoke\n"
    records = []
    with bgzf.open_bgzf_reader(path) as fh:
        if sam.read_raw_header(fh) != b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 0):
            raise AssertionError(f"{path}: unexpected header")
        for body in sam.iter_raw_records(fh):
            l_name, (l_seq,) = body[8], struct.unpack_from("<I", body, 16)
            if body[:16] != struct.pack("<iiBBHHH", -1, -1, l_name, 0, 4680, 0, 4):
                raise AssertionError(f"{path}: unexpected fixed fields {body[:16]!r}")
            seq_at = 32 + l_name
            qual_at = seq_at + (l_seq + 1) // 2
            records.append((body[32 : seq_at - 1], body[seq_at:qual_at], body[qual_at : qual_at + l_seq],
                            parse_z_tags(body[qual_at + l_seq :])))
    return records


def timed_command(kernels, module, class_name, call):
    """Run ``call`` with the launch counts reset just before and read just
    after; returns (result, wall seconds, launches, the command's instance)."""
    import torch

    made = []
    torch.cuda.synchronize()
    kernels.reset_launches()  # a main path's run starts here
    start = time.perf_counter()
    with recording(module, class_name, made):
        result = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launches)  # ... and ends here
    return result, seconds, launches, made[0]


def split_line(seconds: float, split: dict) -> str:
    other = seconds - sum(split.values())
    return (f"read {split['read']:.2f} s, correct (submit + wait) {split['correct']:.2f} s, "
            f"write/compress {split['write']:.2f} s, other {other:.2f} s")


def phase_fastq(rng, whitelist_ascii, table, stamp: str, modules):
    """FastqProcess (BAM and FASTQ shards), SampleFastq, FastqMetrics and
    CheckBarcodePartition through their entry points on the card, against
    the generator and the plain version; returns the kernel launches of
    the phase's main-path runs and the BAM shards, which stay for the sort
    phase."""
    kernels, native, wl_ops, port_platform, port_fqp, port_sample, bgzf, sam = modules
    phase_start = start = time.perf_counter()
    WORK.mkdir(exist_ok=True)
    wl_path = WORK / "whitelist.txt"
    newline = np.full((whitelist_ascii.shape[0], 1), ord("\n"), dtype=np.uint8)
    wl_path.write_bytes(np.concatenate([whitelist_ascii, newline], axis=1).tobytes())

    # 10x v2 triplets: phase 4's query mix without its short reads (FastqMetrics
    # refuses reads shorter than 16C10M; short reads run in the card tests)
    n = FASTQ_READS
    cb_ascii, _, _ = make_queries(rng, whitelist_ascii, n)
    r1_ascii = np.concatenate([cb_ascii, LETTERS[rng.integers(0, 4, size=(n, R1_LEN - CB_LEN))]], axis=1)
    r2_ascii = LETTERS[rng.integers(0, 4, size=(n, R2_LEN))]
    odd = rng.random((n, R2_LEN))
    r2_ascii[odd < 0.002] = IUPAC[rng.integers(0, IUPAC.size, size=int((odd < 0.002).sum()))]
    r2_ascii[(odd >= 0.002) & (odd < 0.004)] += ord("a") - ord("A")
    r1_seq, r2_seq = full_rows(r1_ascii), full_rows(r2_ascii)
    r1_qual = full_rows(rng.integers(35, 75, size=(n, R1_LEN), dtype=np.uint8))
    r2_qual_rows = rng.integers(35, 75, size=(n, R2_LEN), dtype=np.uint8)
    r2_qual = full_rows(r2_qual_rows)
    i1_seq = full_rows(LETTERS[rng.integers(0, 4, size=(n, SAMPLE_LEN))])
    i1_qual = full_rows(rng.integers(35, 75, size=(n, SAMPLE_LEN), dtype=np.uint8))
    names = [b"r%07d 1:N:0:1" % i for i in range(n)]  # Illumina comments: cut at the space
    cuts = ((0, n // 2), (n // 2, n))
    paths = {kind: [str(WORK / f"{kind}_{t}.fastq.gz") for t in range(2)] for kind in ("r1", "r2", "i1")}
    for kind, (seqs, quals) in (("r1", (r1_seq, r1_qual)), ("r2", (r2_seq, r2_qual)), ("i1", (i1_seq, i1_qual))):
        write_fastq_files(paths[kind], names, seqs, quals, cuts)
    total_bytes = sum(Path(p).stat().st_size for kind in paths.values() for p in kind)
    bam_size = total_bytes / ((FASTQ_SHARDS - 0.5) * (1 << 30))  # ceil(3.5) = 4 shards
    log(f"[fastq] inputs: {n} 10x v2 triplets in 2 triplet files (R1 {R1_LEN} bp, R2 {R2_LEN} bp with "
        f"IUPAC and lowercase bases, I1 {SAMPLE_LEN} bp; gz), {total_bytes} bytes, --bam-size {bam_size!r}; "
        f"whitelist {whitelist_ascii.shape[0]} x {CB_LEN}; made in {time.perf_counter() - start:.1f} s")

    cr = [s[:CB_LEN] for s in r1_seq]
    want_index = expected_indices(wl_ops, table, cr, CB_LEN)
    whitelist_rows = whitelist_ascii.tobytes()
    want_cb = [whitelist_rows[k * CB_LEN : (k + 1) * CB_LEN] if k >= 0 else None for k in want_index.tolist()]
    want_counts = {"correct": sum(c is not None and c == r for c, r in zip(want_cb, cr)),
                   "uncorrectable": int((want_index < 0).sum())}
    want_counts["corrected"] = n - want_counts["correct"] - want_counts["uncorrectable"]
    want_packed = ((NIBBLE[r2_ascii[:, 0::2]] << 4) | NIBBLE[r2_ascii[:, 1::2]]).tobytes()
    want_phred = (r2_qual_rows - 33).tobytes()
    half = R2_LEN // 2

    base = ["--r1", *paths["r1"], "--r2", *paths["r2"], "--i1", *paths["i1"], "-w", str(wl_path),
            "--bam-size", repr(bam_size), "--sample-id", "smoke"]
    launches_total = 0
    shard_of = {}
    for fmt in ("BAM", "FASTQ"):
        prefix = WORK / f"shard_{fmt.lower()}"
        stderr = io.StringIO()
        native.reset_calls()
        with contextlib.redirect_stderr(stderr):
            rc, seconds, launches, command = timed_command(
                kernels, port_fqp, "FastqProcess",
                lambda: port_platform.TenXV2.fastq_process(base + ["--output-format", fmt, "-o", str(prefix)]))
        if rc != 0:
            raise AssertionError(f"FastqProcess {fmt} returned {rc}")
        check_calls(native, f"FastqProcess {fmt}", fastqprocess=1)
        batches = -(-n // BATCH)
        launches_total += launches["whitelist_correct"]
        if launches["whitelist_correct"] != batches:
            raise AssertionError(f"FastqProcess {fmt}: {launches['whitelist_correct']} launches, want {batches}")
        lines = stderr.getvalue().strip().splitlines()
        want_lines = [f"Total barcodes:{n}", f" correct:{want_counts['correct']}",
                      f"corrected:{want_counts['corrected']}", f"uncorrectible:{want_counts['uncorrectable']}",
                      f"uncorrected:{want_counts['uncorrectable'] / n * 100.0:f}",
                      f"wrote {FASTQ_SHARDS} {fmt} shard(s), {n} reads"]
        if lines != want_lines:
            raise AssertionError(f"FastqProcess {fmt} stderr {lines} != {want_lines}")
        log(f"[fastq] {stamp} | FastqProcess -w {fmt} on cuda: {n} reads in {seconds:.2f} s = "
            f"{n / seconds:.0f} reads/s (native loop, BGZF pool of {native.pool_threads()} threads); "
            f"{split_line(seconds, command.seconds)}; {batches} batches, "
            f"{launches['whitelist_correct']} kernel launches; counters {want_counts}")

        check_start = time.perf_counter()
        seen = np.zeros(n, dtype=np.int64)
        if fmt == "BAM":
            shards = bam_shards = port_fqp.shard_paths(str(prefix), FASTQ_SHARDS)
            for shard, path in enumerate(shards):
                for name, packed, phred, tags in read_bam_shard(path, bgzf, sam):
                    i = int(name[1:])
                    seen[i] += 1
                    shard_of[i] = shard
                    want = [("CR", cr[i]), ("CY", r1_qual[i][:CB_LEN])]
                    if want_cb[i] is not None:
                        want.append(("CB", want_cb[i]))
                    want += [("UR", r1_seq[i][CB_LEN : CB_LEN + UMI_LEN]), ("UY", r1_qual[i][CB_LEN : CB_LEN + UMI_LEN]),
                             ("SR", i1_seq[i]), ("SY", i1_qual[i])]
                    if (name != b"r%07d" % i or tags != want or packed != want_packed[i * half : (i + 1) * half]
                            or phred != want_phred[i * R2_LEN : (i + 1) * R2_LEN]):
                        raise AssertionError(f"BAM shard {shard}: read {i} differs: {name!r} {tags} != {want}")
            partition = io.StringIO()
            with contextlib.redirect_stderr(partition):
                begin = time.perf_counter()
                ok = port_platform.GenericPlatform.check_barcode_partition(["-b", *shards])
                partition_seconds = time.perf_counter() - begin
                copy = str(WORK / "copy_of_shard_0.bam")
                shutil.copy(shards[0], copy)
                duplicated = port_platform.GenericPlatform.check_barcode_partition(["-b", shards[0], copy])
            if (ok, duplicated) != (0, 1):
                raise AssertionError(f"CheckBarcodePartition: {ok} on the shards, {duplicated} on a shard "
                                     f"and its copy: {partition.getvalue()[-300:]}")
            report = partition.getvalue().strip().splitlines()
            log(f"[fastq] CheckBarcodePartition: 0 on the {FASTQ_SHARDS} shards ({report[0]}; {n} records in "
                f"{partition_seconds:.2f} s), 1 on shard 0 beside its copy ({report[-1]})")
        else:
            for shard in range(FASTQ_SHARDS):
                r1_lines = gzip.decompress(Path(f"{prefix}_R1_{shard}.fastq.gz").read_bytes()).split(b"\n")
                r2_lines = gzip.decompress(Path(f"{prefix}_R2_{shard}.fastq.gz").read_bytes()).split(b"\n")
                for k in range(0, len(r1_lines) - 1, 4):
                    i = int(r1_lines[k][2:])
                    seen[i] += 1
                    want_r1 = [b"@r%07d" % i, r1_seq[i][: CB_LEN + UMI_LEN], b"+", r1_qual[i][: CB_LEN + UMI_LEN]]
                    want_r2 = [b"@r%07d" % i, r2_seq[i], b"+", r2_qual[i]]
                    if r1_lines[k : k + 4] != want_r1 or r2_lines[k : k + 4] != want_r2 or shard_of[i] != shard:
                        raise AssertionError(f"FASTQ shard {shard}: read {i} differs or moved from BAM shard "
                                             f"{shard_of[i]}")
        if not (seen == 1).all():
            raise AssertionError(f"{fmt}: {int((seen == 0).sum())} reads missing, {int((seen > 1).sum())} repeated")
        sizes = np.bincount(np.array([shard_of[i] for i in range(n)]), minlength=FASTQ_SHARDS)
        log(f"[fastq] {fmt} shards checked in {time.perf_counter() - check_start:.1f} s: every read once, "
            + ("names, bases (IUPAC as 15), qualities and tags CR CY [CB] UR UY SR SY equal the generator's, "
               "CB the plain version's on the card" if fmt == "BAM" else
               "R1 = CR+UR / CY+UY, R2 the read, each read in its BAM shard")
            + f"; reads per shard {sizes.tolist()}")

    # SampleFastq: slide-seq pairs, R1 and R2 each over two files cut at
    # different reads (two concatenated streams)
    start = time.perf_counter()
    m = SLIDESEQ_READS
    wl14 = make_whitelist(rng, SLIDESEQ_WHITELIST, 14)
    wl14_path = WORK / "whitelist14.txt"
    wl14_path.write_bytes(np.concatenate([wl14, np.full((len(wl14), 1), ord("\n"), np.uint8)], axis=1).tobytes())
    bc_ascii, bc_len, _ = make_queries(rng, wl14, m)
    linker = LETTERS[rng.integers(0, 4, size=(m, 18))]
    umi = LETTERS[rng.integers(0, 4, size=(m, 10))]
    s1_ascii = np.concatenate([bc_ascii[:, :8], linker, bc_ascii[:, 8:], umi], axis=1)  # 42 bp
    s1_seq = [s if k == 14 else bc[:k] for s, bc, k in zip(full_rows(s1_ascii), full_rows(bc_ascii), bc_len)]
    s1_qual = [q[: len(s)] for q, s in zip(full_rows(rng.integers(35, 75, size=(m, 42), dtype=np.uint8)), s1_seq)]
    s2_seq = full_rows(LETTERS[rng.integers(0, 4, size=(m, R2_LEN))])
    s2_qual = full_rows(rng.integers(35, 75, size=(m, R2_LEN), dtype=np.uint8))
    s_names = [b"s%07d" % i for i in range(m)]
    s_paths = {kind: [str(WORK / f"s{kind}_{t}.fastq.gz") for t in range(2)] for kind in ("r1", "r2")}
    write_fastq_files(s_paths["r1"], s_names, s1_seq, s1_qual, ((0, m // 3), (m // 3, m)))
    write_fastq_files(s_paths["r2"], s_names, s2_seq, s2_qual, ((0, m // 2 + 17), (m // 2 + 17, m)))
    barcodes = [s[:8] + s[26:32] if len(s) == 42 else s for s in s1_seq]
    table14 = wl_ops.make_table(
        to_card(wl_ops.barcode_codes(full_rows(wl14), 14), table.codes.device))
    kept_rows = np.flatnonzero(expected_indices(wl_ops, table14, barcodes, 14) >= 0)
    log(f"[fastq] SampleFastq inputs: {m} {SLIDESEQ_STRUCTURE} pairs (R1 42 bp, R2 {R2_LEN} bp; R1 and R2 in "
        f"two files each, cut at different reads), whitelist {SLIDESEQ_WHITELIST} x 14; made in "
        f"{time.perf_counter() - start:.1f} s")
    out = WORK / "sampled"
    stdout = io.StringIO()
    native.reset_calls()
    with contextlib.redirect_stdout(stdout):
        rc, seconds, launches, command = timed_command(
            kernels, port_sample, "SampleFastq",
            lambda: port_platform.GenericPlatform.sample_fastq(
                ["--R1", *s_paths["r1"], "--R2", *s_paths["r2"], "--white-list", str(wl14_path),
                 "--read-structure", SLIDESEQ_STRUCTURE, "--output-prefix", str(out)]))
    batches = -(-m // BATCH)
    launches_total += launches["whitelist_correct"]
    if rc != 0 or stdout.getvalue() != f"kept {kept_rows.size} of {m} reads\n":
        raise AssertionError(f"SampleFastq: rc {rc}, {stdout.getvalue()!r}, want {kept_rows.size} kept of {m}")
    if launches["whitelist_correct"] != batches:
        raise AssertionError(f"SampleFastq: {launches['whitelist_correct']} launches, want {batches}")
    check_calls(native, "SampleFastq", sample_fastq=1)
    want_r1 = b"".join(
        b"@s%07d\n%s%s%s%sT\n+\n%s%s%s%sF\n" % (
            i, s1_seq[i][:8], b"CTTCAGCGTTCCCGAGAG", s1_seq[i][26:32], s1_seq[i][32:41],
            s1_qual[i][:8], b"F" * 18, s1_qual[i][26:32], s1_qual[i][32:41])
        for i in kept_rows.tolist())
    want_r2 = b"".join(b"@s%07d\n%s\n+\n%s\n" % (i, s2_seq[i], s2_qual[i]) for i in kept_rows.tolist())
    if Path(f"{out}.R1").read_bytes() != want_r1 or Path(f"{out}.R2").read_bytes() != want_r2:
        raise AssertionError("SampleFastq: the kept reads' R1 rewrite or R2 differs from the generator's")
    log(f"[fastq] {stamp} | SampleFastq on cuda: {m} pairs in {seconds:.2f} s = {m / seconds:.0f} reads/s "
        f"(native loop); "
        f"{split_line(seconds, command.seconds)}; {batches} batches, {launches['whitelist_correct']} kernel "
        f"launches; kept {kept_rows.size} (the plain version's count on the card), every rewritten R1 "
        f"(barcode[:8] + linker + barcode[8:] + UMI + T) and R2 exact")

    # FastqMetrics on FastqProcess's R1 files
    prefix = WORK / "fastq_metrics"
    native.reset_calls()
    begin = time.perf_counter()
    port_platform.GenericPlatform.fastq_metrics(["--R1", *paths["r1"], "--read-structure", "16C10M",
                                                 "--sample-id", str(prefix)])
    seconds = time.perf_counter() - begin
    check_calls(native, "FastqMetrics", fastq_metrics=1)
    for suffix, rows in ((".numReads_perCell_XC.txt", r1_ascii[:, :CB_LEN]),
                         (".numReads_perCell_XM.txt", r1_ascii[:, CB_LEN : CB_LEN + UMI_LEN])):
        values, first, counts = np.unique(np.ascontiguousarray(rows).view(f"S{rows.shape[1]}").ravel(),
                                          return_index=True, return_counts=True)
        order = np.lexsort((first, -counts))
        want = b"".join(b"%d\t%s\n" % (counts[k], values[k]) for k in order)
        if Path(f"{prefix}{suffix}").read_bytes() != want:
            raise AssertionError(f"FastqMetrics {suffix} differs from the generator's counts")
    upper = np.where((r1_ascii >= ord("a")) & (r1_ascii <= ord("z")), r1_ascii - 32, r1_ascii)
    for suffix, rows in ((".barcode_distribution_XC.txt", upper[:, :CB_LEN]),
                         (".barcode_distribution_XM.txt", upper[:, CB_LEN : CB_LEN + UMI_LEN])):
        table_rows = np.stack([(rows == ord(b)).sum(axis=0) for b in "ACGTN"], axis=1)
        want = b"position\tA\tC\tG\tT\tN\n" + b"".join(
            b"%d\t%d\t%d\t%d\t%d\t%d\n" % (k + 1, *row) for k, row in enumerate(table_rows.tolist()))
        if Path(f"{prefix}{suffix}").read_bytes() != want:
            raise AssertionError(f"FastqMetrics {suffix} differs from the generator's counts")
    log(f"[fastq] {stamp} | FastqMetrics (host, native scan, {min(2, native.pool_threads())} threads) on the 2 R1 "
        f"files: {n} reads in {seconds:.2f} s = {n / seconds:.0f} reads/s; the four files equal numpy counts "
        f"of the generator")
    clear_work(*KEPT_FOR_SORT, *(Path(p).name for p in bam_shards))
    log(f"[fastq] phase 7 took {time.perf_counter() - phase_start:.1f} s")
    return launches_total, bam_shards


SORT_TAGS = ("CB", "UB", "GE")
SORT_CHUNK = 500_000  # TagSortBam's default --records-per-chunk, not cut
# phase 5's outputs that phases 6 and 7 leave for the sort phase
KEPT_FOR_SORT = ("cli_cell.csv.gz", "cell_sorted.bam")
# the inputs and one-device outputs of phases 5, 6 and 8 that the mesh
# phase runs again on the mesh and compares with
KEPT_FOR_MESH = (
    "cell_sorted.bam", "gene_sorted.bam", "mito.gtf", "cli_cell.csv.gz", "cli_gene.csv.gz",
    "count.bam", "genes.gtf", "cli_count.npz", "cli_count_row_index.npy", "cli_count_col_index.npy",
    "cell_part0.csv.gz", "cell_part1.csv.gz", "merged_cell.csv.gz", "merged_gene.csv.gz",
    "cell_shuffled.bam", "fused_cell.csv.gz",
)


def clear_work(*keep: str) -> None:
    """Remove the work files but the names in ``keep``, KEPT_FOR_MESH and
    KEPT_FOR_SERVE, which a later phase reads."""
    for path in WORK.iterdir():
        if path.name not in keep and path.name not in KEPT_FOR_MESH and path.name not in KEPT_FOR_SERVE:
            shutil.rmtree(path) if path.is_dir() else path.unlink()


def raw_bodies(path, bgzf, sam) -> list:
    """The record bodies of a BAM, undecoded, in order."""
    with bgzf.open_bgzf_reader(str(path)) as fh:
        sam.read_raw_header(fh)
        return list(sam.iter_raw_records(fh))


def write_qc_inputs(directory: Path) -> dict:
    """Small Picard, HISAT2 and RSEM files for two cells; returns, per
    GroupQCs type, (files, {(row, column): value written})."""
    directory.mkdir()
    cells = {"cellA": (1000, 0.25, 812), "cellB": (500, 0.5, 377)}
    out = {"Picard": ([], {}), "PicardTable": ([], {}), "HISAT2": ([], {}), "RSEM": ([], {})}
    for cell, (total, duplication, insert) in cells.items():
        path = directory / f"{cell}_qc.alignment_summary_metrics.txt"
        rows = [f"{category}\t{reads}\t{reads}\t" for category, reads in
                (("FIRST_OF_PAIR", total // 2), ("SECOND_OF_PAIR", total // 2), ("PAIR", total))]
        path.write_text("## htsjdk.samtools.metrics.StringHeader\n## METRICS CLASS\t"
                        "picard.analysis.AlignmentSummaryMetrics\nCATEGORY\tTOTAL_READS\tPF_READS\tSAMPLE\n"
                        + "\n".join(rows) + "\n\n## HISTOGRAM\tjava.lang.Integer\nx\ty\n1\t2\n")
        out["Picard"][0].append(str(path))
        out["Picard"][1].update({(cell, "TOTAL_READS.PAIR"): total, (cell, "PF_READS.FIRST_OF_PAIR"): total // 2})
        path = directory / f"{cell}_qc.duplication_metrics.txt"
        path.write_text("## METRICS CLASS\tpicard.sam.DuplicationMetrics\nLIBRARY\tREAD_PAIRS_EXAMINED\t"
                        f"PERCENT_DUPLICATION\nlib1\t{total // 2}\t{duplication}\n")
        out["Picard"][0].append(str(path))
        out["Picard"][1][(cell, "PERCENT_DUPLICATION")] = duplication
        path = directory / f"{cell}_qc.insert_size_metrics.txt"
        path.write_text("## METRICS CLASS\tpicard.analysis.InsertSizeMetrics\nMEDIAN_INSERT_SIZE\t"
                        f"PAIR_ORIENTATION\n{insert}\tFR\n{insert + 5}\tRF\n")
        out["PicardTable"][0].append(str(path))
        out["PicardTable"][1].update({(cell, "MEDIAN_INSERT_SIZE"): insert, (cell, "PAIR_ORIENTATION"): "FR"})
        path = directory / f"{cell}_qc.log"
        path.write_text(f"HISAT2 summary stats:\nTotal reads: {total}\nAligned 0 time: {total // 10} (10.00%)\n"
                        f"Overall alignment rate: 90.00%\n")
        out["HISAT2"][0].append(str(path))
        out["HISAT2"][1].update({(cell, "Total reads"): total, (cell, "Overall alignment rate"): "90.00%"})
        path = directory / f"{cell}_rsem.cnt"
        path.write_text(f"{total // 10} {total - total // 10} 0 {total}\n{insert} 7 3\n{total + 9} 0\n")
        out["RSEM"][0].append(str(path))
        out["RSEM"][1].update({(cell, "total reads"): total, (cell, "unique aligned"): insert})
    return out


def check_qc_csv(path: Path, written: dict, index_column: str = None) -> int:
    """Every (row, column) value written reads back from the CSV (numbers
    as numbers); returns the cells checked."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    key = header.index(index_column) if index_column else 0
    table = {}
    for row in rows[1:]:
        table.setdefault(row[key], dict(zip(header, row)))
    for (row, column), value in written.items():
        got = table[row][column]
        if (float(got) != value) if isinstance(value, (int, float)) else (got != value):
            raise AssertionError(f"{path.name}: [{row}, {column}] is {got!r}, {value!r} was written")
    return len(written)


def phase_sort(rng, stamp: str, modules, shards) -> None:
    """TagSortBam with the fused cell metrics pass on the card, VerifyBamSort,
    SplitBam and GroupQCs through their entry points."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, native, port_platform, port_bam, bgzf, sam = modules
    phase_start = start = time.perf_counter()
    with bgzf.open_bgzf_reader(str(WORK / "cell_sorted.bam")) as fh:
        header = sam.read_raw_header(fh)
        phase5 = list(sam.iter_raw_records(fh))
    shuffled = WORK / "cell_shuffled.bam"
    with bgzf.BgzfWriter(str(shuffled), level=1) as out:
        out.write(header)
        order = rng.permutation(len(phase5))
        for lo in range(0, len(order), 1 << 16):
            out.write(b"".join(struct.pack("<I", len(phase5[i])) + phase5[i] for i in order[lo : lo + (1 << 16)]))
    n = len(phase5)
    log(f"[sort] inputs: phase 5's {n} cell records in a shuffled order (BGZF level 1, "
        f"{shuffled.stat().st_size} bytes); made in {time.perf_counter() - start:.1f} s")

    # the fused pass: the native sort in partials on the host, its merge
    # through a pipe into the native decoder, frames to the card
    stem, sorted_bam = WORK / "fused_cell", WORK / "fused_sorted.bam"
    args = ["-i", str(shuffled), "-t", *SORT_TAGS, "--cell-metrics-output", str(stem),
            "-a", str(WORK / "mito.gtf"), "-o", str(sorted_bam)]
    write_mito_gtf(WORK / "mito.gtf")
    gatherers = []
    torch.cuda.synchronize()
    native.reset_calls()
    kernels.reset_launches()  # the main path's run starts here
    begin = time.perf_counter()
    with recording(port_platform, "GatherCellMetrics", gatherers), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc = port_platform.GenericPlatform.tag_sort_bam(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    launches = dict(kernels.launches)  # ... and ends here
    busy_ms = device_busy_ms(prof)
    if rc != 0 or any(launches.values()):
        raise AssertionError(f"TagSortBam: rc {rc}; hand kernel launches {launches} (want none)")
    check_calls(native, "TagSortBam", tagsort_stream_frames=1, format_csv_block=None)
    gatherer = gatherers[0]
    gather_split, sort_split = gatherer.seconds, gatherer.source_stats
    # the ring's producer decodes the pipe on its thread (its seconds hold
    # its waits on the sort), the sort's phases run on the sort's thread,
    # and this thread waits on the ring (decode_wait)
    other = wall - sum(v for k, v in gather_split.items() if k != "decode")
    log(f"[sort] {stamp} | TagSortBam --cell-metrics-output -o on cuda: {n} records in {wall:.2f} s = "
        f"{n / wall:.0f} records/s; native sort ({native.default_threads()} threads, chunks of "
        f"{SORT_CHUNK}) on its thread: read {sort_split['read']:.2f} s, chunk sort {sort_split['sort']:.2f} s, "
        f"{sort_split['partial_files']} partial writes {sort_split['partials']:.2f} s, merge and BAM tee {sort_split['merge']:.2f} s; "
        f"ring: {gatherer.ring_batches} frames decoded from the pipe on its thread in "
        f"{gather_split['decode']:.2f} s; metrics pass: waiting on the ring {gather_split['decode_wait']:.2f} s, pack "
        f"{gather_split['pack']:.2f} s, upload+enqueue {gather_split['dispatch']:.2f} s, wait "
        f"{gather_split['wait']:.2f} s, CSV {gather_split['csv']:.2f} s, other {other:.2f} s; "
        f"{len(gatherer.batches)} device batches; device busy (torch.profiler, kernels and copies) "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}; no hand kernel launched")
    if sort_split["partial_files"] != -(-n // SORT_CHUNK) or len(gatherer.batches) < 2:
        raise AssertionError(f"want {-(-n // SORT_CHUNK)} partials ({n} records in chunks of {SORT_CHUNK}) "
                             f"and >= 2 device batches, got {sort_split} and {len(gatherer.batches)}")
    fused = read_csv(stem.with_name(stem.name + ".csv.gz"))[0]
    want = read_csv(WORK / "cli_cell.csv.gz")[0]
    if fused != want:
        raise AssertionError("the fused CSV differs from phase 5's CalculateCellMetrics CSV")
    out_bodies = raw_bodies(sorted_bam, bgzf, sam)
    if sorted(out_bodies) != sorted(phase5):
        raise AssertionError("the sorted BAM's records are not the input's")
    if out_bodies != phase5:
        raise AssertionError("the sorted BAM's record order differs from phase 5's (CB, UB, GE) order")
    del out_bodies, phase5
    log(f"[sort] the fused CSV equals phase 5's CalculateCellMetrics CSV byte for byte ({len(fused)} bytes); "
        f"the sorted BAM holds the input's {n} record bodies, in phase 5's order")

    stdout = io.StringIO()
    begin = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = port_platform.GenericPlatform.verify_bam_sort(["-i", str(sorted_bam), "-t", *SORT_TAGS])
    verify_seconds = time.perf_counter() - begin
    if rc != 0 or stdout.getvalue() != f"{sorted_bam} is correctly sorted by {list(SORT_TAGS)} and query name\n":
        raise AssertionError(f"VerifyBamSort: rc {rc}, {stdout.getvalue()!r}")
    try:
        port_platform.GenericPlatform.verify_bam_sort(["-i", str(shuffled), "-t", *SORT_TAGS])
    except port_bam.SortError as error:
        refused = str(error).splitlines()[0]
    else:
        raise AssertionError("VerifyBamSort passed the shuffled BAM")
    log(f"[sort] VerifyBamSort: 0 on the sorted BAM ({n} records in {verify_seconds:.2f} s = "
        f"{n / verify_seconds:.0f} records/s), SortError on the shuffled one ({refused})")
    sorted_bam.unlink()  # the shuffled BAM stays for the mesh phase

    # SplitBam on phase 7's four shards, from inside the work directory: the
    # scratch directories go in the working directory. SplitBam re-encodes
    # each record, as the JAX package's does, and the BAM writer writes the
    # bin field (bytes 10-11, an index hint) as 0 where FastqProcess wrote
    # 4680, so records are compared without it
    def unbinned(paths):
        return collections.Counter(b[:10] + b[12:] for path in paths for b in raw_bodies(path, bgzf, sam))

    in_bodies = unbinned(shards)
    size_mb = sum(Path(p).stat().st_size for p in shards) * 1e-6
    before = set(WORK.iterdir())
    stdout = io.StringIO()
    with contextlib.chdir(WORK), contextlib.redirect_stdout(stdout):
        begin = time.perf_counter()
        rc = port_platform.GenericPlatform.split_bam(
            ["-b", *shards, "-p", "chunk", "-s", repr(size_mb / 3.5), "-t", "CB", "CR", "--num-processes", "4"])
        split_seconds = time.perf_counter() - begin
    chunks = stdout.getvalue().split()
    if rc != 0 or chunks != [str((WORK / f"chunk_{i}.bam").resolve()) for i in range(4)]:
        raise AssertionError(f"SplitBam: rc {rc}, printed {chunks}")
    if set(WORK.iterdir()) - before != {Path(c) for c in chunks}:
        raise AssertionError(f"SplitBam left {sorted(set(WORK.iterdir()) - before)}")
    out_bodies = unbinned(chunks)
    if out_bodies != in_bodies or max(out_bodies.values()) != 1:
        raise AssertionError("SplitBam: the chunks do not hold every input record exactly once "
                             f"(bin field aside): {sum(in_bodies.values())} in, {sum(out_bodies.values())} out, "
                             f"{len(in_bodies - out_bodies)} input records missing")
    partition = io.StringIO()
    with contextlib.redirect_stderr(partition):
        ok = port_platform.GenericPlatform.check_barcode_partition(["-b", *chunks])
    if ok != 0:
        raise AssertionError(f"CheckBarcodePartition on the SplitBam chunks: {partition.getvalue()[-300:]}")
    log(f"[sort] SplitBam -t CB CR --num-processes 4: {sum(in_bodies.values())} records of {len(shards)} BAMs "
        f"into {len(chunks)} chunks in {split_seconds:.2f} s; every record in exactly one chunk (its bytes but "
        f"the re-encoded bin field), no scratch "
        f"directory left, CheckBarcodePartition 0 ({partition.getvalue().strip()})")

    # GroupQCs: all five types, on files written here, without pandas
    qc = write_qc_inputs(WORK / "qc")
    checked = 0
    for metrics_type in ("Picard", "HISAT2", "RSEM"):
        files, written = qc[metrics_type]
        out = WORK / "qc" / metrics_type
        port_platform.GenericPlatform.group_qc_outputs(["-f", *files, "-o", str(out), "-t", metrics_type])
        checked += check_qc_csv(out.with_name(out.name + ".csv"), written)
    files, written = qc["PicardTable"]
    for path, cell in zip(files, ("cellA", "cellB")):
        # one CSV per input file, named by its class; a cell's first row is read
        out = WORK / "qc" / f"table_{cell}"
        port_platform.GenericPlatform.group_qc_outputs(["-f", path, "-o", str(out), "-t", "PicardTable"])
        checked += check_qc_csv(out.with_name(out.name + "_insert_size_metrics.csv"),
                                {k: v for k, v in written.items() if k[0] == cell}, "Sample")
    core = WORK / "qc" / "Core"
    port_platform.GenericPlatform.group_qc_outputs(
        ["-f", str(WORK / "qc" / "Picard.csv"), str(WORK / "qc" / "HISAT2.csv"), "-o", str(core), "-t", "Core"])
    checked += check_qc_csv(core.with_name("Core.csv"), {**qc["Picard"][1], **qc["HISAT2"][1]})
    log(f"[sort] GroupQCs Picard, PicardTable, HISAT2, RSEM and Core: {checked} cells read back as written")
    if any(kernels.launches.values()):
        raise AssertionError(f"a hand kernel launched in the sort phase: {kernels.launches}")
    clear_work()
    log(f"[sort] phase 8 took {time.perf_counter() - phase_start:.1f} s")


MESH_SHARDS = 2
# the distributed step's and the sample sort's input: the cell BAM's first
# records, at 2 shards of 2^17 (their CPU mesh run is the reference)
MESH_STEP_RECORDS = 1 << 18


@contextlib.contextmanager
def mesh_for_devices(port_platform, mesh):
    """Within the block, ``--devices N`` with N the mesh's size resolves to
    ``mesh`` (the one-card mesh, which no command line can ask for); every
    other value resolves as the command would."""
    real = port_platform._resolve_mesh

    def resolve(devices, backend, parser, device):
        if devices == mesh.size and backend != "cpu":
            return mesh
        return real(devices, backend, parser, device)

    port_platform._resolve_mesh = resolve
    try:
        yield
    finally:
        port_platform._resolve_mesh = real


def same_sharded(name: str, got: dict, want: dict) -> None:
    """Two stacked sharded results equal, float bits included."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: columns {sorted(got)} != {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a, b.view(np.int32) if b.dtype == np.float32 else b
        ):
            raise AssertionError(f"{name}: {key} differs between the card mesh and the CPU mesh")


def phase_mesh(stamp: str, modules) -> None:
    """The six ``--devices`` commands on a 2-shard card mesh against their
    one-device outputs of phases 5, 6 and 8; the mesh functions on the card
    against a CPU mesh."""
    import torch

    kernels, port_platform, port_par, port_par_gatherer, port_gatherer, port_gtf, packed = modules
    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        mesh = port_par.make_mesh(MESH_SHARDS)
        patch = contextlib.nullcontext()
        how = f"the commands' own --devices {MESH_SHARDS}"
    else:
        # the CLI's mesh needs as many cards as shards: JAX's parser error
        stderr = io.StringIO()
        with contextlib.redirect_stderr(stderr), contextlib.suppress(SystemExit):
            port_platform.GenericPlatform.calculate_cell_metrics(
                ["-i", str(WORK / "cell_sorted.bam"), "-o", str(WORK / "refused"), "--devices", str(MESH_SHARDS)])
        want = f"error: requested {MESH_SHARDS} devices, only {n_cards} available"
        if want not in stderr.getvalue() or list(WORK.glob("refused*")):
            raise AssertionError(f"--devices {MESH_SHARDS} on {n_cards} card: {stderr.getvalue()!r}")
        log(f"[mesh] --devices {MESH_SHARDS} on this {n_cards}-card machine stops at the parser: {want!r}")
        card = torch.device("cuda", 0)
        mesh = port_par.make_mesh(devices=[card] * MESH_SHARDS)
        patch = mesh_for_devices(port_platform, mesh)
        how = f"--devices {MESH_SHARDS} resolved to the one-card mesh"
    log(f"[mesh] {n_cards} card(s) of {torch.cuda.get_device_name(0)}: the commands run on {mesh!r} ({how}); "
        f"fingerprint {port_par.mesh_fingerprint(mesh)}")
    devices = ["--devices", str(MESH_SHARDS)]
    mito = str(WORK / "mito.gtf")
    commands = [
        ("calculate_cell_metrics", "ShardedCellMetrics",
         ["-i", str(WORK / "cell_sorted.bam"), "-o", str(WORK / "mesh_cell"), "-a", mito],
         "mesh_cell.csv.gz", "cli_cell.csv.gz"),
        ("calculate_gene_metrics", "ShardedGeneMetrics",
         ["-i", str(WORK / "gene_sorted.bam"), "-o", str(WORK / "mesh_gene")],
         "mesh_gene.csv.gz", "cli_gene.csv.gz"),
        ("bam_to_count_matrix", "CountMatrix",
         ["-b", str(WORK / "count.bam"), "-a", str(WORK / "genes.gtf"), "-o", str(WORK / "mesh_count")],
         "mesh_count", "cli_count"),
        ("merge_cell_metrics", None,
         [str(WORK / "cell_part0.csv.gz"), str(WORK / "cell_part1.csv.gz"), "-o", str(WORK / "mesh_merged_cell")],
         "mesh_merged_cell.csv.gz", "merged_cell.csv.gz"),
        ("merge_gene_metrics", None,
         [str(WORK / "cli_gene.csv.gz"), str(WORK / "cli_gene.csv.gz"), "-o", str(WORK / "mesh_merged_gene")],
         "mesh_merged_gene.csv.gz", "merged_gene.csv.gz"),
        ("tag_sort_bam", "ShardedCellMetrics",
         ["-i", str(WORK / "cell_shuffled.bam"), "-t", *SORT_TAGS, "--cell-metrics-output",
          str(WORK / "mesh_fused"), "-a", mito],
         "mesh_fused.csv.gz", "fused_cell.csv.gz"),
    ]
    with patch:
        for entry, recorded, args, got, want in commands:
            made = []
            module = port_platform if recorded == "CountMatrix" else port_par_gatherer
            torch.cuda.synchronize()
            begin = time.perf_counter()
            with recording(module, recorded, made) if recorded else contextlib.nullcontext():
                rc = getattr(port_platform.GenericPlatform, entry)(args + devices)
                torch.cuda.synchronize()
            wall = time.perf_counter() - begin
            if entry == "bam_to_count_matrix":
                equal = same_files(WORK / got, WORK / want)
            else:
                equal = read_csv(WORK / got)[0] == read_csv(WORK / want)[0]
            if rc != 0 or not equal:
                raise AssertionError(f"{entry} --devices {MESH_SHARDS}: rc {rc}, output equal to {want}: {equal}")
            detail = ""
            if made:
                runner = made[0]
                split = ", ".join(f"{k} {v:.2f}" for k, v in runner.seconds.items() if isinstance(v, float))
                shards = [b.get("shards", MESH_SHARDS) for b in runner.batches]
                detail = (f"; {len(runner.batches)} batches over {shards[0] if shards else MESH_SHARDS} shards, "
                          f"{sum(b['records'] for b in runner.batches)} records padded to "
                          f"{sum(b['padded'] for b in runner.batches)}; seconds: {split}")
                if getattr(runner, "source_stats", None):
                    detail += "; sort: " + ", ".join(
                        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}" for k, v in runner.source_stats.items())
            log(f"[mesh] {stamp} | {entry} --devices {MESH_SHARDS}: {wall:.2f} s wall{detail}; "
                f"output equals {want} (one device)")

    cpu_mesh = port_par.make_mesh(MESH_SHARDS, device="cpu")
    begin = time.perf_counter()
    if port_par.collective_preflight(mesh) != port_par.collective_preflight(cpu_mesh):
        raise AssertionError("collective_preflight: the card mesh and the CPU mesh differ")
    frames = packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), MESH_STEP_RECORDS, want_qname=False)
    frame = next(frames)
    frames.close()
    names = port_gtf.get_mitochondrial_gene_names(mito)
    is_mito = np.asarray([name in names for name in frame.gene_names], dtype=bool)
    cols = port_gatherer._pad_columns(frame, is_mito)[0]
    stacked = port_par.partition_columns(cols, MESH_SHARDS, key="cell")
    keys = {"k1": frame.cell.reshape(MESH_SHARDS, -1), "k2": frame.umi.reshape(MESH_SHARDS, -1),
            "payload": np.arange(frame.n_records, dtype=np.int32).reshape(MESH_SHARDS, -1),
            "valid": np.ones((MESH_SHARDS, frame.n_records // MESH_SHARDS), dtype=bool)}
    seconds = {}
    results = {}
    for name, on in (("card", mesh), ("cpu", cpu_mesh)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        cell, gene = port_par.distributed_metrics_step(stacked, on)
        step = (port_par.stack_to_host(cell), port_par.stack_to_host(gene))
        seconds[name, "step"] = time.perf_counter() - start
        start = time.perf_counter()
        ordered = port_par.stack_to_host(port_par.distributed_sort(keys, ["k1", "k2"], on))
        seconds[name, "sort"] = time.perf_counter() - start
        results[name] = step + (ordered,)
    for label, got, want in zip(("step cell", "step gene", "sort"), results["card"], results["cpu"]):
        same_sharded(label, got, want)
    flat = np.concatenate([results["card"][2]["k1"][s][results["card"][2]["valid"][s]] for s in range(MESH_SHARDS)])
    if flat.size != frame.n_records or np.any(np.diff(flat) < 0):
        raise AssertionError("distributed_sort: the flattened shards are not the records in order")
    log(f"[mesh] {stamp} | collective_preflight equal on the card and CPU meshes; distributed_metrics_step "
        f"({frame.n_records} records, {stacked['cell'].shape[1]} a shard) card {seconds['card', 'step']:.2f} s, "
        f"cpu {seconds['cpu', 'step']:.2f} s; distributed_sort (cell, umi) card {seconds['card', 'sort']:.2f} s, "
        f"cpu {seconds['cpu', 'sort']:.2f} s; every output equal bit for bit ({time.perf_counter() - begin:.1f} s)")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the mesh phase: {kernels.launches}")
    log("[mesh] no hand kernel launched (kernels.launches unchanged)")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_SCHED:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[mesh] phase 9 took {time.perf_counter() - phase_start:.1f} s")


# phase 5's cell BAM, its GTF and its one-shot CSV, and phase 10's chunks:
# the distributed phase's inputs
KEPT_FOR_DIST = ("cell_sorted.bam", "mito.gtf", "cli_cell.csv.gz", "chunks")
# phase 5's cell BAM (the serve workers' calibration BAM) and phase 10's
# chunks (the serve phase's tenant jobs) are among them
KEPT_FOR_SERVE = KEPT_FOR_DIST
# phase 5's cell BAM, its GTF and its one-shot CSV, for the chunk queue
KEPT_FOR_SCHED = ("cell_sorted.bam", "mito.gtf", "cli_cell.csv.gz", *KEPT_FOR_SERVE)
SCHED_CHUNKS = 4.5  # -s is the BAM's size over this: 5 chunks
SCHED_TTL = 2.0  # seconds a dead worker's lease outlives its last heartbeat
SCHED_STRAGGLE = 0.5  # worker B's delay at each claim
WORKER_FLAG = "--sched-worker"


def sched_worker(argv) -> int:
    """One worker of phase 10, in its own process: the port's chunk queue on
    cuda over ``<workdir>/chunks/*.bam``, faults from the environment
    (``SCTOOLS_TPU_FAULTS``). Prints, as ``[worker] {json}`` lines, the hand
    kernel launches (a count a process) when its queue starts and, at its
    end, with its wall and its committed parts. Exit 0, or 86 on an injected
    crash, which leaves only the first line."""
    workdir, process_id, n_processes, gtf = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    begin = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch.parallel import launch

    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    committed = launch.run_process_cell_metrics(
        sorted(str(p) for p in (workdir / "chunks").glob("*.bam")), str(workdir / f"proc{process_id}"),
        n_processes, process_id, frozenset(port_gtf.get_mitochondrial_gene_names(gtf)),
        lease_ttl=SCHED_TTL, backoff_base=0.1,
    )
    print("[worker] " + json.dumps({"wall": time.perf_counter() - begin, "committed": len(committed),
                                    "launches": dict(kernels.launches)}), flush=True)
    return 0


def phase_sched(stamp: str, modules) -> None:
    """SplitBam on phase 5's cell BAM, then the chunk queue on the card: two
    worker processes at once, one killed mid-chunk and the other a straggler
    that fails one chunk twice and steals the dead one's lease, a clean
    relaunch, ``sched status``, and both part merges against phase 5's
    one-shot CSV."""
    import os

    import torch

    port_platform, port_sched, port_launch, port_collective = modules
    phase_start = start = time.perf_counter()
    workdir = WORK / "sched"
    (workdir / "chunks").mkdir(parents=True)
    bam = WORK / "cell_sorted.bam"
    size_mb = bam.stat().st_size * 1e-6
    stdout = io.StringIO()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(stdout):
        rc = port_platform.GenericPlatform.split_bam(
            ["-b", str(bam), "-p", str(workdir / "chunks" / "chunk"), "-s", repr(size_mb / SCHED_CHUNKS),
             "-t", "CB"])
    split_seconds = time.perf_counter() - start
    made = stdout.getvalue().split()
    if rc != 0 or len(made) < 4:
        raise AssertionError(f"SplitBam: rc {rc}, want >= 4 chunks, printed {made}")
    # zero-padded names: the chunks sort in the split's order, so task
    # chunkNNNN reads chunkNNNN.bam and a fault spec can name either
    for i in range(len(made)):
        os.replace(workdir / "chunks" / f"chunk_{i}.bam", workdir / "chunks" / f"chunk{i:04d}.bam")
    n_chunks = len(made)
    log(f"[sched] SplitBam -t CB -s {size_mb / SCHED_CHUNKS:.2f} on phase 5's cell BAM ({size_mb:.1f} MB): "
        f"{n_chunks} chunks in {split_seconds:.2f} s")

    journal_dir = workdir / "sched-journal"
    gtf = str(WORK / "mito.gtf")

    def launch(process_id: int, spec: str):
        env = {k: v for k, v in os.environ.items() if k != "SCTOOLS_TPU_FAULTS"}
        if spec:
            env["SCTOOLS_TPU_FAULTS"] = spec
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), WORKER_FLAG, str(workdir), str(process_id), "2", gtf],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        return proc, time.perf_counter()

    def finish(proc, began, timeout=300):
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out, time.perf_counter() - began

    def worker_id(proc, process_id):
        return f"proc{process_id}-of-2-{proc.pid}"

    spec_a = "crash@gatherer.batch:match=chunk0000,times=1"
    spec_b = f"delay@task.claimed:secs={SCHED_STRAGGLE};fail@task.claimed:match=chunk0002,times=2"
    procs = []
    try:
        # A first, so that it holds chunk0000 (the first task by name) when
        # B starts; B then finds it leased and takes the rest
        a, a_began = launch(0, spec_a)
        procs.append(a)
        probe = port_sched.Journal(str(journal_dir), worker_id="smoke-probe")
        deadline = time.perf_counter() + 120
        holder = None
        while holder is None and time.perf_counter() < deadline:
            exited = a.poll() is not None  # then this last look sees its final journal
            if journal_dir.is_dir():
                tasks, states = probe.replay()
                holder = next((st.worker for tid, st in states.items()
                               if tid in tasks and tasks[tid].name == "chunk0000" and st.state == "leased"), None)
            if exited:
                break
            time.sleep(0.05)
        if holder != worker_id(a, 0):
            raise AssertionError(f"worker A never leased chunk0000 (holder {holder}): {a.communicate()[0][-3000:]}")
        b, b_began = launch(1, spec_b)
        procs.append(b)
        runs = {"A": finish(a, a_began), "B": finish(b, b_began)}
        ids = {"A": worker_id(a, 0), "B": worker_id(b, 1)}
        before_relaunch = probe.replay()[1]
        r, r_began = launch(0, "")
        procs.append(r)
        runs["relaunch"] = finish(r, r_began)
        ids["relaunch"] = worker_id(r, 0)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if runs["A"][0] != 86 or "injected crash at gatherer.batch" not in runs["A"][1]:
        raise AssertionError(f"worker A should die at gatherer.batch with 86: rc {runs['A'][0]}\n{runs['A'][1][-3000:]}")
    for name in ("B", "relaunch"):
        if runs[name][0] != 0:
            raise AssertionError(f"worker {name}: rc {runs[name][0]}\n{runs[name][1][-3000:]}")

    tasks, states = probe.replay()
    by_name = {tasks[tid].name: st for tid, st in states.items()}
    if len(by_name) != n_chunks or any(st.state != port_sched.COMMITTED for st in by_name.values()):
        raise AssertionError(f"not every chunk committed: { {n: st.state for n, st in by_name.items()} }")
    want_attempts = {name: 1 for name in by_name}
    want_attempts.update(chunk0000=2, chunk0002=3)
    got = {name: (st.attempts, st.steals) for name, st in by_name.items()}
    if got != {name: (n, int(name == "chunk0000")) for name, n in want_attempts.items()}:
        raise AssertionError(f"(attempts, steals) per chunk: {got}")
    if by_name["chunk0000"].worker != ids["B"]:
        raise AssertionError(f"chunk0000 committed by {by_name['chunk0000'].worker}, not B ({ids['B']})")
    if {t: vars(st) for t, st in states.items()} != {t: vars(st) for t, st in before_relaunch.items()}:
        raise AssertionError("the relaunch changed the journal's task states")
    events = probe.events()
    for name, (rc, out, wall) in runs.items():
        leased = [e for e in events if e.get("worker") == ids[name] and e.get("event") == "leased"]
        reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
        # A's crash (os._exit at the top of its first device batch) leaves
        # only its first report; the others report at their end too
        if len(reports) != (1 if name == "A" else 2) or any(any(r["launches"].values()) for r in reports):
            raise AssertionError(f"worker {name}: hand kernel launches {reports}")
        log(f"[sched] {stamp} | worker {name} ({ids[name]}): exit {rc} in {wall:.2f} s wall, "
            f"{len(leased)} attempts, {sum(int(e.get('stolen', 0)) for e in leased)} steals, "
            f"hand kernel launches 0 {'at its start' if name == 'A' else 'at its start and its end'}")
    if any(e.get("worker") == ids["relaunch"] and e.get("event") == "leased" for e in events):
        raise AssertionError("the clean relaunch made an attempt")

    status = subprocess.run(
        [sys.executable, "-m", "sctools_tpu_torch.sched", "status", str(journal_dir)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    total = [line for line in status.stdout.splitlines() if line.startswith("total=")]
    if status.returncode != 0 or total != [f"total={n_chunks} (committed={n_chunks})"]:
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    log(f"[sched] python -m sctools_tpu_torch.sched status: exit 0, {total[0]}; "
        f"{[line for line in status.stdout.splitlines() if line.startswith('mesh ')]}")

    pattern = str(workdir / "metrics.part*.csv.gz")
    want = read_csv(WORK / "cli_cell.csv.gz")[0]
    mesh = port_launch.local_mesh()
    merged = {}
    for name, merge, kwargs in (("merge_sorted_csv_parts", port_launch.merge_sorted_csv_parts, {}),
                                ("collective_merge_parts", port_collective.collective_merge_parts, {"mesh": mesh})):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        rows = merge(pattern, str(workdir / f"{name}.csv.gz"), journal_dir=str(journal_dir),
                     expected_parts=n_chunks, **kwargs)
        torch.cuda.synchronize()
        merged[name] = time.perf_counter() - begin
        if read_csv(workdir / f"{name}.csv.gz")[0] != want:
            raise AssertionError(f"{name}: the merged CSV differs from phase 5's CalculateCellMetrics CSV")
    log(f"[sched] {stamp} | merge_sorted_csv_parts {merged['merge_sorted_csv_parts']:.2f} s, "
        f"collective_merge_parts on {mesh!r} {merged['collective_merge_parts']:.2f} s: {rows} rows each, "
        f"both equal phase 5's CalculateCellMetrics CSV byte for byte ({len(want)} bytes)")
    # the chunks are the serve phase's tenant jobs
    shutil.move(str(workdir / "chunks"), str(WORK / "chunks"))
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_SERVE:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[sched] phase 10 took {time.perf_counter() - phase_start:.1f} s")



# phase 10's five chunks as three tenants' jobs
SERVE_TENANTS = (("t0", (0, 1)), ("t1", (2, 3)), ("t2", (4,)))
# and two small jobs a tenant, which the planner puts in the chunks' packs:
# its estimate (file size over 48 bytes, the JAX package's) reads each
# chunk (~160 bytes a record) as 790,000-910,000 records, so a chunk fills
# most of a 2^20 pack alone
SERVE_SMALL_JOBS = 2
SERVE_SMALL_RECORDS = 30_000
SERVE_TTL = 2.0  # seconds a dead worker's lease outlives its last heartbeat
SERVE_HOLD = 120.0  # the victim's delay at its first claim: it is killed inside it
SERVE_FLAG = "--serve-worker"


def serve_worker(argv) -> int:
    """One resident worker of phase 11, in its own process: ``python -m
    sctools_tpu_torch.serve worker`` with ``argv`` (on cuda, its default),
    faults from the environment. Prints the hand kernel launches as
    ``[worker] {json}`` lines when it starts and, after the CLI's own JSON
    summary line, at its end."""
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch.serve import cli

    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    rc = cli.main(["worker", *argv])
    print("[worker] " + json.dumps({"launches": dict(kernels.launches)}), flush=True)
    return rc


def phase_serve(rng, stamp: str, modules) -> None:
    """The serving plane on the card: phase 10's five chunks and six small
    libraries submitted as three tenants' jobs with ``python -m
    sctools_tpu_torch.serve submit``; a victim worker that leases one job a
    tenant and is SIGTERM'd inside its pack, then a worker and its
    replacement, each warmed on phase 5's cell BAM, drain the journal at the
    2^20-record batch width in cross-tenant packs on CUDA graphs. Every
    artifact against its input's solo CalculateCellMetrics CSV, the chunks'
    merge against the one-shot CSV, ``sched status``'s serve view, and one
    full batch's device pass eager against graph replay."""
    import os
    import signal

    import torch

    (port_platform, port_sched, port_launch, port_gatherer, port_device, port_seg, port_graphs, packed,
     bgzf) = modules
    phase_start = time.perf_counter()
    workdir = WORK / "serve"
    journal_dir = workdir / "journal"
    chunks = sorted((WORK / "chunks").glob("chunk*.bam"))
    if len(chunks) != 5:
        raise AssertionError(f"phase 10 left {len(chunks)} chunks, want 5")
    # (tenant, input BAM, output stem) of every job
    jobs = [(tenant, chunks[i], workdir / "out" / f"metrics.part{i:04d}")
            for tenant, indices in SERVE_TENANTS for i in indices]
    begin = time.perf_counter()
    (workdir / "small").mkdir(parents=True)
    for tenant, _ in SERVE_TENANTS:
        for k in range(SERVE_SMALL_JOBS):
            bam = workdir / "small" / f"{tenant}.{k}.bam"
            write_tagged_bam(bam, rng, sort_reads(make_reads(rng, SERVE_SMALL_RECORDS), "cell"), bgzf)
            jobs.append((tenant, bam, workdir / "out" / f"small.{tenant}.{k}"))
    made = time.perf_counter() - begin
    submit = []
    for tenant, bam, stem in jobs:
        submit += ["--job", tenant, str(bam), str(stem)]
    begin = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.serve", "submit", str(journal_dir), *submit],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    if done.returncode != 0 or f"registered {len(jobs)} new job(s)" not in done.stdout:
        raise AssertionError(f"serve submit: rc {done.returncode}\n{done.stdout}{done.stderr}")
    log(f"[serve] python -m sctools_tpu_torch.serve submit: {len(jobs)} jobs of 3 tenants in "
        f"{time.perf_counter() - begin:.2f} s: {', '.join(f'{t} {b.name} {b.stat().st_size / 1e6:.1f} MB' for t, b, _ in jobs)} "
        f"(the small libraries, {SERVE_SMALL_RECORDS} records each, made in {made:.2f} s)")

    def launch(worker_id: str, spec: str, *extra):
        env = {k: v for k, v in os.environ.items() if k != "SCTOOLS_TPU_FAULTS"}
        if spec:
            env["SCTOOLS_TPU_FAULTS"] = spec
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), SERVE_FLAG, str(journal_dir), "--worker-id", worker_id,
             "--lease-ttl", repr(SERVE_TTL), "--poll-interval", "0.1", "--idle-timeout", "120", *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        return proc, time.perf_counter()

    probe = port_sched.Journal(str(journal_dir), worker_id="smoke-probe")
    procs = []
    runs = {}
    try:
        # the victim: one job a tenant (--max-depth 1), held inside the pack
        victim, began = launch("wA", f"delay@task.claimed:secs={SERVE_HOLD},times=1", "--max-depth", "1")
        procs.append(victim)
        deadline = time.perf_counter() + 120
        while not any(st.state == "leased" for st in probe.replay()[1].values()):
            if victim.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the victim never leased a job: {victim.communicate()[0][-3000:]}")
            time.sleep(0.05)
        tasks, states = probe.replay()
        held = sorted(tasks[tid].name for tid, st in states.items() if st.state == "leased")
        calibration = ("--calibration-bam", str(WORK / "cell_sorted.bam"), "--drain")
        survivor, survivor_began = launch("wB", "", *calibration)
        procs.append(survivor)
        victim.send_signal(signal.SIGTERM)
        victim_out, _ = victim.communicate(timeout=60)
        runs["wA"] = (victim.returncode, victim_out, time.perf_counter() - began)
        replacement, replacement_began = launch("wC", "", *calibration)
        procs.append(replacement)
        for name, proc, start in (("wB", survivor, survivor_began), ("wC", replacement, replacement_began)):
            out, _ = proc.communicate(timeout=600)
            runs[name] = (proc.returncode, out, time.perf_counter() - start)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    serve_wall = time.perf_counter() - survivor_began
    if runs["wA"][0] != -signal.SIGTERM:
        raise AssertionError(f"the victim should die of SIGTERM: rc {runs['wA'][0]}\n{runs['wA'][1][-3000:]}")
    summaries = {}
    for name, (rc, out, wall) in runs.items():
        reports = [json.loads(line[len("[worker] "):]) for line in out.splitlines() if line.startswith("[worker] ")]
        if any(any(r["launches"].values()) for r in reports):
            raise AssertionError(f"worker {name}: hand kernel launches {reports}")
        if name == "wA":
            continue
        if rc != 0 or len(reports) != 2:
            raise AssertionError(f"worker {name}: rc {rc}\n{out[-3000:]}")
        summaries[name] = json.loads(next(line for line in out.splitlines() if line.startswith('{"worker"')))
    log(f"[serve] victim wA leased {held} at --max-depth 1, SIGTERM'd inside its pack "
        f"(delay@task.claimed): exit {runs['wA'][0]} after {runs['wA'][2]:.2f} s; no hand kernel at its start")

    tasks, states = probe.replay()
    events = probe.events()
    probe.close()
    if sorted(st.state for st in states.values()) != ["committed"] * len(jobs):
        raise AssertionError(f"not every job committed: { {tasks[t].name: st.state for t, st in states.items()} }")
    stolen = [e for e in events if e.get("event") == "leased" and e.get("stolen")]
    if not stolen:
        raise AssertionError("no lease was stolen from the victim")
    tenant_of = {tid: task.payload["tenant"] for tid, task in tasks.items()}
    cross = [e for e in events if e.get("event") == "committed"
             and len({tenant_of[t] for t in e["pack_members"]}) > 1]
    packs_run = sum(s["packs_run"] for s in summaries.values())
    if packs_run < 1 or not cross or any(s["packs_degraded"] for s in summaries.values()):
        raise AssertionError(f"packs: {summaries}; {len(cross)} jobs committed in cross-tenant packs")
    for name, summary in summaries.items():
        graphs = summary["graphs"]
        if graphs["keys"] != graphs["captures_warmup"] + graphs["captures_serving"]:
            raise AssertionError(f"worker {name}: a graph key captured twice: {graphs}")
        log(f"[serve] {stamp} | worker {name}: warmup {summary['warmup_s']:.2f} s "
            f"({graphs['captures_warmup']} graphs captured on the calibration BAM), first result "
            f"{summary['first_result_s'] if summary['first_result_s'] is None else round(summary['first_result_s'], 2)} "
            f"s after its start, {summary['jobs_committed']} jobs in {summary['packs_run']} packs "
            f"({summary['packs_degraded']} degraded); graphs: {graphs['captures_serving']} captured while "
            f"serving, {graphs['replays']} replays, {graphs['keys']} keys; exit 0 in {runs[name][2]:.2f} s wall; "
            f"no hand kernel at its start and its end")
    name_of = {tid: tasks[tid].name for tid in tasks}
    commits = [e for e in events if e.get("event") == "committed"]
    for plan in [e for e in events if e.get("event") == "worker" and e.get("pack_plan")]:
        log(f"[serve] pack plan of {plan['worker']}: {[name_of.get(t, t) for t in plan['pack_plan']['tids']]}")
    for commit in sorted(commits, key=lambda e: name_of[e["id"]]):
        log(f"[serve] {name_of[commit['id']]} committed by {commit['worker']}: pack of "
            f"{len(commit['pack_members'])}, {commit['pack_rows']} records by member, bucket "
            f"{commit['pack_bucket']}, audit {commit['audit']}")
    first = min(e["ts"] for e in events if e.get("event") == "leased" and e.get("worker") in summaries)
    last = max(e["ts"] for e in commits)
    records = sum(c["audit"]["records_streamed"] for c in commits)
    log(f"[serve] {stamp} | {len(jobs)} jobs ({records} records) in {last - first:.2f} s from the first lease "
        f"of wB or wC to the last commit = {len(jobs) / (last - first):.3f} jobs/s, "
        f"{records / (last - first):.0f} records/s; {len(cross)} jobs committed in cross-tenant packs; "
        f"{len(stolen)} leases stolen ({sorted(name_of[e['id']] for e in stolen)}); wB and wC started "
        f"{serve_wall:.2f} s before both exited")

    # each artifact against its input's solo CalculateCellMetrics on the card
    for i, (_, bam, stem) in enumerate(jobs):
        solo = workdir / f"solo{i}"
        if port_platform.GenericPlatform.calculate_cell_metrics(["-i", str(bam), "-o", str(solo)]) != 0:
            raise AssertionError(f"CalculateCellMetrics on {bam.name} failed")
        if read_csv(Path(str(stem) + ".csv.gz"))[0] != read_csv(Path(str(solo) + ".csv.gz"))[0]:
            raise AssertionError(f"{stem.name}: the served CSV differs from {bam.name}'s solo CSV")
    # the serve jobs carry no mitochondrial GTF (the JAX payload has none):
    # the one-shot reference is phase 5's command without -a
    one_shot = workdir / "one_shot"
    port_platform.GenericPlatform.calculate_cell_metrics(["-i", str(WORK / "cell_sorted.bam"), "-o", str(one_shot)])
    rows = port_launch.merge_sorted_csv_parts(str(workdir / "out" / "metrics.part*.csv.gz"),
                                              str(workdir / "merged.csv.gz"), expected_parts=5)
    want = read_csv(Path(str(one_shot) + ".csv.gz"))[0]
    if read_csv(workdir / "merged.csv.gz")[0] != want:
        raise AssertionError("the merged served CSVs differ from the one-shot CalculateCellMetrics CSV")
    log(f"[serve] every served CSV equals its input's solo CalculateCellMetrics CSV on the card; the chunks' "
        f"merge_sorted_csv_parts ({rows} rows) equals the one-shot CSV of phase 5's cell BAM byte for byte "
        f"({len(want)} bytes, decompressed)")

    status = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.sched", "status", str(journal_dir)],
                            capture_output=True, text=True, cwd=REPO, timeout=120)
    lines = [line for line in status.stdout.splitlines() if line.startswith("serve ")]
    wanted = ("serve tenant t0:", "serve tenant t1:", "serve tenant t2:", "serve admission wB:",
              "serve steer wB: mode=off", "serve rows: ")
    if status.returncode != 0 or not all(any(line.startswith(w) for line in lines) for w in wanted) \
            or not any(line.startswith("serve rows: ") and line.endswith("— balanced") for line in lines):
        raise AssertionError(f"sched status: rc {status.returncode}\n{status.stdout}{status.stderr}")
    for line in lines:
        log(f"[serve] status: {line}")

    # one full 2^20 batch's device pass, eager against graph replay
    frame = next(packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), METRICS_BATCH, want_qname=False))
    cut = int(np.nonzero(frame.cell[1:] != frame.cell[:-1])[0][-1]) + 1
    batch = port_gatherer.slice_frame(frame, 0, cut)
    gatherer = port_gatherer.GatherCellMetrics(str(WORK / "cell_sorted.bam"), str(workdir / "unused"))
    gatherer.start_stream()
    int_names, float_names = port_gatherer.wire_result_names(gatherer.columns)
    k = port_seg.entity_bucket(int(np.count_nonzero(batch.cell[1:] != batch.cell[:-1])) + 1, METRICS_BATCH)
    graph_set = port_graphs.GraphSet("cuda")
    for presorted in (True, False):
        cols, kwargs, decisions = gatherer.pack_batch(batch, pad_to=METRICS_BATCH, presorted=presorted)
        staged = {name: to_card(array, "cuda") for name, array in cols.items()}
        passes = {
            "eager": lambda: port_device.compute_entity_metrics(staged, **kwargs),
            "graph": lambda: graph_set.run(staged, **kwargs),
        }
        blocks, times, host = {}, {}, {}
        for name, engine in passes.items():
            def one_batch(engine=engine):
                return port_device.compact_results_wire(engine(), int_names, float_names, k)

            blocks[name] = one_batch().cpu().numpy()
            times[name] = cuda_ms(one_batch, repeats=5)
            torch.cuda.synchronize()
            begin = time.perf_counter()
            for _ in range(5):
                one_batch()
            torch.cuda.synchronize()
            host[name] = (time.perf_counter() - begin) / 5 * 1e3
        if not np.array_equal(blocks["eager"], blocks["graph"]):
            raise AssertionError(f"graph replay's block differs from the eager block (presorted={presorted})")
        log(f"[serve] {stamp} | one full batch ({decisions['records']} records padded to "
            f"{kwargs['num_segments']}, {'presorted, prepacked' if presorted else 'device-sorted, plain'}"
            f"{', run-keyed' if decisions['run_keyed'] else ''}) device pass + compaction: eager "
            f"{times['eager']:.3f} ms, graph replay {times['graph']:.3f} ms (CUDA events, 5 calls queued back "
            f"to back); host wall a call with a sync after 5: eager {host['eager']:.3f} ms, graph "
            f"{host['graph']:.3f} ms; blocks equal byte for byte")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_DIST:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[serve] phase 11 took {time.perf_counter() - phase_start:.1f} s")


DIST_FLAG = "--dist-worker"
DIST_PROCESSES = 2
DIST_STEPS = 3  # the step's runs a worker times: the first one cold


def dist_worker(argv) -> int:
    """One process of phase 12, in its own process: joins the group on
    ``cuda:<card>``, runs the chunk queue over ``<work>/chunks`` (rank 0
    merges the parts), then its shard of ``<workdir>/stacked.npz`` through
    ``host_local_to_global`` and ``distributed_metrics_step`` on the global
    mesh, writing its shard's outputs to ``out<p>.npz``. Prints one
    ``[worker] {json}`` line: the transport, the seconds of each stage, the
    step's wall and device milliseconds, the bytes it sent across the
    process boundary and the hand kernel launches at its start and end."""
    workdir, process_id, coordinator, card, gtf = Path(argv[0]), int(argv[1]), argv[2], int(argv[3]), argv[4]
    begin = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch

    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import parallel as par

    report = {"launches_start": dict(kernels.launches)}
    device = torch.device("cuda", card)
    start = time.perf_counter()
    report["transport"] = par.initialize_distributed(coordinator, DIST_PROCESSES, process_id, device=device,
                                                     timeout=300.0)
    report["init_s"] = time.perf_counter() - start

    start = time.perf_counter()
    chunks = sorted(str(p) for p in (WORK / "chunks").glob("*.bam"))
    committed = par.run_process_cell_metrics(
        chunks, str(workdir / f"proc{process_id}"), DIST_PROCESSES, process_id,
        frozenset(port_gtf.get_mitochondrial_gene_names(gtf)), mesh=par.make_mesh(devices=[device]))
    report["tier1_s"], report["committed"] = time.perf_counter() - start, len(committed)
    par.sync_processes("parts-written")
    if process_id == 0:
        start = time.perf_counter()
        report["rows"] = par.merge_sorted_csv_parts(str(workdir / "metrics.part*.csv.gz"),
                                                    str(workdir / "merged.csv.gz"), expected_parts=len(chunks))
        report["merge_s"] = time.perf_counter() - start

    mesh = par.global_mesh(devices=[device])
    with np.load(workdir / "stacked.npz") as f:
        local = {name: f[name][mesh.local_shards] for name in f.files}
    start = time.perf_counter()
    batch = par.host_local_to_global(local, mesh)
    torch.cuda.synchronize(device)
    report["upload_s"] = time.perf_counter() - start
    report["wall_ms"], report["device_ms"] = [], []
    for _ in range(DIST_STEPS):
        par.collective.crossed.clear()
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            start = time.perf_counter()
            events[0].record()
            cell, gene = par.distributed_metrics_step(batch, mesh)
            events[1].record()
            events[1].synchronize()
        report["wall_ms"].append((time.perf_counter() - start) * 1e3)
        report["device_ms"].append(events[0].elapsed_time(events[1]))
    report["crossed"] = dict(par.collective.crossed)
    out = {}
    for kind, result in (("cell", cell), ("gene", gene)):
        for row, columns in par.addressable_to_host(result).items():
            out.update({f"{kind}/{row}/{name}": value for name, value in columns.items()})
    np.savez(workdir / f"out{process_id}.npz", **out)
    par.sync_processes("outputs-written")
    par.distributed.shutdown()
    report["launches_end"] = dict(kernels.launches)
    report["wall_s"] = time.perf_counter() - begin
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def phase_dist(stamp: str, modules) -> None:
    """Two processes joined into one mesh on the card: the chunk queue under
    the group with a rank-0 merge against phase 5's CSV, then the whole cell
    BAM's cross-process ``distributed_metrics_step`` against the in-process
    card mesh's, bit for bit."""
    import socket

    import torch

    kernels, port_par, port_gatherer, port_gtf, packed = modules
    phase_start = time.perf_counter()
    launches_before = dict(kernels.launches)
    workdir = WORK / "dist"
    workdir.mkdir()
    n_cards = torch.cuda.device_count()
    cards, want_transport = ((0, 1), "nccl") if n_cards >= DIST_PROCESSES else ((0, 0), "gloo")
    mito = str(WORK / "mito.gtf")
    start = time.perf_counter()
    frames = packed.iter_frames_from_bam(str(WORK / "cell_sorted.bam"), 2 * METRICS_BATCH, want_qname=False)
    frame = next(frames)
    frames.close()
    if frame.n_records != CELL_RECORDS:
        raise AssertionError(f"one frame of the cell BAM holds {frame.n_records} records, want {CELL_RECORDS}")
    names = port_gtf.get_mitochondrial_gene_names(mito)
    is_mito = np.asarray([name in names for name in frame.gene_names], dtype=bool)
    cols = port_gatherer._pad_columns(frame, is_mito)[0]
    stacked = port_par.partition_columns(cols, DIST_PROCESSES, key="cell", shard_size=METRICS_BATCH)
    np.savez(workdir / "stacked.npz", **stacked)
    log(f"[dist] phase 5's cell BAM ({frame.n_records} records) partitioned by cell into {DIST_PROCESSES} shards "
        f"of {METRICS_BATCH} ({', '.join(str(int(v.sum())) for v in stacked['valid'])} valid) in "
        f"{time.perf_counter() - start:.2f} s")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    begin = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), DIST_FLAG, str(workdir), str(p), coordinator, str(card), mito],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for p, card in enumerate(cards)]
    try:
        outputs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    workers_s = time.perf_counter() - begin
    reports = []
    for p, (proc, out) in enumerate(zip(procs, outputs)):
        lines = [line for line in out.splitlines() if line.startswith("[worker] ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"dist worker {p}: rc {proc.returncode}\n{out[-4000:]}")
        reports.append(json.loads(lines[0][len("[worker] "):]))
    for p, report in enumerate(reports):
        if report["transport"] != want_transport:
            raise AssertionError(f"worker {p} took {report['transport']}, want {want_transport} on {n_cards} card(s)")
        if any(report["launches_start"].values()) or any(report["launches_end"].values()):
            raise AssertionError(f"worker {p}: hand kernel launches {report['launches_start']} -> "
                                 f"{report['launches_end']}")
    if read_csv(workdir / "merged.csv.gz")[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
        raise AssertionError("tier 1: the rank-0 merge differs from phase 5's CalculateCellMetrics CSV")
    log(f"[dist] {stamp} | {DIST_PROCESSES} workers on {['cuda:%d' % c for c in cards]} over {want_transport} "
        f"({n_cards} card(s)) in {workers_s:.2f} s; tier 1: "
        + "; ".join(f"worker {p} init {r['init_s']:.2f} s, {r['committed']} chunks in {r['tier1_s']:.2f} s"
                    for p, r in enumerate(reports))
        + f"; rank 0 merged {reports[0]['rows']} rows in {reports[0]['merge_s']:.2f} s, equal to phase 5's "
        f"CalculateCellMetrics CSV byte for byte (decompressed)")

    card = torch.device("cuda", 0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    want = [port_par.stack_to_host(result) for result in
            port_par.distributed_metrics_step(stacked, port_par.make_mesh(devices=[card, card]))]
    reference_s = time.perf_counter() - start
    for p in range(DIST_PROCESSES):
        with np.load(workdir / f"out{p}.npz") as got:
            for kind, result in zip(("cell", "gene"), want):
                same_sharded(f"worker {p} {kind}", {name: got[f"{kind}/{p}/{name}"] for name in result},
                             {name: value[p] for name, value in result.items()})
    for p, r in enumerate(reports):
        log(f"[dist] {stamp} | worker {p} on cuda:{cards[p]}: distributed_metrics_step on the global mesh, "
            f"{METRICS_BATCH} records a shard: wall {', '.join(f'{t:.3f}' for t in r['wall_ms'])} ms, device "
            f"(CUDA events) {', '.join(f'{t:.3f}' for t in r['device_ms'])} ms ({DIST_STEPS} runs, the first "
            f"cold); bytes sent across the process boundary a step: {r['crossed']}; upload {r['upload_s']:.2f} s; "
            f"hand kernel launches 0 at its start and its end; {r['wall_s']:.2f} s in all")
    log(f"[dist] every per-shard cell and gene output equals the in-process [cuda:0, cuda:0] step's bit for bit "
        f"(that step {reference_s:.2f} s with its pull)")
    if dict(kernels.launches) != launches_before:
        raise AssertionError(f"a hand kernel launched in the dist phase: {kernels.launches}")
    for path in WORK.iterdir():
        if path.name not in KEPT_FOR_ANALYSIS:
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    log(f"[dist] phase 12 took {time.perf_counter() - phase_start:.1f} s")


# phase 10's chunks, phase 5's GTF and one-shot CSV: the witnessed sched
# worker's inputs and its reference
KEPT_FOR_ANALYSIS = ("mito.gtf", "cli_cell.csv.gz", "chunks")
ANALYSIS_FLAG = "--analysis-worker"
ANALYSIS_READS = 2 * BATCH  # the witnessed attach: two kernel batches
# the witness's and the frame witness's variables, set on the witnessed
# worker only
WITNESS_VARS = ("SCTOOLS_TPU_LOCK_DEBUG", "SCTOOLS_TPU_LOCK_GRAPH", "SCTOOLS_TPU_FRAME_DEBUG",
                "SCTOOLS_TPU_TRACE", "SCTOOLS_TPU_TRACE_WORKER")


def analysis_worker(argv) -> int:
    """One worker of phase 13, in its own process, witnessed or not as its
    environment says: attach -w on ``<workdir>``'s inputs into
    ``<workdir>/<tag>.bam``, then one sched worker draining
    ``<work>/chunks`` into ``<workdir>/<tag>/``, on cuda. Prints one
    ``[worker] {json}`` line: each stage's seconds and the hand kernel
    launches, each counted from 0 at the stage's start, and the frame
    witness's stamped frames and violations."""
    workdir, tag = Path(argv[0]), argv[1]
    import torch

    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.analysis import witness
    from sctools_tpu_torch.ingest import framedebug
    from sctools_tpu_torch.parallel import launch

    report = {"witness": witness.enabled(), "frame_debug": framedebug.enabled()}
    kernels.reset_launches()  # this slice's path: the witnessed attach
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = port_platform.TenXV2.attach_barcodes(attach_args(workdir, workdir / f"{tag}.bam"))
    torch.cuda.synchronize()
    report["attach"] = {"rc": rc, "seconds": time.perf_counter() - start, "launches": dict(kernels.launches)}
    kernels.reset_launches()
    start = time.perf_counter()
    committed = launch.run_process_cell_metrics(
        sorted(str(p) for p in (WORK / "chunks").glob("*.bam")), str(workdir / tag / "proc0"), 1, 0,
        frozenset(port_gtf.get_mitochondrial_gene_names(str(WORK / "mito.gtf"))), lease_ttl=SCHED_TTL,
        backoff_base=0.1,
    )
    torch.cuda.synchronize()
    report["sched"] = {"committed": len(committed), "seconds": time.perf_counter() - start,
                       "launches": dict(kernels.launches)}
    report["stamped"] = framedebug.stamped_count()
    report["frame_violations"] = framedebug.violations()
    print("[worker] " + json.dumps(report), flush=True)
    return 0


def phase_analysis(rng, whitelist_ascii, stamp: str, modules) -> int:
    """The port's static checks on this machine, then attach and a sched
    worker under the runtime lock witness and the frame witness, each
    against the same run unwitnessed; every lock dump against the static
    lock graph. Returns the witnessed attach's kernel launches."""
    import os

    kernels, port_launch, bgzf = modules
    phase_start = time.perf_counter()
    workdir = WORK / "analysis"
    trace = workdir / "trace"
    trace.mkdir(parents=True)
    graph_path = workdir / "lock-graph.json"
    env = {k: v for k, v in os.environ.items() if k not in WITNESS_VARS}
    env["SCTOOLS_TPU_SCX_CACHE"] = "0"  # no parse store left in the checkout

    # (a) the passes, as a user runs them
    start = time.perf_counter()
    gate = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "sctools_tpu_torch", "chip_smoke.py",
                           "--json"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    passes_s = time.perf_counter() - start
    if gate.returncode != 0:
        raise AssertionError(f"the static checks: rc {gate.returncode}\n{gate.stdout[-4000:]}{gate.stderr[-2000:]}")
    result = json.loads(gate.stdout)
    if result["findings"]:
        raise AssertionError(f"the static checks found {result['findings']}")
    start = time.perf_counter()
    emitted = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", "--emit-lock-graph",
                              str(graph_path), "sctools_tpu_torch"],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    graph_s = time.perf_counter() - start
    if emitted.returncode != 0:
        raise AssertionError(f"--emit-lock-graph: rc {emitted.returncode}\n{emitted.stdout}{emitted.stderr}")
    graph = json.loads(graph_path.read_text())
    static_edges = {(e["from"], e["to"]) for e in graph["edges"]}
    log(f"[analysis] {stamp} | python -m sctools_tpu_torch.analysis sctools_tpu_torch chip_smoke.py --json: "
        f"exit 0, {len(result['findings'])} findings over {result['checked_files']} files in {passes_s:.2f} s "
        f"(lint, abi, race, life; no parse store); --emit-lock-graph in {graph_s:.2f} s: "
        f"{len(graph['locks'])} locks {sorted(graph['locks'])}, {len(graph['edges'])} order edges, "
        f"{len(graph['entries'])} entries {[e['site'] for e in graph['entries']]}")

    # (b) + (c) the workers, unwitnessed then witnessed
    start = time.perf_counter()
    write_attach_inputs(rng, whitelist_ascii, ANALYSIS_READS, bgzf, workdir)
    log(f"[analysis] attach inputs: {ANALYSIS_READS} reads, whitelist {whitelist_ascii.shape[0]} x {CB_LEN}, "
        f"made in {time.perf_counter() - start:.1f} s")
    witnessed_env = dict(env, SCTOOLS_TPU_LOCK_DEBUG="1", SCTOOLS_TPU_LOCK_GRAPH=str(graph_path),
                         SCTOOLS_TPU_FRAME_DEBUG="1", SCTOOLS_TPU_TRACE=str(trace),
                         SCTOOLS_TPU_TRACE_WORKER="witnessed")
    reports, walls = {}, {}
    for tag, worker_env in (("plain", env), ("witnessed", witnessed_env)):
        begin = time.perf_counter()
        proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), ANALYSIS_FLAG, str(workdir), tag],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=worker_env)
        try:
            out = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        walls[tag] = time.perf_counter() - begin
        lines = [line for line in out.splitlines() if line.startswith("[worker] ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"{tag} worker: rc {proc.returncode}\n{out[-4000:]}")
        reports[tag] = json.loads(lines[0][len("[worker] "):])
    batches = -(-ANALYSIS_READS // BATCH)
    n_chunks = len(list((WORK / "chunks").glob("*.bam")))
    for tag, report in reports.items():
        if report["witness"] != (tag == "witnessed") or report["frame_debug"] != (tag == "witnessed"):
            raise AssertionError(f"{tag} worker: witness {report['witness']}, frame witness {report['frame_debug']}")
        if report["attach"]["rc"] != 0 or report["attach"]["launches"] != {"whitelist_correct": batches}:
            raise AssertionError(f"{tag} attach: rc {report['attach']['rc']}, launches {report['attach']['launches']}, "
                                 f"want {batches} (one a batch)")
        if any(report["sched"]["launches"].values()):
            raise AssertionError(f"{tag} sched worker launched a hand kernel: {report['sched']['launches']}")
        if report["sched"]["committed"] != n_chunks:
            raise AssertionError(f"{tag} sched worker committed {report['sched']['committed']} of {n_chunks} chunks")
        merged = workdir / tag / "merged.csv.gz"
        port_launch.merge_sorted_csv_parts(str(workdir / tag / "metrics.part*.csv.gz"), str(merged),
                                           journal_dir=str(workdir / tag / "sched-journal"), expected_parts=n_chunks)
        if read_csv(merged)[0] != read_csv(WORK / "cli_cell.csv.gz")[0]:
            raise AssertionError(f"{tag} sched worker: the merged CSV differs from phase 5's CalculateCellMetrics CSV")
    if (workdir / "witnessed.bam").read_bytes() != (workdir / "plain.bam").read_bytes():
        raise AssertionError("the witnessed attach's BAM differs from the unwitnessed one's")
    witnessed = reports["witnessed"]
    if witnessed["frame_violations"] or not witnessed["stamped"]:
        raise AssertionError(f"frame witness: {witnessed['stamped']} frames stamped, violations "
                             f"{witnessed['frame_violations']}")

    # (d) the dump: the witnessed worker's, at its exit
    dumps = sorted(path.name for path in trace.glob("locks.*.json"))
    if dumps != ["locks.witnessed.json"]:
        raise AssertionError(f"lock dumps: {dumps}")
    dump = json.loads((trace / "locks.witnessed.json").read_text())
    if not dump["enabled"] or dump["violations"] or dump["static_graph"] != str(graph_path):
        raise AssertionError(f"lock dump: enabled {dump['enabled']}, static graph {dump['static_graph']}, "
                             f"violations {dump['violations']}")
    blocking = {(e["from"], e["to"]) for e in dump["edges"] if not e["bounded"]}
    if not blocking <= static_edges:
        raise AssertionError(f"observed edges {sorted(blocking - static_edges)} are not in the static graph")
    missing = set(graph["locks"]) - set(dump["acquires"])
    if missing:
        raise AssertionError(f"locks never acquired under the witness: {sorted(missing)}")
    log(f"[analysis] {stamp} | witnessed worker (SCTOOLS_TPU_LOCK_DEBUG=1 with the static graph, "
        f"SCTOOLS_TPU_FRAME_DEBUG=1): attach of {ANALYSIS_READS} reads {witnessed['attach']['seconds']:.2f} s "
        f"(unwitnessed {reports['plain']['attach']['seconds']:.2f} s), {witnessed['attach']['launches']} "
        f"launches = {batches} batches, BAM equal to the unwitnessed one's byte for byte; one sched worker "
        f"drained {witnessed['sched']['committed']} chunks in {witnessed['sched']['seconds']:.2f} s (unwitnessed "
        f"{reports['plain']['sched']['seconds']:.2f} s), merged CSV equal to phase 5's byte for byte "
        f"(decompressed), both runs; process walls: unwitnessed {walls['plain']:.2f} s, then witnessed "
        f"{walls['witnessed']:.2f} s")
    edges = [(e["from"], e["to"], "bounded" if e["bounded"] else "blocking") for e in dump["edges"]]
    log(f"[analysis] {stamp} | locks.witnessed.json: 0 violations; acquisitions {dict(sorted(dump['acquires'].items()))}; "
        f"observed edges {edges or 'none'} (every blocking one in the static graph); {witnessed['stamped']} frames "
        f"stamped, 0 stale reads")
    shutil.rmtree(WORK)
    log(f"[analysis] phase 13 took {time.perf_counter() - phase_start:.1f} s")
    return witnessed["attach"]["launches"]["whitelist_correct"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reads", type=int, default=4 * BATCH)
    args = parser.parse_args(argv)

    import torch

    smoke_start = time.perf_counter()
    sms, clock_hz = phase_device()
    stamp = nvidia_smi("name,power.limit")
    if not (REPO / "sctools_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no sctools_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import count as port_count
    from sctools_tpu_torch import fastqprocess as port_fqp
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels, native
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch import bam as port_bam
    from sctools_tpu_torch import samplefastq as port_sample
    from sctools_tpu_torch.io import bgzf, packed, sam
    from sctools_tpu_torch.metrics import device as port_device
    from sctools_tpu_torch.metrics import gatherer as port_gatherer
    from sctools_tpu_torch.metrics import merge as port_merge
    from sctools_tpu_torch.ops import counting as port_counting
    from sctools_tpu_torch.ops import segments as port_seg
    from sctools_tpu_torch.ops import whitelist as wl_ops
    from sctools_tpu_torch import parallel as port_par
    from sctools_tpu_torch.parallel import gatherer as port_par_gatherer
    from sctools_tpu_torch.parallel import launch as port_launch
    from sctools_tpu_torch import sched as port_sched
    from sctools_tpu_torch.metrics import collective as port_collective
    from sctools_tpu_torch.serve import graphs as port_graphs

    phase_build(kernels, native)
    rng = np.random.default_rng(args.seed)
    whitelist_ascii = make_whitelist(rng, WHITELIST_SIZE, CB_LEN)
    table, measured = phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops)
    launches = phase_attach(
        rng, whitelist_ascii, args.reads, table, measured["ms"], stamp,
        (kernels, native, wl_ops, port_platform, bgzf, sam),
    )
    csvs = phase_metrics(
        np.random.default_rng(args.seed + 1), stamp,
        (kernels, native, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf, packed),
    )
    phase_count(
        np.random.default_rng(args.seed + 2), stamp,
        (kernels, native, port_platform, port_count, port_counting, port_merge, port_gtf, bgzf, packed), csvs,
    )
    fastq_launches, bam_shards = phase_fastq(
        np.random.default_rng(args.seed + 3), whitelist_ascii, table, stamp,
        (kernels, native, wl_ops, port_platform, port_fqp, port_sample, bgzf, sam),
    )
    phase_sort(
        np.random.default_rng(args.seed + 4), stamp,
        (kernels, native, port_platform, port_bam, bgzf, sam), bam_shards,
    )
    phase_mesh(stamp, (kernels, port_platform, port_par, port_par_gatherer, port_gatherer, port_gtf, packed))
    phase_sched(stamp, (port_platform, port_sched, port_launch, port_collective))
    phase_serve(np.random.default_rng(args.seed + 5), stamp,
                (port_platform, port_sched, port_launch, port_gatherer, port_device, port_seg, port_graphs, packed,
                 bgzf))
    phase_dist(stamp, (kernels, port_par, port_gatherer, port_gtf, packed))
    analysis_launches = phase_analysis(np.random.default_rng(args.seed + 6), whitelist_ascii, stamp,
                                       (kernels, port_launch, bgzf))
    record = {
        "name": "whitelist_correct",
        "route": "cuda",
        "source": "sctools_tpu_torch/csrc/whitelist_correct.cu",
        "replaces": "sctools_tpu/ops/whitelist.py:125",
        # every main-path run of the smoke: attach, FastqProcess in both
        # formats, SampleFastq and the analysis phase's witnessed attach (the
        # metrics, count, sort, mesh, sched, serve and dist paths launch none)
        "launches": launches["whitelist_correct"] + fastq_launches + analysis_launches,
        "verdict": "exact",
        **measured,
    }
    log(f"[smoke] phases 1-13 took {time.perf_counter() - smoke_start:.1f} s")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER_FLAG]:  # one of phase 10's worker processes
        sys.exit(sched_worker(sys.argv[2:]))
    if sys.argv[1:2] == [SERVE_FLAG]:  # one of phase 11's worker processes
        sys.exit(serve_worker(sys.argv[2:]))
    if sys.argv[1:2] == [DIST_FLAG]:  # one of phase 12's worker processes
        sys.exit(dist_worker(sys.argv[2:]))
    if sys.argv[1:2] == [ANALYSIS_FLAG]:  # one of phase 13's worker processes
        sys.exit(analysis_worker(sys.argv[2:]))
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as error:  # any failed phase: report it, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {error}", file=sys.stderr)
        sys.exit(1)
