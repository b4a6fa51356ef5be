#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``sctools_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--seed N] [--reads N]

Phases, in order; any failure exits non-zero before the last line:

1. device  -- requires ``torch.cuda.is_available()``; prints the card's name
              and power limit as nvidia-smi gives them, and the versions;
2. build   -- compiles every kernel of ``sctools_tpu_torch/csrc`` with nvcc
              and prints the seconds;
3. kernel  -- the whitelist kernel against its plain torch version, exactly,
              at the 10x v2 shape (65,536 queries x a 737,280-barcode
              synthetic whitelist) and on edge cases; times the kernel, the
              plain version and two library score products alone (cuBLAS
              float32, and torch._int_mm on the int8 one-hot tables);
4. attach  -- ``TenXV2.attach_barcodes`` through the port's argparse entry
              on 262,144 synthetic reads (4 batches of 65,536) with the
              737,280-barcode whitelist; every record's tags are re-read and
              checked, CB against the plain version's answer for its CR;
5. metrics -- ``GenericPlatform.calculate_cell_metrics`` and
              ``calculate_gene_metrics`` on the card at the gatherer's
              2^20-record batch width: a synthetic 10x v2 library on GRCh38's
              25 primary sequences, 1,250,000 records sorted by (CB, UB, GE)
              and 1,150,000 of them by (GE, CB, UB), each one full batch, a
              remainder and a carried tail; the CSVs of the commands, of the
              same frames on the card and of the same frames on the CPU must
              be equal byte for byte (decompressed), and per cell n_reads,
              n_molecules, n_genes and n_mitochondrial_molecules must equal
              the generator's counts. Prints records/s, the wall split, device
              milliseconds per batch and the profiler's top device ops. The
              metrics path has no hand kernel; the phase checks that none
              launched;
6. kernels -- one JSON line per the port's kernel contract.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The whitelist and the metrics library are synthetic, made from ``--seed``;
the whitelist has the size and length of Cell Ranger's
737K-august-2016.txt. Work files go to ``.chip_smoke_work/`` in the
checkout and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
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
    """The reads as raw BAM records (tags CB CR CY UB UR UY [GE] [XF] [NH]),
    built with numpy one layout group at a time, BGZF level 1."""
    n = len(reads["cell"])
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
    layout = np.stack([n_cigar, ge_len, reads["xf"], reads["nh"] > 0], axis=1)
    groups, group_of = np.unique(layout, axis=0, return_inverse=True)
    for g, (cig, glen, xf_code, has_nh) in enumerate(groups):
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
            np.frombuffer(b"".join(b"r%09d\0" % i for i in idx), np.uint8).reshape(m, 11),
            np.broadcast_to(_u8(np.array(cigar, np.uint32), "<u4").ravel(), (m, 4 * int(cig))),
            packed[idx], qual_q[idx],
            _z_tag(b"CB", reads["cb"][idx]), _z_tag(b"CR", reads["cr"][idx]),
            _z_tag(b"CY", qual_q[idx, :CB_LEN] + 33),
            _z_tag(b"UB", reads["ub"][idx]), _z_tag(b"UR", reads["ur"][idx]),
            _z_tag(b"UY", qual_q[idx, CB_LEN : CB_LEN + UMI_LEN] + 33),
        ]
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


def phase_build(kernels):
    start = time.perf_counter()
    for name in kernels.launches:
        kernels.library(name)
    seconds = time.perf_counter() - start
    for name, output in kernels.build_output.items():
        for line in output.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(kernels.launches)} kernel(s) built and loaded in {seconds:.2f} s")


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
    table = wl_ops.make_table(torch.from_numpy(wl_ops.barcode_codes(
        as_bytes(wl_ascii, np.full(len(wl_ascii), length)), length)).to(device))
    q = torch.from_numpy(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), length)).to(device)
    got, plain = wl_ops.correct_codes(q, table), wl_ops.correct_plain(q, table)
    torch.cuda.synchronize()
    return got, plain


def phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops):
    import torch

    device = torch.device("cuda")
    table = wl_ops.make_table(
        torch.from_numpy(wl_ops.barcode_codes(as_bytes(whitelist_ascii, np.full(len(whitelist_ascii), CB_LEN)), CB_LEN)).to(device)
    )
    q_ascii, q_len, _ = make_queries(rng, whitelist_ascii, BATCH)
    queries = torch.from_numpy(wl_ops.barcode_codes(as_bytes(q_ascii, q_len), CB_LEN)).to(device)

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


def phase_attach(rng, whitelist_ascii, n_reads, table, kernel_ms, modules):
    import torch

    kernels, wl_ops, port_platform, bgzf, sam = modules
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    start = time.perf_counter()
    wl_path = WORK / "whitelist.txt"
    newline = np.full((whitelist_ascii.shape[0], 1), ord("\n"), dtype=np.uint8)
    wl_path.write_bytes(np.concatenate([whitelist_ascii, newline], axis=1).tobytes())

    cb_ascii, cb_len, kinds = make_queries(rng, whitelist_ascii, n_reads)
    tail = LETTERS[rng.integers(0, 4, size=(n_reads, R1_LEN - CB_LEN))]
    r1_ascii = np.concatenate([cb_ascii, tail], axis=1)
    r1_len = np.where(cb_len < CB_LEN, cb_len, R1_LEN)  # a short barcode is a short read
    r1_seq = as_bytes(r1_ascii, r1_len)
    r1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, R1_LEN), dtype=np.uint8), r1_len)
    i1_seq = as_bytes(LETTERS[rng.integers(0, 4, size=(n_reads, SAMPLE_LEN))], np.full(n_reads, SAMPLE_LEN))
    i1_qual = as_bytes(rng.integers(35, 75, size=(n_reads, SAMPLE_LEN), dtype=np.uint8), np.full(n_reads, SAMPLE_LEN))
    write_fastq_gz(WORK / "r1.fastq.gz", r1_seq, r1_qual)
    write_fastq_gz(WORK / "i1.fastq.gz", i1_seq, i1_qual)
    u2_bodies = write_u2(WORK / "u2.bam", rng, n_reads, bgzf)
    log(f"[attach] inputs: {n_reads} reads (R1 {R1_LEN} bp gz, I1 {SAMPLE_LEN} bp gz, "
        f"u2 {R2_LEN} bp BAM), whitelist {whitelist_ascii.shape[0]} x {CB_LEN}, "
        f"made in {time.perf_counter() - start:.1f} s")

    output = WORK / "tagged.bam"
    args = ["--r1", str(WORK / "r1.fastq.gz"), "--u2", str(WORK / "u2.bam"),
            "--i1", str(WORK / "i1.fastq.gz"), "-o", str(output), "-w", str(wl_path)]
    stderr = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launches()  # the main path's run starts here
    start = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = port_platform.TenXV2.attach_barcodes(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launches)  # ... and ends here
    if rc != 0:
        raise AssertionError(f"attach returned {rc}")
    batches = -(-n_reads // BATCH)
    if launches["whitelist_correct"] != batches:
        raise AssertionError(f"{launches['whitelist_correct']} kernel launches, want {batches}")
    summary = stderr.getvalue()
    log(f"[attach] {n_reads} reads in {seconds:.2f} s = {n_reads / seconds:.0f} reads/s, "
        f"{batches} batches, {launches['whitelist_correct']} kernel launches")
    for line in summary.strip().splitlines():
        log(f"[attach] {line.strip()}")

    # expected CB: the plain version, beside the table, for every CR
    cr = [s[:CB_LEN] for s in r1_seq]
    expected = []
    for lo in range(0, n_reads, BATCH):
        q = torch.from_numpy(wl_ops.barcode_codes(cr[lo : lo + BATCH], CB_LEN)).to(table.codes.device)
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
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        port_platform.TenXV2.attach_barcodes(args[:-2])
    plain_seconds = time.perf_counter() - start
    log(f"[attach] without -w: {n_reads} reads in {plain_seconds:.2f} s = "
        f"{n_reads / plain_seconds:.0f} reads/s; correction adds "
        f"{seconds - plain_seconds:.2f} s, of which the kernel "
        f"~{launches['whitelist_correct'] * kernel_ms / 1e3:.3f} s (launches x kernel ms)")
    shutil.rmtree(WORK)
    return launches


def decode_frames(path: str) -> list:
    """The port's decode of ``path`` into frames of METRICS_BATCH records.

    Runs in a spawned worker process once the timed commands are done: it
    imports the port's host I/O only (no torch, no CUDA)."""
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch.io.packed import iter_frames_from_bam

    return list(iter_frames_from_bam(path, METRICS_BATCH))


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
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf = modules
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
        begin = time.perf_counter()
        # the device-side profile (no host ops) gives the command's busy time
        with recording(port_platform, cls_name[axis], made), profile(
            activities=[ProfilerActivity.CUDA]
        ) as prof:
            getattr(port_platform.GenericPlatform, entry[axis])(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        busy_ms = device_busy_ms(prof)
        gatherer = made[0]
        device_ms = gatherer.device_ms()
        split = gatherer.seconds
        other = wall - sum(split.values())
        n = len(axes[axis]["cell"])
        log(f"[metrics] {stamp} | {entry[axis]} on cuda: {n} records in {wall:.2f} s = "
            f"{n / wall:.0f} records/s; decode {split['decode']:.2f} s, pack "
            f"{split['pack']:.2f} s, upload+enqueue {split['dispatch']:.2f} s, waiting on "
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

    # the frames for the cuda/cpu comparison, both axes decoded at once in
    # two worker processes
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        decoded = {axis: pool.submit(decode_frames, str(path)) for axis, path in paths.items()}
        frames = {axis: future.result() for axis, future in decoded.items()}

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
        staged = {name: torch.from_numpy(array).to(gatherer._device) for name, array in cols.items()}
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
    shutil.rmtree(WORK)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reads", type=int, default=4 * BATCH)
    args = parser.parse_args(argv)

    import torch

    sms, clock_hz = phase_device()
    stamp = nvidia_smi("name,power.limit")
    if not (REPO / "sctools_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no sctools_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import gtf as port_gtf
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.io import bgzf, sam
    from sctools_tpu_torch.metrics import device as port_device
    from sctools_tpu_torch.metrics import gatherer as port_gatherer
    from sctools_tpu_torch.ops import segments as port_seg
    from sctools_tpu_torch.ops import whitelist as wl_ops

    phase_build(kernels)
    rng = np.random.default_rng(args.seed)
    whitelist_ascii = make_whitelist(rng, WHITELIST_SIZE, CB_LEN)
    table, measured = phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops)
    launches = phase_attach(
        rng, whitelist_ascii, args.reads, table, measured["ms"],
        (kernels, wl_ops, port_platform, bgzf, sam),
    )
    phase_metrics(
        np.random.default_rng(args.seed + 1), stamp,
        (kernels, port_platform, port_gatherer, port_device, port_gtf, port_seg, bgzf),
    )
    record = {
        "name": "whitelist_correct",
        "route": "cuda",
        "source": "sctools_tpu_torch/csrc/whitelist_correct.cu",
        "replaces": "sctools_tpu/ops/whitelist.py:125",
        "launches": launches["whitelist_correct"],
        "verdict": "exact",
        **measured,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as error:  # any failed phase: report it, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {error}", file=sys.stderr)
        sys.exit(1)
