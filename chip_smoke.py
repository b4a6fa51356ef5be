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
              plain version and the cuBLAS score product alone;
4. attach  -- ``TenXV2.attach_barcodes`` through the port's argparse entry
              on 262,144 synthetic reads (4 batches of 65,536) with the
              737,280-barcode whitelist; every record's tags are re-read and
              checked, CB against the plain version's answer for its CR;
5. kernels -- one JSON line per the port's kernel contract.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The whitelist is synthetic, of the size and length of Cell Ranger's
737K-august-2016.txt, made from ``--seed``. Work files go to
``.chip_smoke_work/`` in the checkout and are removed at the end.
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


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` over ``repeats`` timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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

    Counted from the function, not from this kernel's design: the TPU
    kernel's one-hot score product, [n_q, 4L] x [4L, n_w], whose 0/1 values
    are exact in int8, at the published int8 tensor-core peak (two
    operations per multiply-add); the threshold and the max run beside it
    and are not counted. Bytes: the query codes and the packed table read
    once, the int32 indices written once.
    """
    ops_s = 2.0 * n_q * n_w * 4 * length / INT8_TENSOR_OPS_PER_S
    words = -(-length // 16)
    bytes_s = (n_q * length + n_w * 8 * words + n_q * 4) / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


def int32_issue_floor_ms(n_q: int, n_w: int, length: int, sms: int, clock_hz: float) -> float:
    """The floor of this kernel's own design: its instruction mix at issue rate.

    Per pair and per 16-base word, an xor, a shift and two 3-input logic ops
    (LOP3) make the mismatch mask and one POPC counts it; per pair a compare
    and a select keep the best index, and an add per extra word sums the
    counts. INT32 ops issue at 64 and POPC at 16 per clock per SM. Not the
    function's bound: a tensor-core formulation needs fewer cycles.
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

    # edge cases: L = 1 and 14, duplicates, N in the whitelist, ragged sizes
    edge_rng = np.random.default_rng(7)
    edges = ((1, 5, 3001), (14, 5003, 3001), (16, 2049, 257), (17, 1025, 999), (33, 777, 555),
             (49, 1031, 611), (64, 1537, 700))
    for length, n_w, n_q in edges:
        wl = make_whitelist(edge_rng, n_w, length)
        wl[3, 0] = ord("N")
        wl[-1] = wl[1]  # duplicate: the last copy wins
        qa, ql, _ = make_queries(edge_rng, wl, n_q)
        qa[:4], ql[:4] = wl[[1, 3, -1, 0]], length
        t = wl_ops.make_table(torch.from_numpy(wl_ops.barcode_codes(as_bytes(wl, np.full(n_w, length)), length)).to(device))
        q = torch.from_numpy(wl_ops.barcode_codes(as_bytes(qa, ql), length)).to(device)
        got_e, plain_e = wl_ops.correct_codes(q, t), wl_ops.correct_plain(q, t)
        torch.cuda.synchronize()
        check_exact(f"edge L={length} n_w={n_w} n_q={n_q}", got_e, plain_e)
        if length > 1 and got_e[0].item() != n_w - 1:
            raise AssertionError(f"duplicate entry: got {got_e[0].item()}, want the last ({n_w - 1})")
    log(f"[kernel] edge cases exact: L={', '.join(str(e[0]) for e in edges)}; duplicates; "
        "N in whitelist; ragged n_q/n_w")

    ms = cuda_ms(lambda: wl_ops.correct_codes(queries, table), repeats=15)
    plain_ms = cuda_ms(lambda: wl_ops.correct_plain(queries, table), repeats=3, warmup=1)
    # yardstick only: cuBLAS one-hot score product, chunked like the plain
    # version (the full [65,536 x 737,280] f32 matrix would be 193 GB)
    q_onehot = wl_ops.onehot_codes(queries)
    w_onehot = wl_ops.onehot_codes(table.codes)
    chunk = wl_ops.PLAIN_CHUNK
    scores = torch.empty((BATCH, chunk), dtype=torch.float32, device=device)

    def score_product():
        for start in range(0, w_onehot.shape[0], chunk):
            w = w_onehot[start : start + chunk]
            torch.matmul(q_onehot, w.T, out=scores[:, : w.shape[0]])

    library_ms = cuda_ms(score_product, repeats=3, warmup=1)
    del scores, q_onehot, w_onehot
    n_w = table.codes.shape[0]
    bound_ms, bound_by = kernel_bound_ms(BATCH, n_w, CB_LEN)
    floor_ms = int32_issue_floor_ms(BATCH, n_w, CB_LEN, sms, clock_hz)
    log(f"[kernel] per {BATCH}-query batch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: int8 tensor-core one-hot product at the "
        f"published peak), this design's INT32 issue floor {floor_ms:.3f} ms, "
        f"cuBLAS score product only {library_ms:.3f} ms")
    return table, dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                       int32_issue_floor_ms=floor_ms)


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reads", type=int, default=4 * BATCH)
    args = parser.parse_args(argv)

    import torch

    sms, clock_hz = phase_device()
    if not (REPO / "sctools_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no sctools_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    from sctools_tpu_torch import kernels
    from sctools_tpu_torch import platform as port_platform
    from sctools_tpu_torch.io import bgzf, sam
    from sctools_tpu_torch.ops import whitelist as wl_ops

    phase_build(kernels)
    rng = np.random.default_rng(args.seed)
    whitelist_ascii = make_whitelist(rng, WHITELIST_SIZE, CB_LEN)
    table, measured = phase_kernel(rng, whitelist_ascii, sms, clock_hz, wl_ops)
    launches = phase_attach(
        rng, whitelist_ascii, args.reads, table, measured["ms"],
        (kernels, wl_ops, port_platform, bgzf, sam),
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
