"""FASTQ triplets -> N disjoint-barcode shards: the port of FastqProcess.

The port of the JAX package's ``fastqprocess_native``
(sctools_tpu/native/__init__.py:928-1053) with its C++ loop
(native/fastqprocess.cpp), in Python over the port's own FASTQ and BGZF code:

- R1[i], R2[i] and I1[i] are read as one triplet at a time, in step; the
  errors ``r1 fastq ended before r2``, ``r2 fastq ended before r1`` and
  ``i1 fastq ended before r1`` are the native loop's (:274-319), and a
  longer I1 is ignored;
- CR/CY and UR/UY are sliced from R1, SR/SY from I1 (only when I1 files
  are given, :316-325, :422-429), each cut at its first NUL byte, as the
  native layer's fixed-width buffers give them back (:362-376);
- the stream is cut into batches of 65,536 reads; with a whitelist each
  batch's CR go to ``WhitelistCorrector.submit``: one upload, one kernel
  launch, one pull. The host reads and slices batch k+1 while batch k is
  on the device, as ``attach`` does;
- each read goes to shard ``fnv1a(key) % n_shards``, the key being the
  corrected barcode, else the raw one (:392-396), so that a cell never
  spans shards; the hash runs over a whole batch in numpy ``uint64``;
- BAM shards get the native route's unaligned records (``bam_record``),
  FASTQ shards ``@name / CR+UR / + / CY+UY`` in R1 and the read in R2
  (:157-169, :398-410);
- stderr gets the progress line every 10M reads (:443-446) and, with a
  whitelist, the summary of ``__init__.py:1020-1030``;
- on any failure the shard files this run created are removed, unfinished.
"""

from __future__ import annotations

import os
import struct
import sys
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from . import consts
from .device import DeviceLike, resolve
from .fastq import BatchReader, Spans, extract_spans, span_len
from .io import bgzf
from .io.sam import z_tags
from .ops.whitelist import PendingCorrection, WhitelistCorrector, correction_summary

BATCH_SIZE = 1 << 16
PROGRESS_EVERY = 10_000_000  # the reference's cadence (fastq_common.cpp:340)
MAX_NAME = 254  # l_read_name is one byte and counts the name's NUL

FNV_OFFSET = np.uint64(1469598103934665603)
FNV_PRIME = np.uint64(1099511628211)

# byte -> BAM 4-bit base code as fastqprocess.cpp:57-66 writes it: ACGT in
# either case 1/2/4/8, '=' 0, every other byte (IUPAC codes included) 15
_NIBBLE = bytearray([15]) * 256
for _base, _code in zip(b"ACGTacgt=", (1, 2, 4, 8, 1, 2, 4, 8, 0)):
    _NIBBLE[_base] = _code
_NIBBLE = bytes(_NIBBLE)
_PHRED = bytes((b - 33) & 0xFF for b in range(256))  # quality byte - 33, wrapped
del _base, _code

# refID, pos, l_read_name, mapq, bin, n_cigar, flag, l_seq, next refID,
# next pos, tlen (fastqprocess.cpp:129-145)
_RECORD_HEAD = struct.Struct("<iiBBHHHIiii")


def strip_nul(values: List[bytes]) -> List[bytes]:
    """Each value cut at its first NUL byte."""
    if b"\0" not in b"".join(values):
        return values
    return [value.partition(b"\0")[0] for value in values]


def shard_of(keys: np.ndarray, lengths: np.ndarray, n_shards: int) -> np.ndarray:
    """int64 shard per row: FNV-1a of the row's first ``lengths`` bytes, mod
    ``n_shards`` (fastqprocess.cpp:47-54).

    ``keys`` is ``[n, width]`` uint8. The hash runs column by column over
    all rows at once; a row stops changing past its own length. Array
    arithmetic in ``uint64`` wraps as the C++ does.
    """
    h = np.full(len(keys), FNV_OFFSET, dtype=np.uint64)
    for column in range(keys.shape[1]):
        stepped = (h ^ keys[:, column].astype(np.uint64)) * FNV_PRIME
        h = np.where(column < lengths, stepped, h)
    return (h % np.uint64(n_shards)).astype(np.int64)


def shard_paths(prefix: str, n_shards: int, output_format: str = "BAM") -> List[str]:
    """The shard files of a run: ``<prefix>_<i>.bam``, or per shard
    ``<prefix>_R1_<i>.fastq.gz`` then ``<prefix>_R2_<i>.fastq.gz``."""
    if output_format.upper() == "FASTQ":
        return [f"{prefix}_{r}_{i}.fastq.gz" for i in range(n_shards) for r in ("R1", "R2")]
    return [f"{prefix}_{i}.bam" for i in range(n_shards)]


def bam_header(sample_id: str) -> bytes:
    """The shards' unaligned BAM header, with no references
    (fastqprocess.cpp:116-125)."""
    text = f"@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:{sample_id}\n".encode()
    return b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", 0)


def bam_records(
    names: List[bytes], sequences: List[bytes], qualities: List[bytes]
) -> List[bytes]:
    """Each read's unaligned record without its block size and tags
    (``build_bam_record``, fastqprocess.cpp:129-155): flag 4, bin 4680,
    bases as ``_NIBBLE`` codes, a quality shorter than the sequence padded
    with '!', quality bytes ``q - 33`` wrapped to a byte.

    The bases of the whole batch are coded and packed two to a byte at once
    (an odd sequence is padded with '=', whose code is 0), the qualities
    translated at once, and each record cut from the two.
    """
    lengths = [len(s) for s in sequences]
    padded = b"".join(s + b"=" if len(s) % 2 else s for s in sequences)
    codes = np.frombuffer(padded.translate(_NIBBLE), dtype=np.uint8)
    packed = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    phred = b"".join(
        q if len(q) == k else q[:k].ljust(k, b"!") for q, k in zip(qualities, lengths)
    ).translate(_PHRED)
    records = []
    base = qual = 0
    for name, k in zip(names, lengths):
        half = (k + 1) // 2
        head = _RECORD_HEAD.pack(-1, -1, len(name) + 1, 0, 4680, 0, 4, k, -1, -1, 0)
        records.append(b"".join(
            (head, name, b"\0", packed[base : base + half], phred[qual : qual + k])))
        base += half
        qual += k
    return records


class _Reads(NamedTuple):
    """The records of a batch: R2's names, sequences and qualities, and the
    R1 and I1 lines that go with them."""

    names: List[bytes]
    sequences: List[bytes]
    qualities: List[bytes]
    r1_sequences: List[bytes]
    r1_qualities: List[bytes]
    i1_sequences: List[bytes]
    i1_qualities: List[bytes]


class _Batch(NamedTuple):
    reads: _Reads
    cr: List[bytes]
    cy: List[bytes]
    ur: List[bytes]
    uy: List[bytes]
    sr: List[bytes]
    sy: List[bytes]
    correction: Optional[PendingCorrection]


class _Triplet:
    """One R1/R2(/I1) triplet of files read in step (fastqprocess.cpp:274-319)."""

    def __init__(self, r1: str, r2: str, i1: Optional[str]):
        self.r1, self.r2 = BatchReader([r1]), BatchReader([r2])
        self.i1 = BatchReader([i1]) if i1 is not None else None

    def take(self, n: int):
        """Up to ``n`` triplets' lines and whether R1 is done; raises the
        native loop's error for the earliest read at fault."""
        _, r1_seqs, r1_quals = self.r1.take(n)
        count = len(r1_seqs)
        names, seqs, quals = self.r2.take(count)
        i1_seqs: List[bytes] = []
        i1_quals: List[bytes] = []
        if self.i1 is not None:
            _, i1_seqs, i1_quals = self.i1.take(count)
        # (read index, order within a read, message) of each fault
        faults = []
        if len(seqs) < count:
            faults.append((len(seqs), 0, "r2 fastq ended before r1"))
        if names and max(map(len, names)) > MAX_NAME:
            index = next(i for i, name in enumerate(names) if len(name) > MAX_NAME)
            faults.append((index, 1, "read name longer than 254 characters: "
                           + names[index].decode(errors="replace")))
        if self.i1 is not None and len(i1_seqs) < count:
            faults.append((len(i1_seqs), 2, "i1 fastq ended before r1"))
        done = count < n
        if not faults and done and self.r2.take(1)[1]:
            faults.append((count, 0, "r1 fastq ended before r2"))
        if faults:
            raise RuntimeError(f"fastqprocess read failed: {min(faults)[2]}")
        return _Reads(names, seqs, quals, r1_seqs, r1_quals, i1_seqs, i1_quals), done


class FastqProcess:
    """One FastqProcess run; ``run()`` writes the shards and returns the
    counters. ``seconds`` splits the wall time of ``run`` into reading and
    slicing the FASTQ (``read``), correction (``correct``: submit and the
    wait for the result) and building, compressing and writing the shards
    (``write``)."""

    def __init__(
        self,
        r1_files: Sequence[str],
        r2_files: Sequence[str],
        output_prefix: str,
        cb_spans: Spans,
        umi_spans: Spans,
        sample_spans: Optional[Spans] = None,
        i1_files: Optional[Sequence[str]] = None,
        whitelist: Optional[str] = None,
        n_shards: int = 1,
        output_format: str = "BAM",
        sample_id: str = "",
        batch_size: int = BATCH_SIZE,
        compress_level: int = 6,
        device: DeviceLike = None,
    ):
        self._device = resolve(device)
        self._r1s, self._r2s = list(r1_files), list(r2_files)
        self._i1s = list(i1_files or [])
        if not self._r1s or len(self._r1s) != len(self._r2s):
            raise RuntimeError("fastqprocess open failed: need equal non-empty R1/R2 path lists")
        if self._i1s and len(self._i1s) != len(self._r1s):
            raise RuntimeError(
                "fastqprocess open failed: I1 list must be empty or match R1 list length")
        if n_shards < 1:
            raise RuntimeError("fastqprocess open failed: n_shards must be >= 1")
        if output_format.upper() not in ("BAM", "FASTQ"):
            raise ValueError("output_format must be BAM or FASTQ")
        self._fastq_mode = output_format.upper() == "FASTQ"
        self._cb_spans, self._umi_spans = list(cb_spans or []), list(umi_spans or [])
        self._sample_spans = list(sample_spans or [])
        self._cb_len = span_len(self._cb_spans)
        self._umi_len = span_len(self._umi_spans)
        # I1 is read only for sample spans (fastqprocess.cpp:316)
        self._read_i1 = bool(self._i1s) and span_len(self._sample_spans) > 0
        self._corrector = None
        if whitelist is not None:
            self._corrector = WhitelistCorrector.from_file(whitelist, device=self._device)
            if self._cb_len != self._corrector.barcode_length:
                raise RuntimeError(
                    f"whitelist barcode length {self._corrector.barcode_length} does "
                    f"not match the cell barcode span length {self._cb_len}"
                )
            self._whitelist = np.frombuffer(
                "".join(self._corrector.whitelist).encode("latin-1"), dtype=np.uint8
            ).reshape(-1, self._cb_len)
        self._prefix = output_prefix
        self._n_shards = n_shards
        self._sample_id = sample_id
        self._batch_size = batch_size
        self._level = compress_level
        self._writers: List[bgzf.BgzfWriter] = []
        self._created: List[str] = []
        self.stats = {"total_reads": 0, "correct": 0, "corrected": 0, "uncorrectable": 0}
        self.seconds = {"read": 0.0, "correct": 0.0, "write": 0.0}

    def _open_outputs(self) -> None:
        fmt = "FASTQ" if self._fastq_mode else "BAM"
        for path in shard_paths(self._prefix, self._n_shards, fmt):
            try:
                writer = bgzf.BgzfWriter(path, level=self._level)
            except OSError as error:
                raise RuntimeError(
                    f"fastqprocess open failed: cannot open for write {path}") from error
            self._created.append(path)
            self._writers.append(writer)
            if not self._fastq_mode:
                writer.write(bam_header(self._sample_id))

    def _reads(self):
        """Batches of up to ``batch_size`` reads, across triplets."""
        parts: List[_Reads] = []
        filled = 0
        for t, (r1, r2) in enumerate(zip(self._r1s, self._r2s)):
            triplet = _Triplet(r1, r2, self._i1s[t] if self._read_i1 else None)
            done = False
            while not done:
                reads, done = triplet.take(self._batch_size - filled)
                if reads.names:
                    parts.append(reads)
                    filled += len(reads.names)
                if filled == self._batch_size:
                    yield _Reads(*(sum(columns, []) for columns in zip(*parts)))
                    parts, filled = [], 0
        if parts:
            yield _Reads(*(sum(columns, []) for columns in zip(*parts)))

    def _batches(self):
        """Read, slice and submit one batch at a time."""
        batches = self._reads()
        while True:
            start = time.perf_counter()
            reads = next(batches, None)
            if reads is None:
                return
            # a kind without spans slices empty values
            r1_seqs, r1_quals = reads.r1_sequences, reads.r1_qualities
            cr = strip_nul(extract_spans(r1_seqs, self._cb_spans))
            cy = strip_nul(extract_spans(r1_quals, self._cb_spans))
            ur = strip_nul(extract_spans(r1_seqs, self._umi_spans))
            uy = strip_nul(extract_spans(r1_quals, self._umi_spans))
            sr = sy = []
            if self._read_i1:
                sr = strip_nul(extract_spans(reads.i1_sequences, self._sample_spans))
                sy = strip_nul(extract_spans(reads.i1_qualities, self._sample_spans))
            middle = time.perf_counter()
            correction = None
            if self._corrector is not None:
                correction = self._corrector.submit(cr)
            self.seconds["read"] += middle - start
            self.seconds["correct"] += time.perf_counter() - middle
            yield _Batch(reads, cr, cy, ur, uy, sr, sy, correction)

    def _shards(self, batch: _Batch, indices: Optional[np.ndarray]):
        """(shard per read, corrected barcode per read or None), and the
        counters' update, from the whitelist indices (None: no whitelist)."""
        n = len(batch.reads.names)
        width = self._cb_len
        cr_lengths = np.fromiter(map(len, batch.cr), dtype=np.int64, count=n)
        joined = b"".join(c.ljust(width, b"\0") for c in batch.cr)
        keys = np.frombuffer(joined, dtype=np.uint8).reshape(n, width).copy()
        corrected: List[Optional[bytes]] = [None] * n
        if indices is not None:
            hit = indices >= 0
            rows = self._whitelist[indices[hit]]
            same = (cr_lengths[hit] == width) & (keys[hit] == rows).all(axis=1)
            self.stats["correct"] += int(same.sum())
            self.stats["corrected"] += int(hit.sum() - same.sum())
            self.stats["uncorrectable"] += int(n - hit.sum())
            keys[hit] = rows
            cr_lengths = np.where(hit, width, cr_lengths)
            row_bytes = rows.tobytes()
            for j, i in enumerate(np.flatnonzero(hit)):
                corrected[i] = row_bytes[j * width : (j + 1) * width]
        return shard_of(keys, cr_lengths, self._n_shards), corrected

    def _write(self, batch: _Batch) -> None:
        indices = None
        if batch.correction is not None:
            start = time.perf_counter()
            indices = batch.correction.indices()
            self.seconds["correct"] += time.perf_counter() - start
        start = time.perf_counter()
        shards, corrected = self._shards(batch, indices)
        reads = batch.reads
        n = len(reads.names)
        if self._fastq_mode:
            r1_chunks: List[List[bytes]] = [[] for _ in range(self._n_shards)]
            r2_chunks: List[List[bytes]] = [[] for _ in range(self._n_shards)]
            for i, shard in enumerate(shards.tolist()):
                name = reads.names[i]
                r1_chunks[shard].append(
                    b"@%s\n%s%s\n+\n%s%s\n" % (name, batch.cr[i], batch.ur[i], batch.cy[i], batch.uy[i]))
                r2_chunks[shard].append(
                    b"@%s\n%s\n+\n%s\n" % (name, reads.sequences[i], reads.qualities[i]))
            for shard in range(self._n_shards):
                self._writers[2 * shard].write(b"".join(r1_chunks[shard]))
                self._writers[2 * shard + 1].write(b"".join(r2_chunks[shard]))
        else:
            # tags in the native order (:412-429): CR CY [CB], UR UY, SR SY
            columns = []
            if self._cb_len:
                columns += [z_tags(consts.RAW_CELL_BARCODE_TAG_KEY, batch.cr),
                            z_tags(consts.QUALITY_CELL_BARCODE_TAG_KEY, batch.cy),
                            z_tags(consts.CELL_BARCODE_TAG_KEY, corrected)]
            if self._umi_len:
                columns += [z_tags(consts.RAW_MOLECULE_BARCODE_TAG_KEY, batch.ur),
                            z_tags(consts.QUALITY_MOLECULE_BARCODE_TAG_KEY, batch.uy)]
            if self._read_i1:
                columns += [z_tags(consts.RAW_SAMPLE_BARCODE_TAG_KEY, batch.sr),
                            z_tags(consts.QUALITY_SAMPLE_BARCODE_TAG_KEY, batch.sy)]
            columns.insert(0, bam_records(reads.names, reads.sequences, reads.qualities))
            chunks: List[List[bytes]] = [[] for _ in range(self._n_shards)]
            for shard, parts in zip(shards.tolist(), zip(*columns)):
                record = b"".join(parts)
                chunks[shard].append(struct.pack("<I", len(record)) + record)
            for shard in range(self._n_shards):
                self._writers[shard].write(b"".join(chunks[shard]))
        before = self.stats["total_reads"]
        self.stats["total_reads"] += n
        for count in range(before // PROGRESS_EVERY + 1, self.stats["total_reads"] // PROGRESS_EVERY + 1):
            print(f"[fastqprocess] {count * PROGRESS_EVERY} reads processed", file=sys.stderr)
        self.seconds["write"] += time.perf_counter() - start

    def run(self) -> dict:
        """Write the shards; returns the counters {total_reads, correct,
        corrected, uncorrectable}."""
        try:
            self._open_outputs()
            # one batch ahead: the loop reads and submits batch k+1 before
            # it waits for and writes batch k
            previous: Optional[_Batch] = None
            for batch in self._batches():
                if previous is not None:
                    self._write(previous)
                previous = batch
            if previous is not None:
                self._write(previous)
            start = time.perf_counter()
            for writer in self._writers:
                writer.close()
            self.seconds["write"] += time.perf_counter() - start
        except BaseException:
            # never leave partial shards that could read as complete
            for writer in self._writers:
                writer.abort()
            for path in self._created:
                try:
                    os.remove(path)
                except OSError:
                    pass
            raise
        if self._corrector is not None and self.stats["total_reads"]:
            stats = self.stats
            print(correction_summary(stats["total_reads"], stats["correct"], stats["corrected"],
                                     stats["uncorrectable"]), file=sys.stderr)
        return dict(self.stats)


def fastq_process(
    r1_files: Sequence[str],
    r2_files: Sequence[str],
    output_prefix: str,
    cb_spans: Spans,
    umi_spans: Spans,
    sample_spans: Optional[Spans] = None,
    i1_files: Optional[Sequence[str]] = None,
    whitelist: Optional[str] = None,
    n_shards: int = 1,
    output_format: str = "BAM",
    sample_id: str = "",
    batch_size: int = BATCH_SIZE,
    compress_level: int = 6,
    device: DeviceLike = None,
) -> dict:
    """FASTQ triplets -> ``n_shards`` disjoint-barcode shards.

    Shards are ``<output_prefix>_<i>.bam``, or ``<output_prefix>_R1_<i>.fastq.gz``
    and ``<output_prefix>_R2_<i>.fastq.gz`` with ``output_format="FASTQ"``.
    Spans are ``[start, end)`` slices of R1 (C, M) and I1 (S); several spans
    of one kind concatenate. Returns {total_reads, correct, corrected,
    uncorrectable}; the last three count only with a whitelist.
    """
    return FastqProcess(
        r1_files, r2_files, output_prefix, cb_spans, umi_spans, sample_spans, i1_files,
        whitelist, n_shards, output_format, sample_id, batch_size, compress_level, device,
    ).run()
