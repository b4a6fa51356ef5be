"""The batched barcode-attach loop: FASTQ barcodes -> tags on an unaligned BAM.

The port of the JAX package's two attach routes, routed as its
``_attach_with_native`` gate routes them (sctools_tpu/platform.py:160-194):

- one r1 file and a gzip u2, with no sample spans read from r1, take the
  native layer's ``attach`` (``native/attach.cpp``, the port's copy of the
  JAX package's C++ loop, ``attach_barcodes_native``,
  sctools_tpu/native/__init__.py:1097-1219). A native failure raises and
  leaves no output: there is no fallback to Python;
- a list of r1 files, a u2 that is not gzip, or sample spans without i1
  (a read structure's S segments) take the Python loop below, which
  follows the native route's output:

  - r1 (+ i1) and u2 stream in lockstep with zip semantics: the run stops
    when either runs out (__init__.py:1194-1195);
  - the stream is cut into batches of 65,536 reads; each batch uploads one
    uint8 code block, makes one kernel launch and pulls its indices back;
  - the host reads and slices batch k+1 while batch k is on the device, and
    waits for batch k's result (a CUDA event, not a device-wide sync) only
    when it writes batch k's records;
  - each u2 record's bytes pass through unchanged, with CR CY [CB] UR UY
    [SR SY] appended as Z tags in the native route's order; a read shorter
    than a span gives a truncated value without the line terminator.

Both routes print the native route's summary (:1198-1208) and its progress
line every 10M reads (:1186-1193) to stderr. Sample spans index i1 when it
is given, else r1.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Iterator, List, NamedTuple, Optional, Sequence, Union

from . import consts, native
from .device import DeviceLike, resolve
from .fastq import Spans, extract_spans, iter_batches, span_len
from .io import bgzf
from .io.sam import iter_raw_records, read_raw_header, z_tags
from .ops.whitelist import PendingCorrection, WhitelistCorrector, correction_summary

BATCH_SIZE = 1 << 16
PROGRESS_EVERY = 10_000_000  # the reference's cadence (fastq_common.cpp:340)


class _Batch(NamedTuple):
    n: int
    cr: List[bytes]
    tags_before_cb: List[bytes]  # CR, CY
    tags_after_cb: List[bytes]  # UR, UY, SR, SY
    correction: Optional[PendingCorrection]


class _Counts:
    def __init__(self):
        self.written = 0
        self.correct = 0
        self.corrected = 0
        self.uncorrectable = 0
        self.next_progress = PROGRESS_EVERY


def _join_tags(groups: Sequence[List[bytes]], n: int) -> List[bytes]:
    if not groups:
        return [b""] * n
    return [b"".join(parts) for parts in zip(*groups)]


def _batches(
    r1, i1, cb_spans: Spans, umi_spans: Spans, sample_spans: Spans,
    corrector: Optional[WhitelistCorrector], batch_size: int,
) -> Iterator[_Batch]:
    """Read, slice and submit one batch at a time."""
    i1_batches = iter_batches(i1, batch_size) if i1 and sample_spans else None
    for sequences, qualities in iter_batches(r1, batch_size):
        n = len(sequences)
        before: List[List[bytes]] = []
        after: List[List[bytes]] = []
        cr: List[bytes] = []
        if cb_spans:
            cr = extract_spans(sequences, cb_spans)
            before += [
                z_tags(consts.RAW_CELL_BARCODE_TAG_KEY, cr),
                z_tags(consts.QUALITY_CELL_BARCODE_TAG_KEY,
                        extract_spans(qualities, cb_spans)),
            ]
        if umi_spans:
            after += [
                z_tags(consts.RAW_MOLECULE_BARCODE_TAG_KEY,
                        extract_spans(sequences, umi_spans)),
                z_tags(consts.QUALITY_MOLECULE_BARCODE_TAG_KEY,
                        extract_spans(qualities, umi_spans)),
            ]
        if sample_spans:
            if i1_batches is not None:
                sample_seqs, sample_quals = next(i1_batches, ([], []))
                if len(sample_seqs) < n:
                    raise ValueError("i1 fastq ended before r1")
            else:
                sample_seqs, sample_quals = sequences, qualities
            after += [
                z_tags(consts.RAW_SAMPLE_BARCODE_TAG_KEY,
                        extract_spans(sample_seqs, sample_spans)),
                z_tags(consts.QUALITY_SAMPLE_BARCODE_TAG_KEY,
                        extract_spans(sample_quals, sample_spans)),
            ]
        correction = corrector.submit(cr) if corrector is not None else None
        yield _Batch(n, cr, _join_tags(before, n), _join_tags(after, n), correction)


def _write_batch(
    batch: _Batch, records: Iterator[bytes], out: bgzf.BgzfWriter,
    whitelist: Optional[List[bytes]], counts: _Counts,
) -> bool:
    """Tag and write the batch's records; False once u2 has run out."""
    indices = batch.correction.indices() if batch.correction is not None else None
    chunks = []
    for i in range(batch.n):
        body = next(records, None)
        if body is None:
            break
        tags = batch.tags_before_cb[i]
        if indices is not None:
            index = indices[i]
            if index < 0:
                counts.uncorrectable += 1
            else:
                value = whitelist[index]
                tags += b"CBZ" + value + b"\0"
                if value == batch.cr[i]:
                    counts.correct += 1
                else:
                    counts.corrected += 1
        tags += batch.tags_after_cb[i]
        chunks.append(struct.pack("<I", len(body) + len(tags)))
        chunks.append(body)
        chunks.append(tags)
    written = len(chunks) // 3
    out.write(b"".join(chunks))
    counts.written += written
    if counts.written >= counts.next_progress:
        print(f"[attach] {counts.written} reads processed", file=sys.stderr)
        counts.next_progress += PROGRESS_EVERY
    return written == batch.n


def attach_barcodes(
    r1: Union[str, Sequence[str]],
    u2: str,
    output_bam: str,
    cb_spans: Spans,
    umi_spans: Spans,
    sample_spans: Spans = (),
    i1: Optional[str] = None,
    whitelist: Optional[str] = None,
    device: DeviceLike = None,
    batch_size: int = BATCH_SIZE,
) -> int:
    """Attach barcode tags from r1 (+ i1) to the records of u2.

    ``r1`` is one FASTQ file, or a list of them read as one stream. Spans
    are ``[start, end)`` slices; several spans of one kind concatenate.
    Returns the number of records written. On an error the partial output
    is removed.
    """
    device = resolve(device)
    cb_spans, umi_spans, sample_spans = (
        list(cb_spans or []), list(umi_spans or []), list(sample_spans or []),
    )
    corrector = None
    if whitelist is not None:
        corrector = WhitelistCorrector.from_file(whitelist, device=device)
        cb_len = span_len(cb_spans)
        if cb_len != corrector.barcode_length:
            raise ValueError(
                f"whitelist barcode length {corrector.barcode_length} does "
                f"not match the cell barcode span length {cb_len}"
            )
    if isinstance(r1, str) and bgzf.is_gzip(u2) and not (sample_spans and i1 is None):
        written, correct, corrected, uncorrectable = native.attach(
            r1, u2, output_bam, cb_spans, umi_spans, sample_spans, i1, corrector, batch_size)
        if corrector is not None and written:
            print(correction_summary(written, correct, corrected, uncorrectable), file=sys.stderr)
        return written
    if not bgzf.is_gzip(u2):
        raise ValueError(f"{u2} is not a BAM file")

    whitelist_bytes = None
    if corrector is not None:
        whitelist_bytes = [b.encode("latin-1") for b in corrector.whitelist]
    counts = _Counts()
    try:
        with bgzf.open_bgzf_reader(u2) as source, bgzf.BgzfWriter(output_bam) as out:
            out.write(read_raw_header(source))
            records = iter_raw_records(source)
            # one batch ahead: the loop reads and submits batch k+1 before it
            # waits for and writes batch k
            previous: Optional[_Batch] = None
            for batch in _batches(
                r1, i1, cb_spans, umi_spans, sample_spans, corrector, batch_size
            ):
                if previous is not None and not _write_batch(
                    previous, records, out, whitelist_bytes, counts
                ):
                    previous = None
                    break  # u2 exhausted before the fastq (zip semantics)
                previous = batch
            if previous is not None:
                _write_batch(previous, records, out, whitelist_bytes, counts)
    except BaseException:
        # never leave a partial output that could read as complete
        try:
            os.remove(output_bam)
        except OSError:
            pass
        raise
    if corrector is not None and counts.written:
        print(correction_summary(counts.written, counts.correct, counts.corrected,
                                 counts.uncorrectable), file=sys.stderr)
    return counts.written
