"""Downsample FASTQs to whitelist-correctable reads: the port of SampleFastq.

The port of the JAX package's ``sample_fastq_native``
(sctools_tpu/native/__init__.py:788-866) with its C++ loop
(native/fastqtools.cpp:178-461), in Python over the port's own FASTQ code:

- R1 and R2 are two streams, each the concatenation of its files, zipped
  record by record; a count mismatch is a ``ValueError`` (:209-233, :357-391);
- the cell barcode is sliced from R1 by the read structure's C segments;
  batches of 65,536 go to ``WhitelistCorrector.submit`` (one upload, one
  kernel launch, one pull), the next batch read while one is on the device;
- a read is kept when its barcode corrects. Its R1 is rewritten in the
  fixed slide-seq layout ``barcode[:8] + linker + barcode[8:] + UMI + "T"``
  with 'F' qualities for the linker and the T (:409-441); its R2 passes
  through under its native name;
- outputs are ``<prefix>.R1`` and ``<prefix>.R2`` (plain text), removed on
  any failure.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

from .device import DeviceLike, resolve
from .fastq import BatchReader, ReadStructure, extract_spans
from .ops.whitelist import PendingCorrection, WhitelistCorrector

BATCH_SIZE = 1 << 16
# the fixed slide-seq spacer the reference hardcodes (samplefastq.cpp:94)
SLIDESEQ_LINKER = b"CTTCAGCGTTCCCGAGAG"
_LINKER_QUALITY = b"F" * len(SLIDESEQ_LINKER)
_HEAD = 8  # barcode bases before the linker


class _Batch(NamedTuple):
    names: List[bytes]
    barcodes: List[bytes]
    barcode_quals: List[bytes]
    umis: List[bytes]
    umi_quals: List[bytes]
    r2_names: List[bytes]
    r2_sequences: List[bytes]
    r2_qualities: List[bytes]
    correction: PendingCorrection


class SampleFastq:
    """One SampleFastq run; ``run()`` returns (kept, total). ``seconds``
    splits its wall time into reading and slicing (``read``), correction
    (``correct``: submit and the wait) and writing the kept reads
    (``write``)."""

    def __init__(
        self,
        r1_files: Union[str, Sequence[str]],
        r2_files: Union[str, Sequence[str]],
        whitelist_file: str,
        read_structure: str,
        output_prefix: str = "sampled_down",
        batch_size: int = BATCH_SIZE,
        device: DeviceLike = None,
    ):
        device = resolve(device)
        self._r1 = [r1_files] if isinstance(r1_files, str) else list(r1_files)
        self._r2 = [r2_files] if isinstance(r2_files, str) else list(r2_files)
        if not self._r1 or not self._r2:
            raise RuntimeError("samplefastq open failed: need R1 and R2 inputs")
        structure = ReadStructure(read_structure)
        self._cb_spans, self._umi_spans = structure.spans("C"), structure.spans("M")
        self._corrector = WhitelistCorrector.from_file(whitelist_file, device=device)
        cb_len = structure.barcode_length("C")
        if cb_len != self._corrector.barcode_length:
            raise RuntimeError(
                f"whitelist barcode length {self._corrector.barcode_length} does "
                f"not match the cell barcode span length {cb_len}"
            )
        self._prefix = output_prefix
        self._batch_size = batch_size
        self.seconds = {"read": 0.0, "correct": 0.0, "write": 0.0}

    def _batches(self):
        """Read, slice and submit one batch at a time."""
        r1, r2 = BatchReader(self._r1), BatchReader(self._r2)
        while True:
            start = time.perf_counter()
            names, seqs, quals = r1.take(self._batch_size)
            r2_names, r2_seqs, r2_quals = r2.take(len(names))
            # the streams must end together (the strict zip of :370-373)
            if len(r2_names) < len(names) or (len(names) < self._batch_size and r2.take(1)[0]):
                raise ValueError("R1 and R2 hold different read counts")
            if not names:
                return
            barcodes = extract_spans(seqs, self._cb_spans)
            batch = [names, barcodes, extract_spans(quals, self._cb_spans),
                     extract_spans(seqs, self._umi_spans), extract_spans(quals, self._umi_spans),
                     r2_names, r2_seqs, r2_quals]
            middle = time.perf_counter()
            correction = self._corrector.submit(barcodes)
            self.seconds["read"] += middle - start
            self.seconds["correct"] += time.perf_counter() - middle
            yield _Batch(*batch, correction)

    def _write(self, batch: _Batch, out_r1, out_r2) -> int:
        start = time.perf_counter()
        indices = batch.correction.indices()
        middle = time.perf_counter()
        r1_lines, r2_lines = [], []
        for i in (indices >= 0).nonzero()[0].tolist():
            barcode, quality = batch.barcodes[i], batch.barcode_quals[i]
            head = min(_HEAD, len(barcode))
            r1_lines.append(b"".join((
                b"@", batch.names[i], b"\n", barcode[:head], SLIDESEQ_LINKER,
                barcode[head:], batch.umis[i], b"T\n+\n", quality[:head],
                _LINKER_QUALITY, quality[head:], batch.umi_quals[i], b"F\n",
            )))
            r2_lines.append(b"@%s\n%s\n+\n%s\n" % (
                batch.r2_names[i], batch.r2_sequences[i], batch.r2_qualities[i]))
        out_r1.write(b"".join(r1_lines))
        out_r2.write(b"".join(r2_lines))
        self.seconds["correct"] += middle - start
        self.seconds["write"] += time.perf_counter() - middle
        return len(r1_lines)

    def run(self) -> Tuple[int, int]:
        """Write ``<prefix>.R1`` / ``<prefix>.R2``; returns (kept, total) reads."""
        paths = [self._prefix + ".R1", self._prefix + ".R2"]
        kept = total = 0
        try:
            with open(paths[0], "wb") as out_r1, open(paths[1], "wb") as out_r2:
                # one batch ahead, as in fastqprocess
                previous: Optional[_Batch] = None
                for batch in self._batches():
                    total += len(batch.names)
                    if previous is not None:
                        kept += self._write(previous, out_r1, out_r2)
                    previous = batch
                if previous is not None:
                    kept += self._write(previous, out_r1, out_r2)
        except BaseException:
            for path in paths:
                try:
                    os.remove(path)
                except OSError:
                    pass
            raise
        return kept, total


def sample_fastq(
    r1_files: Union[str, Sequence[str]],
    r2_files: Union[str, Sequence[str]],
    whitelist_file: str,
    read_structure: str,
    output_prefix: str = "sampled_down",
    batch_size: int = BATCH_SIZE,
    device: DeviceLike = None,
) -> Tuple[int, int]:
    """Write ``<prefix>.R1`` / ``<prefix>.R2`` with the reads whose cell
    barcode corrects to the whitelist; returns (kept, total) reads.

    The R1 rewrite assumes the slide-seq split-barcode geometry the
    reference assumes (8 barcode bases before the linker,
    samplefastq.cpp:91-97).
    """
    return SampleFastq(
        r1_files, r2_files, whitelist_file, read_structure, output_prefix, batch_size, device
    ).run()
