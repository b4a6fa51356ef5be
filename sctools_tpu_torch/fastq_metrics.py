"""FASTQ-level barcode statistics: the port of FastqMetrics.

The port of ``sctools_tpu/fastq_metrics.py`` and of the native scan it runs
(sctools_tpu/native/fastqtools.cpp:60-318), in host numpy: R1 shards are
scanned in file order, the cell barcode and the UMI sliced by the read
structure, and four files written under the reference's names
(fastq_metrics.cpp:232-242), the UMI table under the historical
``numReads_perCell_XM`` name:

- ``<prefix>.numReads_perCell_XM.txt`` and ``.numReads_perCell_XC.txt``:
  ``count<TAB>sequence`` rows, most reads first, ties in order of first
  appearance over the files in order (:294-305);
- ``<prefix>.barcode_distribution_XC.txt`` and ``_XM.txt``: per 1-based
  position, the reads with A, C, G, T and N there, case-insensitive; other
  bytes count nowhere.

A read shorter than the read structure is a ``ValueError`` (:121-128).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Union

import numpy as np

from .fastq import BatchReader, ReadStructure, extract_spans

_BATCH_SIZE = 1 << 16

# byte -> base row (A=0 C=1 G=2 T=3 N=4), case-insensitive; other = 5
_CODE_LUT = np.full(256, 5, dtype=np.uint8)
for _row, _base in enumerate(b"ACGTN"):
    _CODE_LUT[_base] = _CODE_LUT[_base + 32] = _row
del _row, _base


class _Tables:
    """The count table and position matrix of one kind of barcode."""

    def __init__(self, length: int):
        self.length = length
        self.counts: Counter = Counter()
        self.positions = np.zeros((length, 5), dtype=np.int64)

    def add(self, values: List[bytes]) -> None:
        self.counts.update(values)
        if self.length:
            codes = _CODE_LUT[np.frombuffer(b"".join(values), dtype=np.uint8)]
            codes = codes.reshape(len(values), self.length)
            for row in range(5):
                self.positions[:, row] += (codes == row).sum(axis=0)

    def write_counts(self, path: str) -> None:
        # sorted() is stable: ties keep the Counter's first-appearance order
        rows = sorted(self.counts.items(), key=lambda item: -item[1])
        with open(path, "wb") as out:
            out.write(b"".join(b"%d\t%s\n" % (count, value) for value, count in rows))

    def write_positions(self, path: str) -> None:
        lines = [b"position\tA\tC\tG\tT\tN\n"]
        for i, row in enumerate(self.positions.tolist()):
            lines.append(b"%d\t%d\t%d\t%d\t%d\t%d\n" % (i + 1, *row))
        with open(path, "wb") as out:
            out.write(b"".join(lines))


def compute_fastq_metrics(
    fastq_files: Union[str, List[str]], read_structure: str, output_prefix: str
) -> int:
    """Scan the R1 shards and write the four outputs; returns the reads scanned."""
    if isinstance(fastq_files, str):
        fastq_files = [fastq_files]
    structure = ReadStructure(read_structure)
    cb_spans, umi_spans = structure.spans("C"), structure.spans("M")
    barcodes = _Tables(structure.barcode_length("C"))
    umis = _Tables(structure.barcode_length("M"))
    n_reads = 0
    for path in fastq_files:
        records = BatchReader([path])
        while True:
            _, sequences, _ = records.take(_BATCH_SIZE)
            if not sequences:
                break
            if min(map(len, sequences)) < structure.length:
                first = next(len(s) for s in sequences if len(s) < structure.length)
                raise ValueError(
                    f"{path}: read of length {first} is shorter than read "
                    f"structure (needs {structure.length})"
                )
            barcodes.add(extract_spans(sequences, cb_spans))
            umis.add(extract_spans(sequences, umi_spans))
            n_reads += len(sequences)
    umis.write_counts(output_prefix + ".numReads_perCell_XM.txt")
    barcodes.write_counts(output_prefix + ".numReads_perCell_XC.txt")
    barcodes.write_positions(output_prefix + ".barcode_distribution_XC.txt")
    umis.write_positions(output_prefix + ".barcode_distribution_XM.txt")
    return n_reads
