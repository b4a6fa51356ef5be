"""FASTQ-level barcode statistics: the port of FastqMetrics.

The port of ``sctools_tpu/fastq_metrics.py`` on its native route: the scan
is the native layer's ``fastq_metrics`` (``native/fastqtools.cpp``, the
port's copy of the JAX package's ``scx_fqm``), one thread per R1 shard,
the shards folded in file order. It writes four files under the
reference's names (fastq_metrics.cpp:232-242), the UMI table under the
historical ``numReads_perCell_XM`` name:

- ``<prefix>.numReads_perCell_XM.txt`` and ``.numReads_perCell_XC.txt``:
  ``count<TAB>sequence`` rows, most reads first, ties in order of first
  appearance over the files in order;
- ``<prefix>.barcode_distribution_XC.txt`` and ``_XM.txt``: per 1-based
  position, the reads with A, C, G, T and N there, case-insensitive; other
  bytes count nowhere.

A read shorter than the read structure is a ``ValueError``.

Beside it, the library's accumulator: ``FastQMetrics`` ingests R1 files in
Python, in batches of 65,536 reads whose per-position base counts
(``PositionWeightMatrix``) are masked column sums, merges shards with
``+=`` and ``write``s the same four files. ``compute_fastq_metrics`` never
falls back to it.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Union

import numpy as np

from . import native
from .fastq import ReadStructure, Reader

_BASES = "ACGTN"
# byte value -> base row (A=0 C=1 G=2 T=3 N=4), case-insensitive; other = 5
_CODE_LUT = np.full(256, 5, dtype=np.uint8)
for _i, _b in enumerate(_BASES):
    _CODE_LUT[ord(_b)] = _i
    _CODE_LUT[ord(_b.lower())] = _i
del _i, _b

_BATCH_SIZE = 1 << 16


def _codes(sequences: List[str], length: int) -> np.ndarray:
    """[n, length] uint8 base codes (sequences must have that length)."""
    joined = "".join(sequences).encode("ascii")
    flat = np.frombuffer(joined, dtype=np.uint8)
    return _CODE_LUT[flat].reshape(len(sequences), length)


class PositionWeightMatrix:
    """Per-position base composition counts (reference fastq_metrics.h:19-32)."""

    def __init__(self, length: int):
        self.length = length
        self.counts = np.zeros((length, 5), dtype=np.int64)

    def record_batch(self, codes: np.ndarray) -> None:
        for base in range(5):
            self.counts[:, base] += (codes == base).sum(axis=0)

    def __iadd__(self, other: "PositionWeightMatrix") -> "PositionWeightMatrix":
        self.counts += other.counts
        return self

    def write(self, filename: str) -> None:
        with open(filename, "w") as out:
            out.write("position\tA\tC\tG\tT\tN\n")
            for i in range(self.length):
                row = "\t".join(str(int(c)) for c in self.counts[i])
                out.write(f"{i + 1}\t{row}\n")


def _write_counts(counts: Counter, filename: str) -> None:
    """count<TAB>sequence rows, most to fewest, ties in first-seen order
    (fastq_metrics.cpp:211-224)."""
    with open(filename, "w") as out:
        for seq, count in sorted(counts.items(), key=lambda kv: -kv[1]):
            out.write(f"{count}\t{seq}\n")


class FastQMetrics:
    """Accumulates barcode/UMI statistics over R1 fastq files."""

    def __init__(self, read_structure: Union[str, ReadStructure]):
        if isinstance(read_structure, str):
            read_structure = ReadStructure(read_structure)
        self.read_structure = read_structure
        self.barcode_length = read_structure.barcode_length("C")
        self.umi_length = read_structure.barcode_length("M")
        self.barcode_counts: Counter = Counter()
        self.umi_counts: Counter = Counter()
        self.barcode_pwm = PositionWeightMatrix(self.barcode_length)
        self.umi_pwm = PositionWeightMatrix(self.umi_length)

    def ingest(self, fastq_files: Union[str, Iterable[str]]) -> int:
        """Process fastq file(s); returns the number of reads ingested."""
        n_reads = 0
        barcodes: List[str] = []
        umis: List[str] = []
        for record in Reader(fastq_files):
            # fixed-width code matrices require full-length reads
            self.read_structure.validate_length(record.sequence)
            barcodes.append(self.read_structure.extract(record.sequence, "C"))
            umis.append(self.read_structure.extract(record.sequence, "M"))
            n_reads += 1
            if len(barcodes) >= _BATCH_SIZE:
                self._flush(barcodes, umis)
                barcodes, umis = [], []
        if barcodes:
            self._flush(barcodes, umis)
        return n_reads

    def _flush(self, barcodes: List[str], umis: List[str]) -> None:
        self.barcode_counts.update(barcodes)
        self.umi_counts.update(umis)
        self.barcode_pwm.record_batch(_codes(barcodes, self.barcode_length))
        self.umi_pwm.record_batch(_codes(umis, self.umi_length))

    def __iadd__(self, other: "FastQMetrics") -> "FastQMetrics":
        """Shard merge (reference fastq_metrics.cpp:145-153)."""
        self.barcode_counts.update(other.barcode_counts)
        self.umi_counts.update(other.umi_counts)
        self.barcode_pwm += other.barcode_pwm
        self.umi_pwm += other.umi_pwm
        return self

    def write(self, prefix: str) -> None:
        """The four output files (reference fastq_metrics.cpp:232-242)."""
        _write_counts(self.umi_counts, prefix + ".numReads_perCell_XM.txt")
        _write_counts(self.barcode_counts, prefix + ".numReads_perCell_XC.txt")
        self.barcode_pwm.write(prefix + ".barcode_distribution_XC.txt")
        self.umi_pwm.write(prefix + ".barcode_distribution_XM.txt")


def compute_fastq_metrics(
    fastq_files: Union[str, List[str]], read_structure: str, output_prefix: str
) -> int:
    """Scan the R1 shards and write the four outputs; returns the reads scanned."""
    if isinstance(fastq_files, str):
        fastq_files = [fastq_files]
    structure = ReadStructure(read_structure)
    return native.fastq_metrics(
        fastq_files, structure.spans("C"), structure.spans("M"), structure.length, output_prefix
    )
