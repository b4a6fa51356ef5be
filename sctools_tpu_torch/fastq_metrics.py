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
"""

from __future__ import annotations

from typing import List, Union

from . import native
from .fastq import ReadStructure


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
