"""FASTQ triplets -> N disjoint-barcode shards: the port of FastqProcess.

The port of the JAX package's ``fastqprocess_native``
(sctools_tpu/native/__init__.py:928-1053): the loop is the native layer's
``fastqprocess`` (``native/fastqprocess.cpp``, the port's copy of the JAX
package's C++ loop), and this module is its caller:

- R1[i], R2[i] and I1[i] are read as one triplet at a time, in step; the
  errors ``r1 fastq ended before r2``, ``r2 fastq ended before r1`` and
  ``i1 fastq ended before r1`` are the native loop's, and a longer I1 is
  ignored;
- CR/CY and UR/UY are sliced from R1, SR/SY from I1 (only when I1 files
  are given), each cut at its first NUL byte;
- the stream is cut into batches of 65,536 reads; with a whitelist each
  batch's CR block goes to ``WhitelistCorrector.submit_block``: one upload,
  one kernel launch, one pull;
- each read goes to shard ``fnv1a(key) % n_shards``, the key being the
  corrected barcode, else the raw one, so that a cell never spans shards;
- BAM shards get unaligned records with the tags CR CY [CB] UR UY [SR SY],
  FASTQ shards ``@name / CR+UR / + / CY+UY`` in R1 and the read in R2;
  the shards' BGZF blocks are compressed on one pool of threads;
- stderr gets the progress line every 10M reads and, with a whitelist, the
  summary of ``__init__.py:1020-1030``;
- on any failure the shard files of this run are removed.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from . import native
from .device import DeviceLike, resolve
from .fastq import Spans
from .native import shard_paths
from .ops.whitelist import WhitelistCorrector, correction_summary

__all__ = ["FastqProcess", "fastq_process", "shard_paths"]

BATCH_SIZE = 1 << 16


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
        device: DeviceLike = None,
    ):
        device = resolve(device)
        self._corrector = None
        if whitelist is not None:
            self._corrector = WhitelistCorrector.from_file(whitelist, device=device)
        self._arguments = (
            list(r1_files), list(r2_files), output_prefix, list(cb_spans or []),
            list(umi_spans or []), list(sample_spans or []), list(i1_files or []),
            self._corrector, n_shards, output_format, sample_id, batch_size,
        )
        self.stats = {"total_reads": 0, "correct": 0, "corrected": 0, "uncorrectable": 0}
        self.seconds = {"read": 0.0, "correct": 0.0, "write": 0.0}

    def run(self) -> dict:
        """Write the shards; returns the counters {total_reads, correct,
        corrected, uncorrectable}."""
        self.stats = native.fastqprocess(*self._arguments, self.seconds)
        stats = self.stats
        if self._corrector is not None and stats["total_reads"]:
            print(correction_summary(stats["total_reads"], stats["correct"], stats["corrected"],
                                     stats["uncorrectable"]), file=sys.stderr)
        return dict(stats)


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
        whitelist, n_shards, output_format, sample_id, batch_size, device,
    ).run()
