"""Downsample FASTQs to whitelist-correctable reads: the port of SampleFastq.

The port of the JAX package's ``sample_fastq_native``
(sctools_tpu/native/__init__.py:788-866): the loop is the native layer's
``sample_fastq`` (``native/fastqtools.cpp``, the port's copy of the JAX
package's C++ loop), and this module is its caller:

- R1 and R2 are two streams, each the concatenation of its files, zipped
  record by record; a count mismatch is a ``ValueError``;
- the cell barcode is sliced from R1 by the read structure's C segments;
  batches of 65,536 go to ``WhitelistCorrector.submit_block`` (one upload,
  one kernel launch, one pull);
- a read is kept when its barcode corrects. Its R1 is rewritten in the
  fixed slide-seq layout ``barcode[:8] + linker + barcode[8:] + UMI + "T"``
  with 'F' qualities for the linker and the T, the barcode's quality cut
  at the same place as the barcode (a shorter quality is sliced, never read
  past its end); its R2 passes through under its native name;
- outputs are ``<prefix>.R1`` and ``<prefix>.R2`` (plain text), removed on
  any failure.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

from . import native
from .device import DeviceLike, resolve
from .fastq import ReadStructure
from .ops.whitelist import WhitelistCorrector

BATCH_SIZE = 1 << 16


class SampleFastq:
    """One SampleFastq run; ``run()`` returns (kept, total). ``seconds``
    splits its wall time into reading and slicing (``read``), correction
    (``correct``: submit and the wait, the wait on the kernel's result
    also in ``correct.wait``) and writing the kept reads (``write``)."""

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
        structure = ReadStructure(read_structure)
        self._cb_spans, self._umi_spans = structure.spans("C"), structure.spans("M")
        self._corrector = WhitelistCorrector.from_file(whitelist_file, device=device)
        self._prefix = output_prefix
        self._batch_size = batch_size
        self.seconds = {"read": 0.0, "correct": 0.0, "correct.wait": 0.0, "write": 0.0}

    def run(self) -> Tuple[int, int]:
        """Write ``<prefix>.R1`` / ``<prefix>.R2``; returns (kept, total) reads."""
        return native.sample_fastq(
            self._r1, self._r2, self._corrector, self._cb_spans, self._umi_spans, self._prefix,
            self._batch_size, self.seconds,
        )


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
