"""Host helpers of the port: background-thread prefetching (``prefetch``)
and synthetic workloads (``synth``; the native BAM generator is
``native.synth_bam_native``)."""

from .prefetch import prefetch_depth, prefetch_iterator
from .synth import make_synthetic_columns

__all__ = ["make_synthetic_columns", "prefetch_depth", "prefetch_iterator"]
