"""Host (streaming) metrics aggregators: the backend of ``--backend cpu``.

The port's own copy of ``sctools_tpu.metrics.aggregator``, with the one
piece of ``sctools_tpu.stats`` it needs (the Welford accumulator). It keeps
the exact streaming semantics of the reference aggregators: one aggregator
instance per entity, per-record updates in Python floats in record order,
higher-order metrics at finalize. Its quirks stay as they are:

- reads with XF == INTERGENIC count toward reads_mapped_intergenic whatever
  their mapped state, and reads missing XF count toward reads_unmapped;
- the genes/cells histograms count reads (every record increments), so
  n_mitochondrial_molecules is read-weighted;
- variance is sample variance, nan below two observations;
- noise_reads and antisense_reads are always 0 (never implemented upstream).

The CSV header is ``vars()`` of a fresh aggregator with privates dropped, so
the declaration order of public attributes below is the column order
(``metrics.schema`` pins the same order for the device path).
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence, Set

import numpy as np

from .. import consts

_PHRED_OFFSET = 33
_HIGH_QUALITY = 30  # "bases above 30" threshold shared by all quality metrics


class OnlineGaussianSufficientStatistic:
    """(count, mean, M2) moment accumulator, one value at a time (Welford)."""

    __slots__ = ("_count", "_mean", "_m2")

    def __init__(self):
        self._count = 0
        self._mean = 0.0
        self._m2 = 0.0

    def update(self, new_value: float) -> None:
        self._count += 1
        step = new_value - self._mean
        self._mean += step / self._count
        self._m2 += step * (new_value - self._mean)

    @property
    def mean(self) -> float:
        """Current mean (0.0 when nothing observed)."""
        return self._mean

    def calculate_variance(self) -> float:
        """Sample variance; nan below two observations."""
        return self._m2 / (self._count - 1) if self._count >= 2 else float("nan")


def _frac_high_quality(scores) -> float:
    """Fraction of phred scores strictly above the quality threshold."""
    arr = np.asarray(scores)
    return int((arr > _HIGH_QUALITY).sum()) / arr.size


def _tag_phred_frac(record, tag_key: str) -> float:
    """High-quality fraction of a string-encoded quality tag (offset 33)."""
    encoded = record.get_tag(tag_key)
    scores = np.frombuffer(encoded.encode(), np.uint8).astype(np.int32)
    return _frac_high_quality(scores - _PHRED_OFFSET)


def _ratio(numerator, denominator) -> float:
    return numerator / denominator if denominator else float("nan")


def _count_if(histogram: Counter, predicate) -> int:
    return sum(1 for count in histogram.values() if predicate(count))


# XF value -> counter attribute bumped for mapped reads
_LOCATION_COUNTERS = {
    consts.CODING_ALIGNMENT_LOCATION_TAG_VALUE: "reads_mapped_exonic",
    consts.INTRONIC_ALIGNMENT_LOCATION_TAG_VALUE: "reads_mapped_intronic",
    consts.UTR_ALIGNMENT_LOCATION_TAG_VALUE: "reads_mapped_utr",
}


class MetricAggregator:
    """Accumulates the 24 common metrics for one entity (cell or gene)."""

    def __init__(self):
        # -- per-record counters (public names are CSV columns, in order) --
        self.n_reads: int = 0
        self.noise_reads: int = 0  # never incremented (matches reference)
        self._fragment_reads = Counter()  # (ref, pos, strand, tags) -> reads
        self._molecule_reads = Counter()  # tag triple -> reads

        self._umi_quality_frac = OnlineGaussianSufficientStatistic()
        self.perfect_molecule_barcodes: int = 0

        self._genomic_quality_frac = OnlineGaussianSufficientStatistic()
        self._genomic_quality = OnlineGaussianSufficientStatistic()

        self.reads_mapped_exonic: int = 0
        self.reads_mapped_intronic: int = 0
        self.reads_mapped_utr: int = 0

        self.reads_mapped_uniquely: int = 0
        self.reads_mapped_multiple: int = 0
        self.duplicate_reads: int = 0

        self.spliced_reads: int = 0
        self.antisense_reads: int = 0  # never incremented (matches reference)
        self._plus_strand_reads = 0

        # -- higher-order columns, computed by finalize() --
        for deferred in (
            "molecule_barcode_fraction_bases_above_30_mean",
            "molecule_barcode_fraction_bases_above_30_variance",
            "genomic_reads_fraction_bases_quality_above_30_mean",
            "genomic_reads_fraction_bases_quality_above_30_variance",
            "genomic_read_quality_mean",
            "genomic_read_quality_variance",
            "n_molecules",
            "n_fragments",
            "reads_per_molecule",
            "reads_per_fragment",
            "fragments_per_molecule",
            "fragments_with_single_read_evidence",
            "molecules_with_single_read_evidence",
        ):
            setattr(self, deferred, None)

    def parse_extra_fields(self, tags, record) -> None:
        raise NotImplementedError

    def parse_molecule(self, tags: Sequence[str], records: Iterable) -> None:
        """Fold all records of one molecule (one tag triple) into the state."""
        for record in records:
            self.parse_extra_fields(tags=tags, record=record)
            self._observe(tags, record)

    def _observe(self, tags, record) -> None:
        self.n_reads += 1
        self._molecule_reads[tags] += 1

        self._umi_quality_frac.update(
            _tag_phred_frac(record, consts.QUALITY_MOLECULE_BARCODE_TAG_KEY)
        )

        # a read missing either the corrected or the raw molecule barcode
        # simply doesn't inform the perfect-barcode counter
        if record.has_tag(consts.RAW_MOLECULE_BARCODE_TAG_KEY) and record.has_tag(
            consts.MOLECULE_BARCODE_TAG_KEY
        ):
            self.perfect_molecule_barcodes += record.get_tag(
                consts.RAW_MOLECULE_BARCODE_TAG_KEY
            ) == record.get_tag(consts.MOLECULE_BARCODE_TAG_KEY)

        aligned_scores = record.query_alignment_qualities
        self._genomic_quality_frac.update(_frac_high_quality(aligned_scores))
        self._genomic_quality.update(float(np.mean(aligned_scores)))

        if record.is_unmapped:
            return  # everything below describes the alignment

        fragment = (record.reference_id, record.pos, record.is_reverse, tags)
        self._fragment_reads[fragment] += 1

        bump = _LOCATION_COUNTERS.get(record.get_tag(consts.ALIGNMENT_LOCATION_TAG_KEY))
        if bump is not None:
            setattr(self, bump, getattr(self, bump) + 1)

        if record.get_tag(consts.NUMBER_OF_HITS_TAG_KEY) == 1:
            self.reads_mapped_uniquely += 1
        else:
            self.reads_mapped_multiple += 1

        self.duplicate_reads += bool(record.is_duplicate)
        # any N cigar-op base marks the alignment as spliced
        self.spliced_reads += record.get_cigar_stats()[0][3] > 0
        self._plus_strand_reads += not record.is_reverse

    def finalize(self) -> None:
        for stat, column in (
            (self._umi_quality_frac, "molecule_barcode_fraction_bases_above_30"),
            (self._genomic_quality_frac, "genomic_reads_fraction_bases_quality_above_30"),
            (self._genomic_quality, "genomic_read_quality"),
        ):
            setattr(self, column + "_mean", stat.mean)
            setattr(self, column + "_variance", stat.calculate_variance())

        self.n_molecules = len(self._molecule_reads)
        self.n_fragments = len(self._fragment_reads)
        self.reads_per_molecule = _ratio(self.n_reads, self.n_molecules)
        self.reads_per_fragment = _ratio(self.n_reads, self.n_fragments)
        self.fragments_per_molecule = _ratio(self.n_fragments, self.n_molecules)
        self.fragments_with_single_read_evidence = _count_if(
            self._fragment_reads, lambda count: count == 1
        )
        self.molecules_with_single_read_evidence = _count_if(
            self._molecule_reads, lambda count: count == 1
        )


class CellMetrics(MetricAggregator):
    """Cell-specific aggregator: adds the 11 CB-keyed extras."""

    def __init__(self):
        super().__init__()

        self._cb_quality_frac = OnlineGaussianSufficientStatistic()
        self.perfect_cell_barcodes: int = 0

        self.reads_mapped_intergenic: int = 0
        self.reads_unmapped: int = 0
        self.reads_mapped_too_many_loci: int = 0  # never incremented upstream

        self._gene_reads = Counter()  # gene tag -> reads (None-gene included)

        for deferred in (
            "cell_barcode_fraction_bases_above_30_variance",
            "cell_barcode_fraction_bases_above_30_mean",
            "n_genes",
            "genes_detected_multiple_observations",
            "n_mitochondrial_genes",
            "n_mitochondrial_molecules",
            "pct_mitochondrial_molecules",
        ):
            setattr(self, deferred, None)

    def parse_extra_fields(self, tags, record) -> None:
        self._cb_quality_frac.update(_tag_phred_frac(record, consts.QUALITY_CELL_BARCODE_TAG_KEY))

        # reads without a corrected CB don't inform the perfect-barcode count
        if record.has_tag(consts.CELL_BARCODE_TAG_KEY):
            self.perfect_cell_barcodes += record.get_tag(
                consts.RAW_CELL_BARCODE_TAG_KEY
            ) == record.get_tag(consts.CELL_BARCODE_TAG_KEY)

        # XF semantics inherited from the reference: INTERGENIC counts as
        # mapped-intergenic whatever the flag says, a missing XF counts the
        # read as unmapped
        if not record.has_tag(consts.ALIGNMENT_LOCATION_TAG_KEY):
            self.reads_unmapped += 1
        elif (
            record.get_tag(consts.ALIGNMENT_LOCATION_TAG_KEY)
            == consts.INTERGENIC_ALIGNMENT_LOCATION_TAG_VALUE
        ):
            self.reads_mapped_intergenic += 1

        self._gene_reads[tags[2]] += 1  # the no-gene group is None

    def finalize(self, mitochondrial_genes: Set[str] = frozenset()) -> None:
        super().finalize()

        self.cell_barcode_fraction_bases_above_30_mean = self._cb_quality_frac.mean
        self.cell_barcode_fraction_bases_above_30_variance = (
            self._cb_quality_frac.calculate_variance()
        )

        self.n_genes = len(self._gene_reads)
        self.genes_detected_multiple_observations = _count_if(
            self._gene_reads, lambda count: count > 1
        )

        mito_reads = {
            gene: count for gene, count in self._gene_reads.items() if gene in mitochondrial_genes
        }
        self.n_mitochondrial_genes = len(mito_reads)
        self.n_mitochondrial_molecules = sum(mito_reads.values())
        if self.n_mitochondrial_molecules:
            self.pct_mitochondrial_molecules = (
                self.n_mitochondrial_molecules / sum(self._gene_reads.values()) * 100.0
            )
        else:
            self.pct_mitochondrial_molecules = 0.00


class GeneMetrics(MetricAggregator):
    """Gene-specific aggregator: adds the 2 GE-keyed extras."""

    def __init__(self):
        super().__init__()

        self._cell_reads = Counter()  # cell tag -> reads

        self.number_cells_detected_multiple: int = None
        self.number_cells_expressing: int = None

    def parse_extra_fields(self, tags, record) -> None:
        self._cell_reads[tags[1]] += 1

    def finalize(self) -> None:
        super().finalize()

        self.number_cells_expressing = len(self._cell_reads)
        self.number_cells_detected_multiple = _count_if(
            self._cell_reads, lambda count: count > 1
        )
