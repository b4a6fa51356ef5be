"""Metric CSV schemas (the port's own copy of ``sctools_tpu.metrics.schema``).

Column names and order replicate the reference's headers, which are derived
from attribute insertion order in its aggregator constructors
(src/sctools/metrics/aggregator.py:132-189 for the 24 common columns,
437-461 for the 11 cell extras, 561-568 for the 2 gene extras; the C++ layer
pins the same lists at fastqpreprocessing/src/metricgatherer.h:112-138,
220-233, 250-254). Merged outputs and downstream pipelines key on these names.
"""

# 24 metrics common to cells and genes, in header order
COMMON_COLUMNS = [
    "n_reads",
    "noise_reads",
    "perfect_molecule_barcodes",
    "reads_mapped_exonic",
    "reads_mapped_intronic",
    "reads_mapped_utr",
    "reads_mapped_uniquely",
    "reads_mapped_multiple",
    "duplicate_reads",
    "spliced_reads",
    "antisense_reads",
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
]

# 11 cell-specific extras, in header order (note: variance precedes mean for
# the cell barcode quality pair, an intentional reference quirk)
CELL_COLUMNS = COMMON_COLUMNS + [
    "perfect_cell_barcodes",
    "reads_mapped_intergenic",
    "reads_unmapped",
    "reads_mapped_too_many_loci",
    "cell_barcode_fraction_bases_above_30_variance",
    "cell_barcode_fraction_bases_above_30_mean",
    "n_genes",
    "genes_detected_multiple_observations",
    "n_mitochondrial_genes",
    "n_mitochondrial_molecules",
    "pct_mitochondrial_molecules",
]

# 2 gene-specific extras
GENE_COLUMNS = COMMON_COLUMNS + [
    "number_cells_detected_multiple",
    "number_cells_expressing",
]

INT_COLUMNS = {
    "n_reads", "noise_reads", "perfect_molecule_barcodes",
    "reads_mapped_exonic", "reads_mapped_intronic", "reads_mapped_utr",
    "reads_mapped_uniquely", "reads_mapped_multiple", "duplicate_reads",
    "spliced_reads", "antisense_reads", "n_molecules", "n_fragments",
    "fragments_with_single_read_evidence", "molecules_with_single_read_evidence",
    "perfect_cell_barcodes", "reads_mapped_intergenic", "reads_unmapped",
    "reads_mapped_too_many_loci", "n_genes",
    "genes_detected_multiple_observations", "n_mitochondrial_genes",
    "n_mitochondrial_molecules",
    "number_cells_detected_multiple", "number_cells_expressing",
}
