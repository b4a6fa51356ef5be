"""Global constants: GA4GH-style BAM tag keys and framework limits.

Mirrors the tag vocabulary of the reference (src/sctools/consts.py:13-41) so that
BAM files produced/consumed by either toolchain interoperate. The port's own
copy of ``sctools_tpu.consts``.
"""

# BAM tag constants

RAW_SAMPLE_BARCODE_TAG_KEY = "SR"
QUALITY_SAMPLE_BARCODE_TAG_KEY = "SY"

MOLECULE_BARCODE_TAG_KEY = "UB"
RAW_MOLECULE_BARCODE_TAG_KEY = "UR"
QUALITY_MOLECULE_BARCODE_TAG_KEY = "UY"

CELL_BARCODE_TAG_KEY = "CB"
RAW_CELL_BARCODE_TAG_KEY = "CR"
QUALITY_CELL_BARCODE_TAG_KEY = "CY"

GENE_NAME_TAG_KEY = "GE"
NUMBER_OF_HITS_TAG_KEY = "NH"

ALIGNMENT_LOCATION_TAG_KEY = "XF"
INTRONIC_ALIGNMENT_LOCATION_TAG_VALUE = "INTRONIC"
CODING_ALIGNMENT_LOCATION_TAG_VALUE = "CODING"
UTR_ALIGNMENT_LOCATION_TAG_VALUE = "UTR"
INTERGENIC_ALIGNMENT_LOCATION_TAG_VALUE = "INTERGENIC"

# bam splitting guardrails (reference: src/sctools/consts.py:35-36)

MAX_BAM_SPLIT_SUBFILES_TO_WARN = 500
MAX_BAM_SPLIT_SUBFILES_TO_RAISE = 1000

# modes of the count matrix runs

SINGLE_CELL_COUNT_MATRIX = 0
SINGLE_NUCLEI_COUNT_MATRIX = 1

# Integer encoding of the XF alignment-location tag used in packed record tensors.
# 0 is reserved for "tag missing" so that device code can treat absence uniformly;
# 5 marks a tag that is present but carries an unrecognized value (absence and
# unknown values have different metric semantics: only true absence counts
# toward reads_unmapped).
XF_MISSING = 0
XF_CODING = 1
XF_INTRONIC = 2
XF_UTR = 3
XF_INTERGENIC = 4
XF_OTHER = 5

XF_VALUE_TO_CODE = {
    CODING_ALIGNMENT_LOCATION_TAG_VALUE: XF_CODING,
    INTRONIC_ALIGNMENT_LOCATION_TAG_VALUE: XF_INTRONIC,
    UTR_ALIGNMENT_LOCATION_TAG_VALUE: XF_UTR,
    INTERGENIC_ALIGNMENT_LOCATION_TAG_VALUE: XF_INTERGENIC,
}
XF_CODE_TO_VALUE = {v: k for k, v in XF_VALUE_TO_CODE.items()}
