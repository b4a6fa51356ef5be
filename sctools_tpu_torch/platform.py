"""Command-line layer of the port: the metrics and barcode-attach entry points.

``GenericPlatform.calculate_cell_metrics`` and ``calculate_gene_metrics`` are
the ports of the JAX package's (sctools_tpu/platform.py:497-565) with the same
argparse surface, so Optimus command lines parse unchanged; they run the
port's streaming gatherer (``sctools_tpu_torch.metrics.gatherer``). Two of
their options have no port yet and stop at the parser: ``--backend cpu`` (the
host aggregators) and ``--devices N`` with N > 1 (the mesh).

``TenXV2.attach_barcodes`` and ``BarcodePlatform.attach_barcodes`` are the
ports of sctools_tpu/platform.py:916-993, :1118-1389, with the same
geometry validation and ``--read-structure``. Both run the port's batched
attach loop (``sctools_tpu_torch.attach``), which follows the JAX package's
native route: tags in the order CR CY [CB] UR UY [SR SY], and no line
terminator inside the tags of a read shorter than its spans.

Every entry point is a classmethod taking an optional ``args`` list, plus a
``device`` keyword: ``cuda`` unless the caller passes ``device="cpu"``.
Unlike the JAX classes, ``BarcodePlatform`` keeps the geometry of one call
local to that call instead of storing it on the class.
"""

from __future__ import annotations

import argparse
from typing import Iterable, List, Optional, Set, Tuple

from . import attach, consts, fastq, gtf
from .device import DeviceLike
from .metrics.gatherer import GatherCellMetrics, GatherGeneMetrics


def _build_parser(*specs) -> argparse.ArgumentParser:
    """An ArgumentParser from compact ``(flags, options)`` pairs."""
    parser = argparse.ArgumentParser()
    for flags, options in specs:
        parser.add_argument(*flags, **options)
    return parser


# barcode kind -> (sequence tag, quality tag) for EmbeddedBarcode building
_BARCODE_TAG_PAIRS = {
    "cell": (consts.RAW_CELL_BARCODE_TAG_KEY, consts.QUALITY_CELL_BARCODE_TAG_KEY),
    "molecule": (
        consts.RAW_MOLECULE_BARCODE_TAG_KEY,
        consts.QUALITY_MOLECULE_BARCODE_TAG_KEY,
    ),
    "sample": (
        consts.RAW_SAMPLE_BARCODE_TAG_KEY,
        consts.QUALITY_SAMPLE_BARCODE_TAG_KEY,
    ),
}


def _embedded(kind: str, start: int, end: int) -> fastq.EmbeddedBarcode:
    sequence_tag, quality_tag = _BARCODE_TAG_PAIRS[kind]
    return fastq.EmbeddedBarcode(start, end, sequence_tag, quality_tag)


def _span(start: Optional[int], length: Optional[int]) -> List[Tuple[int, int]]:
    return [(start, start + length)] if length else []


_R1_SPEC = (("--r1",), dict(required=True, help="fastq carrying the cell and molecule barcodes"))
_U2_SPEC = (
    ("--u2",),
    dict(
        required=True,
        help="unaligned bam holding the cDNA reads (picard FastqToSam of read 2)",
    ),
)
_OUTPUT_SPEC = (("-o", "--output-bamfile"), dict(required=True, help="where the tagged bam goes"))
_WHITELIST_SPEC = (
    ("-w", "--whitelist"),
    dict(
        default=None,
        help="cell barcode whitelist; when given, barcodes within hamming "
        "distance 1 of a whitelisted value also get a corrected CB tag",
    ),
)


_INPUT_BAM_SPEC = (("-i", "--input-bam"), dict(required=True, help="the sorted tagged bam"))
_FILESTEM_SPEC = (
    ("-o", "--output-filestem"),
    dict(required=True, help="stem for the metrics csv"),
)
_BACKEND_SPEC = (
    ("--backend",),
    dict(
        default="device",
        choices=["device", "tpu", "cpu"],
        help="compute backend: device/tpu = the torch engine on the device "
        "(cuda unless the caller asks for the cpu); cpu = the host "
        "aggregators, not ported yet (default: device)",
    ),
)
_DEVICES_SPEC = (
    ("--devices",),
    dict(
        type=int,
        default=0,
        help="shard the computation over N devices; 0/1 = one device "
        "(default). N > 1 is not ported yet",
    ),
)


def _metric_gatherer(kind: str, args, parser):
    """The gatherer class of a metric command, or a parser error for the
    options that have no port yet."""
    if args.backend == "cpu":
        parser.error(
            "--backend cpu (the host aggregators) is not ported yet: "
            "ROADMAP queue 1, item 1; use --backend device"
        )
    if args.devices and args.devices > 1:
        parser.error(
            "--devices N > 1 (the mesh) is not ported yet: ROADMAP queue 1, "
            "item 5 (multi-GPU)"
        )
    return GatherCellMetrics if kind == "cell" else GatherGeneMetrics


class GenericPlatform:
    """Entry points shared by all sequencing platforms."""

    @classmethod
    def calculate_gene_metrics(
        cls, args: Iterable[str] = None, device: DeviceLike = None
    ) -> int:
        """Per-gene QC metrics csv from a (GE, CB, UB)-sorted bam
        (reference platform.py:225-261)."""
        parser = _build_parser(_INPUT_BAM_SPEC, _FILESTEM_SPEC, _BACKEND_SPEC, _DEVICES_SPEC)
        args = parser.parse_args(args)
        gatherer_cls = _metric_gatherer("gene", args, parser)
        gatherer_cls(args.input_bam, args.output_filestem, device=device).extract_metrics()
        return 0

    @classmethod
    def calculate_cell_metrics(
        cls, args: Iterable[str] = None, device: DeviceLike = None
    ) -> int:
        """Per-cell QC metrics csv from a (CB, UB, GE)-sorted bam
        (reference platform.py:263-313)."""
        parser = _build_parser(
            _INPUT_BAM_SPEC,
            _FILESTEM_SPEC,
            (
                ("-a", "--gtf-annotation-file"),
                dict(
                    required=False,
                    default=None,
                    help="the annotation the bam was aligned against; enables "
                    "the mitochondrial metrics",
                ),
            ),
            _BACKEND_SPEC,
            _DEVICES_SPEC,
        )
        args = parser.parse_args(args)
        gatherer_cls = _metric_gatherer("cell", args, parser)
        mitochondrial_gene_ids: Set[str] = set()
        if args.gtf_annotation_file:
            mitochondrial_gene_ids = gtf.get_mitochondrial_gene_names(args.gtf_annotation_file)
        gatherer_cls(
            args.input_bam, args.output_filestem, mitochondrial_gene_ids, device=device
        ).extract_metrics()
        return 0


class TenXV2(GenericPlatform):
    """10x Genomics v2 geometry: cell barcode r1[0:16), molecule barcode
    r1[16:26), sample barcode i1[0:8) (reference platform.py:608-625)."""

    cell_barcode = _embedded("cell", 0, 16)
    molecule_barcode = _embedded("molecule", 16, 26)
    sample_barcode = _embedded("sample", 0, 8)

    @classmethod
    def attach_barcodes(cls, args=None, device: DeviceLike = None) -> int:
        """Attach 10x barcodes from r1 (+ optional i1) fastqs to an unaligned
        bam (reference platform.py:706-758)."""
        parser = _build_parser(
            _R1_SPEC,
            _U2_SPEC,
            (
                ("--i1",),
                dict(default=None, help="i7 index fastq, when a sample "
                     "barcode should be attached"),
            ),
            _OUTPUT_SPEC,
            _WHITELIST_SPEC,
        )
        args = parser.parse_args(args)
        cell, molecule, sample = cls.cell_barcode, cls.molecule_barcode, cls.sample_barcode
        attach.attach_barcodes(
            args.r1, args.u2, args.output_bamfile,
            [(cell.start, cell.end)], [(molecule.start, molecule.end)],
            [(sample.start, sample.end)] if args.i1 else [],
            i1=args.i1, whitelist=args.whitelist, device=device,
        )
        return 0


class BarcodePlatform(GenericPlatform):
    """User-defined barcode geometry (generalizes TenXV2.attach_barcodes;
    reference platform.py:761-1126)."""

    @classmethod
    def _validate_barcode_input(cls, given_value: int, min_value: int) -> int:
        if given_value >= min_value:
            return given_value
        raise argparse.ArgumentTypeError("barcode length/position out of range")

    @classmethod
    def _validate_barcode_start_pos(cls, given_value) -> int:
        return cls._validate_barcode_input(int(given_value), 0)

    @classmethod
    def _validate_barcode_length(cls, given_value) -> int:
        return cls._validate_barcode_input(int(given_value), 1)

    @classmethod
    def _validate_barcode_length_and_position(
        cls, barcode_start_position, barcode_length
    ) -> None:
        has_start = barcode_start_position is not None
        has_length = barcode_length is not None
        if has_start != has_length:
            raise argparse.ArgumentTypeError(
                "Invalid position/length, both position and length must be "
                "provided by the user together"
            )

    @classmethod
    def _validate_barcode_args(cls, args) -> None:
        for start, length in (
            (args.cell_barcode_start_pos, args.cell_barcode_length),
            (args.molecule_barcode_start_pos, args.molecule_barcode_length),
            (args.sample_barcode_start_pos, args.sample_barcode_length),
        ):
            cls._validate_barcode_length_and_position(start, length)
        if args.whitelist is not None and args.cell_barcode_length is None:
            raise argparse.ArgumentTypeError(
                "A whitelist can only be provided with a cell barcode "
                "position and length"
            )
        # a sample barcode lives in the i7 index read (reference
        # platform.py:824-827)
        if args.sample_barcode_length is not None and not args.i1:
            raise argparse.ArgumentTypeError(
                "An i7 index fastq file must be given to attach a sample barcode"
            )
        # cell and molecule barcodes must not overlap in r1 (reference
        # platform.py:830-836: molecule must start at or after cell end)
        if (
            args.cell_barcode_length is not None
            and args.molecule_barcode_length is not None
        ):
            cls._validate_barcode_input(
                args.molecule_barcode_start_pos,
                args.cell_barcode_start_pos + args.cell_barcode_length,
            )

    @classmethod
    def attach_barcodes(cls, args=None, device: DeviceLike = None) -> int:
        """Attach barcodes at user-specified positions
        (reference platform.py:1004-1126)."""
        start_type = cls._validate_barcode_start_pos
        length_type = cls._validate_barcode_length
        parser = _build_parser(
            _R1_SPEC,
            _U2_SPEC,
            _OUTPUT_SPEC,
            _WHITELIST_SPEC,
            (
                ("--i1",),
                dict(default=None, help="i7 index fastq carrying the sample barcode"),
            ),
            (
                ("--sample-barcode-start-position",),
                dict(
                    dest="sample_barcode_start_pos",
                    default=None,
                    help="0-based position of the sample barcode in i1",
                    type=start_type,
                ),
            ),
            (
                ("--sample-barcode-length",),
                dict(
                    dest="sample_barcode_length",
                    default=None,
                    help="base-pair length of the sample barcode",
                    type=length_type,
                ),
            ),
            (
                ("--cell-barcode-start-position",),
                dict(
                    dest="cell_barcode_start_pos",
                    default=None,
                    help="0-based position of the cell barcode in r1",
                    type=start_type,
                ),
            ),
            (
                ("--cell-barcode-length",),
                dict(
                    dest="cell_barcode_length",
                    default=None,
                    help="base-pair length of the cell barcode",
                    type=length_type,
                ),
            ),
            (
                ("--molecule-barcode-start-position",),
                dict(
                    dest="molecule_barcode_start_pos",
                    default=None,
                    help="0-based position of the molecule barcode in r1 "
                    "(must start at or after the cell barcode's end when "
                    "both are given)",
                    type=start_type,
                ),
            ),
            (
                ("--molecule-barcode-length",),
                dict(
                    dest="molecule_barcode_length",
                    default=None,
                    help="base-pair length of the molecule barcode",
                    type=length_type,
                ),
            ),
            (
                ("--read-structure",),
                dict(
                    default=None,
                    help="read-structure string describing r1, e.g. "
                    "8C18X6C9M1X (C = cell, M = molecule, S = sample, "
                    "X = skip); replaces the position/length arguments and "
                    "supports split barcodes",
                ),
            ),
        )
        args = parser.parse_args(args)

        if args.read_structure is not None:
            if any(
                value is not None
                for value in (
                    args.cell_barcode_start_pos,
                    args.cell_barcode_length,
                    args.molecule_barcode_start_pos,
                    args.molecule_barcode_length,
                    args.sample_barcode_start_pos,
                    args.sample_barcode_length,
                )
            ):
                raise argparse.ArgumentTypeError(
                    "--read-structure replaces the barcode position/length arguments"
                )
            if args.i1:
                raise argparse.ArgumentTypeError(
                    "--read-structure describes r1 only; encode a sample "
                    "barcode as an S segment instead of passing --i1"
                )
            structure = fastq.ReadStructure(args.read_structure)
            # S segments are sliced from r1: the attach loop reads sample
            # spans from r1 when no i1 is given
            attach.attach_barcodes(
                args.r1, args.u2, args.output_bamfile,
                structure.spans("C"), structure.spans("M"), structure.spans("S"),
                whitelist=args.whitelist, device=device,
            )
            return 0

        cls._validate_barcode_args(args)

        attach.attach_barcodes(
            args.r1, args.u2, args.output_bamfile,
            _span(args.cell_barcode_start_pos, args.cell_barcode_length),
            _span(args.molecule_barcode_start_pos, args.molecule_barcode_length),
            _span(args.sample_barcode_start_pos, args.sample_barcode_length),
            i1=args.i1, whitelist=args.whitelist, device=device,
        )
        return 0
