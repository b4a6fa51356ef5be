"""Command-line layer of the port: all sixteen entry points of the JAX CLI.

``GenericPlatform.calculate_cell_metrics`` and ``calculate_gene_metrics`` are
the ports of the JAX package's (sctools_tpu/platform.py:497-565) with the same
argparse surface, so Optimus command lines parse unchanged; they run the
port's streaming gatherer (``sctools_tpu_torch.metrics.gatherer``) on the
device, or with ``--backend cpu`` its host aggregators.

``GenericPlatform.bam_to_count_matrix`` (``CreateCountMatrix``) and the
three merges, ``merge_count_matrices``, ``merge_gene_metrics`` and
``merge_cell_metrics``, are the ports of sctools_tpu/platform.py:567-750,
with the same flags; the count's ``--backend cpu`` is the
reference-semantics host loop of ``count.py``.

``tag_sort_bam`` (``TagSortBam``), ``verify_bam_sort``, ``split_bam`` and
``group_qc_outputs`` are the ports of sctools_tpu/platform.py:198-495,
:752-790, with the same flags, help and parser errors. The sorts run on the
host (``tagsort``, ``native``, ``bam``); ``TagSortBam --cell-metrics-output``
/ ``--gene-metrics-output`` feeds the native sort's merged stream to the
metrics pass on the device in one pass. The other three are host code.

``TenXV2.attach_barcodes`` and ``BarcodePlatform.attach_barcodes`` are the
ports of sctools_tpu/platform.py:916-993, :1118-1389, with the same
geometry validation and ``--read-structure``. Both run
``sctools_tpu_torch.attach``, routed as the JAX package routes: one r1 file
and a BGZF u2 take the native layer's attach loop, anything else the
Python loop, which writes the same records (tags in the order CR CY [CB]
UR UY [SR SY], and no line terminator inside the tags of a read shorter
than its spans).

``TenXV2.fastq_process`` (``FastqProcess``), ``GenericPlatform.sample_fastq``,
``fastq_metrics`` and ``check_barcode_partition`` are the ports of
sctools_tpu/platform.py:792-913, :995-1115, with the same flags, stderr lines
and exit codes. The first three run the native layer's FASTQ loops
(``fastqprocess``, ``samplefastq``, ``fastq_metrics``), the first two with
each batch's barcodes corrected on the whitelist kernel;
``check_barcode_partition`` is host code.

Every entry point is a classmethod taking an optional ``args`` list, plus a
``device`` keyword: ``cuda`` unless the caller passes ``device="cpu"``; the
host-only commands accept it and do not use it. ``--devices N`` with N > 1
runs CalculateCellMetrics, CalculateGeneMetrics, the fused TagSortBam and
CreateCountMatrix on a mesh of N devices of ``device``'s type (N cards, or N
CPU shards with ``device="cpu"``; ``parallel``), and MergeCellMetrics /
MergeGeneMetrics as the collective merges (``metrics.collective``), with
the JAX package's parser errors.
Unlike the JAX classes, ``BarcodePlatform`` keeps the geometry of one call
local to that call instead of storing it on the class.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import attach, bam, consts, fastq, groups, gtf, native, tagsort
from .count import DEFAULT_BATCH_RECORDS, CountMatrix
from .device import DeviceLike, resolve
from .fastq_metrics import compute_fastq_metrics
from .fastqprocess import fastq_process
from .io import bgzf
from .io.sam import AlignmentReader, AlignmentWriter, aux_fields, aux_value, query_name
from .metrics.gatherer import GatherCellMetrics, GatherGeneMetrics
from .metrics.merge import MergeCellMetrics, MergeGeneMetrics
from .samplefastq import sample_fastq


def _build_parser(*specs, description=None, defaults=None) -> argparse.ArgumentParser:
    """An ArgumentParser from compact ``(flags, options)`` pairs."""
    parser = argparse.ArgumentParser(description=description)
    if defaults:
        parser.set_defaults(**defaults)
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
        "aggregators, streaming reference-semantics path (default: device)",
    ),
)
_DEVICES_SPEC = (
    ("--devices",),
    dict(
        type=int,
        default=0,
        help="shard the device computation over the first N devices as a "
        "mesh (entity-hash partition, one pass a shard; output identical to "
        "one device). 0/1 = one device (default)",
    ),
)


def _resolve_mesh(devices: int, backend: str, parser, device: DeviceLike):
    """``--devices N > 1`` -> a mesh over the first N devices of
    ``device``'s type (else None), or JAX's parser errors: N > 1 needs the
    device backend and N devices. A ``cuda`` request without a GPU raises
    as every entry point does."""
    if not devices or devices <= 1:
        return None
    if backend == "cpu":
        parser.error("--devices requires the device backend")
    from .parallel.mesh import make_mesh

    try:
        return make_mesh(devices, device=device)
    except ValueError as error:
        parser.error(str(error))


def _make_metric_gatherer(kind: str, devices: int, backend: str, parser, device: DeviceLike):
    """(gatherer class, its keyword arguments) of a metrics pass: the
    mesh-sharded gatherer for ``--devices N > 1``, else the single-device
    one, on ``device`` (resolved here: without a GPU, ``cuda`` raises before
    any input is read) or with the host aggregators of ``--backend cpu``."""
    mesh = _resolve_mesh(devices, backend, parser, device)
    if mesh is not None:
        from .parallel.gatherer import sharded_gatherer_cls

        return sharded_gatherer_cls(kind), {"mesh": mesh}
    cls = GatherCellMetrics if kind == "cell" else GatherGeneMetrics
    if backend == "cpu":
        return cls, {"backend": "cpu"}
    return cls, {"device": resolve(device)}


_MERGE_SPECS = (
    (("metric_files",), dict(nargs="+", help="the chunked metric csvs")),
    (("-o", "--output-filestem"), dict(required=True, help="stem for the merged csv")),
    _DEVICES_SPEC,
)


class GenericPlatform:
    """Entry points shared by all sequencing platforms."""

    @classmethod
    def get_tags(cls, raw_tags: Optional[Sequence[str]]) -> Iterable[str]:
        # flatten a potentially nested list (argparse nargs='+' + action='append')
        flattened: List[str] = []
        for tag in raw_tags or []:
            flattened.extend(tag if isinstance(tag, list) else [tag])
        return flattened

    @classmethod
    def tag_sort_bam(cls, args: Iterable = None, device: DeviceLike = None) -> int:
        """Sort a bam by zero or more tags, then query name (reference
        platform.py:55-97).

        With ``--cell-metrics-output`` / ``--gene-metrics-output`` the merged
        sorted stream feeds the metrics engine on ``device`` directly: one
        pass, and when ``-o`` is omitted no sorted BAM is written at all.
        Without a metrics output the sort is host code and ``device`` is not
        used.
        """
        parser = _build_parser(
            (("-i", "--input_bam"), dict(required=True, help="the bam to sort")),
            (
                ("-o", "--output_bam"),
                dict(
                    default=None,
                    help="where the sorted bam goes (optional when a "
                    "metrics output is requested)",
                ),
            ),
            (
                ("-t", "--tags"),
                dict(
                    nargs="+",
                    action="append",
                    help="sort keys in priority order (space separated), "
                    "e.g. -t CB GE UB; query name always breaks ties",
                ),
            ),
            (
                ("--records-per-chunk",),
                dict(
                    type=int,
                    default=None,
                    help="bound memory by spilling sorted chunks of this many "
                    "records and k-way merging them (out-of-core; default: "
                    "all in memory when unset)",
                ),
            ),
            (
                ("--cell-metrics-output",),
                dict(
                    default=None,
                    help="compute per-cell metrics from the merged stream "
                    "(one pass; requires -t CB UB GE) and write this csv "
                    "stem",
                ),
            ),
            (
                ("--gene-metrics-output",),
                dict(
                    default=None,
                    help="compute per-gene metrics from the merged stream "
                    "(one pass; requires -t GE CB UB) and write this csv "
                    "stem",
                ),
            ),
            (
                ("-a", "--gtf-annotation-file"),
                dict(
                    default=None,
                    help="annotation for the mitochondrial metrics "
                    "(cell metrics only)",
                ),
            ),
            _DEVICES_SPEC,
            description="Sort a bam by a list of zero or more tags, then query name",
        )
        args = parser.parse_args(args)

        tags = cls.get_tags(args.tags)
        fused = cls._fused_metrics_request(parser, args, tags)
        if fused is not None:
            return cls._tag_sort_with_metrics(args, tags, *fused, parser=parser, device=device)
        if args.devices and args.devices > 1:
            parser.error(
                "--devices applies to the fused metrics outputs "
                "(--cell-metrics-output/--gene-metrics-output)"
            )
        if args.output_bam is None:
            parser.error("-o/--output_bam is required without a metrics output")
        if args.records_per_chunk is not None:
            tagsort.tag_sort_bam_out_of_core(
                args.input_bam, args.output_bam, tags, records_per_chunk=args.records_per_chunk
            )
            return 0
        with AlignmentReader(args.input_bam, "rb") as f:
            header = f.header.copy()
            sorted_records = bam.sort_by_tags_and_queryname(iter(f), tags)
        with AlignmentWriter(args.output_bam, header, "wb") as f:
            for record in sorted_records:
                f.write(record)
        return 0

    @classmethod
    def _fused_metrics_request(cls, parser, args, tags):
        """Validate the fused-metrics flags; None when not requested.

        Tag order is the metric type's contract: cell metrics need (CB, UB,
        GE), gene metrics (GE, CB, UB).
        """
        if args.cell_metrics_output and args.gene_metrics_output:
            parser.error("pass either --cell-metrics-output or --gene-metrics-output")
        if args.cell_metrics_output:
            if list(tags) != ["CB", "UB", "GE"]:
                parser.error("--cell-metrics-output requires -t CB UB GE")
            return ("cell", args.cell_metrics_output)
        if args.gene_metrics_output:
            if list(tags) != ["GE", "CB", "UB"]:
                parser.error("--gene-metrics-output requires -t GE CB UB")
            return ("gene", args.gene_metrics_output)
        return None

    @classmethod
    def _tag_sort_with_metrics(
        cls, args, tags, kind, metrics_stem, parser=None, device: DeviceLike = None
    ) -> int:
        """One merge pass: sorted stream -> metrics on ``device`` (+ an
        optional sorted bam, teed at BGZF level 1).

        The native sort's merge streams into the gatherer
        (``native.tagsort_stream_frames``, behind the ingest ring's prefetch
        stage), as in the JAX package, for every gzip input: the JAX
        package's two-pass fallback, for a BAM named ``.sam``, gives the
        same outputs. An input that is not gzip fails as
        that fallback fails, opening it as a BAM (SAM text: gzip's error).
        A failure publishes no CSV and leaves no sorted BAM and no partials:
        the sorted BAM is teed into the scratch directory and moved to
        ``-o`` only once the metrics pass has succeeded (the ring's producer
        may finish the sort before the pass fails).
        """
        mitochondrial_gene_ids: Set[str] = set()
        if args.gtf_annotation_file:
            mitochondrial_gene_ids = gtf.get_mitochondrial_gene_names(args.gtf_annotation_file)
        # the metrics side runs on the mesh with --devices N > 1; the sort
        # stays the native out-of-core merge on the host
        gatherer_cls, gatherer_kwargs = _make_metric_gatherer(kind, args.devices, "device", parser, device)
        if not bgzf.is_gzip(args.input_bam):
            AlignmentReader(args.input_bam, "rb").close()  # raises, as that fallback does
        scratch_dir = os.path.dirname(os.path.abspath(args.output_bam or metrics_stem))
        with tempfile.TemporaryDirectory(prefix="tagsort_", dir=scratch_dir) as scratch:
            tee = os.path.join(scratch, "sorted.bam") if args.output_bam else None
            # the source runs inside extract_metrics, after ``gatherer`` is
            # bound, and reports the sort's own work to it
            gatherer = gatherer_cls(
                args.input_bam, metrics_stem, mitochondrial_gene_ids,
                frame_source=lambda: native.tagsort_stream_frames(
                    args.input_bam, tags, os.path.join(scratch, "partial"), gatherer.source_stats,
                    sort_batch_records=args.records_per_chunk or tagsort.DEFAULT_RECORDS_PER_CHUNK,
                    bam_output=tee,
                ),
                **gatherer_kwargs,
            )
            gatherer.extract_metrics()
            if tee is not None:
                os.replace(tee, args.output_bam)
        return 0

    @classmethod
    def verify_bam_sort(cls, args: Iterable = None, device: DeviceLike = None) -> int:
        """Verify a bam is sorted by tags then query name (reference
        platform.py:99-143). Host code: each record's key is read from its
        raw bytes (``io.sam.aux_fields``) with the values the decoded record
        would give, so the check and its ``SortError`` are the JAX
        command's."""
        parser = _build_parser(
            (("-i", "--input_bam"), dict(required=True, help="the bam to check")),
            (
                ("-t", "--tags"),
                dict(
                    nargs="+",
                    action="append",
                    help="the expected sort keys (space separated), e.g. -t CB GE UB",
                ),
            ),
            description="Check that a bam is sorted by the given tags, then query name",
        )
        args = parser.parse_args(args)

        tags = cls.get_tags(args.tags)
        wanted = [tag.encode() for tag in tags]

        def sortable(body: bytes) -> bam.TagSortableRecord:
            fields = aux_fields(body)
            values = [aux_value(body, fields[t]) if t in fields else "" for t in wanted]
            return bam.TagSortableRecord(tags, values, query_name(body).decode())

        with AlignmentReader(args.input_bam, "rb") as reader:
            bam.verify_sort((sortable(body) for body in reader.raw_records()), tags)
        print(f"{args.input_bam} is correctly sorted by {tags} and query name")
        return 0

    @classmethod
    def split_bam(cls, args: Iterable = None, device: DeviceLike = None) -> int:
        """Split bamfiles into disjoint-barcode chunks of approximately equal
        size (reference platform.py:152-223); prints chunk filenames. Host
        code, with worker pools."""
        parser = _build_parser(
            (
                ("-b", "--bamfile"),
                dict(nargs="+", required=True, help="the bam(s) to partition"),
            ),
            (
                ("-p", "--output-prefix"),
                dict(required=True, help="filename stem for the chunks"),
            ),
            (
                ("-s", "--subfile-size"),
                dict(
                    required=False,
                    default=1000,
                    type=float,
                    help="per-chunk size target in MB (default 1000)",
                ),
            ),
            (
                ("--num-processes",),
                dict(
                    required=False,
                    default=None,
                    type=int,
                    help="worker process count for the scan and write pools",
                ),
            ),
            (
                ("-t", "--tags"),
                dict(
                    nargs="+",
                    help="partition tag(s), tried in order per record: a "
                    "later tag is consulted only when every earlier one is "
                    "absent",
                ),
            ),
            (
                ("--drop-missing",),
                dict(
                    dest="raise_missing",
                    action="store_false",
                    help="silently skip records carrying none of the tags "
                    "(default: raise)",
                ),
            ),
        )
        args = parser.parse_args(args)

        chunk_names = bam.split(
            args.bamfile,
            args.output_prefix,
            args.tags,
            approx_mb_per_split=args.subfile_size,
            raise_missing=args.raise_missing,
            num_processes=args.num_processes,
        )
        print(" ".join(chunk_names))
        return 0

    @classmethod
    def calculate_gene_metrics(
        cls, args: Iterable[str] = None, device: DeviceLike = None
    ) -> int:
        """Per-gene QC metrics csv from a (GE, CB, UB)-sorted bam
        (reference platform.py:225-261)."""
        parser = _build_parser(_INPUT_BAM_SPEC, _FILESTEM_SPEC, _BACKEND_SPEC, _DEVICES_SPEC)
        args = parser.parse_args(args)
        gatherer_cls, kwargs = _make_metric_gatherer(
            "gene", args.devices, "cpu" if args.backend == "cpu" else "device", parser, device
        )
        gatherer_cls(args.input_bam, args.output_filestem, **kwargs).extract_metrics()
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
        mitochondrial_gene_ids: Set[str] = set()
        if args.gtf_annotation_file:
            mitochondrial_gene_ids = gtf.get_mitochondrial_gene_names(args.gtf_annotation_file)
        gatherer_cls, kwargs = _make_metric_gatherer(
            "cell", args.devices, "cpu" if args.backend == "cpu" else "device", parser, device
        )
        gatherer_cls(
            args.input_bam, args.output_filestem, mitochondrial_gene_ids, **kwargs
        ).extract_metrics()
        return 0


    @classmethod
    def merge_gene_metrics(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Merge chunked gene metrics csvs (reference platform.py:315-347).

        A host merge; ``--devices N > 1`` runs the collective merge on a
        mesh of N devices of ``device``'s type instead (the count columns
        reduce in one ``psum``), with the same output bytes."""
        parser = _build_parser(*_MERGE_SPECS)
        args = parser.parse_args(args)
        mesh = _resolve_mesh(args.devices, "device", parser, device)
        if mesh is not None:
            from .metrics.collective import CollectiveMergeGeneMetrics

            CollectiveMergeGeneMetrics(args.metric_files, args.output_filestem, mesh=mesh).execute()
            return 0
        MergeGeneMetrics(args.metric_files, args.output_filestem).execute()
        return 0

    @classmethod
    def merge_cell_metrics(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Merge chunked cell metrics csvs (cells are disjoint across chunks;
        reference platform.py:349-381). A host merge, like the gene one;
        ``--devices N > 1`` gathers the rows over a mesh instead."""
        parser = _build_parser(*_MERGE_SPECS)
        args = parser.parse_args(args)
        mesh = _resolve_mesh(args.devices, "device", parser, device)
        if mesh is not None:
            from .metrics.collective import CollectiveMergeCellMetrics

            CollectiveMergeCellMetrics(args.metric_files, args.output_filestem, mesh=mesh).execute()
            return 0
        MergeCellMetrics(args.metric_files, args.output_filestem).execute()
        return 0

    @classmethod
    def bam_to_count_matrix(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Count matrix from a queryname-grouped tagged bam (reference
        platform.py:383-473)."""
        parser = _build_parser(
            (("-b", "--bam-file"), dict(required=True, help="the queryname-sorted tagged bam")),
            (
                ("-o", "--output-prefix"),
                dict(required=True, help="stem for the .npz/.npy matrix files"),
            ),
            (
                ("-a", "--gtf-annotation-file"),
                dict(
                    required=True,
                    help="the annotation the bam was aligned against (defines the gene axis)",
                ),
            ),
            (
                ("-c", "--cell-barcode-tag"),
                dict(help=f"cell barcode tag (default = {consts.CELL_BARCODE_TAG_KEY})"),
            ),
            (
                ("-m", "--molecule-barcode-tag"),
                dict(help=f"molecule barcode tag (default = {consts.MOLECULE_BARCODE_TAG_KEY})"),
            ),
            (
                ("-g", "--gene-id-tag"),
                dict(
                    dest="gene_name_tag",
                    help=f"gene name tag (default = {consts.GENE_NAME_TAG_KEY})",
                ),
            ),
            (
                ("-n", "--sn-rna-seq-mode"),
                dict(action="store_true", help="snRNA Seq mode (default = False)"),
            ),
            (
                ("--batch-records",),
                dict(
                    type=int,
                    default=None,
                    help="alignments decoded per streaming batch (bounds host "
                    f"memory; default {DEFAULT_BATCH_RECORDS})",
                ),
            ),
            (
                ("--backend",),
                dict(
                    default="device",
                    choices=["device", "tpu", "cpu"],
                    help="compute backend: device/tpu = the torch count pass on the "
                    "device (cuda unless the caller asks for the cpu); cpu = the "
                    "reference-semantics host loop (default: device)",
                ),
            ),
            _DEVICES_SPEC,
            defaults=dict(
                cell_barcode_tag=consts.CELL_BARCODE_TAG_KEY,
                molecule_barcode_tag=consts.MOLECULE_BARCODE_TAG_KEY,
                gene_name_tag=consts.GENE_NAME_TAG_KEY,
            ),
        )
        args = parser.parse_args(args)
        open_mode = "r" if args.bam_file.endswith(".sam") else "rb"
        gene_name_to_index = gtf.extract_gene_names(args.gtf_annotation_file)
        backend = "cpu" if args.backend == "cpu" else "device"
        # snRNA mode loads extended gene locations in the reference, but the
        # counting never reads them: the flag is accepted for CLI parity
        matrix = CountMatrix.from_sorted_tagged_bam(
            bam_file=args.bam_file,
            gene_name_to_index=gene_name_to_index,
            cell_barcode_tag=args.cell_barcode_tag,
            molecule_barcode_tag=args.molecule_barcode_tag,
            gene_name_tag=args.gene_name_tag,
            open_mode=open_mode,
            backend=backend,
            batch_records=(
                args.batch_records if args.batch_records is not None else DEFAULT_BATCH_RECORDS
            ),
            device=device,
            mesh=_resolve_mesh(args.devices, backend, parser, device),
        )
        matrix.save(args.output_prefix)
        return 0

    @classmethod
    def merge_count_matrices(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Concatenate chunked count matrices (reference platform.py:475-516).
        A host merge, like the metric ones."""
        parser = _build_parser(
            (
                ("-i", "--input-prefixes"),
                dict(
                    nargs="+",
                    help="stems of the chunked matrices: PREFIX names PREFIX.npz, "
                    "PREFIX_col_index.npy and PREFIX_row_index.npy",
                ),
            ),
            (("-o", "--output-stem"), dict(required=True, help="stem for the merged csr matrix")),
        )
        args = parser.parse_args(args)
        CountMatrix.merge_matrices(args.input_prefixes).save(args.output_stem)
        return 0

    @classmethod
    def group_qc_outputs(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Aggregate Picard / HISAT2 / RSEM QC files (reference
        platform.py:518-576). Host code, without pandas."""
        parser = _build_parser(
            (
                ("-f", "--file_names"),
                dict(
                    dest="file_names",
                    nargs="+",
                    required=True,
                    help="the QC files to aggregate",
                ),
            ),
            (
                ("-o", "--output_name"),
                dict(dest="output_name", required=True, help="the csv to write"),
            ),
            (
                ("-t", "--metrics_type"),
                dict(
                    dest="metrics_type",
                    choices=["Picard", "PicardTable", "Core", "HISAT2", "RSEM"],
                    required=True,
                    help="which parser/aggregation to apply",
                ),
            ),
        )
        args = parser.parse_args(args)

        dispatch = {
            "Picard": groups.write_aggregated_picard_metrics_by_row,
            "PicardTable": groups.write_aggregated_picard_metrics_by_table,
            "Core": groups.write_aggregated_qc_metrics,
            "HISAT2": groups.parse_hisat2_log,
            "RSEM": groups.parse_rsem_cnt,
        }
        dispatch[args.metrics_type](args.file_names, args.output_name)
        return 0

    @classmethod
    def check_barcode_partition(
        cls, args: Iterable[str] = None, device: DeviceLike = None
    ) -> int:
        """Verify that split/scatter outputs hold disjoint cell barcodes
        (reference fastqpreprocessing/utils/check_barcode_partition.py):
        fails if a barcode appears in more than one file. Host code, like
        the merges."""
        parser = _build_parser(
            (
                ("-b", "--bam-files"),
                dict(nargs="+", required=True, help="the split/scatter output BAMs to validate"),
            ),
            (
                ("-t", "--tag"),
                dict(
                    default=consts.CELL_BARCODE_TAG_KEY,
                    help=f"partition tag (default {consts.CELL_BARCODE_TAG_KEY})",
                ),
            ),
        )
        args = parser.parse_args(args)
        owner: Dict[str, str] = {}
        violations = 0
        for path in args.bam_files:
            mode = "r" if path.endswith(".sam") else None
            with AlignmentReader(path, mode) as reader:
                seen = set()
                for record in reader:
                    value = record.tags.get(args.tag)
                    if value is not None:
                        seen.add(value[1])
            for barcode in seen:
                if barcode in owner and owner[barcode] != path:
                    print(f"barcode {barcode} appears in {owner[barcode]} AND {path}", file=sys.stderr)
                    violations += 1
                else:
                    owner[barcode] = path
        if violations:
            print(f"partition INVALID: {violations} barcode(s) span files", file=sys.stderr)
            return 1
        print(
            f"partition OK: {len(owner)} barcode(s) disjoint across {len(args.bam_files)} file(s)",
            file=sys.stderr,
        )
        return 0

    @classmethod
    def fastq_metrics(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """FASTQ-level barcode/UMI statistics (reference
        fastqpreprocessing/src/fastq_metrics.cpp:174-242). Host code."""
        parser = _build_parser(
            (("--R1",), dict(nargs="+", required=True, help="R1 fastq file shard(s)")),
            (
                ("--read-structure",),
                dict(required=True, help="read structure of R1, e.g. 16C10M or 8C18X6C9M1X"),
            ),
            (("--sample-id",), dict(required=True, help="prefix for the four output files")),
        )
        args = parser.parse_args(args)
        compute_fastq_metrics(args.R1, args.read_structure, args.sample_id)
        return 0

    @classmethod
    def sample_fastq(cls, args: Iterable[str] = None, device: DeviceLike = None) -> int:
        """Downsample fastqs to whitelist-correctable reads (reference
        fastqpreprocessing/src/samplefastq.cpp:69-104)."""
        parser = _build_parser(
            (("--R1",), dict(nargs="+", required=True, help="R1 fastq(s)")),
            (("--R2",), dict(nargs="+", required=True, help="R2 fastq(s)")),
            (("--white-list",), dict(required=True, help="cell barcode whitelist file")),
            (("--read-structure",), dict(required=True, help="read structure of R1")),
            (
                ("--output-prefix",),
                dict(default="sampled_down", help="output prefix (default: sampled_down)"),
            ),
        )
        args = parser.parse_args(args)
        kept, total = sample_fastq(
            args.R1, args.R2, args.white_list, args.read_structure, args.output_prefix,
            device=device,
        )
        print(f"kept {kept} of {total} reads")
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

    @classmethod
    def fastq_process(cls, args=None, device: DeviceLike = None) -> int:
        """The fastqprocess scatter: FASTQ triplets -> N disjoint-barcode
        shards (reference fastqpreprocessing/src/fastqprocess.cpp,
        fastq_common.cpp:362-414).

        Each read goes to shard hash(corrected-or-raw cell barcode) %
        n_shards, so a cell never spans files. The shard count is the
        reference's rule: ceil(total input GiB / --bam-size)
        (input_options.cpp:53-72).
        """
        parser = _build_parser(
            (
                ("--r1",),
                dict(nargs="+", required=True, help="read 1 fastq files (barcode + umi reads)"),
            ),
            (("--r2",), dict(nargs="+", required=True, help="read 2 fastq files (cDNA reads)")),
            (("--i1",), dict(nargs="+", default=None, help="(optional) i7 index fastq files")),
            (("-w", "--whitelist"), dict(default=None, help="cell barcode whitelist for correction")),
            (
                ("--output-format",),
                dict(default="BAM", choices=["BAM", "FASTQ"], help="shard output type (default BAM)"),
            ),
            (
                ("--bam-size",),
                dict(type=float, default=1.0, help="target GiB of input per output shard "
                     "(default 1.0; reference input_options.h:29)"),
            ),
            (("--sample-id",), dict(default="", help="@RG SM value for BAM shard headers")),
            (
                ("-o", "--output-prefix"),
                dict(default="subfile", help="shard filename prefix (default subfile)"),
            ),
            (("--barcode-length",), dict(type=int, default=16)),
            (("--umi-length",), dict(type=int, default=10)),
            (("--sample-length",), dict(type=int, default=8)),
            (
                ("--read-structure",),
                dict(
                    default=None,
                    help="R1 layout as a read-structure string, e.g. 8C18X6C9M1X "
                    "(C=cell, M=umi, S=sample, X=skip); overrides "
                    "--barcode-length/--umi-length",
                ),
            ),
        )
        args = parser.parse_args(args)
        if len(args.r1) != len(args.r2):
            parser.error("--r1 and --r2 need the same number of files")
        if args.i1 is not None and len(args.i1) != len(args.r1):
            parser.error("--i1 must match --r1 in file count")
        if args.bam_size <= 0:
            parser.error("--bam-size must be positive")
        total_bytes = sum(os.path.getsize(f) for f in args.r1 + args.r2 + (args.i1 or []))
        n_shards = max(1, math.ceil(total_bytes / (args.bam_size * (1 << 30))))
        if args.read_structure:
            structure = fastq.ReadStructure(args.read_structure)
            cb_spans, umi_spans = structure.spans("C"), structure.spans("M")
            # S segments name I1 positions: without --i1 they give no SR/SY
            sample_spans = structure.spans("S") or (
                [(0, args.sample_length)] if args.i1 else None
            )
        else:
            cb_spans = [(0, args.barcode_length)]
            umi_spans = [(args.barcode_length, args.barcode_length + args.umi_length)]
            sample_spans = [(0, args.sample_length)] if args.i1 else None
        stats = fastq_process(
            args.r1, args.r2, args.output_prefix, cb_spans, umi_spans,
            sample_spans=sample_spans, i1_files=args.i1, whitelist=args.whitelist,
            n_shards=n_shards, output_format=args.output_format,
            sample_id=args.sample_id, device=device,
        )
        print(
            f"wrote {n_shards} {args.output_format} shard(s), {stats['total_reads']} reads",
            file=sys.stderr,
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
