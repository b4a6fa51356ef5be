"""BAM toolkit: subsetting, tagging, tag grouping, sorting, splitting.

The port's own copy of ``sctools_tpu.bam``:

- ``SubsetAlignments``: the indices of the first reads aligned to a
  chromosome (and, optionally, of other reads);
- ``Tagger``: tags from generators iterated in lockstep with a BAM's
  records, written through ``AlignmentWriter`` (the library route; the
  ``Attach*`` commands take the batched native route, ``attach``);
- ``get_tag_or_default`` and ``iter_tag_groups`` with the CB / UB / GE
  wrappers: consecutive-run grouping over tag values, on
  ``itertools.groupby`` (the host metrics aggregators run on them);
- ``AlignmentSortOrder`` / ``QueryNameSortOrder``, ``TagSortableRecord``,
  ``sort_by_tags_and_queryname``, ``verify_sort`` and ``SortError``:
  tag-then-queryname order with missing tags as empty strings, on one
  materialized key tuple;
- ``split``: the barcode-partitioned scatter of ``SplitBam``, with its bin
  assignment (``get_barcode_for_alignment`` on a decoded record, the
  scatter itself on undecoded bodies), worker pools, scratch directories
  and bin merges.

Host code: nothing here imports torch, so the worker pools of ``split`` may
fork.
"""

from __future__ import annotations

import functools
import itertools
import math
import os
import shutil
import uuid
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, Generator, Iterable, Iterator, List, Optional, Set, Tuple, Union

from . import consts
from .io.sam import AlignmentReader, AlignmentWriter, BamRecord, aux_fields, aux_value, merge_bam_files

_STDERR_FD = 2  # phase markers bypass logging, like the reference's os.write


def _log_phase(message: str) -> None:
    os.write(_STDERR_FD, message.encode() + b"\n")


def get_tag_or_default(
    alignment: BamRecord, tag_key: str, default: Optional[str] = None
) -> Optional[str]:
    """The tag's value, or ``default`` when absent."""
    try:
        return alignment.get_tag(tag_key)
    except KeyError:
        return default


# ------------------------------------------------------------- subsetting


_EXPECTED_CHROMOSOMES = frozenset(
    name
    for bare in [str(i) for i in range(1, 23)] + ["M", "MT", "X", "Y"]
    for name in (bare, "chr" + bare)
)


class SubsetAlignments:
    """Extracts indices of reads aligned to requested chromosome(s)."""

    def __init__(self, alignment_file: str, open_mode: str = None):
        if open_mode is None:
            for suffix, inferred in ((".bam", "rb"), (".sam", "r")):
                if alignment_file.endswith(suffix):
                    open_mode = inferred
                    break
            else:
                raise ValueError(
                    f"Could not autodetect file type for alignment_file "
                    f"{alignment_file} (detectable suffixes: .sam, .bam)"
                )
        self._file = alignment_file
        self._open_mode = open_mode

    def indices_by_chromosome(
        self, n_specific: int, chromosome: str, include_other: int = 0
    ) -> Union[List[int], Tuple[List[int], List[int]]]:
        """First ``n_specific`` record indices on ``chromosome`` (plus,
        optionally, ``include_other`` indices of other/unmapped reads)."""
        chromosome = str(chromosome)
        if chromosome not in _EXPECTED_CHROMOSOMES:
            warnings.warn(
                "chromsome %s not in list of expected chromosomes: %r"
                % (chromosome, sorted(_EXPECTED_CHROMOSOMES))
            )

        on_target: List[int] = []
        off_target: List[int] = []
        with AlignmentReader(self._file, self._open_mode) as records:
            for index, record in enumerate(records):
                matches = not record.is_unmapped and record.reference_name == chromosome
                if matches and len(on_target) < n_specific:
                    on_target.append(index)
                elif not matches and len(off_target) < include_other:
                    off_target.append(index)
                if len(on_target) == n_specific and len(off_target) == include_other:
                    break

        if len(on_target) < n_specific or len(off_target) < include_other:
            warnings.warn(
                "Only %d unaligned and %d reads aligned to chromosome %s "
                "were found in%s" % (len(off_target), len(on_target), chromosome, self._file)
            )
        return (on_target, off_target) if include_other else on_target


# ---------------------------------------------------------------- tagging


class Tagger:
    """Adds tags to bam records from tag generators iterated in lockstep."""

    def __init__(self, bam_file: str) -> None:
        if not isinstance(bam_file, str):
            raise TypeError(f'The argument "bam_file" must be of type str, not {type(bam_file)}')
        self.bam_file = bam_file

    def tag(self, output_bam_name: str, tag_generators) -> None:
        """Write ``bam_file`` to ``output_bam_name`` with tags attached.

        ``tag_generators`` yield, per record, lists of (tag, value, type)
        tuples; generators must share the bam's record order. The shortest
        of the generators and the bam ends the output.
        """
        with AlignmentReader(self.bam_file, "rb", check_sq=False) as source:
            with AlignmentWriter(output_bam_name, source.header.copy(), "wb") as sink:
                for entry in zip(*tag_generators, source):
                    *tag_sets, record = entry
                    for tag in itertools.chain.from_iterable(tag_sets):
                        record.set_tag(*tag)
                    sink.write(record)


# ---------------------------------------------------------------- grouping


def iter_tag_groups(
    tag: str, bam_iterator: Iterator[BamRecord], filter_null: bool = False
) -> Generator:
    """Yield (records_iterator, tag_value) per consecutive run of ``tag``.

    Reads lacking the tag form a None group. Groups are runs: on unsorted
    input the same value can be yielded more than once.
    """
    keyed = itertools.groupby(bam_iterator, key=lambda record: get_tag_or_default(record, tag))
    for value, group in keyed:
        if filter_null and value is None:
            continue
        # materialize: callers may hold the group while peeking at the next
        yield iter(list(group)), value


def iter_molecule_barcodes(bam_iterator: Iterator[BamRecord]) -> Generator:
    """Group consecutive reads by molecule barcode (UB)."""
    return iter_tag_groups(consts.MOLECULE_BARCODE_TAG_KEY, bam_iterator)


def iter_cell_barcodes(bam_iterator: Iterator[BamRecord]) -> Generator:
    """Group consecutive reads by cell barcode (CB)."""
    return iter_tag_groups(consts.CELL_BARCODE_TAG_KEY, bam_iterator)


def iter_genes(bam_iterator: Iterator[BamRecord]) -> Generator:
    """Group consecutive reads by gene id (GE)."""
    return iter_tag_groups(consts.GENE_NAME_TAG_KEY, bam_iterator)


# ---------------------------------------------------------------- sorting


class AlignmentSortOrder:
    """Base class of alignment sort orders."""

    @property
    def key_generator(self) -> Callable[[BamRecord], Any]:
        raise NotImplementedError


class QueryNameSortOrder(AlignmentSortOrder):
    """Sort order by query name."""

    @staticmethod
    def get_sort_key(alignment: BamRecord) -> str:
        return alignment.query_name

    @property
    def key_generator(self):
        return QueryNameSortOrder.get_sort_key

    def __repr__(self) -> str:
        return "query_name"


class TagSortableRecord:
    """Sort adapter ordering records by tag values then query name.

    Missing tags order as empty strings, so untagged records sort first.
    The comparison is a single materialized key tuple; comparing records
    built against different tag lists is an error.
    """

    __slots__ = ("tag_keys", "tag_values", "query_name", "record")

    def __init__(
        self,
        tag_keys: Iterable[str],
        tag_values: Iterable[str],
        query_name: str,
        record: BamRecord = None,
    ) -> None:
        self.tag_keys = tag_keys
        self.tag_values = tag_values
        self.query_name = query_name
        self.record = record

    @classmethod
    def from_aligned_segment(cls, record: BamRecord, tag_keys: Iterable[str]) -> "TagSortableRecord":
        values = [get_tag_or_default(record, key, "") for key in tag_keys]
        return cls(tag_keys, values, record.query_name, record)

    def _key(self, other: "TagSortableRecord") -> Tuple:
        if self.tag_keys != other.tag_keys:
            raise ValueError(
                f"Cannot compare records using different tag lists: "
                f"{self.tag_keys}, {other.tag_keys}"
            )
        return (tuple(self.tag_values), self.query_name)

    def __lt__(self, other: object) -> bool:
        if not isinstance(other, TagSortableRecord):
            return NotImplemented
        return self._key(other) < other._key(self)

    def __le__(self, other: object) -> bool:
        if not isinstance(other, TagSortableRecord):
            return NotImplemented
        return self._key(other) <= other._key(self)

    def __gt__(self, other: object) -> bool:
        if not isinstance(other, TagSortableRecord):
            return NotImplemented
        return self._key(other) > other._key(self)

    def __ge__(self, other: object) -> bool:
        if not isinstance(other, TagSortableRecord):
            return NotImplemented
        return self._key(other) >= other._key(self)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TagSortableRecord):
            return NotImplemented
        return self._key(other) == other._key(self)

    def __repr__(self) -> str:
        return (
            f"TagSortableRecord(tags: {self.tag_keys}, "
            f"tag_values: {self.tag_values}, query_name: {self.query_name}"
        )

    def __str__(self) -> str:
        return repr(self)


def sort_by_tags_and_queryname(
    records: Iterable[BamRecord], tag_keys: Iterable[str]
) -> Iterable[BamRecord]:
    """Sort records by ``tag_keys`` then query name (in memory, stable)."""
    adapted = sorted(TagSortableRecord.from_aligned_segment(record, tag_keys) for record in records)
    return (item.record for item in adapted)


def verify_sort(records: Iterable[TagSortableRecord], tag_keys: Iterable[str]) -> None:
    """Raise SortError unless records are sorted by ``tag_keys`` + queryname."""
    # the all-empty sentinel cannot compare above any real record
    previous = TagSortableRecord(tag_keys, ["" for _ in tag_keys], "", None)
    for position, record in enumerate(records, start=1):
        if not record >= previous:
            raise SortError(
                f"Records {position - 1} and {position} are not in correct "
                f"order:\n{position}:{record} \nis less than "
                f"\n{position - 1}:{previous}"
            )
        previous = record


class SortError(Exception):
    pass


# ---------------------------------------------------------------- splitting


def get_barcode_for_alignment(alignment: BamRecord, tags: List[str], raise_missing: bool) -> Optional[str]:
    """Value of the first of ``tags`` present on ``alignment`` (else None,
    or RuntimeError with ``raise_missing``)."""
    for tag in tags:
        value = get_tag_or_default(alignment, tag)
        if value is not None:
            return value
    if raise_missing:
        raise RuntimeError("Alignment encountered that is missing {} tag(s).".format(tags))
    return None


def _barcode_of_body(body: bytes, keys: List[bytes], tags: List[str], raise_missing: bool):
    """The value of the first of ``keys`` (``tags`` encoded) among an
    undecoded record body's aux fields, as ``BamRecord.get_tag`` gives it;
    else None, or RuntimeError with ``raise_missing``."""
    fields = aux_fields(body)
    for key in keys:
        field = fields.get(key)
        if field is not None:
            return aux_value(body, field)
    if raise_missing:
        raise RuntimeError("Alignment encountered that is missing {} tag(s).".format(tags))
    return None


def get_barcodes_from_bam(in_bam: str, tags: List[str], raise_missing: bool) -> Set[str]:
    """All distinct (non-None) barcode values in ``in_bam`` for ``tags``,
    read from the aux fields without decoding the records."""
    keys = [tag.encode() for tag in tags]
    with AlignmentReader(in_bam, "rb", check_sq=False) as records:
        values = (_barcode_of_body(body, keys, tags, raise_missing) for body in records.raw_records())
        return {value for value in values if value is not None}


def write_barcodes_to_bins(
    in_bam: str, tags: List[str], barcodes_to_bins: Dict[str, int], raise_missing: bool
) -> List[str]:
    """Scatter ``in_bam`` records into per-bin bam files by barcode, in a
    scratch directory ``{stem}_{uuid}`` made in the working directory.

    The records are copied as the input holds them, undecoded, and at zlib
    level 1: these files live until the bins' merge (``merge_bam_files``),
    which writes each record through the record encoder, so a chunk holds
    the bytes of a decode and re-encode, as JAX's does."""
    stem = os.path.splitext(os.path.basename(in_bam))[0]
    scratch = f"{stem}_{uuid.uuid4()}"
    os.makedirs(scratch)
    keys = [tag.encode() for tag in tags]

    with AlignmentReader(in_bam, "rb", check_sq=False) as records:
        n_bins = len(set(barcodes_to_bins.values()))
        paths = [os.path.join(scratch, f"{scratch}_{index}.bam") for index in range(n_bins)]
        writers = [AlignmentWriter(path, records.header.copy(), "wb", level=1) for path in paths]
        try:
            for body in records.raw_records():
                barcode = _barcode_of_body(body, keys, tags, raise_missing)
                if barcode is not None:
                    writers[barcodes_to_bins[barcode]].write_body(body)
        finally:
            for writer in writers:
                writer.close()
    return paths


def merge_bams(bams: List[str]) -> str:
    """Merge bin files; the first element is the output basename."""
    out_path = os.path.realpath(bams[0] + ".bam")
    merge_bam_files(out_path, bams[1:])
    return out_path


def _assign_bins(barcodes: Iterable[str], n_bins: int) -> Dict[str, int]:
    """Round-robin barcode -> bin map; fewer barcodes than bins = one each."""
    ordered = list(barcodes)
    if len(ordered) <= n_bins:
        return {barcode: index for index, barcode in enumerate(ordered)}
    return {barcode: index % n_bins for index, barcode in enumerate(ordered)}


def split(
    in_bams: List[str],
    out_prefix: str,
    tags: List[str],
    approx_mb_per_split: float = 1000,
    raise_missing: bool = True,
    num_processes: int = None,
) -> List[str]:
    """Split ``in_bams`` by tag value into chunks of ~``approx_mb_per_split``.

    Every barcode lands in exactly one output chunk, the invariant the
    per-chunk metric and count stages and their merges rely on. Bins come
    from iterating the union of the per-file barcode sets, so which chunk a
    barcode lands in depends on ``PYTHONHASHSEED``. The pools fork, as the
    JAX package's do, so the workers share this process's hash seed; the
    union and the bin map are made here. Nothing here touches CUDA.
    """
    if not tags:
        raise ValueError("At least one tag must be passed")
    if num_processes is None:
        num_processes = os.cpu_count()

    total_mb = sum(os.path.getsize(path) for path in in_bams) * 1e-6
    n_subfiles = math.ceil(total_mb / approx_mb_per_split)
    if n_subfiles > consts.MAX_BAM_SPLIT_SUBFILES_TO_RAISE:
        raise ValueError(
            f"Number of requested subfiles ({n_subfiles}) exceeds "
            f"{consts.MAX_BAM_SPLIT_SUBFILES_TO_RAISE}; this will usually "
            f"cause OS errors, think about increasing max_mb_per_split."
        )
    if n_subfiles > consts.MAX_BAM_SPLIT_SUBFILES_TO_WARN:
        warnings.warn(
            f"Number of requested subfiles ({n_subfiles}) exceeds "
            f"{consts.MAX_BAM_SPLIT_SUBFILES_TO_WARN}; this may cause OS "
            f"errors by exceeding fid limits"
        )

    _log_phase("Retrieving barcodes from bams")
    scan = functools.partial(get_barcodes_from_bam, tags=tags, raise_missing=raise_missing)
    with ProcessPoolExecutor(max_workers=num_processes) as pool:
        per_file_barcodes = list(pool.map(scan, in_bams))
    barcodes_to_bins = _assign_bins(set().union(*per_file_barcodes), n_subfiles)
    _log_phase("Retrieved barcodes from bams")

    _log_phase("Splitting the bams by barcode")
    # writing compresses; use half the workers for the write fan-out
    n_writers = math.ceil(num_processes / 2) if num_processes > 2 else 1
    scatter = functools.partial(
        write_barcodes_to_bins,
        tags=list(tags),
        barcodes_to_bins=barcodes_to_bins,
        raise_missing=raise_missing,
    )
    with ProcessPoolExecutor(max_workers=n_writers) as pool:
        scattered = list(pool.map(scatter, in_bams))

    # transpose: per-input lists of per-bin files -> per-bin merge commands
    n_bins = len(set(barcodes_to_bins.values()))
    merge_jobs = [
        [f"{out_prefix}_{bin_index}"] + [shard[bin_index] for shard in scattered]
        for bin_index in range(n_bins)
    ]

    _log_phase("Merging temporary bam files")
    with ProcessPoolExecutor(max_workers=num_processes) as pool:
        merged = list(pool.map(merge_bams, merge_jobs))

    _log_phase("deleting temporary files")
    for shard in scattered:
        shutil.rmtree(os.path.dirname(shard[0]))
    return merged
