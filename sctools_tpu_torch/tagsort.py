"""Tag sort of a BAM: chunked stable sorts, sorted partial BAMs, a k-way merge.

The port of ``sctools_tpu.tagsort``. Both of the JAX package's routes, and
their record order, are kept:

- **the native route**, for a BGZF BAM (not named ``.sam``) sorted on three
  of the string tags CB CR UB UR GE SR: ``native.tagsort``, the port's copy
  of the JAX native sort, over raw record bytes. Each key is the three tag
  values as bytes (a missing tag is empty), then the query name; chunks of
  ``records_per_chunk`` records (at least 1,000) are sorted stably into
  partial BAMs beside the output, which a heap merge that breaks ties by
  partial index concatenates. So records with equal keys keep their input
  order.
- **the object route**, for every other input (other tag keys, such as
  ``NH`` whose integer values order numerically, or a file named ``.sam``):
  the Python chunked sort and heap merge over ``BamRecord``s.

The fused pass of ``TagSortBam --cell-metrics-output`` /
``--gene-metrics-output`` streams the native sort's merge into the metrics
gatherer (``native.tagsort_stream_frames``, called by ``platform``).
"""

from __future__ import annotations

import heapq
import os
import tempfile
from typing import Iterator, List, Sequence

from . import native
from .bam import TagSortableRecord, sort_by_tags_and_queryname
from .io import bgzf
from .io.sam import AlignmentReader, AlignmentWriter

DEFAULT_RECORDS_PER_CHUNK = 500_000
# the native sort's key domain: barcode, umi and gene tags, all strings
STRING_TAGS = frozenset(("CB", "CR", "UB", "UR", "GE", "SR"))


def raw_route(input_bam: str, tag_keys: Sequence[str]) -> bool:
    """The JAX native route's gate: three string tags, a BGZF input, not
    named ``.sam``."""
    return (
        len(tag_keys) == 3
        and set(tag_keys) <= STRING_TAGS
        and not input_bam.endswith(".sam")
        and bgzf.is_gzip(input_bam)
    )


def _write_partial(records, header, tag_keys, directory, index) -> str:
    path = os.path.join(directory, f"partial_{index:05d}.bam")
    with AlignmentWriter(path, header, "wb") as writer:
        for record in sort_by_tags_and_queryname(iter(records), tag_keys):
            writer.write(record)
    return path


def _iter_partial(path: str) -> Iterator:
    with AlignmentReader(path, "rb") as reader:
        yield from reader


def _object_key(tag_keys):
    def key(record):
        sortable = TagSortableRecord.from_aligned_segment(record, tag_keys)
        return (tuple(sortable.tag_values), sortable.query_name)

    return key


def tag_sort_bam_out_of_core(
    input_bam: str,
    output_bam: str,
    tag_keys: Sequence[str],
    records_per_chunk: int = DEFAULT_RECORDS_PER_CHUNK,
    compress_level: int = 1,
) -> int:
    """Sort ``input_bam`` by tags then query name with bounded memory.

    Memory ~ ``records_per_chunk`` records plus one record per partial
    during the merge. Returns the number of records written. The native
    route (``raw_route``) writes at ``compress_level``; the object route
    writes with the BAM writer's own level, as the JAX package's Python
    route does.
    """
    tag_keys = list(tag_keys)
    if raw_route(input_bam, tag_keys):
        return native.tagsort(
            input_bam, output_bam, tag_keys,
            batch_records=records_per_chunk, compress_level=compress_level,
        )
    directory = os.path.dirname(os.path.abspath(output_bam)) or "."
    with tempfile.TemporaryDirectory(prefix="tagsort_", dir=directory) as tmpdir:
        partials: List[str] = []
        current: List = []
        with AlignmentReader(input_bam, "rb") as reader:
            header = reader.header.copy()
            for record in reader:
                current.append(record)
                if len(current) >= records_per_chunk:
                    partials.append(_write_partial(current, header, tag_keys, tmpdir, len(partials)))
                    current = []

        if not partials:
            # whole file fit in one chunk: plain in-memory sort
            with AlignmentWriter(output_bam, header, "wb") as writer:
                for sorted_record in sort_by_tags_and_queryname(iter(current), tag_keys):
                    writer.write(sorted_record)
            return len(current)

        if current:
            partials.append(_write_partial(current, header, tag_keys, tmpdir, len(partials)))
            current = []

        n = 0
        streams = [_iter_partial(p) for p in partials]
        with AlignmentWriter(output_bam, header, "wb") as writer:
            for record in heapq.merge(*streams, key=_object_key(tag_keys)):
                writer.write(record)
                n += 1
        return n
