"""Tag sort of a BAM: chunked stable sorts, sorted partial BAMs, a k-way merge.

The port of ``sctools_tpu.tagsort`` and of the JAX native tag sort
(sctools_tpu/native/tagsort.cpp, ``native.tagsort_native`` and
``native.tagsort_stream_frames``), written for the port's host. Both of the
JAX package's routes, and their record order, are kept:

- **the raw route**, for a BGZF BAM (not named ``.sam``) sorted on three of
  the string tags CB CR UB UR GE SR: record bodies are read with
  ``io.sam.iter_raw_records`` and never decoded. Each key is the three tag
  values as bytes (a missing tag is ``b""``, an integer value its decimal
  digits, as the native walker renders it), then the query name. Each chunk
  of ``records_per_chunk`` records is sorted stably, written as a BGZF
  level-1 partial into a temporary directory, and the partials are merged
  with ``heapq.merge``, which breaks ties by partial index. So records with
  equal keys keep their input order, as the native sort's do.
- **the object route**, for every other input (other tag keys, such as
  ``NH`` whose integer values order numerically, or a file named ``.sam``):
  the Python chunked sort and heap merge over ``BamRecord``s.

``SortedFrameStream`` is the fused pass of ``TagSortBam
--cell-metrics-output`` / ``--gene-metrics-output``, whose keys are always
three string tags: the raw route's merged stream, over any BGZF input, is
decoded once into ``ReadFrame``s for the metrics gatherer's
``frame_source``, and the same pass writes the sorted BAM when one is asked
for. The sort stays on the host, as it does in the JAX package.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import os
import struct
import tempfile
import time
import zlib
from typing import Iterator, List, Optional, Sequence

from .bam import TagSortableRecord, sort_by_tags_and_queryname
from .io import bgzf, packed
from .io.sam import (
    AlignmentReader,
    AlignmentWriter,
    BamHeader,
    BamRecord,
    aux_fields,
    iter_raw_records,
    query_name,
    read_raw_header,
)

DEFAULT_RECORDS_PER_CHUNK = 500_000
# the fused pass's frame width: the metrics gatherer's batch
FRAME_RECORDS = 1 << 20
# the native sort's key domain: barcode, umi and gene tags, all strings
STRING_TAGS = frozenset(("CB", "CR", "UB", "UR", "GE", "SR"))

_Z, _H, _A = ord("Z"), ord("H"), ord("A")
_INT_KINDS = {ord(t): t.islower() for t in "cCsSiI"}  # type byte -> signed


def raw_route(input_bam: str, tag_keys: Sequence[str]) -> bool:
    """The JAX native route's gate: three string tags, a BGZF input, not
    named ``.sam``."""
    return (
        len(tag_keys) == 3
        and set(tag_keys) <= STRING_TAGS
        and not input_bam.endswith(".sam")
        and bgzf.is_gzip(input_bam)
    )


def sort_key(body: bytes, want: Sequence[bytes]) -> tuple:
    """(tag values as bytes, query name) of a record body, compared byte by
    byte. A missing tag, or a float or array value, is ``b""``."""
    fields = aux_fields(body)
    values = []
    for tag in want:
        field = fields.get(tag)
        if field is None:
            values.append(b"")
            continue
        kind, start, stop = field
        if kind == _Z or kind == _H or kind == _A:
            values.append(body[start:stop])
        elif kind in _INT_KINDS:
            number = int.from_bytes(body[start:stop], "little", signed=_INT_KINDS[kind])
            values.append(b"%d" % number)
        else:
            values.append(b"")
    values.append(query_name(body))
    return tuple(values)


@contextlib.contextmanager
def _as_runtime_error():
    """Read, parse and write failures of the raw route raise RuntimeError,
    as the native sort's do."""
    try:
        yield
    except (OSError, EOFError, ValueError, struct.error, zlib.error) as error:
        raise RuntimeError(f"tagsort failed: {error}") from error


def _framed(bodies: List[bytes]) -> bytes:
    """Record bodies with their block_size prefixes, as BAM stores them."""
    return b"".join(struct.pack("<I", len(body)) + body for body in bodies)


class RawTagSort:
    """The raw route over one BGZF BAM: ``sorted_bodies()`` yields the
    record bodies in sorted order. ``seconds`` splits its host time into
    read_key (inflate, record framing, keys), sort, partial_write and merge
    (reading the partials back, their keys and the heap); ``partials``
    counts the partial BAMs of the last run."""

    def __init__(
        self,
        input_bam: str,
        tag_keys: Sequence[str],
        records_per_chunk: int = DEFAULT_RECORDS_PER_CHUNK,
        scratch_dir: str = ".",
    ):
        self._input_bam = input_bam
        self._want = [key.encode() for key in tag_keys]
        # below 1, a chunk is one record, as in the object route
        self._records_per_chunk = max(1, records_per_chunk)
        self._scratch_dir = scratch_dir
        with bgzf.open_bgzf_reader(input_bam) as fh:
            # a non-gzip input (SAM text) raises gzip's own error here, as it
            # does on the JAX package's Python route
            fh.peek(1)
            with _as_runtime_error():
                self.header = read_raw_header(fh)  # the raw bytes, kept verbatim
        self.seconds = dict.fromkeys(("read_key", "sort", "partial_write", "merge"), 0.0)
        self.partials = 0

    def _key(self, body: bytes) -> tuple:
        return sort_key(body, self._want)

    def sorted_bodies(self) -> Iterator[bytes]:
        with _as_runtime_error():
            yield from self._sorted_bodies()

    def _sorted_bodies(self) -> Iterator[bytes]:
        chunk_size = self._records_per_chunk
        with tempfile.TemporaryDirectory(prefix="tagsort_", dir=self._scratch_dir) as tmpdir, \
                bgzf.open_bgzf_reader(self._input_bam) as fh:
            read_raw_header(fh)
            records = iter_raw_records(fh)
            partials: List[str] = []
            while True:
                start = time.perf_counter()
                chunk = list(itertools.islice(records, chunk_size))
                keys = [self._key(body) for body in chunk]
                more = len(chunk) == chunk_size
                if more:  # one record of look-ahead: EOF right after a full chunk
                    peek = next(records, None)
                    more = peek is not None
                    if more:
                        records = itertools.chain([peek], records)
                self.seconds["read_key"] += time.perf_counter() - start
                start = time.perf_counter()
                order = sorted(range(len(chunk)), key=keys.__getitem__)
                del keys
                self.seconds["sort"] += time.perf_counter() - start
                if not partials and not more:
                    # the whole input is one chunk: no partial round trip
                    yield from (chunk[i] for i in order)
                    return
                start = time.perf_counter()
                path = os.path.join(tmpdir, f"partial_{len(partials):05d}.bam")
                with bgzf.BgzfWriter(path, level=1) as out:
                    out.write(self.header)
                    for i in range(0, len(order), 1 << 16):
                        out.write(_framed([chunk[j] for j in order[i : i + (1 << 16)]]))
                partials.append(path)
                self.partials = len(partials)
                del chunk, order
                self.seconds["partial_write"] += time.perf_counter() - start
                if not more:
                    break
            merged = heapq.merge(*(self._iter_partial(path) for path in partials), key=self._key)
            while True:
                start = time.perf_counter()
                batch = list(itertools.islice(merged, 1 << 16))
                self.seconds["merge"] += time.perf_counter() - start
                if not batch:
                    return
                yield from batch

    @staticmethod
    def _iter_partial(path: str) -> Iterator[bytes]:
        with bgzf.open_bgzf_reader(path) as fh:
            read_raw_header(fh)
            yield from iter_raw_records(fh)


@contextlib.contextmanager
def _sorted_bam(path: str, header: bytes, level: int) -> Iterator[bgzf.BgzfWriter]:
    """A BGZF writer at ``level`` that starts with the raw ``header`` and is
    closed when the block ends; a failure (or a generator closed early)
    aborts it and removes ``path``, so a failed run leaves no output."""
    writer = bgzf.BgzfWriter(path, level=level)
    try:
        writer.write(header)
        yield writer
        writer.close()
    except BaseException:
        writer.abort()
        with contextlib.suppress(OSError):
            os.remove(path)
        raise


def _write_raw_sorted(sort: RawTagSort, output_bam: str, compress_level: int) -> int:
    """The raw route to a BGZF file; a failed run leaves no output."""
    n = 0
    with _as_runtime_error(), contextlib.closing(sort.sorted_bodies()) as bodies, \
            _sorted_bam(output_bam, sort.header, compress_level) as writer:
        while True:
            batch = list(itertools.islice(bodies, 1 << 16))
            if not batch:
                break
            writer.write(_framed(batch))
            n += len(batch)
    return n


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
    during the merge. Returns the number of records written. The raw route
    (``raw_route``) writes at ``compress_level``; the object route writes
    with the BAM writer's own level, as the JAX package's Python route does.
    """
    tag_keys = list(tag_keys)
    directory = os.path.dirname(os.path.abspath(output_bam)) or "."
    if raw_route(input_bam, tag_keys):
        sort = RawTagSort(input_bam, tag_keys, records_per_chunk, scratch_dir=directory)
        return _write_raw_sorted(sort, output_bam, compress_level)
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


class SortedFrameStream:
    """The fused pass's frame source: the raw route's merged stream, decoded
    once into ``ReadFrame``s of up to ``FRAME_RECORDS`` records.

    ``frames`` is the gatherer's ``frame_source``. With ``bam_output`` the
    same pass writes the sorted BAM (BGZF level 1, the input's header
    verbatim); with none it writes no sorted file. ``close()`` ends the
    pass: it removes the partials' temporary directory, and a sorted BAM
    left unfinished by a failure. ``seconds`` adds decode (record bodies to
    ``BamRecord``s), frame (records to a ``ReadFrame``) and tee (the sorted
    BAM) to ``RawTagSort.seconds``.
    """

    def __init__(
        self,
        input_bam: str,
        tag_keys: Sequence[str],
        records_per_chunk: int = DEFAULT_RECORDS_PER_CHUNK,
        bam_output: Optional[str] = None,
        scratch_dir: str = ".",
    ):
        self._bam_output = bam_output
        self.sort = RawTagSort(input_bam, tag_keys, records_per_chunk, scratch_dir)
        self.seconds = self.sort.seconds
        self.seconds.update(decode=0.0, frame=0.0, tee=0.0)
        self._running: Optional[Iterator] = None

    def frames(self) -> Iterator[packed.ReadFrame]:
        self._running = self._frames()
        return self._running

    def _frames(self) -> Iterator[packed.ReadFrame]:
        header = BamHeader.from_raw(self.sort.header)
        tee = (
            contextlib.nullcontext() if self._bam_output is None
            else _sorted_bam(self._bam_output, self.sort.header, level=1)
        )
        with _as_runtime_error(), contextlib.closing(self.sort.sorted_bodies()) as bodies, \
                tee as writer:
            while True:
                batch = list(itertools.islice(bodies, FRAME_RECORDS))
                if not batch:
                    break
                if writer is not None:
                    start = time.perf_counter()
                    writer.write(_framed(batch))
                    self.seconds["tee"] += time.perf_counter() - start
                with packed._cyclic_gc_paused():
                    start = time.perf_counter()
                    records = [BamRecord.from_bam_bytes(body, header) for body in batch]
                    del batch
                    self.seconds["decode"] += time.perf_counter() - start
                    start = time.perf_counter()
                    frame = packed.frame_from_records(records)
                    del records  # the records go before the caller takes the frame
                    self.seconds["frame"] += time.perf_counter() - start
                yield frame
            start = time.perf_counter()  # the tee's close, as the block ends
        if writer is not None:
            self.seconds["tee"] += time.perf_counter() - start

    def close(self) -> None:
        if self._running is not None:
            self._running.close()
            self._running = None
