"""FASTQ records and readers, barcode geometry, tag generators and batched
span extraction.

The port's own copy of ``sctools_tpu.fastq``: the 4-line ``Record`` /
``Reader``, ``EmbeddedBarcode`` and the ``ReadStructure`` DSL, and the
library's per-record tag generators (``extract_barcode``,
``EmbeddedBarcodeGenerator``, ``BarcodeGeneratorWithCorrectedCellBarcodes``,
``ReadStructureBarcodeGenerator``), which feed ``bam.Tagger`` and correct
cell barcodes with the host hash map (``barcode.ErrorsToCorrectBarcodesMap``)
as JAX's do. They keep two differences from the batched route: a read
shorter than a barcode's span keeps the FASTQ line's ``"\n"`` in its CR/CY
values (``extract_barcode`` slices the line as it is), and the tags come in
the order the caller gives the generators.

The port's commands (``attach``, ``fastqprocess``, ``samplefastq``,
``fastq_metrics``) take the batched route instead: they read records
through ``BatchReader`` and slice every barcode span of a batch at once
with ``extract_spans``, the way the JAX native layer does
(sctools_tpu/native/native_io.h:404-461), and correct on the card.
"""

from collections import namedtuple
from typing import AnyStr, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from . import consts, reader
from .barcode import ErrorsToCorrectBarcodesMap

_FIELD_NAMES = ("name", "sequence", "name2", "quality")


class Record:
    """A FASTQ record (name, sequence, name2, quality) over bytes fields.

    The four lines are validated on assignment: every field must match the
    record's string type, and the name line must begin with '@'.
    """

    __slots__ = ["_lines"]

    _at = b"@"
    _empty = b""

    def __init__(self, record: Iterable[AnyStr]):
        self._lines = [None, None, None, None]
        for slot, value in zip(range(4), record):
            self._set(slot, value)

    def _set(self, slot: int, value: AnyStr) -> None:
        if not isinstance(value, (bytes, str)):
            raise TypeError(f"FASTQ {_FIELD_NAMES[slot]} must be str or bytes")
        if slot == 0 and not value.startswith(self._at):
            raise ValueError("FASTQ name must start with @")
        self._lines[slot] = value

    def __len__(self) -> int:
        return len(self.sequence)

    def __bytes__(self) -> bytes:
        joined = self._empty.join(self._lines)
        return joined if isinstance(joined, bytes) else joined.encode()

    def __str__(self) -> str:
        return bytes(self).decode()

    def __repr__(self) -> str:
        return "Name: %s\nSequence: %s\nName2: %s\nQuality: %s\n" % tuple(
            self._lines
        )

    def _quality_bytes(self) -> bytes:
        quality = self.quality[:-1]  # trailing newline excluded
        return quality if isinstance(quality, bytes) else quality.encode()

    def average_quality(self) -> float:
        """Mean phred quality over the record."""
        scores = self._quality_bytes()
        return sum(scores) / len(scores) - 33


class StrRecord(Record):
    """A FASTQ record over str fields."""

    _at = "@"
    _empty = ""

    def __str__(self) -> str:
        return self._empty.join(self._lines)


def _line_property(slot: int):
    return property(
        lambda self: self._lines[slot],
        lambda self, value: self._set(slot, value),
    )


for _slot, _field in enumerate(_FIELD_NAMES):
    setattr(Record, _field, _line_property(_slot))
del _slot, _field


class Reader(reader.Reader):
    """FASTQ reader: groups the line stream into 4-line records."""

    def __iter__(self) -> Iterator[Record]:
        record_type = StrRecord if self._mode == "r" else Record
        lines = super().__iter__()
        yield from map(record_type, zip(lines, lines, lines, lines))


# defines the start/end slice of a barcode and its sequence/quality tag names
EmbeddedBarcode = namedtuple("Tag", ["start", "end", "sequence_tag", "quality_tag"])


def extract_barcode(record, embedded_barcode) -> Tuple[Tuple[str, str, str], Tuple[str, str, str]]:
    """Slice a barcode out of ``record``, returning BAM set_tag-ready tuples."""
    seq = record.sequence[embedded_barcode.start : embedded_barcode.end]
    qual = record.quality[embedded_barcode.start : embedded_barcode.end]
    return (
        (embedded_barcode.sequence_tag, seq, "Z"),
        (embedded_barcode.quality_tag, qual, "Z"),
    )


class EmbeddedBarcodeGenerator(Reader):
    """Yields, per FASTQ record, the tag tuples for each embedded barcode."""

    def __init__(self, fastq_files, embedded_barcodes, *args, **kwargs):
        super().__init__(files=fastq_files, *args, **kwargs)
        self.embedded_barcodes = embedded_barcodes

    def __iter__(self):
        for record in super().__iter__():
            barcodes = []
            for barcode in self.embedded_barcodes:
                barcodes.extend(extract_barcode(record, barcode))
            yield barcodes


class BarcodeGeneratorWithCorrectedCellBarcodes(Reader):
    """Yields tag tuples with the cell barcode whitelist-corrected (CB added).

    When the raw cell barcode is in the whitelist or within hamming distance 1
    of a whitelisted barcode, an additional (CB, corrected, 'Z') tuple is
    emitted after the raw CR/CY pair; of two whitelist barcodes within
    distance 1, the later one in the whitelist wins.
    """

    def __init__(
        self,
        fastq_files: Union[str, Iterable[str]],
        embedded_cell_barcode: EmbeddedBarcode,
        whitelist: str,
        other_embedded_barcodes: Iterable[EmbeddedBarcode] = tuple(),
        *args,
        **kwargs,
    ):
        super().__init__(files=fastq_files, *args, **kwargs)
        if isinstance(other_embedded_barcodes, (list, tuple)):
            self.embedded_barcodes = other_embedded_barcodes
        else:
            raise TypeError("if passed, other_embedded_barcodes must be a list or tuple")

        self._error_mapping = ErrorsToCorrectBarcodesMap.single_hamming_errors_from_whitelist(whitelist)
        self.embedded_cell_barcode = embedded_cell_barcode

    def __iter__(self):
        for record in super().__iter__():
            barcodes = []
            barcodes.extend(self.extract_cell_barcode(record, self.embedded_cell_barcode))
            for barcode in self.embedded_barcodes:
                barcodes.extend(extract_barcode(record, barcode))
            yield barcodes

    def extract_cell_barcode(self, record: Tuple[str], cb: EmbeddedBarcode):
        seq_tag, qual_tag = extract_barcode(record, cb)
        try:
            corrected_cb = self._error_mapping.get_corrected_barcode(seq_tag[1])
            return seq_tag, qual_tag, (consts.CELL_BARCODE_TAG_KEY, corrected_cb, "Z")
        except KeyError:
            return seq_tag, qual_tag


# --------------------------------------------------------------------------
# Read-structure DSL (slide-seq style)
# --------------------------------------------------------------------------

# one segment of a read structure: [start, end) plus its kind letter
ReadStructureSegment = namedtuple("ReadStructureSegment", ["start", "end", "kind"])


class ReadStructure:
    """A read-structure string like ``8C18X6C9M1X``.

    The mini-DSL of the reference's fastq_slideseq / fastq_metrics binaries
    (fastqpreprocessing/src/fastq_slideseq.cpp:4-18, fastq_metrics.cpp:17-31):
    digits give a segment length, the following letter its meaning — C = cell
    barcode, M = molecule barcode (UMI), S = sample barcode, X = skip.
    Multiple segments of one kind concatenate (slide-seq splits its cell
    barcode around a linker).
    """

    KINDS = {"C", "M", "S", "X"}

    def __init__(self, structure: str):
        self.structure = structure
        self.segments = self._parse(structure)

    @staticmethod
    def _parse(structure: str):
        segments = []
        offset = 0
        number = ""
        for char in structure:
            if char.isdigit():
                number += char
                continue
            if char not in ReadStructure.KINDS or not number:
                raise ValueError(
                    f"invalid read structure {structure!r}: expected "
                    f"<digits><letter in CMSX> pairs"
                )
            length = int(number)
            segments.append(ReadStructureSegment(offset, offset + length, char))
            offset += length
            number = ""
        if number:
            raise ValueError(f"invalid read structure {structure!r}: trailing digits")
        return segments

    @property
    def length(self) -> int:
        return self.segments[-1].end if self.segments else 0

    def spans(self, kind: str):
        return [(s.start, s.end) for s in self.segments if s.kind == kind]

    def extract(self, sequence: str, kind: str) -> str:
        """Concatenated bases of all ``kind`` segments.

        Reader lines keep their trailing newline; it is stripped here so a
        structure consuming the whole read cannot capture it into a barcode.
        A read shorter than the structure yields truncated segments — the
        graceful degradation the attach path relies on (truncated barcodes
        fail whitelist correction instead of killing the run); callers that
        need fixed widths use ``validate_length`` first.
        """
        sequence = sequence.rstrip("\n")
        return "".join(sequence[s:e] for s, e in self.spans(kind))

    def validate_length(self, sequence: str) -> None:
        """Raise if the read cannot cover the whole structure."""
        effective = len(sequence.rstrip("\n"))
        if effective < self.length:
            raise ValueError(
                f"read of length {effective} is shorter than read "
                f"structure {self.structure!r} (needs {self.length})"
            )

    def barcode_length(self, kind: str) -> int:
        return sum(e - s for s, e in self.spans(kind))


_KIND_TAGS = {
    "C": (consts.RAW_CELL_BARCODE_TAG_KEY, consts.QUALITY_CELL_BARCODE_TAG_KEY),
    "M": (consts.RAW_MOLECULE_BARCODE_TAG_KEY, consts.QUALITY_MOLECULE_BARCODE_TAG_KEY),
    "S": (consts.RAW_SAMPLE_BARCODE_TAG_KEY, consts.QUALITY_SAMPLE_BARCODE_TAG_KEY),
}


class ReadStructureBarcodeGenerator(Reader):
    """Yields, per FASTQ record, tag tuples for each read-structure barcode.

    The generator twin of EmbeddedBarcodeGenerator for segmented geometries;
    with a whitelist, the concatenated cell barcode is corrected and a CB
    tag added (same semantics as BarcodeGeneratorWithCorrectedCellBarcodes).
    """

    def __init__(self, fastq_files, read_structure, whitelist=None, *args, **kwargs):
        super().__init__(files=fastq_files, *args, **kwargs)
        if isinstance(read_structure, str):
            read_structure = ReadStructure(read_structure)
        self.read_structure = read_structure
        self._error_mapping = (
            ErrorsToCorrectBarcodesMap.single_hamming_errors_from_whitelist(whitelist)
            if whitelist is not None
            else None
        )

    def __iter__(self):
        kinds = [kind for kind in ("C", "M", "S") if self.read_structure.spans(kind)]
        for record in super().__iter__():
            barcodes = []
            for kind in kinds:
                seq = self.read_structure.extract(record.sequence, kind)
                qual = self.read_structure.extract(record.quality, kind)
                seq_tag, qual_tag = _KIND_TAGS[kind]
                barcodes.append((seq_tag, seq, "Z"))
                barcodes.append((qual_tag, qual, "Z"))
                if kind == "C" and self._error_mapping is not None:
                    try:
                        corrected = self._error_mapping.get_corrected_barcode(seq)
                        barcodes.append((consts.CELL_BARCODE_TAG_KEY, corrected, "Z"))
                    except KeyError:
                        pass
            yield barcodes


Spans = Sequence[Tuple[int, int]]


def span_len(spans: Spans) -> int:
    """Bases in ``[start, end)`` spans."""
    return sum(end - start for start, end in spans)


_CHUNK_BYTES = 1 << 22


def read_name(name_line: bytes) -> bytes:
    """A record's name as the JAX native layer reads it (native_io.h:456-459):
    without a leading '@', cut at the first space (a tab stays in it)."""
    if name_line[:1] == b"@":
        name_line = name_line[1:]
    return name_line.partition(b" ")[0]


class BatchReader:
    """The records of one or more FASTQ files, ``take(n)`` at a time.

    The JAX native layer's reading (native_io.h:234-254, :449-461): a line
    is the bytes before its ``\\n`` (nothing else is stripped), a last line
    without ``\\n`` still counts, names follow ``read_name``, and a file's
    trailing partial record (fewer than four lines) is dropped. Files are
    read one after the other as one stream of records, each file parsed on
    its own. Compression is detected from magic bytes (``reader.infer_open``);
    a file is opened when the stream reaches it.
    """

    def __init__(self, files):
        self._files = list(reader._normalize_files(files))
        self._chunks: Optional[Iterator[List[bytes]]] = None
        self._lines: List[bytes] = []
        self._pos = 0

    @staticmethod
    def _file_lines(path: str) -> Iterator[List[bytes]]:
        with reader.infer_open(path, "rb")(path) as handle:
            tail = b""
            while True:
                block = handle.read(_CHUNK_BYTES)
                if not block:
                    break
                lines = (tail + block).split(b"\n")
                tail = lines.pop()
                yield lines
            if tail:
                yield [tail]

    def _fill(self, n_lines: int) -> None:
        """Buffer at least ``n_lines`` lines, or every line that is left."""
        if self._pos:
            del self._lines[: self._pos]
            self._pos = 0
        while len(self._lines) < n_lines:
            if self._chunks is None:
                if not self._files:
                    return
                self._chunks = self._file_lines(self._files.pop(0))
            chunk = next(self._chunks, None)
            if chunk is None:  # the file is done: drop its partial record
                del self._lines[len(self._lines) - len(self._lines) % 4 :]
                self._chunks = None
            else:
                self._lines.extend(chunk)

    def take(self, n: int) -> Tuple[List[bytes], List[bytes], List[bytes]]:
        """(names, sequences, qualities) of the next ``n`` records, fewer at the end."""
        self._fill(4 * n)
        end = min(len(self._lines), 4 * n)
        block = self._lines[:end]
        self._pos = end
        return [read_name(line) for line in block[0::4]], block[1::4], block[3::4]


def iter_batches(
    files, batch_size: int
) -> Iterator[Tuple[List[bytes], List[bytes]]]:
    """(sequences, qualities) of up to ``batch_size`` records at a time
    (``BatchReader`` without the names)."""
    records = BatchReader(files)
    while True:
        _, sequences, qualities = records.take(batch_size)
        if not sequences:
            return
        yield sequences, qualities


def extract_spans(values: List[bytes], spans: Spans) -> List[bytes]:
    """The concatenated ``[start, end)`` slices of every value.

    Slices clamp to short values, so a read shorter than its spans gives a
    truncated barcode (native_io.h:404-413); correction then rejects it on
    length.
    """
    if len(spans) == 1:
        ((start, end),) = spans
        return [value[start:end] for value in values]
    return [b"".join(value[s:e] for s, e in spans) for value in values]
