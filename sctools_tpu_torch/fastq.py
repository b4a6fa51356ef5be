"""FASTQ records and readers, barcode geometry, and batched span extraction.

The port's own copy of the host parts of ``sctools_tpu.fastq``: the 4-line
``Record``/``Reader``, ``EmbeddedBarcode`` and the ``ReadStructure`` DSL.
The per-record tag generators of the JAX package's Python route are not
copied: the port's attach loop (``sctools_tpu_torch.attach``) reads r1/i1 in
batches through ``iter_batches`` and slices every barcode span of a batch at
once with ``extract_spans``, the way the JAX native layer does
(sctools_tpu/native/native_io.h:404-461).
"""

import itertools
from collections import namedtuple
from typing import AnyStr, Iterable, Iterator, List, Sequence, Tuple

from . import reader

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


Spans = Sequence[Tuple[int, int]]


def iter_batches(
    files, batch_size: int
) -> Iterator[Tuple[List[bytes], List[bytes]]]:
    """(sequences, qualities) of up to ``batch_size`` records at a time.

    Lines are bytes with the line terminator removed, nothing else: the
    JAX native layer's reading (native_io.h:450-461). A trailing partial
    record (fewer than four lines) is dropped, as both JAX routes drop it.
    """
    lines = iter(reader.Reader(files, mode="rb"))
    while True:
        chunk = list(itertools.islice(lines, 4 * batch_size))
        chunk = chunk[: len(chunk) - len(chunk) % 4]
        if not chunk:
            return
        sequences = [line.rstrip(b"\n") for line in chunk[1::4]]
        qualities = [line.rstrip(b"\n") for line in chunk[3::4]]
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
