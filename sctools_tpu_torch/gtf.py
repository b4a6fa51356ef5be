"""GTF parsing: a columnar table core with record views and gene extractors.

The port's own copy of ``sctools_tpu.gtf``. ``CalculateCellMetrics -a`` (the
mitochondrial gene set) and ``CreateCountMatrix -a`` (the gene axis) run on
the columnar :class:`GTFTable`: lines parse once into numpy object arrays
per field, and attributes stay raw strings, decoded by regex only for the
keys a caller asks for. The library's record API sits beside it:
:class:`GTFRecord` (one line, its attributes decoded on first access),
:class:`Reader` with ``filter``, and the per-chromosome interval
extractors ``extract_extended_gene_names`` and ``extract_gene_exons``.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Dict, Generator, Iterable, List, Optional, Set, Tuple, Union

import numpy as np

from . import reader

_logger = logging.getLogger(__name__)

_MITO_PATTERN = re.compile(r"^mt-", re.IGNORECASE)


def _attribute_pattern(key: str) -> re.Pattern:
    # key <space> "value"  (value may be unquoted in permissive producers)
    return re.compile(rf'(?:^|;)\s*{re.escape(key)} "?([^";]*)"?')


class GTFRecord:
    """View of one GTF line: 8 fixed fields + lazily decoded attributes."""

    __slots__ = ("_fields", "_raw_attributes", "_attributes")

    def __init__(self, line: str):
        parts = line.rstrip("\n").rstrip(";").split("\t")
        self._fields: Tuple[str, ...] = tuple(parts[:8])
        self._raw_attributes: str = parts[8] if len(parts) > 8 else ""
        self._attributes: Optional[Dict[str, str]] = None

    # -- attributes (decoded on first access) ------------------------------

    def _ensure_attributes(self) -> Dict[str, str]:
        if self._attributes is None:
            decoded: Dict[str, str] = {}
            for chunk in self._raw_attributes.split(";"):
                chunk = chunk.strip()
                if not chunk:
                    continue
                key, _, value = chunk.partition(" ")
                decoded[key] = value.strip('"')
            self._attributes = decoded
        return self._attributes

    def get_attribute(self, key: str) -> Optional[str]:
        return self._ensure_attributes().get(key)

    def set_attribute(self, key: str, value: str) -> None:
        self._ensure_attributes()[key] = value

    # -- fixed fields ------------------------------------------------------

    seqname = property(lambda self: self._fields[0])
    chromosome = property(lambda self: self._fields[0])
    source = property(lambda self: self._fields[1])
    feature = property(lambda self: self._fields[2])
    score = property(lambda self: self._fields[5])
    strand = property(lambda self: self._fields[6])
    frame = property(lambda self: self._fields[7])

    @property
    def start(self) -> int:
        return int(self._fields[3])

    @property
    def end(self) -> int:
        return int(self._fields[4])

    @property
    def size(self) -> int:
        if self.end < self.start:
            raise ValueError(f"Invalid record: negative size {self.end - self.start}")
        return self.end - self.start

    def __str__(self) -> str:
        attrs = " ".join(f'{key} "{value}";' for key, value in self._ensure_attributes().items())
        return "\t".join(self._fields) + attrs + "\n"

    def __bytes__(self) -> bytes:
        return str(self).encode()

    def __repr__(self) -> str:
        return f"<Record: {self}>"

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other) -> bool:
        return isinstance(other, GTFRecord) and str(self) == str(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


class Reader(reader.Reader):
    """Line reader yielding GTFRecord views; '#' header lines skipped."""

    def __init__(self, files="-", mode="r", header_comment_char="#"):
        super().__init__(files, mode, header_comment_char)

    def __iter__(self):
        for line in super().__iter__():
            yield GTFRecord(line)

    def filter(self, retain_types: Iterable[str]) -> Generator:
        """Yield only records whose feature column is in ``retain_types``."""
        wanted = set(retain_types)
        return (record for record in self if record.feature in wanted)


# ---------------------------------------------------------------- columnar


@dataclass
class GTFTable:
    """All records of one feature type as columns."""

    chromosome: np.ndarray  # object
    start: np.ndarray  # int64
    end: np.ndarray  # int64
    attributes: np.ndarray  # object (raw attribute strings)

    def __len__(self) -> int:
        return len(self.chromosome)

    def attribute_column(self, key: str, required: bool = False) -> np.ndarray:
        """Decode one attribute key across all rows (None when absent)."""
        pattern = _attribute_pattern(key)
        out = np.empty(len(self), dtype=object)
        for i, raw in enumerate(self.attributes):
            match = pattern.search(raw)
            if match is None:
                if required:
                    raise ValueError(
                        f"Malformed GTF file detected. Record is of type "
                        f'gene but does not have a "{key}" field: '
                        f"{self.chromosome[i]}:{self.start[i]}-{self.end[i]}"
                    )
                out[i] = None
            else:
                out[i] = match.group(1)
        return out


def read_table(
    files: Union[str, List[str]] = "-",
    mode: str = "r",
    header_comment_char: str = "#",
    feature: str = "gene",
) -> GTFTable:
    """Parse a GTF line stream into columns, keeping one feature type."""
    chromosomes: List[str] = []
    starts: List[int] = []
    ends: List[int] = []
    attributes: List[str] = []
    for line in reader.Reader(files, mode, header_comment_char):
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 9 or parts[2] != feature:
            continue
        chromosomes.append(parts[0])
        starts.append(int(parts[3]))
        ends.append(int(parts[4]))
        attributes.append(parts[8])
    return GTFTable(
        chromosome=np.asarray(chromosomes, dtype=object),
        start=np.asarray(starts, dtype=np.int64),
        end=np.asarray(ends, dtype=np.int64),
        attributes=np.asarray(attributes, dtype=object),
    )


def _first_occurrence_filter(names: np.ndarray) -> np.ndarray:
    """Boolean mask keeping the first row of each name; warn on repeats."""
    seen: Set[str] = set()
    keep = np.zeros(len(names), dtype=bool)
    for i, name in enumerate(names):
        if name in seen:
            _logger.warning(
                f'Multiple entries encountered for "{name}". Please validate '
                f"the input GTF file(s). Skipping the record for now; in the "
                f"future, this will be considered as a malformed GTF file."
            )
            continue
        seen.add(name)
        keep[i] = True
    return keep


def extract_gene_names(
    files: Union[str, List[str]] = "-", mode: str = "r", header_comment_char: str = "#"
) -> Dict[str, int]:
    """Map each gene_name to its occurrence order (the count-matrix column)."""
    table = read_table(files, mode, header_comment_char, feature="gene")
    names = table.attribute_column("gene_name", required=True)
    keep = _first_occurrence_filter(names)
    return {name: index for index, name in enumerate(names[keep])}


def get_mitochondrial_gene_names(
    files: Union[str, List[str]] = "-", mode: str = "r", header_comment_char: str = "#"
) -> Set[str]:
    """gene_ids of records whose gene_name matches ^mt- (case-insensitive)."""
    table = read_table(files, mode, header_comment_char, feature="gene")
    names = table.attribute_column("gene_name", required=True)
    gene_ids = table.attribute_column("gene_id")
    is_mito = np.fromiter(
        (_MITO_PATTERN.match(name) is not None for name in names),
        dtype=bool,
        count=len(names),
    )
    return set(gene_ids[is_mito])


def _intervals_by_chromosome(table: GTFTable, names: np.ndarray) -> Dict[str, List[tuple]]:
    """[( (start, end), name )] per chromosome in first-seen order, sorted
    by interval."""
    out: Dict[str, List[tuple]] = {}
    for chromosome in dict.fromkeys(table.chromosome):  # first-seen order
        rows = np.nonzero(table.chromosome == chromosome)[0]
        entries = [((int(table.start[i]), int(table.end[i])), names[i]) for i in rows]
        entries.sort(key=lambda item: item[0])
        out[chromosome] = entries
    return out


def extract_extended_gene_names(
    files: Union[str, List[str]] = "-", mode: str = "r", header_comment_char: str = "#"
) -> Dict[str, List[tuple]]:
    """Per chromosome, [( (start, end), gene_name )] sorted by position."""
    table = read_table(files, mode, header_comment_char, feature="gene")
    names = table.attribute_column("gene_name", required=True)
    keep = _first_occurrence_filter(names)
    table = GTFTable(
        chromosome=table.chromosome[keep],
        start=table.start[keep],
        end=table.end[keep],
        attributes=table.attributes[keep],
    )
    return _intervals_by_chromosome(table, names[keep])


def extract_gene_exons(
    files: Union[str, List[str]] = "-", mode: str = "r", header_comment_char: str = "#"
) -> Dict[str, List[tuple]]:
    """Per chromosome, [(exon_interval_list, gene_name)] sorted by exons."""
    table = read_table(files, mode, header_comment_char, feature="exon")
    names = table.attribute_column("gene_name", required=True)
    out: Dict[str, List[tuple]] = {}
    for chromosome in dict.fromkeys(table.chromosome):
        rows = np.nonzero(table.chromosome == chromosome)[0]
        per_gene: Dict[str, List[tuple]] = {}
        for i in rows:
            per_gene.setdefault(names[i], []).append((int(table.start[i]), int(table.end[i])))
        entries = [(exons, name) for name, exons in per_gene.items()]
        entries.sort(key=lambda item: item[0])
        out[chromosome] = entries
    return out
