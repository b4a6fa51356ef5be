"""GTF parsing for the metrics path: the mitochondrial gene set.

The port's own copy of the part of ``sctools_tpu.gtf`` that
``CalculateCellMetrics -a`` runs: lines parse once into a columnar
:class:`GTFTable` (numpy object arrays per field), and attributes stay raw
strings, decoded by regex only for the keys a caller asks for.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Set, Union

import numpy as np

from . import reader

_MITO_PATTERN = re.compile(r"^mt-", re.IGNORECASE)


def _attribute_pattern(key: str) -> re.Pattern:
    # key <space> "value"  (value may be unquoted in permissive producers)
    return re.compile(rf'(?:^|;)\s*{re.escape(key)} "?([^";]*)"?')


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
