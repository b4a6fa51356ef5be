"""Merge per-chunk metric CSVs, without pandas.

The port of ``sctools_tpu.metrics.merge`` (metrics/merge.py:20-144). Chunks
hold disjoint cell sets, so cell metrics concatenate; gene metrics combine:
the count columns sum per gene, the read-weighted quality moments average
with ``n_reads`` as the weights, and the three ratios are recomputed.

The JAX merge reads and writes through pandas (``read_csv(index_col=0)``,
``concat``, ``groupby(level=0)``, ``to_csv``); this module reproduces the
bytes it writes with ``csv``, ``gzip`` and numpy:

- a column parses as int64 when every field is an integer, else as float64
  through pandas' default converter (``_parse_float``, which is not
  correctly rounded at 17 significant digits), with pandas' NA spellings
  (``None`` among them) and ``inf`` spellings; anything else stays text;
- a concatenated column keeps int64 when every part is int64, is float64
  when the parts are numeric, else holds each part's values as they are;
- gene rows sort by name (``groupby(level=0)``), and a gene whose name reads
  as NA is dropped, as ``groupby`` drops NaN keys;
- int64 is written as an integer, float64 in its shortest round-trip form
  (``inf``, ``-inf``), NaN as an empty field, through ``csv.writer`` with
  the minimal quoting pandas uses;
- the first header cell is the index column's header when every input
  agrees on it, else empty.

Index values are kept as text (an all-integer index, which pandas would
parse as numbers, does not occur in barcode or gene names). The JAX merge's
audit record is observability that the port does not have.
"""

from __future__ import annotations

import csv
import gzip
import io
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

# pandas.read_csv's default NA spellings
_NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
))
# spellings of an infinity pandas' float converter accepts (case-insensitive)
_POS_INF = frozenset(("inf", "+inf", "infinity", "+infinity"))
_NEG_INF = frozenset(("-inf", "-infinity"))
_INT = re.compile(r"\s*[+-]?[0-9]+\s*\Z")
_FLOAT = re.compile(r"\s*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?)([0-9]*))?\s*\Z")
_MAX_DIGITS = 17
_POWERS = [float(f"1e{k}") for k in range(309)]


def _parse_float(text: str) -> Optional[float]:
    """pandas' default float converter (``precise_xstrtod``), or None when
    the text is not a number.

    The first 17 significant digits accumulate in a double as
    ``number * 10 + digit`` (later digits only shift the exponent), and the
    result is multiplied or divided once by the double nearest 10^|exp|.
    Up to 15 digits the accumulation is exact, so it starts from the
    integer of those.
    """
    match = _FLOAT.match(text)
    if match is None:
        lowered = text.strip().lower()
        if lowered in _POS_INF:
            return float("inf")
        if lowered in _NEG_INF:
            return float("-inf")
        return None
    sign, whole, frac, exp_sign, exp_digits = match.groups()
    frac = frac or ""
    if not whole and not frac:
        return None
    if exp_digits == "" and match.group(4) is not None:
        return None  # "1e" or "1e+": pandas un-consumes the "e" and fails
    digits = whole + frac
    exponent = len(whole) - len(digits)
    if len(digits) > _MAX_DIGITS:
        exponent += len(digits) - _MAX_DIGITS
        digits = digits[:_MAX_DIGITS]
    number = float(int(digits[:15] or "0"))
    for digit in digits[15:]:
        number = number * 10.0 + (ord(digit) - 48)
    if sign == "-":
        number = -number
    if exp_digits:
        value = int(exp_digits[:_MAX_DIGITS])
        exponent += -value if exp_sign == "-" else value
    if exponent > 308:
        return float("inf")  # the converter's HUGE_VAL, whatever the sign
    if exponent > 0:
        return number * _POWERS[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POWERS[-308 - exponent] / _POWERS[308]
    return number / _POWERS[-exponent]


class _Column:
    """One parsed column: ``kind`` "i" (int64), "f" (float64) or "O" (a
    list of str / int / float values, NaN for NA)."""

    def __init__(self, kind: str, values):
        self.kind = kind
        self.values = values

    @classmethod
    def parse(cls, texts: Sequence[str]) -> "_Column":
        if not texts:
            return cls("O", [])
        if all(_INT.match(text) for text in texts):
            return cls("i", np.array([int(text) for text in texts], dtype=np.int64))
        floats = [np.nan if text in _NA_VALUES else _parse_float(text) for text in texts]
        if all(value is not None for value in floats):
            return cls("f", np.array(floats, dtype=np.float64))
        return cls("O", [np.nan if text in _NA_VALUES else text for text in texts])

    def objects(self) -> list:
        return list(self.values) if self.kind == "O" else self.values.tolist()

    @classmethod
    def concat(cls, parts: Sequence["_Column"]) -> "_Column":
        kinds = {part.kind for part in parts}
        if kinds == {"i"}:
            return cls("i", np.concatenate([part.values for part in parts]))
        if kinds <= {"i", "f"}:
            return cls("f", np.concatenate([part.values.astype(np.float64) for part in parts]))
        return cls("O", [value for part in parts for value in part.objects()])

    def texts(self) -> List[str]:
        """The column as ``to_csv`` writes it."""
        if self.kind == "i":
            return self.values.astype(str).tolist()
        if self.kind == "f":
            out = self.values.astype(str)
            out[np.isnan(self.values)] = ""
            return out.tolist()
        return ["" if isinstance(value, float) and value != value else str(value)
                for value in self.values]


class _Table:
    """A metric CSV read as pandas reads it with ``index_col=0``."""

    def __init__(self, index_name: str, index: list, names: List[str], columns: List[_Column]):
        self.index_name = index_name
        self.index = index  # str, or None where the name reads as NA
        self.names = names
        self.columns = columns

    def __len__(self) -> int:
        return len(self.index)

    @classmethod
    def read(cls, path: str) -> "_Table":
        # compression follows the file name, as pandas infers it
        with gzip.open(path, "rt", newline="") if path.endswith(".gz") else open(path, newline="") as f:
            rows = [row for row in csv.reader(f) if row]
        header, body = rows[0], rows[1:]
        width = len(header)
        body = [row + [""] * (width - len(row)) for row in body]
        index = [None if row[0] in _NA_VALUES else row[0] for row in body]
        columns = [_Column.parse([row[j] for row in body]) for j in range(1, width)]
        return cls(header[0], index, header[1:], columns)

    def column(self, name: str) -> _Column:
        return self.columns[self.names.index(name)]

    def aligned(self, name: str) -> _Column:
        """The named column, or all NaN where this table lacks it."""
        if name in self.names:
            return self.column(name)
        return _Column("f", np.full(len(self), np.nan))

    @classmethod
    def concat(cls, tables: Sequence["_Table"]) -> "_Table":
        """``pd.concat`` on rows: columns align by name, in the order they
        first appear."""
        names = list(tables[0].names)
        for table in tables[1:]:
            names += [name for name in table.names if name not in names]
        index_names = {table.index_name for table in tables}
        return cls(
            index_names.pop() if len(index_names) == 1 else "",
            [name for table in tables for name in table.index],
            names,
            [_Column.concat([table.aligned(name) for table in tables]) for name in names],
        )

    def write(self, path: str) -> None:
        buffer = io.StringIO()
        writer = csv.writer(buffer, lineterminator="\n")
        writer.writerow([self.index_name] + self.names)
        texts = [column.texts() for column in self.columns]
        index = ["" if name is None else name for name in self.index]
        writer.writerows(zip(index, *texts))
        with gzip.open(path, "wb") as f:
            f.write(buffer.getvalue().encode())


class MergeMetrics:
    """Merges multiple metrics files into one gzip-compressed csv."""

    def __init__(self, metric_files: Sequence[str], output_file: str):
        self._metric_files = metric_files
        if not output_file.endswith(".csv.gz"):
            output_file += ".csv.gz"
        self._output_file = output_file

    def execute(self) -> None:
        raise NotImplementedError


class MergeCellMetrics(MergeMetrics):
    def execute(self) -> None:
        """Concatenate cell metric files (cell sets are disjoint by construction)."""
        _Table.concat([_Table.read(f) for f in self._metric_files]).write(self._output_file)


class MergeGeneMetrics(MergeMetrics):
    COUNT_COLUMNS_TO_SUM = [
        "n_reads",
        "noise_reads",
        "perfect_molecule_barcodes",
        "reads_mapped_exonic",
        "reads_mapped_intronic",
        "reads_mapped_utr",
        "reads_mapped_uniquely",
        "reads_mapped_multiple",
        "duplicate_reads",
        "spliced_reads",
        "antisense_reads",
        "n_molecules",
        "n_fragments",
        "fragments_with_single_read_evidence",
        "molecules_with_single_read_evidence",
        "number_cells_detected_multiple",
        "number_cells_expressing",
    ]

    READ_WEIGHTED_COLUMNS = [
        "molecule_barcode_fraction_bases_above_30_mean",
        "molecule_barcode_fraction_bases_above_30_variance",
        "genomic_reads_fraction_bases_quality_above_30_mean",
        "genomic_reads_fraction_bases_quality_above_30_variance",
        "genomic_read_quality_mean",
        "genomic_read_quality_variance",
    ]

    def _merge_pair(self, nucleus: _Table, leaf: _Table) -> _Table:
        """Merge one chunk into the running result."""
        both = _Table.concat([nucleus, leaf])
        groups = _groups(both.index)
        keys = [key for key, _ in groups]
        columns = [_group_sum(both.column(c), groups) for c in self.COUNT_COLUMNS_TO_SUM]
        weights = both.column("n_reads")
        columns += [
            _Column("f", _weighted_average(both.column(c), weights, groups))
            for c in self.READ_WEIGHTED_COLUMNS
        ]
        by_name = dict(zip(self.COUNT_COLUMNS_TO_SUM, columns))
        with np.errstate(divide="ignore", invalid="ignore"):
            for name, top, bottom in (
                ("reads_per_molecule", "n_reads", "n_molecules"),
                ("fragments_per_molecule", "n_fragments", "n_molecules"),
                ("reads_per_fragment", "n_reads", "n_fragments"),
            ):
                ratio = by_name[top].values.astype(np.float64) / by_name[bottom].values.astype(np.float64)
                columns.append(_Column("f", ratio))
        names = (
            self.COUNT_COLUMNS_TO_SUM
            + self.READ_WEIGHTED_COLUMNS
            + ["reads_per_molecule", "fragments_per_molecule", "reads_per_fragment"]
        )
        return _Table(both.index_name, keys, list(names), columns)

    def execute(self) -> None:
        """Incrementally fold each chunk file into the merged result."""
        nucleus = _Table.read(self._metric_files[0])
        for filename in self._metric_files[1:]:
            nucleus = self._merge_pair(nucleus, _Table.read(filename))
        nucleus.write(self._output_file)


def _groups(index: list) -> List[Tuple[str, np.ndarray]]:
    """(name, row positions in order) per name, names sorted; NA names
    (None) are dropped, as ``groupby(level=0)`` drops NaN keys."""
    rows = {}
    for position, name in enumerate(index):
        if name is not None:
            rows.setdefault(name, []).append(position)
    return [(name, np.asarray(rows[name], dtype=np.int64)) for name in sorted(rows)]


def _group_sum(column: _Column, groups) -> _Column:
    """``groupby.sum``: int64 sums, or float64 sums that skip NaN with
    pandas' compensated (Kahan) summation."""
    if column.kind == "i":
        if not groups:
            return _Column("i", np.zeros(0, dtype=np.int64))
        order = np.concatenate([rows for _, rows in groups])
        starts = np.cumsum([0] + [rows.size for _, rows in groups[:-1]])
        return _Column("i", np.add.reduceat(column.values[order], starts))
    if column.kind != "f":
        raise ValueError("a gene count column is not numeric")
    out = np.zeros(len(groups), dtype=np.float64)
    for g, (_, rows) in enumerate(groups):
        total = compensation = 0.0
        for value in column.values[rows].tolist():
            if value != value:
                continue
            y = value - compensation
            t = total + y
            compensation = t - total - y
            if compensation != compensation:
                compensation = 0.0
            total = t
        out[g] = total
    return _Column("f", out)


def _weighted_average(column: _Column, weights: _Column, groups) -> np.ndarray:
    """Per group, ``np.average(values, weights=n_reads)``, as the JAX merge
    computes it. Raises ZeroDivisionError when a group's weights sum to
    zero, as ``np.average`` does."""
    if column.kind == "O" or weights.kind == "O":
        raise ValueError("a gene metric column is not numeric")
    values, w = column.values, weights.values
    return np.array(
        [np.average(values[rows], weights=w[rows]) for _, rows in groups], dtype=np.float64
    )
