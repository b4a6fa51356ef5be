"""Aggregation of external QC outputs (Picard, HISAT2, RSEM) for SS2 pipelines.

The port of ``sctools_tpu.groups`` without pandas. Picard metric files are
parsed directly (``## METRICS CLASS`` section, tab-separated, numbers
coerced), and the five writers give the bytes the JAX package's pandas
calls write (``DataFrame.from_dict`` / ``insert`` / ``.T`` / ``to_csv``,
``read_csv`` / ``concat(axis=1, join="outer")``), by these rules:

- a table column takes pandas' type from its values, missing ones
  included: all integers -> int64; numbers and missing values -> float64,
  whose integers print as ``1.0``; any string -> object, whose values print
  as ``str`` gives them (integers as ``3``);
- float64 prints in its shortest round-trip form, a missing value as an
  empty field, through ``csv.writer`` with pandas' minimal quoting;
- rows and columns keep the order in which their keys first appear;
- ``Core`` reads each CSV as ``read_csv(index_col=0)`` does (the index and
  every column typed alike: int64, float64, bool spellings, else text, with
  pandas' NA spellings; empty and repeated header names renamed), and joins
  them as the outer ``concat`` does: index values in first-seen order, a
  later file's new rows after the earlier ones, and a column that gains a
  missing row turns int64 into float64. The index header is the one every
  file agrees on, else empty.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .metrics.merge import _NA_VALUES, _Column

_DROP_KEYS = ("SAMPLE", "LIBRARY", "READ_GROUP", "CATEGORY")
# read_csv's default bool spellings
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))


def _coerce(value: str):
    if value == "" or value == "?":
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def parse_picard_metrics(file_name: str) -> Dict:
    """Parse a Picard metrics file's METRICS CLASS section.

    Returns {"metrics": {"class": <java class name>, "contents": dict |
    list[dict]}}: a single data row gives a dict, several rows a list.
    """
    class_name: Optional[str] = None
    header: Optional[List[str]] = None
    rows: List[Dict] = []
    with open(file_name) as fileobj:
        in_metrics = False
        for line in fileobj:
            line = line.rstrip("\n")
            if line.startswith("## METRICS CLASS"):
                class_name = line.split("\t", 1)[1].strip()
                in_metrics = True
                continue
            if not in_metrics:
                continue
            if line.startswith("##") or line == "":
                if rows or header:
                    break  # end of metrics section (histogram follows)
                continue
            fields = line.split("\t")
            if header is None:
                header = fields
            else:
                rows.append({k: _coerce(v) for k, v in zip(header, fields)})
    if class_name is None:
        raise ValueError(f"{file_name}: no '## METRICS CLASS' section found")
    contents: Union[Dict, List[Dict]] = rows[0] if len(rows) == 1 else rows
    return {"metrics": {"class": class_name, "contents": contents}}


# ------------------------------------------------------------ table model


def _column(values: Sequence) -> _Column:
    """Python values (None = missing) as the column pandas infers for them."""
    present = [v for v in values if v is not None]
    numbers = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if numbers and len(present) == len(values) and all(isinstance(v, int) for v in present):
        return _Column("i", np.array(values, dtype=np.int64))
    if numbers and present:
        return _Column("f", np.array([np.nan if v is None else v for v in values], dtype=np.float64))
    return _Column("O", [np.nan if v is None else v for v in values])


def _union(groups: Sequence[Sequence[str]]) -> List[str]:
    """Keys in the order they first appear."""
    return list(dict.fromkeys(key for group in groups for key in group))


def _write_csv(path: str, header: List[str], rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def _write_transposed(path: str, metrics: Dict[str, Dict], class_of: Union[str, Dict]) -> None:
    """``DataFrame.from_dict(metrics)`` with ``Class`` inserted first (one
    name, or one per metric), then ``.T.to_csv``: one row per entity, its
    values typed as one column."""
    keys = _union(list(metrics.values()))
    rows = [["Class"] + [class_of if isinstance(class_of, str) else class_of[key] for key in keys]]
    for name, values in metrics.items():
        texts = _column([values.get(key) for key in keys]).texts()
        rows.append([name] + texts)
    _write_csv(path, [""] + keys, rows)


# ---------------------------------------------------------------- writers


def write_aggregated_picard_metrics_by_row(file_names, output_name) -> None:
    """Aggregate per-cell Picard row metrics into one CSV.

    Input basenames look like 'samplename_qc.<class>.txt'.
    AlignmentSummaryMetrics rows are flattened per CATEGORY (key
    '<METRIC>.<CATEGORY>'); multi-line InsertSizeMetrics keep the first
    line.
    """
    metrics: Dict[str, Dict] = {}
    metric_class: Dict[str, str] = {}
    for file_name in file_names:
        cell_id = os.path.basename(file_name).split("_qc")[0]
        metrics.setdefault(cell_id, {})
        parsed = parse_picard_metrics(file_name)
        class_name = parsed["metrics"]["class"].split(".")[2]
        contents = parsed["metrics"]["contents"]
        if class_name == "AlignmentSummaryMetrics":
            # unpaired runs yield one dict; paired runs one entry per
            # CATEGORY (PAIR/R1/R2), flattened here into suffixed keys
            category_rows = contents if isinstance(contents, list) else [contents]
            rows = {}
            for row in category_rows:
                suffix = "." + row["CATEGORY"]
                for key, value in row.items():
                    if key not in _DROP_KEYS:
                        rows[key + suffix] = value
        elif class_name == "InsertSizeMetrics":
            rows = contents[0] if isinstance(contents, list) else contents
        else:
            rows = contents
        row_values = {k: v for k, v in rows.items() if k not in _DROP_KEYS}
        metrics[cell_id].update(row_values)
        for key in row_values:
            metric_class.setdefault(key, class_name)
    _write_transposed(output_name + ".csv", metrics, metric_class)


def write_aggregated_picard_metrics_by_table(file_names, output_name) -> None:
    """One CSV per Picard table-metrics file, named by metrics class."""
    for file_name in file_names:
        cell_id = os.path.basename(file_name).split("_qc")[0]
        class_name = os.path.basename(file_name).split(".")[1]
        parsed = parse_picard_metrics(file_name)
        contents = parsed["metrics"]["contents"]
        if isinstance(contents, dict):
            contents = [contents]
        names = _union(contents)
        columns = [_column([row.get(name) for row in contents]).texts() for name in names]
        rows = [[cell_id] + [column[i] for column in columns] for i in range(len(contents))]
        _write_csv(output_name + "_" + class_name + ".csv", ["Sample"] + names, rows)


def write_aggregated_qc_metrics(file_names, output_name) -> None:
    """Outer-join previously aggregated QC CSVs column-wise."""
    index_names = set()
    index: Optional[list] = None
    index_kinds: set = set()
    names: List[str] = []
    columns: List[_Column] = []
    for file_name in file_names:
        table = _QcTable.read(file_name)
        index_names.add(table.index_name)
        index_kinds.add(table.index_kind)
        added = table.columns
        if index is None:
            index = table.index
        elif index != table.index:
            for keys in (index, table.index):
                if len(set(keys)) != len(keys):
                    raise ValueError("Reindexing only valid with uniquely valued Index objects")
            seen = set(index)
            union = index + [key for key in table.index if key not in seen]
            columns = [_reindex(column, index, union) for column in columns]
            added = [_reindex(column, table.index, union) for column in table.columns]
            index = union
        names += table.names
        columns += added
    index_kind = "i" if index_kinds == {"i"} else "f" if index_kinds <= {"i", "f"} else "O"
    index_texts = _Column(index_kind, np.array(index) if index_kind != "O" else index).texts()
    header = [index_names.pop() if len(index_names) == 1 else ""] + names
    _write_csv(
        output_name + ".csv", header,
        zip(index_texts, *(column.texts() for column in columns)),
    )


def parse_hisat2_log(file_names, output_name) -> None:
    """Aggregate HISAT2 alignment summaries; '_qc' logs are genome
    alignments (HISAT2G), '_rsem' logs transcriptome (HISAT2T)."""
    metrics: Dict[str, Dict] = {}
    tag = "NONE"
    for file_name in file_names:
        base = os.path.basename(file_name)
        if "_qc" in file_name:
            cell_id, tag = base.split("_qc")[0], "HISAT2G"
        elif "_rsem" in file_name:
            cell_id, tag = base.split("_rsem")[0], "HISAT2T"
        else:
            cell_id = base
        with open(file_name) as fileobj:
            sections = [x.strip().split(":") for x in fileobj]
        del sections[0]  # the section's first row is a header
        metrics[cell_id] = {
            parts[0]: parts[1].strip().split(" ")[0] for parts in sections if len(parts) > 1
        }
    _write_transposed(output_name + ".csv", metrics, tag)


def parse_rsem_cnt(file_names, output_name) -> None:
    """Aggregate RSEM .cnt statistics per cell."""
    # row labels in output order; .cnt line 1 = alignability counts,
    # line 2 = multimapping counts, line 3 = hit total + strandedness
    row_labels = (
        "unalignable reads", "alignable reads", "filtered reads",
        "total reads", "unique aligned", "multiple mapped",
        "total alignments", "strand", "uncertain reads",
    )
    metrics: Dict[str, Dict] = {}
    for file_name in file_names:
        cell_id = os.path.basename(file_name).split("_rsem")[0]
        with open(file_name) as fileobj:
            n0, n1, n2, n_tot = fileobj.readline().split()
            n_unique, n_multi, n_uncertain = fileobj.readline().split()
            n_hits, read_type = fileobj.readline().split()
        metrics[cell_id] = dict(
            zip(
                row_labels,
                (n0, n1, n2, n_tot, n_unique, n_multi, n_hits, read_type, n_uncertain),
            )
        )
    _write_transposed(output_name + ".csv", metrics, "RSEM")


# ------------------------------------------------------- the Core join


def _parse(texts: Sequence[str]) -> _Column:
    """One CSV column as ``read_csv`` types it: bool spellings become
    True/False (object, like a bool column once it holds NaN), else
    ``merge._Column.parse``."""
    present = [text for text in texts if text not in _NA_VALUES]
    if present and all(text in _TRUE or text in _FALSE for text in present):
        return _Column("O", [np.nan if text in _NA_VALUES else text in _TRUE for text in texts])
    return _Column.parse(texts)


def _reindex(column: _Column, index: list, union: list) -> _Column:
    """The column on the rows of ``union``; a row it lacks is missing, and
    an int64 column with a missing row becomes float64."""
    position = {key: i for i, key in enumerate(index)}
    rows = [position.get(key) for key in union]
    values = column.objects()
    if None not in rows:
        picked = [values[i] for i in rows]
        kind = column.kind
    else:
        picked = [np.nan if i is None else values[i] for i in rows]
        kind = "O" if column.kind == "O" else "f"
    return _Column(kind, picked if kind == "O" else np.array(picked, dtype=np.int64 if kind == "i" else np.float64))


class _QcTable:
    """A QC CSV read as ``read_csv(index_col=0)`` reads it."""

    def __init__(self, index_name: str, index: list, index_kind: str, names, columns):
        self.index_name = index_name
        self.index = index
        self.index_kind = index_kind
        self.names = names
        self.columns = columns

    @classmethod
    def read(cls, path: str) -> "_QcTable":
        with open(path, newline="") as f:
            rows = [row for row in csv.reader(f) if row]
        header, body = rows[0], rows[1:]
        width = len(header)
        body = [row + [""] * (width - len(row)) for row in body]
        labels = [name or f"Unnamed: {i}" for i, name in enumerate(header)]
        index = _parse([row[0] for row in body])
        return cls(
            header[0],
            index.objects(),
            index.kind,
            _dedup(labels[1:]),
            [_parse([row[j] for row in body]) for j in range(1, width)],
        )


def _dedup(names: List[str]) -> List[str]:
    """pandas' renaming of repeated column names: ``x``, ``x.1``, ``x.2``."""
    names = list(names)
    counts: Dict[str, int] = {}
    for i, name in enumerate(names):
        count = counts.get(name, 0)
        while count > 0:
            counts[name] = count + 1
            name = f"{name}.{count}"
            count = counts.get(name, 0)
        names[i] = name
        counts[name] = count + 1
    return names
