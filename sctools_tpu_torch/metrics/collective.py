"""The metric merges with their data plane on the device mesh.

The port of ``sctools_tpu.metrics.collective``'s class-level merges
(metrics/collective.py:74-290, :452-596), on the port's pandas-free
``metrics.merge`` tables:

- every part's numeric columns go to the mesh as raw int32 *lanes*
  (int64 and float64 columns as bit-pattern pairs), parts round-robined
  over the shards, so the collective is pure data movement and bit-exact;
- one ``all_gather`` brings every shard's rows to every device (the
  concatenation of the file-level merge), and for gene metrics one
  ``psum`` reduces a dense ``[gene vocabulary, count columns]`` int32
  accumulator: integer addition is exact, so it equals the host's sums;
- one pull brings the merged block back; the host decodes the lanes and
  writes through the file-level merge's own table code.

``CollectiveMergeCellMetrics`` equals ``MergeCellMetrics`` byte for byte
(the same mixed int/float column upcast). ``CollectiveMergeGeneMetrics``
equals ``MergeGeneMetrics``: the count columns come from the ``psum``, the
float64 read-weighted moments and ratios from the file-level fold on the
host over the gathered rows (float64 stays a host dtype; the device carries
those columns as opaque lanes), and the fold's count sums must equal the
device's before the output is written. The int32 lanes refuse sums that
overflow, within one shard and across shards.

One difference from the JAX package: a gene whose name reads as NA
(``None``, which the gatherer writes for records without GE) makes JAX's
vocabulary sort raise ``TypeError``; here it joins no count slot and the
fold drops it, as ``MergeGeneMetrics`` does. Not ported: the merges'
audit records.

``collective_merge_parts`` (metrics/collective.py:288-450) is the
gatherer-part merge of ``parallel.launch.merge_sorted_csv_parts`` with the
same validation and the same output bytes: the parts' numeric values go
through the same lanes and ``all_gather``, and the host renders the pulled
values with ``str()``, the writer's own format. That is byte-identical
because every value of a gatherer part round-trips through ``str()``; a
value that does not, or a ragged row, is refused with JAX's message.
"""

from __future__ import annotations

import gzip
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import ingest
from ..ops import segments as seg
from ..parallel import collective
from ..parallel.mesh import Mesh, make_mesh
from ..sched import atomic_output
from ..sched.parts import validated_parts
from .merge import MergeGeneMetrics, MergeMetrics, _Column, _Table

_INT_TEXT = re.compile(r"^-?\d+$")
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _encode_lanes(columns: Sequence[np.ndarray]) -> np.ndarray:
    """[rows, 2 * n_columns] int32 bit-lane matrix of int64 / float64
    columns; the device never interprets the lanes."""
    rows = len(columns[0]) if columns else 0
    lanes = np.empty((rows, 2 * len(columns)), dtype=np.int32)
    for index, column in enumerate(columns):
        if column.dtype not in (np.float64, np.int64):
            raise ValueError(f"collective merge carries int64/float64 columns only, got {column.dtype}")
        lanes[:, 2 * index : 2 * index + 2] = column.view(np.int32).reshape(rows, 2)
    return lanes


def _decode_lanes(lanes: np.ndarray, dtypes: Sequence[np.dtype]) -> List[np.ndarray]:
    """Inverse of ``_encode_lanes`` (bit-exact)."""
    out: List[np.ndarray] = []
    for index, dtype in enumerate(dtypes):
        raw = np.ascontiguousarray(lanes[:, 2 * index : 2 * index + 2])
        out.append(raw.view(np.int64).reshape(-1).view(dtype).copy())
    return out


def _stack_shards(n_shards: int, part_lanes: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[List[int]], int]:
    """Round-robin parts over the shards into one [S, R, L] block; returns
    it, the parts each shard carries in concatenation order, and the
    power-of-two row bucket R."""
    assignment: List[List[int]] = [[] for _ in range(n_shards)]
    for part_index in range(len(part_lanes)):
        assignment[part_index % n_shards].append(part_index)
    shard_rows = [sum(part_lanes[p].shape[0] for p in parts) for parts in assignment]
    rows_bucket = seg.bucket_size(max(max(shard_rows), 1), minimum=8)
    n_lanes = part_lanes[0].shape[1] if part_lanes else 0
    stacked = np.zeros((n_shards, rows_bucket, n_lanes), dtype=np.int32)
    for shard, parts in enumerate(assignment):
        cursor = 0
        for p in parts:
            block = part_lanes[p]
            stacked[shard, cursor : cursor + block.shape[0]] = block
            cursor += block.shape[0]
    return stacked, assignment, rows_bucket


def _gathered_part_rows(gathered: np.ndarray, assignment, part_rows) -> List[np.ndarray]:
    """Slice the pulled [S, R, L] block back into per-part row blocks."""
    out: List[Optional[np.ndarray]] = [None] * len(part_rows)
    for shard, parts in enumerate(assignment):
        cursor = 0
        for p in parts:
            out[p] = gathered[shard, cursor : cursor + part_rows[p]]
            cursor += part_rows[p]
    return [block for block in out if block is not None]


def _merge_mesh(mesh: Optional[Mesh]) -> Mesh:
    """The merge mesh: the caller's, or one over every CUDA device."""
    return mesh if mesh is not None else make_mesh()


def _device_gather_parts(
    mesh: Mesh,
    part_columns: List[List[np.ndarray]],
    counts: Optional[np.ndarray] = None,
) -> Tuple[List[List[np.ndarray]], Optional[np.ndarray]]:
    """Ship every part's 8-byte columns through the mesh gather.

    Returns ``(per_part_columns, summed)``: the columns decoded bit-exactly
    from the pulled block and, when ``counts`` (an ``[n_shards, vocab,
    n_counts]`` int32 accumulator) rides along, the ``psum``-reduced
    ``[vocab, n_counts]`` totals (else None). Every part must have the same
    dtype layout (callers unify it first).
    """
    dtypes = [c.dtype for c in part_columns[0]]
    part_lanes = [_encode_lanes(cols) for cols in part_columns]
    part_rows = [lanes.shape[0] for lanes in part_lanes]
    stacked, assignment, _ = _stack_shards(mesh.size, part_lanes)
    axis = tuple(mesh.axis_names)  # every shard, on any mesh
    shards = [ingest.upload(stacked[s], device) for s, device in enumerate(mesh.devices)]
    # [R, L] local blocks -> [S, R, L] on every shard
    gathered = collective.all_gather(shards, mesh, axis)
    if counts is None:
        pulled = ingest.pull(gathered[0])
        summed = None
    else:
        partials = [ingest.upload(counts[s], device) for s, device in enumerate(mesh.devices)]
        # dense int32 accumulators: exact, so this psum is the host's sum
        totals = collective.psum(partials, mesh, axis)
        pulled = ingest.pull(gathered[0])
        summed = ingest.pull(totals[0]).numpy()
    gathered = pulled.numpy()
    return [
        _decode_lanes(block, dtypes) for block in _gathered_part_rows(gathered, assignment, part_rows)
    ], summed


def _parse_canonical_part(path: str) -> Tuple[str, List[str], List[str]]:
    """(header_line, index_texts, row_tails) of one gatherer part file."""
    with gzip.open(path, "rt") as f:
        header = f.readline()
        names: List[str] = []
        tails: List[str] = []
        for line in f:
            if not line.strip():
                continue
            name, _, tail = line.rstrip("\n").partition(",")
            names.append(name)
            tails.append(tail)
    return header, names, tails


def _columns_from_tails(path: str, tails: List[str], n_columns: int) -> List[np.ndarray]:
    """Parse row tails into canonical int64/float64 columns.

    Every value must round-trip through ``str()`` byte for byte, which the
    gatherer's CSV writer guarantees, or the merge refuses the input rather
    than silently rewriting it.
    """
    cells = [tail.split(",") for tail in tails]
    for row in cells:
        if len(row) != n_columns:
            raise ValueError(
                f"collective merge: ragged row in {path} "
                f"({len(row)} fields, header has {n_columns})"
            )
    columns: List[np.ndarray] = []
    for col in range(n_columns):
        texts = [row[col] for row in cells]
        if all(_INT_TEXT.match(t) for t in texts):
            values = np.array([int(t) for t in texts], dtype=np.int64)
        else:
            values = np.array([float(t) for t in texts], dtype=np.float64)
        rendered = [str(v) for v in values.tolist()]
        if rendered != texts:
            drift = next((t, r) for t, r in zip(texts, rendered) if t != r)
            raise ValueError(
                f"collective merge: non-canonical value {drift[0]!r} in "
                f"{path} (round-trips as {drift[1]!r}); merge these parts "
                "with parallel.merge_sorted_csv_parts instead"
            )
        columns.append(values)
    return columns


def collective_merge_parts(
    part_pattern: str,
    output_path: str,
    mesh: Optional[Mesh] = None,
    compress: bool = True,
    journal_dir: Optional[str] = None,
    expected_parts: Optional[int] = None,
) -> int:
    """Join per-worker CSV parts through the mesh's ``all_gather``.

    The drop-in for ``parallel.launch.merge_sorted_csv_parts``: the same
    validation (gap, duplicate and journal checks), the same output bytes.
    The parts' values travel as int32 lanes, one ``all_gather`` replaces
    the host's concatenation, one pull brings them back, and the host
    renders them with ``str()``. ``mesh`` defaults to every CUDA device.
    Returns the number of entity rows written.
    """
    paths = validated_parts(part_pattern, journal_dir, expected_parts)
    header: Optional[str] = None
    part_names: List[List[str]] = []
    part_columns: List[List[np.ndarray]] = []
    for path in paths:
        part_header, names, tails = _parse_canonical_part(path)
        if header is None:
            header = part_header
        elif part_header != header:
            raise ValueError(f"part {path} header differs")
        n_columns = len(part_header.rstrip("\n").split(",")) - 1
        part_names.append(names)
        part_columns.append(_columns_from_tails(path, tails, n_columns))
    # one dtype layout across parts (one schema writer); a column that is
    # int in one part and float in another would need a cast the text
    # merge never makes: refuse instead of guessing
    layouts = {tuple(c.dtype.str for c in cols) for cols in part_columns}
    if len(layouts) > 1:
        raise ValueError(
            f"collective merge: parts under {part_pattern!r} disagree on "
            f"column dtypes ({sorted(layouts)}); merge with "
            "parallel.merge_sorted_csv_parts instead"
        )
    gathered, _ = _device_gather_parts(_merge_mesh(mesh), part_columns)
    # the text merge's row order: keyed on the index text, parts
    # presorted, ties broken by part order: (name, part, row) exactly
    order = sorted(
        (name, part_index, row_index)
        for part_index, names in enumerate(part_names)
        for row_index, name in enumerate(names)
    )
    rendered = [
        [",".join(row) for row in zip(*([str(v) for v in column.tolist()] for column in columns))]
        for columns in gathered
    ]
    with atomic_output(output_path) as tmp_path:
        opener = gzip.open if compress else open
        with opener(tmp_path, "wt") as out:
            out.write(header or "")
            for name, part_index, row_index in order:
                out.write(f"{name},{rendered[part_index][row_index]}\n")
    return len(order)


def _unified_tables(metric_files: Sequence[str]) -> Tuple[List[_Table], List[str]]:
    """Every input read as a table, each column cast to its kind across the
    inputs: float64 if any input parsed it as float, else int64 (the
    concatenation's upcast, applied before the lane encoding)."""
    tables = [_Table.read(f) for f in metric_files]
    names = list(tables[0].names)
    for table in tables[1:]:
        if list(table.names) != names:
            raise ValueError("collective merge: input files disagree on columns")
    for j, name in enumerate(names):
        kinds = {table.columns[j].kind for table in tables}
        if not kinds <= {"i", "f"}:
            # text has no lane encoding, and a bool column would render as
            # 1/0 after a cast: refuse toward the file-level merger
            raise ValueError(
                f"collective merge: column {name!r} is non-numeric "
                f"(dtype kinds {sorted(kinds)}); merge these files with "
                "the file-level MergeCellMetrics/MergeGeneMetrics instead"
            )
        if kinds == {"i", "f"}:
            for table in tables:
                table.columns[j] = _Column("f", table.columns[j].values.astype(np.float64))
    return tables, names


def _rebuilt(tables: Sequence[_Table], names: List[str], gathered) -> List[_Table]:
    """The tables again, their values the ones that came back from the mesh."""
    return [
        _Table(table.index_name, table.index, list(names),
               [_Column(column.kind, values) for column, values in zip(table.columns, cols)])
        for table, cols in zip(tables, gathered)
    ]


class CollectiveMergeCellMetrics(MergeMetrics):
    """``MergeCellMetrics`` with the concatenation's data plane on the mesh:
    cells are disjoint across inputs, so the merge is the gather."""

    def __init__(self, metric_files, output_file: str, mesh: Optional[Mesh] = None):
        super().__init__(metric_files, output_file)
        self._mesh = mesh

    def execute(self) -> None:
        tables, names = _unified_tables(self._metric_files)
        mesh = _merge_mesh(self._mesh)
        gathered, _ = _device_gather_parts(mesh, [[c.values for c in t.columns] for t in tables])
        _Table.concat(_rebuilt(tables, names, gathered)).write(self._output_file)


class CollectiveMergeGeneMetrics(MergeMetrics):
    """``MergeGeneMetrics`` with the count reduction on the mesh: each shard
    scatters its parts' integer count columns into a dense
    ``[gene vocabulary, n_counts]`` accumulator and one ``psum`` sums them;
    the read-weighted moments and ratios come from the host fold over the
    gathered rows, whose count sums must equal the device's."""

    def __init__(self, metric_files, output_file: str, mesh: Optional[Mesh] = None):
        super().__init__(metric_files, output_file)
        self._mesh = mesh

    def execute(self) -> None:
        tables, names = _unified_tables(self._metric_files)
        mesh = _merge_mesh(self._mesh)
        legacy = MergeGeneMetrics(self._metric_files, self._output_file)
        count_columns = [
            c for c in legacy.COUNT_COLUMNS_TO_SUM
            if c in names and all(t.column(c).kind == "i" for t in tables)
        ]
        vocab = sorted({name for table in tables for name in table.index if name is not None})
        slot = {name: index for index, name in enumerate(vocab)}
        vocab_bucket = seg.bucket_size(max(len(vocab), 1), minimum=8)
        n_shards = mesh.size
        accumulators = np.zeros((n_shards, vocab_bucket, max(len(count_columns), 1)), dtype=np.int64)
        for part_index, table in enumerate(tables):
            shard = part_index % n_shards
            named = [i for i, name in enumerate(table.index) if name is not None]
            rows = np.asarray([slot[table.index[i]] for i in named], dtype=np.int64)
            for c_index, column in enumerate(count_columns):
                np.add.at(accumulators[shard, :, c_index], rows, table.column(column).values[named])
        # range-check the cross-shard totals and the per-shard partials:
        # each partial can fit int32 while their psum wraps, and with mixed
        # signs a partial can overflow while the total fits
        totals = accumulators.sum(axis=0)
        for staged_values in (totals, accumulators):
            if staged_values.max(initial=0) > _I32_MAX or staged_values.min(initial=0) < _I32_MIN:
                raise ValueError(
                    "collective merge: summed count column exceeds int32 "
                    "on-device range; merge with MergeGeneMetrics instead"
                )
        gathered, summed = _device_gather_parts(
            mesh, [[c.values for c in t.columns] for t in tables], counts=accumulators.astype(np.int32)
        )
        rebuilt = _rebuilt(tables, names, gathered)
        nucleus = rebuilt[0]
        for leaf in rebuilt[1:]:
            nucleus = legacy._merge_pair(nucleus, leaf)
        if count_columns:
            named = [i for i, name in enumerate(nucleus.index) if name is not None]
            at = np.asarray([slot[nucleus.index[i]] for i in named], dtype=np.int64)
            for c_index, column in enumerate(count_columns):
                host = nucleus.column(column)
                device_sums = summed[at, c_index].astype(np.int64)
                if host.kind != "i" or not np.array_equal(host.values[named], device_sums):
                    raise AssertionError(
                        "collective gene merge: device psum disagrees with "
                        "the host fold — refusing to publish"
                    )
                values = host.values.copy()
                values[named] = device_sums
                nucleus.columns[nucleus.names.index(column)] = _Column("i", values)
        nucleus.write(self._output_file)
