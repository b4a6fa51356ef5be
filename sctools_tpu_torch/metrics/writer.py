"""Buffered metric CSV writer (gzipped unless asked not to), atomically committed.

The port's own copy of ``sctools_tpu.metrics.writer``. The output format is
the reference's CSV contract: a header line starting with a bare comma (the
unnamed index column), one row per entity, every value rendered by
``str()``. Rows are formatted into an in-memory block and flushed in
batches, so the gzip stream gets large writes.

Commit is atomic: bytes stream into a process-unique ``*.inflight.<pid>``
temp sibling (``sched.commit.inflight_path``), and only ``close()``
publishes it onto the final path with ``os.replace``; the ``writer.commit``
fault site (``sched.faults``) sits just before the rename, as in the JAX
writer. ``discard()`` abandons the output without publishing (the error
path). ``write_block`` renders its rows with the native layer's block
formatter (``native.format_csv_block``), which gives the bytes of the
``str()`` path at C++ speed, as the JAX writer does. The writer is the one
emission point of metric rows (solo and packed), so it adds each row to
the audit ledger's ``rows.emitted`` (``obs.audit``); ``rows_written``
counts them too, for the gatherers' own records.
"""

from __future__ import annotations

import gzip
import os
from numbers import Number
from typing import Any, List, Mapping

import numpy as np

from .. import native
from ..obs import audit as _audit
from ..sched import faults
from ..sched.commit import inflight_path

_FLUSH_EVERY = 4096  # rows per underlying write


class MetricCSVWriter:
    """Accumulates entity rows and writes them through in batches."""

    def __init__(self, output_stem: str, compress: bool = True):
        """``compress=False`` writes a plain ``.csv`` with the same commit."""
        suffix = ".csv.gz" if compress else ".csv"
        if not output_stem.endswith(suffix):
            output_stem += suffix
        self._filename = output_stem
        self._inflight = inflight_path(output_stem)
        self._committed = False
        if compress:
            # level 1: on numeric CSV rows the ratio loss against the default
            # (9) is small, and the writer shares a host core with decode and
            # dispatch
            self._sink = gzip.open(self._inflight, "wb", compresslevel=1)
        else:
            self._sink = open(self._inflight, "wb")
        self._columns: List[str] = []
        self._rows: List[str] = []
        #: entity rows written (the header is not a row)
        self.rows_written = 0

    @property
    def filename(self) -> str:
        return self._filename

    def _push(self, line: str) -> None:
        self._rows.append(line)
        if len(self._rows) >= _FLUSH_EVERY:
            self._flush()

    def _flush(self) -> None:
        if self._rows:
            self._sink.write(("\n".join(self._rows) + "\n").encode())
            self._rows.clear()

    def write_header(self, record: Mapping[str, Any]) -> None:
        """Column names = keys of ``record``, privates (_-prefixed) dropped."""
        self._columns = [key for key in record if not key.startswith("_")]
        self._push("," + ",".join(self._columns))

    def write(self, index: str, record: Mapping[str, Number]) -> None:
        """Append one entity row; ``index`` is the cell barcode / gene name."""
        if not isinstance(index, str):
            index = repr(index)  # None genes/cells render as 'None'
        values = ",".join(str(record[column]) for column in self._columns)
        self.rows_written += 1
        # conservation ledger: this writer is the ONE emission point for
        # metric rows (solo and packed), so rows.emitted counts here
        _audit.add("rows.emitted", 1)
        self._push(index + "," + values)

    def write_block(self, index, columns) -> None:
        """Append many rows at once.

        ``index`` holds the entity names; ``columns`` is a list of
        equal-length numpy arrays (integer or floating) in header order.
        Values are canonicalised to float64 / int64 first, because
        ``str(np.float32)`` and ``str(np.bool_)`` differ from their 64-bit
        casts; an integral float keeps its trailing ``.0``. The native
        formatter renders each value as ``str()`` renders its cast.
        """
        self._flush()  # keep row order: pending str rows go first
        columns = [
            arr.astype(
                np.float64 if np.issubdtype(arr.dtype, np.floating) else np.int64,
                copy=False,
            )
            for arr in map(np.asarray, columns)
        ]
        index = [str(name) for name in index]
        for name in index:
            # an index value holding a separator would shift every later
            # column of its row (multi-gene "a,b" rows are filtered earlier)
            if "," in name or "\n" in name:
                raise ValueError(f"index value needs CSV quoting: {name!r}")
        self.rows_written += len(index)
        # conservation ledger: one integer add for the whole block
        _audit.add("rows.emitted", len(index))
        self._sink.write(native.format_csv_block(index, columns))

    def close(self) -> None:
        """Finish the stream and atomically publish the final CSV."""
        if self._committed:
            return
        self._flush()
        self._sink.close()
        # the crash window: bytes complete, rename pending. The merge must
        # never see this state as a finished part
        faults.fire("writer.commit", name=self._filename)
        if faults.should_corrupt("writer.commit", name=self._filename):
            with open(self._inflight, "rb") as f:
                data = f.read()
            with open(self._inflight, "wb") as f:
                f.write(faults.mangle(data))
        os.replace(self._inflight, self._filename)
        self._committed = True

    def discard(self) -> None:
        """Abandon the output: close the stream, publish nothing."""
        if self._committed:
            return
        self._rows.clear()
        try:
            self._sink.close()
        except OSError:
            pass
        try:
            os.remove(self._inflight)
        except OSError:
            pass
        self._committed = True
