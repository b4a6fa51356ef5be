"""Cell x gene count matrices (CellRanger-2.1.1-compatible counting).

The port of ``sctools_tpu.count`` on its single-device path, with two
backends:

- ``device``: the BAM streams in batches of at most ``batch_records``
  alignments through the ingest ring (``ingest.ring_frames``: a prefetch
  thread decodes the next batch, through the native layer's packed column
  arena with query names for a BGZF input with the default tag keys, while
  this thread works on the current one), each cut at its last query-name
  boundary (the incomplete tail group carries into the next batch). Per
  batch the host builds the padded count columns
  (``device_count_columns``), makes one ``ingest.upload`` of them as one
  int32 block, runs ``ops.counting.count_molecules`` on the device and
  makes one ``ingest.pull`` of the five result columns as one block, read
  only after its event. The batch's unique triples accumulate as packed integers
  (``_MoleculeAccumulator``) that one vectorized pass deduplicates across
  batches and orders by first observation. One batch's pull is waited on
  only after the next batch is queued. The loop holds at most two ring
  frames (``frame`` and ``following``); a queued batch keeps only its
  frame's vocabularies, owned lists that the ring does not recycle, so
  nothing is read from a slot past the ring's retention window.
- ``cpu``: the reference-semantics host loop (itertools.groupby over query
  names), the parity oracle.

File formats are interchangeable with the reference's: ``save`` / ``load``
use .npz + _row_index.npy + _col_index.npy, and ``merge_matrices`` vstacks
chunked matrices whose cell rows are disjoint.

With a ``mesh`` (``--devices N``) each batch is partitioned by cell over
the mesh's devices and counted on every shard
(``parallel.count.pack_sharded_count`` / ``dispatch_sharded_count``, the
port of ``_add_batch_sharded``); the molecules, their first indices mapped
back to batch positions, accumulate as above.

Not ported: the accumulator's one-batch ``add_batch`` (the streaming loop queues and
finishes each batch itself through ``dispatch`` and ``finish``), the
guard ladder (a failed batch fails the command), and the JAX package's
heartbeats, dispatch records and audit counters. A matrix
built by the device backend keeps plain records instead: ``batches`` and
``seconds``.
"""

from __future__ import annotations

import itertools
import operator
import time
from collections import deque
from typing import Dict, List, NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import consts, ingest
from .bam import get_tag_or_default
from .device import DeviceLike, resolve
from .io.packed import (
    IRREGULAR_BARCODE_BASE,
    compact_frame,
    concat_frames,
    copy_frame,
    pack_barcode_u64,
    slice_frame,
    unpack_barcode_u64,
)
from .io.sam import AlignmentReader
from .ops.counting import count_molecules
from .ops.segments import bucket_size

_DEFAULT_TAGS = (
    consts.CELL_BARCODE_TAG_KEY,
    consts.MOLECULE_BARCODE_TAG_KEY,
    consts.GENE_NAME_TAG_KEY,
)

# alignments decoded per streaming batch (the reference's
# alignments_per_batch memory knob)
DEFAULT_BATCH_RECORDS = 1 << 19

# the rows of the one int32 block a batch uploads, and of the one block it
# pulls back
UPLOAD_COLUMNS = ("qname", "cell", "umi", "gene", "eligible", "cb_ok", "ub_ok", "valid")
RESULT_COLUMNS = ("is_molecule", "cell", "umi", "gene", "first_index")


class _MoleculeAccumulator:
    """Accumulates per-batch unique molecules; dedups across batches.

    Each batch's device pass emits the batch-local unique (cell, umi, gene)
    triples. Codes are batch-local, so triples accumulate in a
    batch-independent form: barcodes as order-preserving packed uint64
    (``io.packed.pack_barcode_u64``), genes as global column indices, plus
    the global first-observation record index: ~24 bytes a molecule.

    Barcodes that cannot pack (non-ACGTN, > 21 bases) get synthetic ids
    above 2**63 from a side table; they dedup and order exactly like any
    other value.
    """

    def __init__(self, gene_name_to_index: Dict[str, int], device: torch.device):
        self._gene_name_to_index = gene_name_to_index
        self._device = device
        self._cells: List[np.ndarray] = []
        self._umis: List[np.ndarray] = []
        self._genes: List[np.ndarray] = []
        self._firsts: List[np.ndarray] = []
        self._irregular: Dict[str, int] = {}
        self._irregular_names: List[str] = []

    def _pack_names(self, names: List[str]) -> np.ndarray:
        out = np.empty(len(names), dtype=np.uint64)
        for i, name in enumerate(names):
            packed = pack_barcode_u64(name)
            if packed is None:
                code = self._irregular.get(name)
                if code is None:
                    code = int(IRREGULAR_BARCODE_BASE) + len(self._irregular_names)
                    self._irregular[name] = code
                    self._irregular_names.append(name)
                packed = code
            out[i] = packed
        return out

    def _pack_used(self, codes: np.ndarray, names) -> np.ndarray:
        """Pack only the vocabulary entries ``codes`` reference: a batch's
        vocabulary approaches its size (every distinct UMI), its molecules'
        barcodes are far fewer, and packing is a per-character loop."""
        unique = np.unique(codes)
        packed = self._pack_names([names[int(code)] for code in unique])
        return packed[np.searchsorted(unique, codes)]

    def _name_of(self, packed: int) -> str:
        if packed >= int(IRREGULAR_BARCODE_BASE):
            return self._irregular_names[packed - int(IRREGULAR_BARCODE_BASE)]
        return unpack_barcode_u64(packed)

    def dispatch(self, block: np.ndarray) -> ingest.Pulled:
        """Queue one batch's device work: its ``[8, n]`` column block up,
        ``count_molecules``, its five results down in one ``[5, n]`` block."""
        staged = ingest.upload(block, self._device)
        out = count_molecules(dict(zip(UPLOAD_COLUMNS, staged)), num_segments=block.shape[1])
        return ingest.pull(torch.stack([out[name].to(torch.int32) for name in RESULT_COLUMNS]))

    def finish(self, names: "BatchNames", offset: int, result: np.ndarray) -> int:
        """Append one batch's molecules from its pulled ``[5, n]`` block;
        returns how many there were. ``names`` are its frame's
        vocabularies."""
        is_molecule = result[0].astype(bool)
        cells, umis, genes, first = (result[i][is_molecule] for i in range(1, 5))
        self._append_molecules(names, cells, umis, genes, first.astype(np.int64), offset)
        return int(is_molecule.sum())

    def _gene_vocab_cols(self, names: "BatchNames") -> np.ndarray:
        """Batch gene vocabulary -> output column indices (once per batch)."""
        return np.asarray(
            [self._gene_name_to_index.get(name, -1) for name in names.gene_names],
            dtype=np.int64,
        )

    def _append_molecules(self, names: "BatchNames", cells, umis, genes, first, offset: int) -> None:
        gene_cols = self._gene_vocab_cols(names)[genes]
        if np.any(gene_cols < 0):
            missing = {names.gene_names[g] for g in np.unique(genes[gene_cols < 0])}
            raise KeyError(
                f"gene names not present in gene_name_to_index: {sorted(missing)[:5]}"
            )
        self._cells.append(self._pack_used(cells, names.cell_names))
        self._umis.append(self._pack_used(umis, names.umi_names))
        self._genes.append(gene_cols)
        self._firsts.append(np.asarray(first, dtype=np.int64) + offset)

    def assemble(self):
        """Global dedup and matrix assembly (vectorized, one pass)."""
        n_genes = len(self._gene_name_to_index)
        if not self._cells:
            return sp.csr_matrix((0, n_genes), dtype=np.uint32), np.asarray([], dtype=str)
        cells = np.concatenate(self._cells)
        umis = np.concatenate(self._umis)
        genes = np.concatenate(self._genes)
        firsts = np.concatenate(self._firsts)

        # cross-batch dedup: a triple seen in several batches counts once,
        # with the earliest first-observation index
        order = np.lexsort((firsts, umis, genes, cells))
        cells, umis, genes, firsts = cells[order], umis[order], genes[order], firsts[order]
        new = np.ones(len(cells), dtype=bool)
        if len(cells) > 1:
            new[1:] = (
                (cells[1:] != cells[:-1]) | (genes[1:] != genes[:-1]) | (umis[1:] != umis[:-1])
            )
        cells, genes, firsts = cells[new], genes[new], firsts[new]

        # row order = first observation in file order (the reference assigns
        # cell indices as cells appear): per-cell min first index, cells
        # ordered by that minimum
        unique_cells, inverse = np.unique(cells, return_inverse=True)
        cell_min_first = np.full(len(unique_cells), np.iinfo(np.int64).max)
        np.minimum.at(cell_min_first, inverse, firsts)
        order = np.argsort(cell_min_first, kind="stable")
        ordered_codes = unique_cells[order]
        rank = np.empty(len(unique_cells), dtype=np.int64)
        rank[order] = np.arange(len(unique_cells))
        cell_rows = rank[inverse]

        coordinate_matrix = sp.coo_matrix(
            (np.ones(len(cell_rows), dtype=np.uint32), (cell_rows, genes)),
            shape=(len(ordered_codes), n_genes),
            dtype=np.uint32,
        )
        row_index = np.asarray([self._name_of(int(code)) for code in ordered_codes])
        return coordinate_matrix.tocsr(), row_index


class BatchNames(NamedTuple):
    """What a queued batch keeps of its frame for ``finish``: the
    vocabularies, which the frame owns (never views of a ring slot)."""

    cell_names: List[str]
    umi_names: List[str]
    gene_names: List[str]


def pack_count_block(frame, pad_to: int = 0) -> np.ndarray:
    """The batch's padded count columns as one ``[8, n]`` int32 block, rows
    in ``UPLOAD_COLUMNS`` order: what one upload carries."""
    cols = device_count_columns(frame, pad_to=pad_to)
    return np.stack([cols[name].astype(np.int32, copy=False) for name in UPLOAD_COLUMNS])


def device_count_columns(frame, pad_to: int = 0) -> Dict[str, np.ndarray]:
    """ReadFrame -> padded columns for ``ops.counting.count_molecules``.

    Host-side eligibility per alignment: GE tag present, XF present and not
    INTERGENIC, gene name not a multi-gene "a,b" string; plus CB/UB
    presence flags read from the vocabulary (the code of "" is a missing
    tag). ``pad_to`` pins the padded size; a larger frame pads to its own
    bucket.
    """
    n = frame.n_records
    gene_names = np.asarray(frame.gene_names, dtype=object)
    has_ge = gene_names != ""
    multi_gene = np.asarray([("," in g) for g in frame.gene_names], dtype=bool)
    xf = frame.xf.astype(np.int32)
    eligible = (
        (xf != consts.XF_MISSING)
        & (xf != consts.XF_INTERGENIC)
        & has_ge[frame.gene]
        & ~multi_gene[frame.gene]
    )
    cb_ok = np.asarray(frame.cell_names, dtype=object)[frame.cell] != ""
    ub_ok = np.asarray(frame.umi_names, dtype=object)[frame.umi] != ""

    size = pad_to if pad_to >= n else bucket_size(n)

    def pad(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full(size, fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    return {
        "qname": pad(frame.qname),
        "cell": pad(frame.cell),
        "umi": pad(frame.umi),
        "gene": pad(frame.gene),
        "eligible": pad(eligible, False),
        "cb_ok": pad(cb_ok, False),
        "ub_ok": pad(ub_ok, False),
        "valid": np.arange(size) < n,
    }


class CountMatrix:
    def __init__(self, matrix: sp.csr_matrix, row_index: np.ndarray, col_index: np.ndarray):
        self._matrix = matrix
        self._row_index = row_index
        self._col_index = col_index
        # filled by the device backend: one entry per dispatched batch, and
        # host wall seconds by activity (``save`` adds its own)
        self.batches: List[dict] = []
        self.seconds: Dict[str, float] = {}
        self.ring_batches = 0  # the frames the ingest ring handed over

    @property
    def matrix(self) -> sp.csr_matrix:
        return self._matrix

    @property
    def row_index(self) -> np.ndarray:
        return self._row_index

    @property
    def col_index(self) -> np.ndarray:
        return self._col_index

    # ------------------------------------------------------------------ build

    @classmethod
    def from_sorted_tagged_bam(
        cls,
        bam_file: str,
        gene_name_to_index: Dict[str, int],
        cell_barcode_tag: str = consts.CELL_BARCODE_TAG_KEY,
        molecule_barcode_tag: str = consts.MOLECULE_BARCODE_TAG_KEY,
        gene_name_tag: str = consts.GENE_NAME_TAG_KEY,
        open_mode: str = "rb",
        backend: str = "device",
        batch_records: int = DEFAULT_BATCH_RECORDS,
        frame_source=None,
        device: DeviceLike = None,
        mesh=None,
    ) -> "CountMatrix":
        """Count unique (cell, molecule, gene) triples from a tagged BAM.

        The counting rule is CellRanger 2.1.1's (reference count.py:156-169):
        a query counts iff its alignments implicate exactly one eligible gene
        (GE present, XF present and not INTERGENIC, single-gene name), and
        each (CB, UB, gene) triple counts once.

        The device backend streams in O(batch + molecules) memory. A
        multi-batch input must keep all alignments of one query adjacent
        (queryname-grouped), as the reference also requires; an input no
        larger than one batch needs no particular order. Its decode sniffs
        BAM or SAM from the file itself, so ``open_mode`` only steers the
        cpu backend. ``frame_source``: optional zero-arg callable yielding
        ReadFrames (decoded with the three tag keys) in place of decoding
        ``bam_file``. ``device``: ``cuda`` unless the caller asks for
        ``cpu``; the cpu backend runs on the host either way.
        """
        if backend == "device":
            return cls._from_bam_device(
                bam_file,
                gene_name_to_index,
                tag_keys=(cell_barcode_tag, molecule_barcode_tag, gene_name_tag),
                batch_records=batch_records,
                frame_source=frame_source,
                device=device,
                mesh=mesh,
            )
        if backend == "cpu":
            return cls._from_bam_cpu(
                bam_file,
                gene_name_to_index,
                cell_barcode_tag,
                molecule_barcode_tag,
                gene_name_tag,
                open_mode=open_mode,
            )
        raise ValueError(f"unknown backend {backend!r}")

    @classmethod
    def _from_bam_device(
        cls,
        bam_file: str,
        gene_name_to_index: Dict[str, int],
        tag_keys=_DEFAULT_TAGS,
        batch_records: int = DEFAULT_BATCH_RECORDS,
        frame_source=None,
        device: DeviceLike = None,
        mesh=None,
    ) -> "CountMatrix":
        if mesh is not None:
            from .parallel.count import dispatch_sharded_count, pack_sharded_count
        accumulator = _MoleculeAccumulator(
            gene_name_to_index, mesh.devices[0] if mesh is not None else resolve(device)
        )
        # host wall seconds by activity: decode (the ring's producer
        # thread; it overlaps the rest), and on this thread decode_wait (on
        # the ring's queue), carry, pack, dispatch, wait (on pulls),
        # accumulate, assemble
        seconds = dict.fromkeys(
            ("decode", "decode_wait", "carry", "pack", "dispatch", "wait", "accumulate",
             "assemble"), 0.0
        )
        batches: List[dict] = []
        pending = deque()  # dispatched, not yet accumulated

        def finish_oldest() -> None:
            names, offset, pulled, batch = pending.popleft()
            start = time.perf_counter()
            result = pulled.numpy()  # waits for this batch's pull only
            seconds["wait"] += time.perf_counter() - start
            start = time.perf_counter()
            batch["molecules"] = accumulator.finish(names, offset, result)
            seconds["accumulate"] += time.perf_counter() - start

        def add(batch_frame, batch_offset: int, pad: int) -> None:
            if batch_frame.n_records == 0:
                return
            start = time.perf_counter()
            if mesh is None:
                block = pack_count_block(batch_frame, pad_to=pad)
                padded, h2d_bytes = block.shape[1], block.nbytes
            else:
                stacked, orig = pack_sharded_count(batch_frame, mesh.size)
                padded = int(stacked["qname"].size)
                h2d_bytes = padded * 4 * len(UPLOAD_COLUMNS)
            seconds["pack"] += time.perf_counter() - start
            start = time.perf_counter()
            if mesh is None:
                pulled = accumulator.dispatch(block)
            else:
                pulled = dispatch_sharded_count(stacked, orig, mesh)
            seconds["dispatch"] += time.perf_counter() - start
            batch = dict(records=batch_frame.n_records, padded=padded, h2d_bytes=h2d_bytes)
            batches.append(batch)
            names = BatchNames(batch_frame.cell_names, batch_frame.umi_names, batch_frame.gene_names)
            pending.append((names, batch_offset, pulled, batch))
            # the previous batch's pull is waited on only now, with this
            # batch queued behind it
            while len(pending) > 1:
                finish_oldest()

        def carried(frame, cut: int):
            """The frame's records from ``cut`` on, compacted (the
            vocabularies stay the tail's own) and copied (the carry owns its
            memory)."""
            start = time.perf_counter()
            tail = copy_frame(compact_frame(slice_frame(frame, cut, frame.n_records)))
            seconds["carry"] += time.perf_counter() - start
            return tail

        def timed(frames):
            frames = iter(frames)
            while True:
                start = time.perf_counter()
                decoded = next(frames, None)
                seconds["decode_wait"] += time.perf_counter() - start
                if decoded is None:
                    return
                yield decoded

        ring_stats: Dict[str, float] = {}
        if frame_source is not None:
            frames = ingest.ring_frames(source=frame_source(), stats=ring_stats)
        else:
            frames = ingest.ring_frames(bam_file, batch_records, want_qname=True,
                                       tag_keys=tuple(tag_keys), stats=ring_stats)
        carry = None
        offset = 0
        multi_batch = False
        capacity = bucket_size(batch_records)
        try:
            iterator = timed(frames)
            frame = next(iterator, None)
            while frame is not None:
                if carry is not None:
                    start = time.perf_counter()
                    frame = concat_frames(carry, frame)
                    seconds["carry"] += time.perf_counter() - start
                    carry = None
                following = next(iterator, None)
                multi_batch = multi_batch or frame.n_records >= batch_records
                pad = capacity if multi_batch else 0
                if following is None:
                    # the final frame goes whole: cutting it would split a
                    # non-adjacent query's alignments across device passes, and
                    # within one pass record order is free. If carries pushed
                    # it past the capacity, cut at query boundaries first
                    # (adjacent in a multi-batch input by the documented
                    # requirement); only a single oversized group overflows.
                    while frame.n_records > capacity:
                        changes = np.nonzero(frame.qname[1:] != frame.qname[:-1])[0]
                        eligible = changes[changes < capacity]
                        if not eligible.size:
                            break
                        cut = int(eligible[-1]) + 1
                        add(slice_frame(frame, 0, cut), offset, pad)
                        offset += cut
                        frame = carried(frame, cut)
                    add(frame, offset, pad)
                    break
                changes = np.nonzero(frame.qname[1:] != frame.qname[:-1])[0]
                if changes.size == 0:
                    # one query group so far: keep accumulating
                    carry = copy_frame(frame)
                    frame = following
                    continue
                # cut at the last query boundary inside the capacity, so the
                # alignments of one query never split across batches (the
                # multi-gene rule spans the whole group) and every batch of a
                # multi-batch run pads to one shape; when even the first group
                # overflows the capacity, cut right after it
                eligible = changes[changes < capacity]
                cut = int(eligible[-1] if eligible.size else changes[0]) + 1
                add(slice_frame(frame, 0, cut), offset, pad)
                offset += cut
                carry = carried(frame, cut)
                frame = following
        finally:
            # closing the ring joins its thread, which closes the native
            # stream (or the frame source), on a failure too
            frames.close()
            seconds["decode"] = ring_stats["decode"]
        while pending:
            finish_oldest()
        start = time.perf_counter()
        matrix, row_index = accumulator.assemble()
        seconds["assemble"] = time.perf_counter() - start
        result = cls(matrix, row_index, _col_index_from_map(gene_name_to_index))
        result.batches = batches
        result.ring_batches = ring_stats["batches"]
        result.seconds.update(seconds)
        return result

    @classmethod
    def _from_bam_cpu(
        cls,
        bam_file: str,
        gene_name_to_index: Dict[str, int],
        cell_barcode_tag: str,
        molecule_barcode_tag: str,
        gene_name_tag: str,
        open_mode: str = "rb",
    ) -> "CountMatrix":
        n_genes = len(gene_name_to_index)
        observed = set()
        data: List[int] = []
        cell_indices: List[int] = []
        gene_indices: List[int] = []
        n_cells = 0
        cell_barcode_to_index: Dict[str, int] = {}

        with AlignmentReader(bam_file, open_mode if open_mode != "rb" else None) as reader:
            for _, grouper in itertools.groupby(reader, key=lambda record: record.query_name):
                alignments = list(grouper)
                cell_barcode = get_tag_or_default(alignments[0], cell_barcode_tag)
                molecule_barcode = get_tag_or_default(alignments[0], molecule_barcode_tag)
                if cell_barcode is None or molecule_barcode is None:
                    continue

                # a query counts iff exactly one eligible gene is implicated
                # across its alignments (reference count.py:262-292)
                implicated = set()
                for alignment in alignments:
                    gene = get_tag_or_default(alignment, gene_name_tag)
                    xf = get_tag_or_default(alignment, consts.ALIGNMENT_LOCATION_TAG_KEY)
                    if (
                        gene is not None
                        and xf is not None
                        and xf != consts.INTERGENIC_ALIGNMENT_LOCATION_TAG_VALUE
                        and len(gene.split(",")) == 1
                    ):
                        implicated.add(gene)
                if len(implicated) != 1:
                    continue
                gene_name = next(iter(implicated))

                if (cell_barcode, molecule_barcode, gene_name) in observed:
                    continue
                observed.add((cell_barcode, molecule_barcode, gene_name))

                gene_index = gene_name_to_index[gene_name]
                if cell_barcode in cell_barcode_to_index:
                    cell_index = cell_barcode_to_index[cell_barcode]
                else:
                    cell_index = n_cells
                    cell_barcode_to_index[cell_barcode] = n_cells
                    n_cells += 1
                data.append(1)
                cell_indices.append(cell_index)
                gene_indices.append(gene_index)

        coordinate_matrix = sp.coo_matrix(
            (data, (cell_indices, gene_indices)), shape=(n_cells, n_genes), dtype=np.uint32
        )
        row_index = np.asarray(
            [k for k, _ in sorted(cell_barcode_to_index.items(), key=operator.itemgetter(1))]
        )
        return cls(coordinate_matrix.tocsr(), row_index, _col_index_from_map(gene_name_to_index))

    # ------------------------------------------------------------- persistence

    def save(self, prefix: str) -> None:
        start = time.perf_counter()
        sp.save_npz(prefix + ".npz", self._matrix, compressed=True)
        np.save(prefix + "_row_index.npy", self._row_index)
        np.save(prefix + "_col_index.npy", self._col_index)
        self.seconds["save"] = time.perf_counter() - start

    @classmethod
    def load(cls, prefix: str) -> "CountMatrix":
        matrix = sp.load_npz(prefix + ".npz")
        row_index = np.load(prefix + "_row_index.npy", allow_pickle=True)
        col_index = np.load(prefix + "_col_index.npy", allow_pickle=True)
        return cls(matrix, row_index, col_index)

    @classmethod
    def merge_matrices(cls, input_prefixes) -> "CountMatrix":
        """Concatenate chunked matrices; cell rows are disjoint by the
        sharding invariant, so the merge is a vstack (reference
        count.py:363-373)."""
        col_indices = [np.load(p + "_col_index.npy", allow_pickle=True) for p in input_prefixes]
        row_indices = [np.load(p + "_row_index.npy", allow_pickle=True) for p in input_prefixes]
        matrices = [sp.load_npz(p + ".npz") for p in input_prefixes]
        for ci in col_indices[1:]:
            if not np.array_equal(ci, col_indices[0]):
                raise ValueError("count-matrix chunks disagree on gene columns")
        matrix = sp.vstack(matrices, format="csr")
        return cls(matrix, np.concatenate(row_indices), col_indices[0])

    @classmethod
    def from_mtx(cls, matrix_mtx: str, row_index_file: str, col_index_file: str) -> "CountMatrix":
        """Load from matrix-market + newline-delimited index files
        (reference count.py:375-400)."""
        from scipy.io import mmread

        matrix = mmread(matrix_mtx).tocsr()
        with open(row_index_file, "r") as fin:
            row_index = np.asarray([line.strip() for line in fin])
        with open(col_index_file, "r") as fin:
            col_index = np.asarray([line.strip() for line in fin])
        return cls(matrix, row_index, col_index)


def _col_index_from_map(gene_name_to_index: Dict[str, int]) -> np.ndarray:
    return np.asarray(
        [k for k, _ in sorted(gene_name_to_index.items(), key=operator.itemgetter(1))]
    )
