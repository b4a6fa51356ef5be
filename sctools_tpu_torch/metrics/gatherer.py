"""Metric gatherers: stream a sorted BAM through the device engine to a CSV.

The port of ``sctools_tpu.metrics.gatherer`` on its device backend. Batches
of at most ``batch_records`` alignments come through the ingest ring
(``ingest.ring_frames``): a prefetch thread decodes the next batch (through
the native layer's packed column arena for a BGZF input, without query
names) while this thread works on the current one. Each batch
is cut at its last entity boundary and the incomplete tail entity carries
into the next batch, so an entity never spans two processed batches and
per-batch results need no merging. Per batch the host makes the same schema
decisions as the JAX gatherer (prepacked keys, run-keyed wire, narrow or
wide genomic lanes, presorted or not), uploads one int32 block
(``ingest.upload``), runs ``metrics.device.compute_entity_metrics`` and
``compact_results_wire`` on the device, and stages the copy of one
compacted int32 block back (``ingest.WritebackRing``). Up to
``_PIPELINE_DEPTH`` batches are on the device before the oldest result is
written, so batch k+2 is packed and uploaded while batch k's copy is in
flight. The loop holds at most two ring frames (the current one while the
next is pulled) and keeps nothing of an older one: the carry is copied, and
a dispatched batch keeps its entity names (an owned list) and its staged
result, so the ring's retention window holds.

Every dispatch goes through the guard ladder (``guard.run_batch`` at site
``gatherer.dispatch``, ``_guarded_dispatch``): a transient retries in
place, a device OOM bisects the batch at entity boundaries
(``guard.entity_splitter``; a bisected piece pads to its own bucket,
``guard.sub_pad_to``), and a poisoned record is quarantined to a sidecar
while the batch goes on without it. So one batch may give several pending
entries, or none. A retry, a half or a remainder runs the same device pass
again. A device fault that surfaces at the wait on a batch's copy (the
ring's ``collect``, site ``gatherer.writeback``) retries a transient there
and otherwise re-raises, a strike on ``gatherer.dispatch``. A failure the
guard cannot absorb fails the command, and the writer discards its temp
file.

``backend='cpu'`` runs the host aggregators (``metrics.aggregator``) over
the tag groups of ``bam.iter_tag_groups``, one entity at a time in record
order: the reference-semantics path, which needs no device.

The mesh-sharded gatherers (``--devices N``) are ``parallel.gatherer``'s:
the same streaming loop with their own dispatch/finalize pair.

Observability is JAX's, at its sites and under its names: per batch an
``upload`` span (the host packing and the upload), a ``compute`` span (the
device pass, its compaction and the staged copy: host dispatch wall, the
device's work is not waited for) and a ``writeback`` span (the wait on the
copy and the CSV block); the counters ``records_decoded``,
``batches_uploaded``, ``h2d_bytes``, ``d2h_bytes``, ``entities_written``,
``run_keyed_batches`` and ``wire_writeback_staged`` / ``_drained``; and one
pulse heartbeat on stage ``gatherer.cell`` / ``gatherer.gene``, which
travels with the pending batch and is emitted at the end of its finalize.
Its legs: h2d the packing and upload, compute the dispatch, d2h the wait
on the copy; its writeback phase is the ring's at the drain's start, as
JAX samples it. The host's layers are timed once each into ``seconds``
(``obs.timed``; while a torch profiler records, the ranges
``scx.gatherer.<key>``): ``start``, ``decode_wait``, ``carry``,
``pack``, ``dispatch``, ``wait``, ``csv`` and ``close`` on this thread,
which do not overlap, and ``decode`` with its parts from the ring's
thread.

The audit ledger's taps (``obs.audit``) are JAX's: ``records.decoded`` per
frame, ``records.computed`` in the guard once a (sub-)batch's dispatch has
succeeded, ``records.quarantined:<reason>`` for the records it isolated,
``rows.computed`` per finalized batch's entities and
``rows.filtered:multi_gene`` for the gene axis's skipped rows (device mask
and host loop alike). Each gatherer also keeps plain records
(``batches``, ``seconds``, ``ring_batches``, ``run_keyed_batches``).
"""

from __future__ import annotations

import sys
from collections import deque
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from .. import guard, ingest, obs
from ..obs import audit
from ..bam import iter_cell_barcodes, iter_genes, iter_molecule_barcodes
from ..device import DeviceLike, resolve
from ..io.packed import (
    FLAG_MITO,
    FLAG_RUN_START,
    KEY_CODE_BITS,
    KEY_HI_SHIFT,
    KEY_LO_MASK,
    KEY_UNMAPPED_SHIFT,
    ReadFrame,
    compact_frame,
    concat_frames,
    copy_frame,
    pack_flags,
    slice_frame,
    wire_layout,
)
from ..io.sam import AlignmentReader
from ..obs import pulse, xprof
from ..ops.segments import bucket_size, entity_bucket
from . import device as device_engine
from .aggregator import CellMetrics, GeneMetrics
from .schema import CELL_COLUMNS, GENE_COLUMNS, INT_COLUMNS
from .writer import MetricCSVWriter

# Device batch size: at most this many alignments are held in host RAM and
# processed per device pass.
DEFAULT_BATCH_RECORDS = 1 << 20

PROGRESS_EVERY = 10_000_000  # the reference's cadence (fastq_common.cpp:340)

_I32_MAX = np.iinfo(np.int32).max

# the keys of MetricGatherer.seconds timed on the gatherer's thread, which
# do not overlap
MAIN_SECONDS = ("start", "decode_wait", "carry", "pack", "dispatch", "wait", "csv", "close")


def _pad_columns(
    frame: ReadFrame,
    is_mito: np.ndarray,
    pad_to: int = 0,
    prepacked_keys: tuple = None,
    pair_mito: bool = False,
    small_ref: bool = False,
    force_wide_genomic: bool = False,
    run_keys_bucket: int = 0,
    run_starts: np.ndarray = None,
    include_cb: bool = True,
):
    """ReadFrame -> (device-ready padded columns, static engine flags).

    ``pad_to`` pins the padded size (streaming batches share one shape); it
    is ignored when the frame is larger. ``include_cb=False`` (the gene
    axis) omits the cell-barcode quality column from both schemas and
    records the choice in the static flags (``with_cb``).

    ``prepacked_keys`` = the (k1, k2, k3) key column names in entity order:
    the batch then ships the device sort's four packed operands plus a [1]
    valid count instead of cell/umi/gene/ref/pos/valid, and the quality
    columns as integer summaries. With ``pair_mito`` the k2 (pair) slot
    carries ``code << 1 | is_mito``. With ``run_keys_bucket`` the two key
    lanes ship once per (k1, k2, k3) run, in a table of that many slots,
    with FLAG_RUN_START on each run's first record (``run_starts``).
    """
    n = frame.n_records
    padded = pad_to if pad_to >= n else bucket_size(n)

    def pad(arr, fill=0, dtype=None):
        arr = np.asarray(arr)
        out = np.full(padded, fill, dtype=dtype or arr.dtype)
        out[:n] = arr
        return out

    if "flags" in frame.extras:
        # the arena decoder prepacked bits 0..11; only the host-knowledge
        # mito bit remains (FLAG_RUN_START is OR-ed below for run-keyed
        # batches, whichever the flags' source)
        flags = (
            frame.extras["flags"].astype(np.int32)
            | (is_mito[frame.gene].astype(np.int32) * FLAG_MITO)
        ).astype(np.int16)
    else:
        flags = pack_flags(
            frame.strand, frame.unmapped, frame.duplicate, frame.spliced,
            frame.xf, frame.perfect_umi, frame.perfect_cb, frame.nh,
            is_mito[frame.gene],
        )
    cols = {"flags": pad(flags, 0, np.int16)}
    if prepacked_keys is None:
        # the plain schema ships the derived float32 quality views
        if include_cb:
            cols["cb_frac30"] = pad(
                np.nan_to_num(frame.cb_frac30, nan=0.0), 0.0, np.float32
            )
        cols.update(
            umi_frac30=pad(np.nan_to_num(frame.umi_frac30, nan=0.0), 0.0, np.float32),
            genomic_frac30=pad(
                np.nan_to_num(frame.genomic_frac30, nan=0.0), 0.0, np.float32
            ),
            genomic_mean=pad(np.nan_to_num(frame.genomic_mean, nan=0.0), 0.0, np.float32),
            cell=pad(frame.cell, 0, np.int32),
            umi=pad(frame.umi, 0, np.int32),
            gene=pad(frame.gene, 0, np.int32),
            ref=pad(frame.ref, 0, np.int32),
            pos=pad(frame.pos, 0, np.int32),
            valid=np.arange(padded) < n,
        )
        return cols, {}
    k1, k2, k3 = (getattr(frame, name).astype(np.int32) for name in prepacked_keys)
    if pair_mito:
        k2 = (k2 << 1) | is_mito[frame.gene].astype(np.int32)
    mapped = ~np.asarray(frame.unmapped, dtype=bool)
    genomic_len = frame.genomic_qual & np.uint32(0xFFFF)
    # ``force_wide_genomic`` is the gatherer's one-way ratchet: once any
    # batch needed the wide u32 genomic columns, later batches pack wide too,
    # so the columns always agree with the static flags the device unpacks by
    narrow_genomic = not force_wide_genomic and bool(genomic_len.max(initial=0) <= 0xFF)
    if narrow_genomic:
        gq = ((frame.genomic_qual >> np.uint32(16)) << np.uint32(8)) | genomic_len
        cols.update(
            genomic_qual=pad(gq.astype(np.uint16), 0, np.uint16),
            genomic_total=pad(frame.genomic_total.astype(np.uint16), 0, np.uint16),
        )
    else:
        cols.update(
            genomic_qual=pad(frame.genomic_qual, 0, np.uint32),
            genomic_total=pad(frame.genomic_total, 0, np.uint32),
        )
    ref_plus_1 = frame.ref.astype(np.int32) + 1
    if small_ref:
        m_ref = pad(
            (np.where(mapped, 0, 0x80) | ref_plus_1).astype(np.uint8), 0xFF, np.uint8
        )
    else:
        m_ref = pad(
            np.where(mapped, 0, 1 << KEY_UNMAPPED_SHIFT) + ref_plus_1,
            _I32_MAX,
            np.int32,
        )
    key_hi = (k1 << KEY_HI_SHIFT) | (k2 >> KEY_HI_SHIFT)
    key_lo = ((k2 & KEY_LO_MASK) << KEY_CODE_BITS) | k3
    ps_col = frame.extras.get("ps")
    if ps_col is None:
        ps_col = (frame.pos.astype(np.int32) << 1) | frame.strand.astype(np.int32)
    cols.update(
        umi_qual=pad(frame.umi_qual, 0, np.uint16),
        m_ref=m_ref,
        ps=pad(ps_col, _I32_MAX, np.int32),
        n_valid=np.asarray([n], dtype=np.int32),
    )
    if include_cb:
        cols["cb_qual"] = pad(frame.cb_qual, 0, np.uint16)
    static_flags = {
        "wide_genomic": not narrow_genomic,
        "small_ref": small_ref,
        "with_cb": include_cb,
    }
    if run_keys_bucket:
        starts = run_starts
        cols["flags"][:n] |= np.int16(FLAG_RUN_START) * starts

        def pad_runs(arr):
            out = np.full(run_keys_bucket, _I32_MAX, dtype=np.int32)
            out[: arr.size] = arr
            return out

        cols["key_hi_runs"] = pad_runs(key_hi[starts])
        cols["key_lo_runs"] = pad_runs(key_lo[starts])
        static_flags["num_runs"] = run_keys_bucket
    else:
        cols["key_hi"] = pad(key_hi, _I32_MAX, np.int32)
        cols["key_lo"] = pad(key_lo, _I32_MAX, np.int32)
    return cols, static_flags


def _pack_wire(cols: Dict[str, np.ndarray], static_flags: dict) -> np.ndarray:
    """Prepacked named columns -> ONE contiguous int32 wire block.

    The section order and widths come from io.packed.wire_layout, the one
    spec this packer and metrics.device._unpack_wire both iterate, after a
    single leading n_valid word; the run table trails when there is one.
    """
    layout = wire_layout(
        bool(static_flags.get("wide_genomic")),
        bool(static_flags.get("small_ref")),
        run_keys=bool(static_flags.get("num_runs")),
        with_cb=bool(static_flags.get("with_cb", True)),
    )
    parts = [cols["n_valid"]]
    for name, width in layout:
        col = cols[name]
        parts.append(
            col if width == 4 and col.dtype == np.int32
            else np.ascontiguousarray(col).view(np.int32)
        )
    if static_flags.get("num_runs"):
        parts += [cols["key_hi_runs"], cols["key_lo_runs"]]
    return np.concatenate(parts)


def prepacked_gate(frame: ReadFrame, entity_kind: str) -> bool:
    """True when every code/coordinate fits the packed-key bit budget.

    Explicit maxima: a dispatched slice shares its parent's merged
    vocabulary, so the record count is no bound. The cell axis packs
    gene<<1|mito into the pair slot (one less gene bit), and pos shifts left
    by 1 into ps, so both get tighter caps that keep the packed int32 keys
    order-preserving.
    """
    code_cap = 1 << KEY_CODE_BITS
    gene_cap = code_cap >> 1 if entity_kind == "cell" else code_cap
    return (
        frame.n_records > 0
        and int(frame.cell.max(initial=0)) < code_cap
        and int(frame.umi.max(initial=0)) < code_cap
        and int(frame.gene.max(initial=0)) < gene_cap
        and int(frame.ref.max(initial=0)) < (1 << KEY_UNMAPPED_SHIFT) - 1
        and int(frame.pos.max(initial=0)) < (1 << 30)
    )


# columns that never cross the device->host wire: three counters the
# reference never increments (written as zeros) and four ratios that are
# pure f32 functions of shipped integer columns (recomputed on the host
# with the engine's exact formulas)
_WIRE_ZERO_INTS = frozenset(("noise_reads", "antisense_reads", "reads_mapped_too_many_loci"))
_WIRE_DERIVED_FLOATS = frozenset(
    (
        "reads_per_molecule",
        "reads_per_fragment",
        "fragments_per_molecule",
        "pct_mitochondrial_molecules",
    )
)


def wire_result_names(columns):
    """(int_names, float_names) actually pulled from the device per batch."""
    int_names = ("entity_code",) + tuple(
        c for c in columns if c in INT_COLUMNS and c not in _WIRE_ZERO_INTS
    )
    float_names = tuple(
        c for c in columns if c not in INT_COLUMNS and c not in _WIRE_DERIVED_FLOATS
    )
    return int_names, float_names


class MetricGatherer:
    """Common driver: decode, pack, compute on the device, write the CSV."""

    entity_kind: str = ""
    columns: List[str] = []

    # batches on the device before the oldest result is pulled: the host
    # packs and uploads batch k+2 while batch k's pull is in flight
    _PIPELINE_DEPTH = 2

    def __init__(
        self,
        bam_file: str,
        output_stem: str,
        mitochondrial_gene_ids: Set[str] = frozenset(),
        compress: bool = True,
        backend: str = "device",
        batch_records: int = DEFAULT_BATCH_RECORDS,
        frame_source=None,
        device: DeviceLike = None,
        graphs=None,
    ):
        """The parameters up to ``frame_source`` are the JAX package's, in
        its order. ``compress=False`` writes a plain ``.csv``. ``backend``:
        ``device`` (the engine on ``device``) or ``cpu`` (the host
        aggregators, which take no device and no frame source).
        ``frame_source``: optional zero-arg callable yielding sorted
        ReadFrames in place of decoding ``bam_file``; ``bam_file`` is still
        read for its header. ``device``: ``cuda`` unless the caller asks
        for ``cpu``. ``graphs``: a ``serve.graphs.GraphSet`` that replays
        the engine's pass from CUDA graphs (the serve worker's); None runs
        it eagerly."""
        if backend not in ("device", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        self._bam_file = bam_file
        self._output_stem = output_stem
        self._mitochondrial_gene_ids = mitochondrial_gene_ids
        self._batch_records = batch_records
        self._frame_source = frame_source
        self._backend = backend
        self._compress = compress
        self._device = resolve(device) if backend == "device" else None
        self._graphs = graphs
        self.run_keyed_batches = 0
        # bytes this gatherer moved each way: the transfer ledger's
        # gatherer.upload / gatherer.writeback sites count the same bytes
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        # records the device pass streamed (every frame the source handed
        # over), and the rows its writer published
        self.records_streamed = 0
        self.rows_emitted = 0
        # one entry per dispatched batch: records, padded size, entities,
        # schema decisions, and on CUDA the (start, end) events around its
        # upload, device pass and pull
        self.batches: List[dict] = []
        # host wall seconds of the run by activity: decode (the ring's
        # producer thread, decoding and filling arenas: it overlaps the
        # rest) and its parts (ingest.DECODE_PARTS: the native stream's
        # file reads, inflate and parse, the arena's fill; the arena path
        # only), and on this thread (MAIN_SECONDS) start (the header probe,
        # the ring's and the writer's set-up), decode_wait (on the ring's
        # queue), carry (the carried tail entity: its concat with the next
        # frame, the cut at the last entity boundary, its compacted copy),
        # pack (schema decisions and padded columns), dispatch
        # (upload and enqueue of the device pass and its pull), wait (on
        # pulls), csv, and close (the writer's close, the ring's join)
        self.seconds = dict.fromkeys(("decode",) + ingest.DECODE_PARTS + MAIN_SECONDS, 0.0)
        # the frames the ring handed over
        self.ring_batches = 0
        # what the frame source reports of its own work, off this thread:
        # the fused TagSortBam's native sort fills its phase seconds and
        # the partials it wrote (``native.tagsort_stream_frames``)
        self.source_stats: Dict[str, float] = {}

    @property
    def bam_file(self) -> str:
        return self._bam_file

    def device_ms(self) -> List[float]:
        """Per batch, the device milliseconds between its two CUDA events
        (its upload, device pass and pull); empty on the CPU. Read after
        ``extract_metrics``."""
        return [
            start.elapsed_time(end)
            for start, end in (b["events"] for b in self.batches if b.get("events"))
        ]

    def extract_metrics(self, mode: str = "rb") -> None:
        """Stream the BAM through the backend to the CSV, in bounded host
        memory for any file size. ``mode="r"`` reads SAM text; the default
        ``"rb"`` leaves the readers to tell BAM from SAM by content."""
        open_mode = mode if mode != "rb" else None
        if self._backend == "cpu":
            if self._frame_source is not None:
                raise ValueError("frame_source requires the device backend")
            self._extract_cpu(open_mode)
            return
        with obs.timed(self.seconds, "start", "gatherer"):
            self.start_stream(open_mode)
            ring_stats: Dict[str, float] = {}
            if self._frame_source is not None:
                frames = ingest.ring_frames(source=self._frame_source(), stats=ring_stats)
            else:
                frames = ingest.ring_frames(self._bam_file, self._batch_records, open_mode, stats=ring_stats)
            out = self._make_writer()
            # the writeback ring: each dispatched batch's compacted block
            # starts its copy at dispatch and drains in FIFO order in
            # finalize; its slot states are the writeback_slots flight section
            self._writeback = ingest.WritebackRing(name=type(self).__name__, slots=self._PIPELINE_DEPTH + 2)
        try:
            with obs.timed(self.seconds, "start", "gatherer"):
                out.write_header({c: None for c in self.columns})
            self._stream_device_batches(self._timed(frames), out)
        except BaseException:
            # never publish a partial, valid-looking CSV
            out.discard()
            raise
        else:
            with obs.timed(self.seconds, "close", "gatherer"):
                out.close()
            self.rows_emitted = out.rows_written
        finally:
            # closing the ring joins its thread, which closes the source: a
            # source left open on a failure holds its files (the native
            # stream, or the fused sort's worker, partials and tee)
            with obs.timed(self.seconds, "close", "gatherer"):
                frames.close()
                self._writeback.close()
            for key in ("decode",) + ingest.DECODE_PARTS:
                self.seconds[key] = ring_stats.get(key, 0.0)
            self.ring_batches = ring_stats["batches"]

    def _make_writer(self) -> MetricCSVWriter:
        """The device pass's output writer. A seam: the serve packer puts a
        router in its place that splits each result block back out to
        per-job CSVs by entity membership."""
        return MetricCSVWriter(self._output_stem, self._compress)

    def start_stream(self, mode: Optional[str] = None) -> None:
        """Reset the wire-schema state that must not flip mid-stream: the u8
        m_ref lane is chosen from the header's reference count, and
        wide_genomic and the run table only ratchet up. ``extract_metrics``
        calls it; a caller of ``pack_batch`` alone calls it first. ``mode``
        is the header probe's ``AlignmentReader`` mode (None sniffs)."""
        with AlignmentReader(self._bam_file, mode) as header_probe:
            self._small_ref = len(header_probe.header.references) <= 0x7F
        self._wide_genomic = False
        self._runs_bucket = 0

    def _timed(self, frames):
        frames = iter(frames)
        while True:
            with obs.timed(self.seconds, "decode_wait", "gatherer"):
                frame = next(frames, None)
            if frame is None:
                return
            yield frame

    def _entity_key(self, frame: ReadFrame) -> np.ndarray:
        return frame.cell if self.entity_kind == "cell" else frame.gene

    # every device dispatch of the streaming loop goes through
    # guard.run_batch: a transient retries under the lease, an OOM bisects
    # at entity boundaries (a bisected piece pads to its own bucket), and a
    # poisoned record is quarantined to a sidecar while the batch goes on
    # without it
    _GUARD_SITE = "gatherer.dispatch"

    def _guarded_dispatch(self, frame: ReadFrame, pad_to: int, presorted: bool, offset: int) -> list:
        """One batch through the guard's ladder -> the list of its pending
        tuples (one, or more after a bisection, or none once quarantine
        took every record). ``offset`` is the absolute stream index of the
        frame's first record, what the sidecars and the ``corrupt_record``
        faults localize by."""

        def dispatch(sub, sub_offset):
            return self._dispatch_device_batch(sub, pad_to=guard.sub_pad_to(pad_to), presorted=presorted)

        return guard.run_batch(dispatch, frame, site=self._GUARD_SITE, name=str(self._bam_file),
                               offset=offset, splitter=guard.entity_splitter(self.entity_kind))

    def _stream_device_batches(self, frames, out) -> None:
        carry: Optional[ReadFrame] = None
        pending = deque()  # dispatched but not yet written
        multi_batch = False
        processed = 0
        dispatch_offset = 0  # absolute stream index of the next dispatch
        next_progress = PROGRESS_EVERY
        for frame in frames:
            processed += frame.n_records
            self.records_streamed += frame.n_records
            obs.count("records_decoded", frame.n_records)
            # conservation ledger: each record enters the compute path
            # exactly once here (carry/slice/concat below conserve), so
            # decoded == computed + quarantined is the task's invariant.
            # int() detaches the scalar from the frame: the ledger keeps a
            # count, never a view
            audit.add("records.decoded", int(frame.n_records))
            if processed >= next_progress:
                print(f"[{type(self).__name__}] {processed} records decoded", file=sys.stderr)
                next_progress += PROGRESS_EVERY
            with obs.timed(self.seconds, "carry", "gatherer"):
                if carry is not None:
                    frame = concat_frames(carry, frame)
                    carry = None
                key = self._entity_key(frame)
                changes = np.nonzero(key[1:] != key[:-1])[0]
                if changes.size == 0:
                    carry = copy_frame(frame)  # one entity so far; keep accumulating
                    continue
                # cut at the last entity boundary that fits the capacity, so
                # every batch of a multi-batch run pads to one shape; only an
                # entity larger than the capacity overflows it. A file
                # smaller than one batch stays at its own bucket size.
                capacity = bucket_size(self._batch_records)
                multi_batch = multi_batch or frame.n_records >= self._batch_records
                eligible = changes[changes < capacity]
                # when even the first entity overflows capacity, cut right after it
                cut = int(eligible[-1] if eligible.size else changes[0]) + 1
                # ascending entity order is the presorted contract; grouped
                # but unordered input takes the device-sorted path for the batch
                ascending = bool(np.all(key[1:cut] >= key[: cut - 1]))
            pending.extend(
                self._guarded_dispatch(
                    slice_frame(frame, 0, cut),
                    pad_to=capacity if multi_batch else 0,
                    presorted=ascending,
                    offset=dispatch_offset,
                )
            )
            dispatch_offset += cut
            # a bisected batch adds more than one entry: drain to depth
            while len(pending) > self._PIPELINE_DEPTH:
                self._finalize_device_batch(*pending.popleft(), out)
            # compact, or the carried vocabularies would accumulate the union
            # of every batch seen so far; copy, so the carry owns its memory
            with obs.timed(self.seconds, "carry", "gatherer"):
                carry = copy_frame(compact_frame(slice_frame(frame, cut, frame.n_records)))
        if carry is not None and carry.n_records:
            tail_key = self._entity_key(carry)
            # the tail pads to its own bucket, not the full batch capacity
            pending.extend(
                self._guarded_dispatch(
                    carry,
                    pad_to=0,
                    presorted=bool(np.all(tail_key[1:] >= tail_key[:-1])),
                    offset=dispatch_offset,
                )
            )
        while pending:
            self._finalize_device_batch(*pending.popleft(), out)

    def _prepare_batch(
        self,
        frame: ReadFrame,
        prepacked: bool,
        pad_to: int = 0,
        run_keys_bucket: int = 0,
        run_starts: np.ndarray = None,
    ):
        """The batch's padded columns -> (cols, static_flags): the packed
        sort operands and integer quality summaries when ``prepacked``, else
        the plain schema."""
        is_mito = np.asarray(
            [name in self._mitochondrial_gene_ids for name in frame.gene_names],
            dtype=bool,
        )
        key_order = (
            ("cell", "gene", "umi") if self.entity_kind == "cell" else ("gene", "cell", "umi")
        )
        cols, static_flags = _pad_columns(
            frame,
            is_mito,
            pad_to=pad_to,
            prepacked_keys=key_order if prepacked else None,
            pair_mito=self.entity_kind == "cell",
            small_ref=self._small_ref,
            force_wide_genomic=self._wide_genomic,
            run_keys_bucket=run_keys_bucket if prepacked else 0,
            run_starts=run_starts,
            include_cb=self.entity_kind == "cell",
        )
        if static_flags.get("wide_genomic"):
            self._wide_genomic = True  # one-way ratchet
        return cols, static_flags

    def pack_batch(self, frame: ReadFrame, pad_to: int, presorted: bool = True):
        """The host side of one batch: its schema decisions and its padded
        columns -> (host arrays, engine kwargs, dict of the decisions).

        Batches are presorted when the input is sorted by the entity tag
        triple (vocabulary codes preserve string order); when every code and
        coordinate also fits the packed-key bit budget (prepacked_gate), the
        host ships the packed sort operands and integer quality summaries.
        """
        prepacked = presorted and prepacked_gate(frame, self.entity_kind)
        run_keys_bucket = 0
        run_starts = None
        if prepacked:
            # run-keyed wire sizing: molecule runs are adjacent in sorted
            # input, so 8 key bytes a record become 8 bytes a run plus one
            # flag bit. The run table's bucket ratchets (never shrinks), and
            # the mode is skipped when the table would eat most of the saving
            run_starts = np.empty(frame.n_records, dtype=bool)
            run_starts[0] = True
            np.logical_or(
                frame.cell[1:] != frame.cell[:-1],
                frame.gene[1:] != frame.gene[:-1],
                out=run_starts[1:],
            )
            run_starts[1:] |= frame.umi[1:] != frame.umi[:-1]
            n_runs = int(np.count_nonzero(run_starts))
            self._runs_bucket = max(self._runs_bucket, bucket_size(n_runs))
            padded = pad_to if pad_to >= frame.n_records else bucket_size(frame.n_records)
            if self._runs_bucket <= padded // 2:
                run_keys_bucket = self._runs_bucket
        cols, static_flags = self._prepare_batch(
            frame, prepacked, pad_to=pad_to,
            run_keys_bucket=run_keys_bucket, run_starts=run_starts,
        )
        num_segments = len(cols["flags"])
        if prepacked:
            cols = {"wire": _pack_wire(cols, static_flags)}
        kwargs = dict(
            num_segments=num_segments, kind=self.entity_kind, presorted=presorted,
            prepacked=prepacked, **static_flags,
        )
        decisions = dict(
            records=frame.n_records, padded=num_segments, presorted=presorted,
            prepacked=prepacked, run_keyed=bool(run_keys_bucket),
            h2d_bytes=sum(array.nbytes for array in cols.values()),
        )
        return cols, kwargs, decisions

    def _dispatch_device_batch(self, frame: ReadFrame, pad_to: int, presorted: bool = True):
        # one heartbeat per batch: the decode interval adopted from the
        # ring's notes, h2d the packing and upload, compute the dispatch;
        # finalize adds the d2h wait and emits it
        hb = pulse.heartbeat(f"gatherer.{self.entity_kind}")
        hb.decode_from_ring()
        hb.begin("h2d")
        # dispatch is timed in two stretches, the upload's end of the upload
        # span and all after it, so that each nests in the spans around it
        with obs.span("upload", records=frame.n_records) as up:
            with obs.timed(self.seconds, "pack", "gatherer"):
                cols, kwargs, batch = self.pack_batch(frame, pad_to, presorted)
            up.add(prepacked=int(batch["prepacked"]))
            with obs.timed(self.seconds, "dispatch", "gatherer"):
                events = None
                if self._device.type == "cuda":
                    # the events bracket the device's work on the batch, from
                    # its upload to its pull, and not the host's packing
                    # before it
                    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    events[0].record()
                staged = {
                    name: ingest.upload(array, self._device, site="gatherer.upload")
                    for name, array in cols.items()
                }
                self.bytes_h2d += batch["h2d_bytes"]
                up.add(bytes=batch["h2d_bytes"])
        with obs.timed(self.seconds, "dispatch", "gatherer"):
            hb.end("h2d")
            hb.add(bytes_h2d=batch["h2d_bytes"])
            obs.count("batches_uploaded")
            obs.count("h2d_bytes", batch["h2d_bytes"])
            if batch["run_keyed"]:
                obs.count("run_keyed_batches")
            self.run_keyed_batches += batch["run_keyed"]
            num_segments = kwargs["num_segments"]
            # occupancy: how much of the padded dispatch was real rows
            xprof.record_dispatch("metrics.compute_entity_metrics", frame.n_records, num_segments)
            hb.begin("compute")
            with obs.span("compute", records=frame.n_records, real_rows=frame.n_records,
                          padded_rows=num_segments):
                # a graph replay returns its static outputs, which the next replay
                # overwrites: the compaction below reads them first, in stream order
                if self._graphs is not None:
                    result = self._graphs.run(staged, **kwargs)
                else:
                    result = device_engine.compute_entity_metrics(staged, **kwargs)
                # the entity count is host-knowable, so the compacting pull is
                # queued here, right behind the batch's device pass
                key = self._entity_key(frame)
                if presorted:
                    n_entities = int(np.count_nonzero(key[1:] != key[:-1])) + 1
                else:
                    n_entities = int(np.unique(key).size)
                k = entity_bucket(n_entities, num_segments)
                int_names, float_names = wire_result_names(self.columns)
                # the pull's own occupancy: real entity rows of the bucketed slice
                xprof.record_dispatch("metrics.compact_results_wire", n_entities, k)
                block = device_engine.compact_results_wire(result, int_names, float_names, k)
                # the block's copy starts now, while the next batch computes;
                # finalize's collect waits for it (or, on a transient, copies
                # it again)
                staged = self._writeback.stage(block)
                if events is not None:
                    events[1].record()
                # the watermark while the batch's buffers are live (peak
                # attribution: the open compute span)
                xprof.sample_memory(devices=(self._device,))
            hb.end("compute")
            hb.add(real_rows=frame.n_records, padded_rows=num_segments, entities=n_entities)
            self.batches.append(dict(batch, entities=n_entities, events=events))
        # keep only what finalize reads, not the frame or the result dict
        return (self._entity_names(frame), staged, n_entities, int_names, float_names,
                frame.n_records, hb)

    def _finalize_device_batch(
        self, entity_names, staged, n_entities: int, int_names, float_names, n_records: int,
        hb, out,
    ) -> None:
        with obs.span("writeback", records=n_records, entities=n_entities) as wb:
            with obs.timed(self.seconds, "wait", "gatherer"):
                # the asynchronous recovery boundary: a device fault of this
                # batch surfaces here, at the wait on its copy, after its
                # guarded dispatch returned. The guarded wait copies the
                # block again on a transient; anything else re-raises to the
                # scheduler, and counts a strike toward the dispatch site
                # pad rows x row bytes of the compacted [columns, k] int32 block
                wasted = staged.nbytes - n_entities * (len(int_names) + len(float_names)) * 4
                # the phase at drain start ("copying" / "staged"), as JAX samples it
                hb.add(wb_phase=self._writeback.phase_code())
                hb.begin("d2h")
                block, d2h_bytes = self._writeback.collect(
                    staged, site="gatherer.writeback", wasted=wasted, degrade_site=self._GUARD_SITE,
                    name=str(self._bam_file),
                )
                hb.end("d2h")
            self.bytes_d2h += d2h_bytes
            wb.add(bytes=d2h_bytes)
            hb.add(bytes_d2h=d2h_bytes)
            hb.emit()
            xprof.sample_memory(devices=(self._device,))
            obs.count("d2h_bytes", d2h_bytes)
            obs.count("entities_written", n_entities)
            audit.add("rows.computed", n_entities)
            with obs.timed(self.seconds, "csv", "gatherer"):
                self._do_finalize_device_batch(
                    entity_names, block, n_entities, int_names, float_names, out
                )

    def _do_finalize_device_batch(
        self, entity_names, block, n_entities: int, int_names, float_names, out
    ) -> None:
        # the block is column-major ([columns, k]), so both halves are
        # zero-copy views of the pulled buffer
        ints = block[: len(int_names)]
        floats = block[len(int_names):].view(np.float32)
        self._write_device_rows(
            entity_names, n_entities, int_names, float_names, ints, floats, out
        )

    def _entity_names(self, frame: ReadFrame) -> List[str]:
        return frame.cell_names if self.entity_kind == "cell" else frame.gene_names

    #: audit-ledger reason for rows _filter_rows drops (subclass-named)
    _filter_reason = "filtered"

    def _filter_rows(self, names: np.ndarray):
        """Vectorized row mask (None = keep all); the gene axis drops multi-genes."""
        return None

    def _write_device_rows(
        self,
        entity_names,
        n_entities: int,
        int_names,
        float_names,
        ints: np.ndarray,
        floats: np.ndarray,
        out: MetricCSVWriter,
    ) -> None:
        """Format one batch's entity rows as a CSV block.

        ``ints``/``floats`` arrive column-major ([columns, k]); every
        accessor below slices a row.
        """
        names = np.asarray(entity_names, dtype=object)
        int_of = {n: i for i, n in enumerate(int_names)}
        float_of = {n: i for i, n in enumerate(float_names)}
        codes = ints[int_of["entity_code"], :n_entities].astype(np.int64)
        row_names = names[codes]
        keep = self._filter_rows(row_names)
        if keep is None:
            keep = slice(None)
        else:
            dropped = n_entities - int(np.count_nonzero(keep))
            if dropped:
                # conservation ledger: deliberately skipped rows are a
                # NAMED fold (multi-gene groups), never silent loss
                audit.add("rows.filtered", dropped, reason=self._filter_reason)
        index = np.where(row_names == "", "None", row_names)[keep]

        def int_col(column):
            return ints[int_of[column], :n_entities][keep].astype(np.int64)

        f32_cache: Dict[str, np.ndarray] = {}

        def f32_of(column):
            if column not in f32_cache:
                f32_cache[column] = ints[int_of[column], :n_entities][keep].astype(np.float32)
            return f32_cache[column]

        def derived(column):
            # the engine's exact f32 formulas (metrics/device.py), applied to
            # the shipped integer columns instead of pulling the ratio
            if column == "reads_per_molecule":
                nm, nr = f32_of("n_molecules"), f32_of("n_reads")
                result = np.where(nm > 0, nr / np.maximum(nm, 1), np.nan)
            elif column == "reads_per_fragment":
                nf, nr = f32_of("n_fragments"), f32_of("n_reads")
                result = np.where(nf > 0, nr / np.maximum(nf, 1), np.nan)
            elif column == "fragments_per_molecule":
                nm, nf = f32_of("n_molecules"), f32_of("n_fragments")
                result = np.where(nm > 0, nf / np.maximum(nm, 1), np.nan)
            elif column == "pct_mitochondrial_molecules":
                mito = f32_of("n_mitochondrial_molecules")
                nr = f32_of("n_reads")
                result = np.where(mito > 0, mito / np.maximum(nr, 1) * np.float32(100.0), 0.0)
            else:
                raise KeyError(f"no host derivation for wire-excluded column {column!r}")
            return result.astype(np.float64)

        def column_values(column):
            if column in int_of:
                return int_col(column)
            if column in float_of:
                return floats[float_of[column], :n_entities][keep].astype(np.float64)
            if column in _WIRE_ZERO_INTS:
                return np.zeros(index.shape[0], dtype=np.int64)
            return derived(column)

        out.write_block(index.astype(str), [column_values(c) for c in self.columns])

    # ---- cpu backend (the reference's streaming semantics) ---------------

    def _extract_cpu(self, mode: Optional[str]) -> None:
        out = MetricCSVWriter(self._output_stem, self._compress)
        try:
            with AlignmentReader(self._bam_file, mode) as reader:
                self._aggregate(iter(reader), out)
        except BaseException:
            # never publish a partial, valid-looking CSV
            out.discard()
            raise
        else:
            out.close()

    def _aggregate(self, records, out: MetricCSVWriter) -> None:
        raise NotImplementedError


class GatherCellMetrics(MetricGatherer):
    """Per-cell metrics; input must be sorted by CB, UB, GE (gene fastest)."""

    entity_kind = "cell"
    columns = CELL_COLUMNS

    def _aggregate(self, records, out: MetricCSVWriter) -> None:
        out.write_header(vars(CellMetrics()))
        for cell_iterator, cell_tag in iter_cell_barcodes(records):
            aggregator = CellMetrics()
            for molecule_iterator, molecule_tag in iter_molecule_barcodes(cell_iterator):
                for gene_iterator, gene_tag in iter_genes(molecule_iterator):
                    aggregator.parse_molecule(
                        tags=(cell_tag, molecule_tag, gene_tag), records=gene_iterator
                    )
            aggregator.finalize(mitochondrial_genes=self._mitochondrial_gene_ids)
            out.write(cell_tag, vars(aggregator))


class GatherGeneMetrics(MetricGatherer):
    """Per-gene metrics; input must be sorted by GE, CB, UB (molecule fastest)."""

    entity_kind = "gene"
    columns = GENE_COLUMNS
    _filter_reason = "multi_gene"

    def _filter_rows(self, names: np.ndarray):
        # multi-gene "a,b" groups are skipped entirely, like the counting stage
        return np.char.find(names.astype(str), ",") < 0

    def _aggregate(self, records, out: MetricCSVWriter) -> None:
        out.write_header(vars(GeneMetrics()))
        for gene_iterator, gene_tag in iter_genes(records):
            if gene_tag and len(gene_tag.split(",")) > 1:
                # multi-gene groups are skipped, as on the device path
                audit.add("rows.filtered", 1, reason="multi_gene")
                continue
            aggregator = GeneMetrics()
            for cell_iterator, cell_tag in iter_cell_barcodes(gene_iterator):
                for molecule_iterator, molecule_tag in iter_molecule_barcodes(cell_iterator):
                    aggregator.parse_molecule(
                        tags=(gene_tag, cell_tag, molecule_tag), records=molecule_iterator
                    )
            aggregator.finalize()
            out.write(gene_tag, vars(aggregator))
