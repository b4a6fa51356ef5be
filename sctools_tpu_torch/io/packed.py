"""ReadFrame: BAM records as packed struct-of-arrays columns.

The port's own copy of ``sctools_tpu.io.packed``: the metrics path's input
format. Each alignment collapses to a handful of integer scalars, with
strings dictionary-encoded host-side: cell/molecule barcodes, gene names and
query names become indices into lexicographically sorted vocabularies, so
device sort order over codes equals string sort order and CSV row order
matches without any device-side string handling.

Missing tags encode as vocabulary entry "" (which sorts first) and flag
columns record true absence where semantics require it (XF missingness feeds
reads_unmapped).

A BGZF BAM decodes through the native layer (``sctools_tpu_torch.native``:
thread-pooled inflate, records parsed straight into these columns), as the
JAX package's does; custom tag keys and inputs that are not gzip (SAM text)
take the pure-Python record path (``io.sam.AlignmentReader``). A frame of
the ingest ring's packed column arena (``ingest.ring_frames``) carries two
prepacked side columns in ``extras``, as in the JAX package; a frame without
them derives its packed flags and sort operands from the columns below.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .. import consts
from . import bgzf
from .sam import AlignmentReader, BamRecord

_QUAL_THRESHOLD = 30

# Padding fill per column for device batches. Columns absent here pad with
# 0/False; these sentinels mean "absent" to the metric semantics (NH missing,
# perfect-barcode not computable) and "sorts after every real record" for
# the prepacked sort operands.
PAD_FILLS = {
    "nh": -1,
    "perfect_umi": -1,
    "perfect_cb": -1,
    "key_hi": np.iinfo(np.int32).max,
    "key_lo": np.iinfo(np.int32).max,
    "ps": np.iinfo(np.int32).max,
    "m_ref": np.iinfo(np.int32).max,
}

# Bit layout of the packed per-record ``flags`` device column: seven narrow
# fields travel as one int16. A zero value means "padding": all flags off,
# perfect fields absent, NH missing.
FLAG_STRAND = 1 << 0
FLAG_UNMAPPED = 1 << 1
FLAG_DUPLICATE = 1 << 2
FLAG_SPLICED = 1 << 3
FLAG_XF_SHIFT = 4  # 3 bits: consts.XF_* codes 0..5
FLAG_PUMI_SHIFT = 7  # 2 bits: stored value+1 (-1 absent / 0 / 1 -> 0,1,2)
FLAG_PCB_SHIFT = 9  # 2 bits: same encoding
FLAG_NH1_SHIFT = 11  # 1 bit: NH tag present and == 1
FLAG_MITO = 1 << 12  # gene is mitochondrial (host vocabulary lookup)
# 1 bit: first record of a (k1,k2,k3) molecule run (run-keyed wire only —
# the per-record sort keys then live in a per-run table the device gathers
# back through cumsum of these bits; metrics.gatherer._pad_columns sets it)
FLAG_RUN_START = 1 << 13

# Packed device-sort key layout, shared by the host packer
# (metrics.gatherer._pad_columns) and the device unpacker
# (metrics.device.compute_entity_metrics, prepacked=True): three codes
# < 2^KEY_CODE_BITS ride two int32 operands as
#   key_hi = k1 << KEY_HI_SHIFT | k2 >> KEY_HI_SHIFT
#   key_lo = (k2 & KEY_LO_MASK) << KEY_CODE_BITS | k3
# plus m_ref = mapped-last << KEY_UNMAPPED_SHIFT | (ref+1) and
# ps = pos << 1 | strand (injective for the host-checked ranges).
KEY_CODE_BITS = 20
KEY_HI_SHIFT = 10
KEY_LO_MASK = (1 << KEY_HI_SHIFT) - 1
KEY_CODE_MASK = (1 << KEY_CODE_BITS) - 1
KEY_UNMAPPED_SHIFT = 30


def wire_layout(
    wide_genomic: bool,
    small_ref: bool,
    run_keys: bool = False,
    with_cb: bool = True,
):
    """Ordered (column name, lane width) spec of the monoblock wire.

    The one source of truth for the one-int32-buffer batch transport: the
    host packer (metrics.gatherer._pack_wire) and the device unpacker
    (metrics.device._unpack_wire) both iterate this list. Widths are bytes
    per record (4 = int32/uint32 lane, 2 = uint16 lane, 1 = uint8 lane);
    wider lanes come first so every section stays 4-byte aligned for any
    padded record count that is a multiple of 4. ``n_valid`` is a single
    leading int32 word, listed separately by both sides.

    ``with_cb=False`` (the gene axis) omits the ``cb_qual`` lane. With
    ``run_keys`` the two per-record sort-key lanes move off the wire into a
    trailing per-run table (``key_hi_runs`` then ``key_lo_runs``, each
    ``num_runs`` int32 words), and each record's FLAG_RUN_START bit rebuilds
    the record->run mapping on the device.
    """
    cols = [] if run_keys else [("key_hi", 4), ("key_lo", 4)]
    cols.append(("ps", 4))
    if wide_genomic:
        cols += [("genomic_qual", 4), ("genomic_total", 4)]
    if not small_ref:
        cols.append(("m_ref", 4))
    cols.append(("umi_qual", 2))
    if with_cb:
        cols.append(("cb_qual", 2))
    cols.append(("flags", 2))
    if not wide_genomic:
        cols += [("genomic_qual", 2), ("genomic_total", 2)]
    if small_ref:
        cols.append(("m_ref", 1))
    return cols


# 3-bit-per-base packed barcodes: A=1 C=2 G=3 N=4 T=5, left-aligned in a
# uint64, so integer order == byte-lexicographic string order and ""
# (missing tag) packs to 0, sorting first. Strings that cannot pack
# (non-ACGTN or > 21 bases) have no u64 form: callers assign synthetic ids
# above 2**63 (all regular packings are < 5<<60 < 2**63).
_BASE_CODE = {"A": 1, "C": 2, "G": 3, "N": 4, "T": 5}
_CODE_BASE = {v: k for k, v in _BASE_CODE.items()}
BARCODE_U64_MAX_LEN = 21
IRREGULAR_BARCODE_BASE = np.uint64(1) << np.uint64(63)


def pack_barcode_u64(value: str):
    """Pack an ACGTN string (<= 21 bases) to its order-preserving uint64.

    Returns None when the string cannot pack (the caller assigns a
    synthetic irregular id).
    """
    if len(value) > BARCODE_U64_MAX_LEN:
        return None
    packed = 0
    shift = 60
    for ch in value:
        code = _BASE_CODE.get(ch)
        if code is None:
            return None
        packed |= code << shift
        shift -= 3
    return packed


def unpack_barcode_u64(packed: int) -> str:
    """Inverse of pack_barcode_u64 for regular (non-synthetic) values."""
    out = []
    for shift in range(60, -1, -3):
        code = (int(packed) >> shift) & 7
        if code == 0:
            break
        out.append(_CODE_BASE[code])
    return "".join(out)


def pack_flags(
    strand: np.ndarray,
    unmapped: np.ndarray,
    duplicate: np.ndarray,
    spliced: np.ndarray,
    xf: np.ndarray,
    perfect_umi: np.ndarray,
    perfect_cb: np.ndarray,
    nh: np.ndarray,
    is_mito: np.ndarray,
) -> np.ndarray:
    """Pack per-record flag fields into the int16 device ``flags`` column."""
    flags = np.asarray(strand, dtype=np.int32) & 1
    flags |= (np.asarray(unmapped, dtype=np.int32) & 1) << 1
    flags |= (np.asarray(duplicate, dtype=np.int32) & 1) << 2
    flags |= (np.asarray(spliced, dtype=np.int32) & 1) << 3
    flags |= (np.asarray(xf, dtype=np.int32) & 7) << FLAG_XF_SHIFT
    flags |= ((np.asarray(perfect_umi, dtype=np.int32) + 1) & 3) << FLAG_PUMI_SHIFT
    flags |= ((np.asarray(perfect_cb, dtype=np.int32) + 1) & 3) << FLAG_PCB_SHIFT
    flags |= (np.asarray(nh, dtype=np.int32) == 1).astype(np.int32) << FLAG_NH1_SHIFT
    flags |= np.asarray(is_mito, dtype=np.int32) << 12
    return flags.astype(np.int16)


@dataclass
class ReadFrame:
    """Columnar batch of alignment records (host numpy; device-ready)."""

    # dictionary-coded strings
    cell: np.ndarray  # int32 codes into cell_names
    umi: np.ndarray
    gene: np.ndarray
    qname: np.ndarray
    cell_names: List[str]
    umi_names: List[str]
    gene_names: List[str]
    qname_names: List[str]

    # alignment coordinates / flags
    ref: np.ndarray  # int32, -1 when unmapped
    pos: np.ndarray  # int32
    strand: np.ndarray  # int8, 1 == reverse
    unmapped: np.ndarray  # bool
    duplicate: np.ndarray  # bool
    spliced: np.ndarray  # bool (cigar contains N op)

    # tag-derived fields
    xf: np.ndarray  # int8, consts.XF_* codes (XF_MISSING when absent)
    nh: np.ndarray  # int32, -1 when absent
    perfect_umi: np.ndarray  # int8: 1 match / 0 mismatch / -1 not computable
    perfect_cb: np.ndarray  # int8: same convention, gated on CB presence

    # quality summaries, exact integer form; the device recovers the float32
    # values by one f32 division each
    umi_qual: np.ndarray  # uint16: above30<<8 | len(UY); 0 == tag missing
    cb_qual: np.ndarray  # uint16: above30<<8 | len(CY); 0 == tag missing
    genomic_qual: np.ndarray  # uint32: above30<<16 | aligned len; 0 == none
    genomic_total: np.ndarray  # uint32: sum of aligned phred scores

    # optional per-record side columns riding the frame through slicing,
    # concatenation and compaction. The arena decoder ships two: ``flags``
    # (the packed int16 device word, bits 0..11: all but the host-knowledge
    # FLAG_MITO and FLAG_RUN_START bits) and ``ps`` (the prepacked
    # pos << 1 | strand sort operand). Consumers treat a missing key as
    # "derive it yourself"; concat keeps only keys both sides carry.
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.cell)

    @property
    def n_records(self) -> int:
        return len(self.cell)

    def _view(self, **kwargs) -> "ReadFrame":
        """A frame whose arrays view this frame's (slice, compact).

        The hook of the ingest frame witness: a stamped arena frame
        (``SCTOOLS_TPU_FRAME_DEBUG=1``, ``ingest.framedebug.WitnessFrame``)
        overrides it so that derived views inherit the stamp, while
        ``copy_frame``, which owns its memory, builds a plain ReadFrame.
        """
        return ReadFrame(**kwargs)

    # ---- derived float views (the plain schema's quality columns) --------

    @property
    def umi_frac30(self) -> np.ndarray:
        """float32 fraction of UY qualities > 30 (nan when tag missing)."""
        return _qual_frac(self.umi_qual, 8)

    @property
    def cb_frac30(self) -> np.ndarray:
        """float32 fraction of CY qualities > 30 (nan when tag missing)."""
        return _qual_frac(self.cb_qual, 8)

    @property
    def genomic_frac30(self) -> np.ndarray:
        """float32 fraction of aligned qualities > 30 (nan when absent)."""
        return _qual_frac(self.genomic_qual, 16)

    @property
    def genomic_mean(self) -> np.ndarray:
        """float32 mean aligned quality (nan when absent)."""
        length = (self.genomic_qual & 0xFFFF).astype(np.float32)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = self.genomic_total.astype(np.float32) / length
        return np.where(length > 0, out, np.float32(np.nan)).astype(np.float32)


def _qual_frac(packed: np.ndarray, shift: int) -> np.ndarray:
    mask = (1 << shift) - 1
    length = (packed & mask).astype(np.float32)
    above = (packed >> shift).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = above / length
    return np.where(length > 0, out, np.float32(np.nan)).astype(np.float32)


def _pack_string_qual(qual: Optional[str], threshold: int = _QUAL_THRESHOLD) -> int:
    """above30<<8 | len for a string-encoded quality tag (0 == missing).

    Lengths above 255 cannot be represented and degrade to "missing".
    """
    if not qual or len(qual) > 0xFF:
        return 0
    above = sum(1 for c in qual if ord(c) - 33 > threshold)
    return (above << 8) | len(qual)


def _pack_aligned_qual(qualities: Sequence[int], threshold: int = _QUAL_THRESHOLD):
    """(above30<<16 | len, total) for aligned phred scores (0, 0 == absent)."""
    n = len(qualities)
    if not n or n > 0xFFFF:
        return 0, 0
    above = sum(1 for q in qualities if q > threshold)
    return (above << 16) | n, sum(qualities)


def _encode_column(values: List[str]):
    """values -> (int32 codes, sorted vocabulary). '' sorts first."""
    arr = np.asarray(values, dtype=object)
    vocabulary, codes = np.unique(arr, return_inverse=True)
    return codes.astype(np.int32), [str(v) for v in vocabulary]


DEFAULT_TAG_KEYS = ("CB", "UB", "GE")


def frame_from_records(
    records: Iterable[BamRecord],
    tag_keys: tuple = DEFAULT_TAG_KEYS,
) -> ReadFrame:
    """Pack an iterable of BamRecords into a ReadFrame.

    ``tag_keys`` = (cell, molecule, gene) tag names. Perfect-barcode
    comparisons stay defined against the 10x raw-tag pairs (CR/UR).
    """
    cells: List[str] = []
    umis: List[str] = []
    genes: List[str] = []
    qnames: List[str] = []
    ref: List[int] = []
    pos: List[int] = []
    strand: List[int] = []
    unmapped: List[bool] = []
    duplicate: List[bool] = []
    spliced: List[bool] = []
    xf: List[int] = []
    nh: List[int] = []
    perfect_umi: List[int] = []
    perfect_cb: List[int] = []
    umi_qual: List[int] = []
    cb_qual: List[int] = []
    genomic_qual: List[int] = []
    genomic_total: List[int] = []

    cb_key, ub_key, ge_key = tag_keys
    for record in records:
        tags = record.tags
        cb = tags.get(cb_key, (None, ""))[1]
        cr = tags.get("CR", (None, None))[1]
        ub = tags.get(ub_key, (None, ""))[1]
        ur = tags.get("UR", (None, None))[1]
        ge = tags.get(ge_key, (None, ""))[1]
        uy = tags.get("UY", (None, None))[1]
        cy = tags.get("CY", (None, None))[1]
        xf_value = tags.get("XF", (None, None))[1]
        nh_value = tags.get("NH", (None, None))[1]

        cells.append(cb)
        umis.append(ub)
        genes.append(ge)
        qnames.append(record.query_name)
        ref.append(record.reference_id)
        pos.append(record.pos)
        strand.append(1 if record.is_reverse else 0)
        unmapped.append(record.is_unmapped)
        duplicate.append(record.is_duplicate)
        cigar_stats, _ = record.get_cigar_stats()
        spliced.append(cigar_stats[3] > 0)
        if xf_value is None:
            xf.append(consts.XF_MISSING)
        else:
            xf.append(consts.XF_VALUE_TO_CODE.get(xf_value, consts.XF_OTHER))
        nh.append(nh_value if nh_value is not None else -1)
        if ur is not None and "UB" in tags:
            perfect_umi.append(1 if ur == ub else 0)
        else:
            perfect_umi.append(-1)
        if "CB" in tags and cr is not None:
            perfect_cb.append(1 if cr == cb else 0)
        else:
            perfect_cb.append(-1)
        umi_qual.append(_pack_string_qual(uy))
        cb_qual.append(_pack_string_qual(cy))
        gq, gt = _pack_aligned_qual(record.query_alignment_qualities or [])
        genomic_qual.append(gq)
        genomic_total.append(gt)

    cell_codes, cell_names = _encode_column(cells)
    umi_codes, umi_names = _encode_column(umis)
    gene_codes, gene_names = _encode_column(genes)
    qname_codes, qname_names = _encode_column(qnames)

    return ReadFrame(
        cell=cell_codes,
        umi=umi_codes,
        gene=gene_codes,
        qname=qname_codes,
        cell_names=cell_names,
        umi_names=umi_names,
        gene_names=gene_names,
        qname_names=qname_names,
        ref=np.asarray(ref, dtype=np.int32),
        pos=np.asarray(pos, dtype=np.int32),
        strand=np.asarray(strand, dtype=np.int8),
        unmapped=np.asarray(unmapped, dtype=bool),
        duplicate=np.asarray(duplicate, dtype=bool),
        spliced=np.asarray(spliced, dtype=bool),
        xf=np.asarray(xf, dtype=np.int8),
        nh=np.asarray(nh, dtype=np.int32),
        perfect_umi=np.asarray(perfect_umi, dtype=np.int8),
        perfect_cb=np.asarray(perfect_cb, dtype=np.int8),
        umi_qual=np.asarray(umi_qual, dtype=np.uint16),
        cb_qual=np.asarray(cb_qual, dtype=np.uint16),
        genomic_qual=np.asarray(genomic_qual, dtype=np.uint32),
        genomic_total=np.asarray(genomic_total, dtype=np.uint32),
    )


_PER_RECORD_FIELDS = (
    "cell", "umi", "gene", "qname", "ref", "pos", "strand", "unmapped",
    "duplicate", "spliced", "xf", "nh", "perfect_umi", "perfect_cb",
    "umi_qual", "cb_qual", "genomic_qual", "genomic_total",
)
_CODED_FIELDS = ("cell", "umi", "gene", "qname")


def slice_frame(frame: ReadFrame, start: int, stop: int) -> ReadFrame:
    """Row-slice a frame; vocabularies are shared (codes stay valid)."""
    kwargs = {name: getattr(frame, name)[start:stop] for name in _PER_RECORD_FIELDS}
    for name in _CODED_FIELDS:
        kwargs[f"{name}_names"] = getattr(frame, f"{name}_names")
    kwargs["extras"] = {k: v[start:stop] for k, v in frame.extras.items()}
    return frame._view(**kwargs)


def copy_frame(frame: ReadFrame) -> ReadFrame:
    """Deep-copy every per-record array (vocabulary lists are shared), so a
    carried tail owns its memory instead of viewing the batch it came from.

    A frame of the ingest ring views a recycled arena slot and is valid only
    for the ring's retention window (``ingest.ring``); one held longer must
    be copied.
    """
    kwargs = {
        name: np.array(getattr(frame, name)) for name in _PER_RECORD_FIELDS
    }
    for name in _CODED_FIELDS:
        kwargs[f"{name}_names"] = getattr(frame, f"{name}_names")
    kwargs["extras"] = {k: np.array(v) for k, v in frame.extras.items()}
    return ReadFrame(**kwargs)


def compact_frame(frame: ReadFrame) -> ReadFrame:
    """Shrink each vocabulary to the names actually referenced.

    Slicing shares the parent's (possibly merged) vocabularies; a carry frame
    held across streaming batches must compact them, or the name lists would
    accumulate the union of every batch seen so far. Codes are remapped onto
    the compacted (still sorted) vocabulary.
    """
    kwargs = {name: getattr(frame, name) for name in _PER_RECORD_FIELDS}
    kwargs["extras"] = dict(frame.extras)
    for name in _CODED_FIELDS:
        codes = getattr(frame, name)
        names = getattr(frame, f"{name}_names")
        used = np.unique(codes)
        if len(used) == len(names):
            kwargs[f"{name}_names"] = names
            continue
        remap = np.zeros(len(names), dtype=np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        kwargs[name] = remap[codes]
        kwargs[f"{name}_names"] = [names[int(code)] for code in used]
    return frame._view(**kwargs)


def _merge_coded(codes_a, names_a, codes_b, names_b):
    """Concatenate two dictionary-coded columns under one merged vocabulary.

    Both vocabularies are sorted (np.unique order), so the union stays sorted
    and a searchsorted gather remaps each side's codes.
    """
    if names_a == names_b:
        return np.concatenate([codes_a, codes_b]).astype(np.int32), names_a
    a = np.asarray(names_a, dtype=object)
    b = np.asarray(names_b, dtype=object)
    union = np.union1d(a, b)
    remap_a = np.searchsorted(union, a).astype(np.int32)
    remap_b = np.searchsorted(union, b).astype(np.int32)
    codes = np.concatenate([
        remap_a[codes_a] if len(codes_a) else codes_a,
        remap_b[codes_b] if len(codes_b) else codes_b,
    ]).astype(np.int32)
    return codes, [str(value) for value in union]


def concat_frames(a: ReadFrame, b: ReadFrame) -> ReadFrame:
    """Concatenate two frames, merging their vocabularies.

    The carry mechanism of the streaming pipeline: the incomplete trailing
    entity of batch k is prepended to batch k+1, so record order is
    preserved and codes are remapped into the merged (still sorted)
    vocabularies.
    """
    if a.n_records == 0:
        return b
    if b.n_records == 0:
        return a
    kwargs = {}
    for name in _CODED_FIELDS:
        codes, names = _merge_coded(
            getattr(a, name), getattr(a, f"{name}_names"),
            getattr(b, name), getattr(b, f"{name}_names"),
        )
        kwargs[name] = codes
        kwargs[f"{name}_names"] = names
    for name in _PER_RECORD_FIELDS:
        if name in _CODED_FIELDS:
            continue
        kwargs[name] = np.concatenate([getattr(a, name), getattr(b, name)])
    # keep only the side columns both sides carry: an arena batch after a
    # Python-decoded or copied carry without them re-derives them instead
    kwargs["extras"] = {
        k: np.concatenate([a.extras[k], b.extras[k]]) for k in a.extras if k in b.extras
    }
    return ReadFrame(**kwargs)


def iter_frames_from_bam(
    path: str,
    batch_records: int,
    tag_keys: tuple = DEFAULT_TAG_KEYS,
    want_qname: bool = True,
):
    """Yield ReadFrames of <= batch_records alignments in file order.

    The bounded-memory decode path. Each frame has its own (sorted)
    vocabularies. A gzip input with the default tag keys streams through
    the native decoder (``native.stream_frames``; ``want_qname=False``
    leaves the qname column empty there, for callers that never read it);
    custom ``tag_keys`` (the native parser reads the fixed 10x tag set) and
    inputs that are not gzip take the Python decoder, as in the JAX
    package.
    """
    if batch_records < 1:
        # 0 would otherwise read as clean EOF and yield an empty-but-valid
        # result for what is always a caller bug
        raise ValueError(f"batch_records must be >= 1, got {batch_records}")
    if tuple(tag_keys) == DEFAULT_TAG_KEYS and bgzf.is_gzip(path):
        from .. import native

        native.library()  # a failed build or load raises here, never caught below
        stream = native.stream_frames(path, batch_records, want_qname=want_qname)
        try:
            first = next(stream, None)
        except RuntimeError:
            # the native decoder refused the input before its first batch (a
            # malformed BGZF container, or gzip that is not BGZF): decode it
            # with the Python reader, as the JAX package's route does, so the
            # caller gets that reader's records or its own exception
            stream = None
        if stream is not None:
            if first is not None:
                yield first
                yield from stream
            return
    yield from _python_frames(path, batch_records, tuple(tag_keys))


def _python_frames(path: str, batch_records: int, tag_keys: tuple):
    with AlignmentReader(path) as reader:
        records = iter(reader)
        while True:
            with _cyclic_gc_paused():
                chunk = list(itertools.islice(records, batch_records))
                frame = frame_from_records(chunk, tag_keys=tag_keys) if chunk else None
                del chunk  # the records go before the caller takes the frame
            if frame is None:
                break
            yield frame


@contextlib.contextmanager
def _cyclic_gc_paused():
    """Pause Python's cyclic garbage collector within the block.

    A chunk's decoded records form no reference cycles, yet each of them is
    several tracked containers, and the collector's passes over a million of
    them take a large share of the Python decoder's time. Their reference
    counts free them all the same.
    """
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def frame_from_bam(path: str) -> ReadFrame:
    """Decode a whole BAM/SAM file into one ReadFrame.

    A gzip input decodes through the native layer (``native.frame_from_bam``);
    SAM text, and an input the native decoder refuses, take the Python
    record path, as in the JAX package.
    """
    if bgzf.is_gzip(path):
        from .. import native

        native.library()  # a failed build or load raises here, never caught below
        try:
            return native.frame_from_bam(path)
        except RuntimeError:
            pass  # the Python reader gives the records, or its own exception
    with AlignmentReader(path) as reader:
        return frame_from_records(reader)
