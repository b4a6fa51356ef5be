"""BAM/SAM records, readers, and writers — the framework's pysam replacement.

Implements the BAM binary record layout (SAMv1 spec section 4) and SAM text,
on top of the BGZF codec in :mod:`sctools_tpu_torch.io.bgzf`. The record API
mirrors the subset of the pysam ``AlignedSegment`` surface the reference
library uses (get_tag/set_tag/has_tag, is_unmapped/is_reverse/is_duplicate,
pos, reference_id, query_qualities, query_alignment_qualities,
get_cigar_stats), so code written against the reference ports directly.

The port's own copy of ``sctools_tpu.io.sam`` (header, record, reader and
writer), plus ``read_raw_header`` / ``iter_raw_records``: the attach loop
passes u2 records through as bytes and appends tags, the way the JAX native
layer does (sctools_tpu/native/attach.cpp:71-109, :221-282).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

from . import bgzf

BAM_MAGIC = b"BAM\x01"

CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OP_TO_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# the hex digits of packed sequence bytes are its 4-bit codes, high nibble
# first: translating them decodes two bases a byte at C speed
_HEX_TO_NT16 = str.maketrans("0123456789abcdef", SEQ_NT16)
_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
for _c in "acmgrsvtwyhkdbn":
    _NT16_CODE[_c] = _NT16_CODE[_c.upper()]

# flag bits
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


class BamHeader:
    """BAM/SAM header: raw text plus the binary reference dictionary."""

    def __init__(self, text: str = "", references: Sequence[Tuple[str, int]] = ()):
        self.text = text
        self.references: List[Tuple[str, int]] = list(references)
        self._name_to_id = {name: i for i, (name, _) in enumerate(self.references)}

    def reference_id(self, name: str) -> int:
        return self._name_to_id.get(name, -1)

    def reference_name(self, ref_id: int) -> Optional[str]:
        if 0 <= ref_id < len(self.references):
            return self.references[ref_id][0]
        return None

    @classmethod
    def from_text(cls, text: str) -> "BamHeader":
        """Build a header from SAM text, deriving references from @SQ lines."""
        references = []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                name, length = None, 0
                for field in line.split("\t")[1:]:
                    if field.startswith("SN:"):
                        name = field[3:]
                    elif field.startswith("LN:"):
                        length = int(field[3:])
                if name is not None:
                    references.append((name, length))
        return cls(text, references)

    def copy(self) -> "BamHeader":
        return BamHeader(self.text, list(self.references))


class BamRecord:
    """A single alignment record.

    Field names and semantics follow the pysam surface used by the reference
    (query_name, flag, reference_id, pos, mapq, cigar, next_reference_id,
    next_pos, tlen, sequence, quality, tags).  ``quality`` holds numeric phred
    scores (no +33 offset); tag values are native Python types.
    """

    __slots__ = [
        "query_name", "flag", "reference_id", "pos", "mapq", "cigar",
        "next_reference_id", "next_pos", "tlen", "sequence", "quality",
        "_tags", "_header",
    ]

    def __init__(
        self,
        query_name: str = "",
        flag: int = FUNMAP,
        reference_id: int = -1,
        pos: int = -1,
        mapq: int = 0,
        cigar: Sequence[Tuple[int, int]] = (),
        next_reference_id: int = -1,
        next_pos: int = -1,
        tlen: int = 0,
        sequence: str = "",
        quality: Optional[Sequence[int]] = None,
        tags: Optional[Dict[str, Tuple[str, object]]] = None,
        header: Optional[BamHeader] = None,
    ):
        self.query_name = query_name
        self.flag = flag
        self.reference_id = reference_id
        self.pos = pos
        self.mapq = mapq
        self.cigar: List[Tuple[int, int]] = list(cigar)  # [(op_code, length)]
        self.next_reference_id = next_reference_id
        self.next_pos = next_pos
        self.tlen = tlen
        self.sequence = sequence
        self.quality: Optional[List[int]] = list(quality) if quality is not None else None
        self._tags: Dict[str, Tuple[str, object]] = dict(tags) if tags else {}
        self._header = header

    # ---- pysam-compatible convenience surface ---------------------------

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FDUP)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def reference_name(self) -> Optional[str]:
        if self._header is None or self.reference_id < 0:
            return None
        return self._header.reference_name(self.reference_id)

    @property
    def query_qualities(self) -> Optional[List[int]]:
        return self.quality

    @property
    def query_alignment_qualities(self) -> Optional[List[int]]:
        """Qualities of the aligned portion (soft-clipped ends excluded)."""
        if self.quality is None:
            return None
        start, end = self._clip_bounds()
        return self.quality[start:end]

    @property
    def query_alignment_sequence(self) -> str:
        start, end = self._clip_bounds()
        return self.sequence[start:end]

    def _clip_bounds(self) -> Tuple[int, int]:
        start, end = 0, len(self.sequence)
        ops = [c for c in self.cigar if c[0] != _CIGAR_OP_TO_CODE["H"]]
        if ops:
            if ops[0][0] == _CIGAR_OP_TO_CODE["S"]:
                start = ops[0][1]
            if len(ops) > 1 and ops[-1][0] == _CIGAR_OP_TO_CODE["S"]:
                end -= ops[-1][1]
        return start, end

    def get_cigar_stats(self) -> Tuple[List[int], List[int]]:
        """(total base count per cigar op, op occurrence count per op).

        Index order follows MIDNSHP=X plus the back/NM slot (length 11),
        matching pysam's layout so ``stats[3]`` is the N (splice) base count
        used by the metrics engine (reference: aggregator.py:329-331).
        """
        base_counts = [0] * 11
        op_counts = [0] * 11
        for op, length in self.cigar:
            base_counts[op] += length
            op_counts[op] += 1
        return base_counts, op_counts

    @property
    def cigarstring(self) -> Optional[str]:
        if not self.cigar:
            return None
        return "".join(f"{length}{CIGAR_OPS[op]}" for op, length in self.cigar)

    def get_tag(self, key: str):
        try:
            return self._tags[key][1]
        except KeyError:
            raise KeyError(f"tag '{key}' not present")

    def has_tag(self, key: str) -> bool:
        return key in self._tags

    def set_tag(self, tag: str, value, value_type: Optional[str] = None) -> None:
        if value is None:
            self._tags.pop(tag, None)
            return
        if value_type is None:
            if isinstance(value, int):
                value_type = "i"
            elif isinstance(value, float):
                value_type = "f"
            else:
                value_type = "Z"
        self._tags[tag] = (value_type, value)

    def get_tags(self) -> List[Tuple[str, object]]:
        return [(k, v) for k, (_t, v) in self._tags.items()]

    @property
    def tags(self) -> Dict[str, Tuple[str, object]]:
        return self._tags

    def __repr__(self) -> str:
        return (
            f"BamRecord({self.query_name!r}, flag={self.flag}, ref={self.reference_id}, "
            f"pos={self.pos}, tags={list(self._tags)})"
        )

    # ---- binary codec ---------------------------------------------------

    _FIXED = struct.Struct("<iiBBHHHiiii")

    def to_bam_bytes(self) -> bytes:
        name = self.query_name.encode() + b"\x00"
        n_cigar = len(self.cigar)
        cigar_packed = b"".join(
            struct.pack("<I", (length << 4) | op) for op, length in self.cigar
        )
        seq = self.sequence
        l_seq = len(seq)
        seq_packed = bytearray((l_seq + 1) // 2)
        for i, base in enumerate(seq):
            code = _NT16_CODE.get(base, 15)
            if i % 2 == 0:
                seq_packed[i // 2] = code << 4
            else:
                seq_packed[i // 2] |= code
        if self.quality is None:
            qual = b"\xff" * l_seq
        else:
            qual = bytes(min(q, 0xFF) for q in self.quality)
        tags = self._encode_tags()
        # bin is a BAI indexing hint; 0 is acceptable for our outputs
        fixed = self._FIXED.pack(
            self.reference_id,
            self.pos,
            len(name),
            self.mapq,
            0,
            n_cigar,
            self.flag,
            l_seq,
            self.next_reference_id,
            self.next_pos,
            self.tlen,
        )
        body = fixed + name + cigar_packed + bytes(seq_packed) + qual + tags
        return struct.pack("<i", len(body)) + body

    def _encode_tags(self) -> bytes:
        out = bytearray()
        for key, (value_type, value) in self._tags.items():
            out += key.encode()
            if value_type == "i":
                number = int(value)
                if number > 0x7FFFFFFF:  # promote to uint32 like htslib does
                    out += b"I" + struct.pack("<I", number)
                else:
                    out += b"i" + struct.pack("<i", number)
            elif value_type in "cCsSI":
                out += value_type.encode() + struct.pack(
                    "<" + value_type.replace("c", "b").replace("C", "B").replace(
                        "s", "h").replace("S", "H"),
                    int(value),
                )
            elif value_type == "A":
                out += b"A" + (value if isinstance(value, bytes) else str(value).encode())[:1]
            elif value_type == "f":
                out += b"f" + struct.pack("<f", float(value))
            elif value_type == "Z":
                text = value if isinstance(value, str) else str(value)
                out += b"Z" + text.encode() + b"\x00"
            elif value_type == "H":
                text = value if isinstance(value, str) else str(value)
                out += b"H" + text.encode() + b"\x00"
            elif value_type == "B":
                sub_type, array = value
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub_type]
                out += b"B" + sub_type.encode() + struct.pack("<i", len(array))
                out += struct.pack("<" + fmt * len(array), *array)
            else:
                raise ValueError(f"unsupported tag type {value_type!r}")
        return bytes(out)

    @classmethod
    def from_bam_bytes(cls, data: bytes, header: Optional[BamHeader] = None) -> "BamRecord":
        (
            ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
            next_ref, next_pos, tlen,
        ) = cls._FIXED.unpack_from(data, 0)
        offset = cls._FIXED.size
        name = data[offset : offset + l_read_name - 1].decode()
        offset += l_read_name
        cigar = []
        for _ in range(n_cigar):
            (val,) = struct.unpack_from("<I", data, offset)
            cigar.append((val & 0xF, val >> 4))
            offset += 4
        seq_bytes = data[offset : offset + (l_seq + 1) // 2]
        offset += (l_seq + 1) // 2
        sequence = seq_bytes.hex().translate(_HEX_TO_NT16)[:l_seq]
        qual_bytes = data[offset : offset + l_seq]
        offset += l_seq
        quality: Optional[List[int]]
        if l_seq and qual_bytes[0] == 0xFF and all(q == 0xFF for q in qual_bytes):
            quality = None
        else:
            quality = list(qual_bytes)
        tags = cls._decode_tags(data, offset)
        return cls(
            query_name=name, flag=flag, reference_id=ref_id, pos=pos, mapq=mapq,
            cigar=cigar, next_reference_id=next_ref, next_pos=next_pos, tlen=tlen,
            sequence=sequence, quality=quality, tags=tags, header=header,
        )

    @staticmethod
    def _decode_tags(data: bytes, offset: int) -> Dict[str, Tuple[str, object]]:
        tags: Dict[str, Tuple[str, object]] = {}
        n = len(data)
        while offset < n:
            key = data[offset : offset + 2].decode()
            value_type = chr(data[offset + 2])
            offset += 3
            if value_type == "A":
                tags[key] = ("A", chr(data[offset])); offset += 1
            elif value_type == "c":
                tags[key] = ("c", struct.unpack_from("<b", data, offset)[0]); offset += 1
            elif value_type == "C":
                tags[key] = ("C", struct.unpack_from("<B", data, offset)[0]); offset += 1
            elif value_type == "s":
                tags[key] = ("s", struct.unpack_from("<h", data, offset)[0]); offset += 2
            elif value_type == "S":
                tags[key] = ("S", struct.unpack_from("<H", data, offset)[0]); offset += 2
            elif value_type == "i":
                tags[key] = ("i", struct.unpack_from("<i", data, offset)[0]); offset += 4
            elif value_type == "I":
                tags[key] = ("I", struct.unpack_from("<I", data, offset)[0]); offset += 4
            elif value_type == "f":
                tags[key] = ("f", struct.unpack_from("<f", data, offset)[0]); offset += 4
            elif value_type in "ZH":
                end = data.index(b"\x00", offset)
                tags[key] = (value_type, data[offset:end].decode()); offset = end + 1
            elif value_type == "B":
                sub_type = chr(data[offset])
                (count,) = struct.unpack_from("<i", data, offset + 1)
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub_type]
                size = struct.calcsize(fmt)
                values = list(
                    struct.unpack_from("<" + fmt * count, data, offset + 5)
                )
                tags[key] = ("B", (sub_type, values))
                offset += 5 + size * count
            else:
                raise ValueError(f"unknown tag type {value_type!r} for {key}")
        return tags

    # ---- SAM text codec --------------------------------------------------

    def to_sam_line(self, header: Optional[BamHeader] = None) -> str:
        header = header or self._header
        rname = "*"
        if header is not None and self.reference_id >= 0:
            rname = header.reference_name(self.reference_id) or "*"
        rnext = "*"
        if header is not None and self.next_reference_id >= 0:
            if self.next_reference_id == self.reference_id:
                rnext = "="
            else:
                rnext = header.reference_name(self.next_reference_id) or "*"
        qual = (
            "*"
            if self.quality is None
            else "".join(chr(min(q, 93) + 33) for q in self.quality)
        )
        fields = [
            self.query_name or "*",
            str(self.flag),
            rname,
            str(self.pos + 1),
            str(self.mapq),
            self.cigarstring or "*",
            rnext,
            str(self.next_pos + 1),
            str(self.tlen),
            self.sequence or "*",
            qual,
        ]
        for key, (value_type, value) in self._tags.items():
            if value_type in "cCsSiI":
                fields.append(f"{key}:i:{value}")
            elif value_type == "f":
                fields.append(f"{key}:f:{value}")
            elif value_type == "A":
                fields.append(f"{key}:A:{value}")
            elif value_type == "B":
                sub_type, values = value
                fields.append(f"{key}:B:{sub_type}," + ",".join(str(v) for v in values))
            else:
                fields.append(f"{key}:{value_type}:{value}")
        return "\t".join(fields)

    @classmethod
    def from_sam_line(cls, line: str, header: Optional[BamHeader] = None) -> "BamRecord":
        fields = line.rstrip("\n").split("\t")
        (qname, flag, rname, pos, mapq, cigar_str, rnext, pnext, tlen, seq, qual) = fields[:11]
        ref_id = -1
        if header is not None and rname != "*":
            ref_id = header.reference_id(rname)
        next_ref_id = -1
        if rnext == "=":
            next_ref_id = ref_id
        elif header is not None and rnext != "*":
            next_ref_id = header.reference_id(rnext)
        cigar: List[Tuple[int, int]] = []
        if cigar_str != "*":
            num = ""
            for ch in cigar_str:
                if ch.isdigit():
                    num += ch
                else:
                    cigar.append((_CIGAR_OP_TO_CODE[ch], int(num)))
                    num = ""
        quality = None if qual == "*" else [ord(c) - 33 for c in qual]
        tags: Dict[str, Tuple[str, object]] = {}
        for tag_field in fields[11:]:
            key, value_type, value = tag_field.split(":", 2)
            if value_type == "i":
                tags[key] = ("i", int(value))
            elif value_type == "f":
                tags[key] = ("f", float(value))
            elif value_type == "B":
                sub_type, rest = value.split(",", 1)
                caster = float if sub_type == "f" else int
                tags[key] = ("B", (sub_type, [caster(v) for v in rest.split(",")]))
            else:
                tags[key] = (value_type, value)
        return cls(
            query_name="" if qname == "*" else qname,
            flag=int(flag),
            reference_id=ref_id,
            pos=int(pos) - 1,
            mapq=int(mapq),
            cigar=cigar,
            next_reference_id=next_ref_id,
            next_pos=int(pnext) - 1,
            tlen=int(tlen),
            sequence="" if seq == "*" else seq,
            quality=quality,
            tags=tags,
            header=header,
        )


class AlignmentReader:
    """Iterate records from a BAM (BGZF) or SAM (text) file.

    ``mode='rb'`` reads BAM, ``mode='r'`` reads SAM; with ``mode=None`` the
    format is sniffed from content (BGZF magic) rather than the extension, in
    the spirit of reader.infer_open.
    """

    def __init__(self, path: str, mode: Optional[str] = None, check_sq: bool = True):
        del check_sq  # accepted for pysam-compat; header refs are never required
        if mode is None:
            mode = "rb" if bgzf.is_gzip(path) else "r"
        self._path = path
        self._mode = mode
        self._fh: Optional[BinaryIO] = None
        self.header = self._read_header()

    def _read_header(self) -> BamHeader:
        if self._mode == "rb":
            self._fh = bgzf.open_bgzf_reader(self._path)
            magic = self._fh.read(4)
            if magic != BAM_MAGIC:
                raise ValueError(f"{self._path} is not a BAM file")
            (l_text,) = struct.unpack("<i", self._fh.read(4))
            text = self._fh.read(l_text).split(b"\x00", 1)[0].decode()
            (n_ref,) = struct.unpack("<i", self._fh.read(4))
            references = []
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", self._fh.read(4))
                name = self._fh.read(l_name)[:-1].decode()
                (l_ref,) = struct.unpack("<i", self._fh.read(4))
                references.append((name, l_ref))
            return BamHeader(text, references)
        # SAM text
        self._sam_fh = open(self._path, "r")
        header_lines = []
        self._first_line: Optional[str] = None
        for line in self._sam_fh:
            if line.startswith("@"):
                header_lines.append(line)
            else:
                self._first_line = line
                break
        return BamHeader.from_text("".join(header_lines))

    def __iter__(self) -> Iterator[BamRecord]:
        if self._mode == "rb":
            assert self._fh is not None
            while True:
                size_bytes = self._fh.read(4)
                if len(size_bytes) < 4:
                    break
                (block_size,) = struct.unpack("<i", size_bytes)
                data = self._fh.read(block_size)
                yield BamRecord.from_bam_bytes(data, self.header)
        else:
            if self._first_line is not None:
                yield BamRecord.from_sam_line(self._first_line, self.header)
                self._first_line = None
            for line in self._sam_fh:
                if line.strip():
                    yield BamRecord.from_sam_line(line, self.header)

    def fetch(self, until_eof: bool = True) -> Iterator[BamRecord]:
        return iter(self)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if getattr(self, "_sam_fh", None) is not None:
            self._sam_fh.close()

    def __enter__(self) -> "AlignmentReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AlignmentWriter:
    """Write records to BAM (``mode='wb'``) or SAM text (``mode='w'``)."""

    def __init__(self, path: str, header: BamHeader, mode: str = "wb"):
        self._mode = mode
        self.header = header
        if mode == "wb":
            self._bgzf = bgzf.BgzfWriter(path)
            self._write_bam_header()
        elif mode == "w":
            self._fh = open(path, "w")
            if header.text:
                self._fh.write(header.text if header.text.endswith("\n") else header.text + "\n")
        else:
            raise ValueError("mode must be 'wb' (bam) or 'w' (sam)")

    def _write_bam_header(self) -> None:
        text = self.header.text.encode()
        out = bytearray()
        out += BAM_MAGIC
        out += struct.pack("<i", len(text))
        out += text
        out += struct.pack("<i", len(self.header.references))
        for name, length in self.header.references:
            encoded = name.encode() + b"\x00"
            out += struct.pack("<i", len(encoded)) + encoded + struct.pack("<i", length)
        self._bgzf.write(bytes(out))

    def write(self, record: BamRecord) -> None:
        if self._mode == "wb":
            self._bgzf.write(record.to_bam_bytes())
        else:
            self._fh.write(record.to_sam_line(self.header) + "\n")

    def close(self) -> None:
        if self._mode == "wb":
            self._bgzf.close()
        else:
            self._fh.close()

    def __enter__(self) -> "AlignmentWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_raw_header(fh: BinaryIO) -> bytes:
    """The BAM header (magic through the reference list) as raw bytes.

    ``fh`` is an uncompressed BAM stream at its start; it is left at the
    first record. The bytes are copied verbatim, so an output that starts
    with them keeps the input's header exactly.
    """
    out = bytearray()

    def take(n: int) -> bytes:
        data = fh.read(n)
        if len(data) != n:
            raise ValueError("truncated BAM header")
        out.extend(data)
        return data

    if take(4) != BAM_MAGIC:
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack("<I", take(4))
    take(l_text)
    (n_ref,) = struct.unpack("<I", take(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<I", take(4))
        take(l_name + 4)  # name + l_ref
    return bytes(out)


def iter_raw_records(fh: BinaryIO) -> Iterator[bytes]:
    """Each record's body (the bytes after its block_size field)."""
    while True:
        size_bytes = fh.read(4)
        if len(size_bytes) < 4:
            return
        (block_size,) = struct.unpack("<I", size_bytes)
        # bound before reading, as the native layer does: corrupt length
        # bytes must not turn into a huge allocation
        if block_size < 32 or block_size > (1 << 28):
            raise ValueError("implausible BAM record size (corrupt stream?)")
        data = fh.read(block_size)
        if len(data) != block_size:
            raise ValueError("truncated BAM record")
        yield data
