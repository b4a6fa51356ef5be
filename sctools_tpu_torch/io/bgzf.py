"""BGZF (blocked gzip) reading and writing.

BGZF is a sequence of independent gzip members, each <= 64 KiB of uncompressed
payload, carrying a 'BC' extra subfield with the compressed block size; this is
the container format of BAM. Readers here accept both true BGZF and plain gzip
(since concatenated-member inflation covers both); the writer emits spec-conform
blocks plus the 28-byte EOF marker so outputs interoperate with htslib tooling.

The port's own copy of ``sctools_tpu.io.bgzf``, without the observability
counters: the writer's block framing and compression level are unchanged, so
a payload written here is byte-identical to the JAX package's output.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from typing import BinaryIO, Iterator, Union


# Standard BGZF end-of-file marker block (an empty payload block).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

# Maximum uncompressed payload per block; kept under 2^16 so BSIZE fits uint16.
MAX_BLOCK_PAYLOAD = 65280

_BGZF_HEADER_STRUCT = struct.Struct("<4BI2BH")


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def is_bgzf(path: str) -> bool:
    """True if the file starts with a gzip member carrying the BC subfield."""
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:2] != b"\x1f\x8b":
        return False
    flg = head[3]
    if not flg & 4:  # FEXTRA
        return False
    return head[12:14] == b"BC"


def decompress(data: bytes) -> bytes:
    """Inflate a full BGZF (or plain gzip) byte string to its payload."""
    return gzip.decompress(data)


def open_bgzf_reader(path: str) -> BinaryIO:
    """Streaming reader over the uncompressed payload of a BGZF/gzip file."""
    return gzip.open(path, "rb")


def iter_blocks(fileobj: BinaryIO) -> Iterator[bytes]:
    """Yield the uncompressed payload of each gzip member in ``fileobj``.

    Used by the parallel native decode path to hand whole blocks to worker
    threads; the pure-Python consumers normally use :func:`open_bgzf_reader`.
    """
    data = fileobj.read()
    offset = 0
    n = len(data)
    while offset < n:
        if data[offset : offset + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {offset}")
        # parse the member header to find the deflate stream
        flg = data[offset + 3]
        pos = offset + 10
        if flg & 4:  # FEXTRA
            (xlen,) = struct.unpack_from("<H", data, pos)
            pos += 2 + xlen
        if flg & 8:  # FNAME
            pos = data.index(b"\x00", pos) + 1
        if flg & 16:  # FCOMMENT
            pos = data.index(b"\x00", pos) + 1
        if flg & 2:  # FHCRC
            pos += 2
        d = zlib.decompressobj(wbits=-15)
        payload = d.decompress(data[pos:])
        consumed = len(data[pos:]) - len(d.unused_data)
        yield payload
        offset = pos + consumed + 8  # skip CRC32 + ISIZE


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress one payload (<= MAX_BLOCK_PAYLOAD bytes) into one BGZF block."""
    if len(payload) > MAX_BLOCK_PAYLOAD:
        raise ValueError("payload exceeds BGZF block capacity")
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = compressor.compress(payload) + compressor.flush()
    # total block size = header(12) + extra(6) + deflate + crc/isize(8);
    # the BC field stores total - 1
    bsize = len(deflated) + 26 - 1
    header = _BGZF_HEADER_STRUCT.pack(
        0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF, 6
    )
    extra = b"BC" + struct.pack("<HH", 2, bsize)
    trailer = struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
    return header + extra + deflated + trailer


class BgzfWriter:
    """Buffered BGZF writer; flushes 64 KiB blocks and writes the EOF marker."""

    def __init__(self, path_or_fileobj: Union[str, BinaryIO], level: int = 6):
        if isinstance(path_or_fileobj, str):
            self._fh: BinaryIO = open(path_or_fileobj, "wb")
            self._owns_fh = True
        else:
            self._fh = path_or_fileobj
            self._owns_fh = False
        self._level = level
        self._buffer = io.BytesIO()
        self._closed = False

    def write(self, data: bytes) -> int:
        self._buffer.write(data)
        if self._buffer.tell() >= MAX_BLOCK_PAYLOAD:
            self._flush_full_blocks()
        return len(data)

    def _flush_full_blocks(self, final: bool = False) -> None:
        data = self._buffer.getvalue()
        pos = 0
        limit = len(data) if final else len(data) - len(data) % MAX_BLOCK_PAYLOAD
        while pos < limit:
            chunk = data[pos : pos + MAX_BLOCK_PAYLOAD]
            self._fh.write(compress_block(chunk, self._level))
            pos += len(chunk)
        self._buffer = io.BytesIO()
        self._buffer.write(data[pos:])

    def close(self) -> None:
        if self._closed:
            return
        self._flush_full_blocks(final=True)
        self._fh.write(BGZF_EOF)
        if self._owns_fh:
            self._fh.close()
        else:
            self._fh.flush()
        self._closed = True

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
