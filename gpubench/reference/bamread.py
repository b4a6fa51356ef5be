"""A plain BGZF and BAM reader in numpy, for the checks.

Written from the SAM/BAM specification (sections 4.1 and 4.2), independent
of the program's readers: BGZF is a series of gzip members, so the file is
inflated member by member with ``zlib``; the records are then cut by their
``block_size`` and their fields gathered by offset, all records at once.
Tags are walked one slot at a time over all records together; a string tag
longer than ``MAX_Z`` bytes, or a ``B`` array, is refused.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

MAX_Z = 128
_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2, ord("i"): 4, ord("I"): 4,
          ord("f"): 4}


def inflate_bgzf(data: bytes) -> bytes:
    """The concatenated payloads of every gzip member of ``data``."""
    out = []
    view = memoryview(data)
    while view:
        d = zlib.decompressobj(31)
        out.append(d.decompress(view))
        out.append(d.flush())
        if not d.eof:
            raise ValueError("truncated BGZF member")
        view = view[len(view) - len(d.unused_data):]
    return b"".join(out)


class Records:
    """The records of one BAM as column arrays over the inflated bytes."""

    def __init__(self, raw: bytes):
        if raw[:4] != b"BAM\1":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack_from("<i", raw, 4)
        at = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", raw, at)
        at += 4
        for _ in range(n_ref):  # the reference sequences' names and lengths
            (l_name,) = struct.unpack_from("<i", raw, at)
            at += 8 + l_name
        offsets = []
        unpack = struct.Struct("<i").unpack_from
        end = len(raw)
        while at < end:
            offsets.append(at)
            at += 4 + unpack(raw, at)[0]
        if at != end:
            raise ValueError("the last record runs past the end of the file")
        self.raw = np.frombuffer(raw, dtype=np.uint8)
        self.offsets = np.array(offsets, dtype=np.int64)
        o = self.offsets
        self.block_size = self.i32(o)
        self.ref, self.pos = self.i32(o + 4), self.i32(o + 8)
        self.l_name = self.raw[o + 12].astype(np.int64)
        self.mapq = self.raw[o + 13]
        self.bin = self.u16(o + 14)
        self.n_cigar = self.u16(o + 16).astype(np.int64)
        self.flag = self.u16(o + 18)
        self.l_seq = self.i32(o + 20).astype(np.int64)
        self.next_ref, self.next_pos, self.tlen = self.i32(o + 24), self.i32(o + 28), self.i32(o + 32)
        self.name_at = o + 36
        self.cigar_at = self.name_at + self.l_name
        self.seq_at = self.cigar_at + 4 * self.n_cigar
        self.qual_at = self.seq_at + (self.l_seq + 1) // 2
        self.tags_at = self.qual_at + self.l_seq
        self.end = o + 4 + self.block_size

    def __len__(self) -> int:
        return len(self.offsets)

    def i32(self, at: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(self.raw[at[:, None] + np.arange(4)]).view("<i4").ravel()

    def u16(self, at: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(self.raw[at[:, None] + np.arange(2)]).view("<u2").ravel()

    def fixed(self, at: np.ndarray, width: int) -> np.ndarray:
        """``[n, width]`` bytes from each record's ``at``."""
        return self.raw[at[:, None] + np.arange(width)]

    def tags(self) -> Dict[bytes, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Per tag name: (record rows, type byte, value offset, value length),
        for the records that hold it. A ``Z`` value's length leaves out its
        NUL; a number's is its width."""
        found: Dict[bytes, list] = {}
        rows = np.arange(len(self))
        cursor = self.tags_at.copy()
        while rows.size:
            head = self.raw[cursor[:, None] + np.arange(3)]
            kind = head[:, 2]
            value_at = cursor + 3
            length = np.zeros(rows.size, dtype=np.int64)
            step = np.zeros(rows.size, dtype=np.int64)
            for code, size in _SIZES.items():
                hit = kind == code
                length[hit] = size
                step[hit] = size
            z = (kind == ord("Z")) | (kind == ord("H"))
            if z.any():
                length[z] = self._z_length(value_at[z])
                step[z] = length[z] + 1
            if (step == 0).any():
                raise ValueError(f"unsupported tag type {chr(int(kind[step == 0][0]))!r}")
            names = np.ascontiguousarray(head[:, :2]).view("S2").ravel()
            for name in np.unique(names):
                sel = names == name
                found.setdefault(bytes(name), []).append((rows[sel], kind[sel], value_at[sel], length[sel]))
            cursor = value_at + step
            if (cursor > self.end[rows]).any():
                raise ValueError("a tag runs past its record")
            more = cursor < self.end[rows]
            rows, cursor = rows[more], cursor[more]
        return {name: tuple(np.concatenate(col) for col in zip(*parts)) for name, parts in found.items()}

    def _z_length(self, at: np.ndarray) -> np.ndarray:
        """The length of the NUL-terminated string at each of ``at``: a
        short window first, the long one only for the rows it missed."""
        length = np.empty(len(at), dtype=np.int64)
        rows = np.arange(len(at))
        for width in (33, MAX_Z + 1):
            window = self.raw[np.minimum(at[rows][:, None] + np.arange(width), len(self.raw) - 1)]
            nul = window == 0
            found = nul.any(axis=1)
            length[rows[found]] = nul[found].argmax(axis=1)
            rows = rows[~found]
            if not rows.size:
                return length
        raise ValueError(f"a string tag longer than {MAX_Z} bytes")

    def z_values(self, at: np.ndarray, length: np.ndarray, width: int) -> np.ndarray:
        """String values as ``[n, width]`` bytes, NUL-padded past each length."""
        block = self.raw[np.minimum(at[:, None] + np.arange(width), len(self.raw) - 1)]
        return np.where(np.arange(width) < length[:, None], block, 0).astype(np.uint8)


def read_bam(path: str) -> Records:
    with open(path, "rb") as f:
        return Records(inflate_bgzf(f.read()))
