"""Hamming <= 1 whitelist correction, by probing neighbours in a sorted table.

The function FastqProcess states (sctools' ``barcode.py`` error map, which
the program's whitelist kernel computes another way):

- a base is one of the uppercase letters A, C, G, T; anything else (N,
  lowercase) matches nothing, on either side;
- whitelist barcode w is a hit for query q when q has the whitelist's
  length and differs from w in at most one position;
- of the hits, the one with the largest whitelist index wins (the last in
  file order, as the reference's map overwrites earlier entries); a query
  with no hit gets -1.

Here each whitelist barcode is a base-4 number; the table holds each
distinct number once with the largest index that carries it, sorted, and
for barcodes of up to 16 bases a bitmap over all 4^L numbers, which turns
away the probes that hit nothing before the binary search. A query with
no bad base probes itself and its 3 x L substitutions, one with a single bad
base the 4 letters at that position, one with more probes nothing.
``tie="first"`` keeps the smallest index instead: the control, which breaks
the stated tie rule.
"""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, dtype=np.uint8)
_CODE[list(b"ACGT")] = (0, 1, 2, 3)


class Table:
    def __init__(self, whitelist: np.ndarray, tie: str = "last"):
        """``whitelist``: ``[n_w, L]`` ASCII bytes, L <= 32."""
        self.length = whitelist.shape[1]
        self.tie = tie
        if self.length > 32:
            raise ValueError("barcodes of more than 32 bases")
        codes = _CODE[whitelist]
        valid = (codes < 4).all(axis=1)
        numbers = self._numbers(np.where(codes < 4, codes, 0))
        index = np.flatnonzero(valid)
        numbers = numbers[valid]
        order = np.argsort(numbers, kind="stable")  # equal numbers keep file order
        ordered = numbers[order]
        if tie == "last":
            keep = np.r_[ordered[1:] != ordered[:-1], True]
        elif tie == "first":
            keep = np.r_[True, ordered[1:] != ordered[:-1]]
        else:
            raise ValueError(f"unknown tie rule {tie!r}")
        self.numbers = ordered[keep]
        self.index = index[order][keep]
        self.bitmap = None
        if self.length <= 16:
            self.bitmap = np.zeros(max(1, 4 ** self.length // 8), dtype=np.uint8)
            byte = (self.numbers >> np.uint64(3)).astype(np.int64)
            bit = np.uint8(1) << (self.numbers & np.uint64(7)).astype(np.uint8)
            # the numbers are sorted and distinct: a byte's bits are distinct,
            # so their sum is their union
            starts = np.flatnonzero(np.r_[True, byte[1:] != byte[:-1]])
            self.bitmap[byte[starts]] = np.add.reduceat(bit, starts, dtype=np.uint8)

    def _numbers(self, codes: np.ndarray) -> np.ndarray:
        out = np.zeros(len(codes), dtype=np.uint64)
        for p in range(self.length):
            out = (out << np.uint64(2)) | codes[:, p].astype(np.uint64)
        return out

    def _lookup(self, probes: np.ndarray) -> np.ndarray:
        out = np.full(len(probes), -1, dtype=np.int64)
        rows = np.arange(len(probes))
        if self.bitmap is not None:
            bits = self.bitmap[(probes >> np.uint64(3)).astype(np.int64)]
            rows = np.flatnonzero((bits >> (probes & np.uint64(7)).astype(np.uint8)) & 1)
        found = probes[rows]
        at = np.minimum(np.searchsorted(self.numbers, found), len(self.numbers) - 1)
        out[rows] = np.where(self.numbers[at] == found, self.index[at], -1)
        return out

    def _better(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        if self.tie == "last":
            return np.maximum(a, b)
        return np.where((b >= 0) & ((a < 0) | (b < a)), b, a)

    def correct(self, queries: np.ndarray, lengths: np.ndarray = None, chunk: int = 1 << 16) -> np.ndarray:
        """Whitelist index per ``[n, L]`` query (-1: none)."""
        out = np.full(len(queries), -1, dtype=np.int64)
        for lo in range(0, len(queries), chunk):
            out[lo : lo + chunk] = self._correct(queries[lo : lo + chunk])
        if lengths is not None:
            out[np.asarray(lengths) != self.length] = -1
        return out

    def _correct(self, queries: np.ndarray) -> np.ndarray:
        length = self.length
        codes = _CODE[queries]
        bad = codes >= 4
        n_bad = bad.sum(axis=1)
        base = self._numbers(np.where(bad, 0, codes))
        best = np.full(len(queries), -1, dtype=np.int64)
        clean = n_bad == 0
        best[clean] = self._lookup(base[clean])
        one = n_bad == 1
        where_bad = bad.argmax(axis=1)
        for p in range(length):
            shift = np.uint64(2 * (length - 1 - p))
            here = codes[:, p].astype(np.uint64)
            for letter in range(4):
                letter_bits = np.uint64(letter) << shift
                # a clean query with position p set to another letter; a query
                # whose one bad base is at p, with that base set to the letter
                probe = (base & ~(np.uint64(3) << shift)) | letter_bits
                rows = (clean & (here != letter)) | (one & (where_bad == p))
                if rows.any():
                    found = self._lookup(probe[rows])
                    best[rows] = self._better(best[rows], found)
        return best
