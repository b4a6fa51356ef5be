"""What FastqProcess has to write for a lane, and the check of its shards.

For every read triplet the shards hold one unaligned BAM record (SAM/BAM
specification 4.2: refID and pos -1, bin 4680, flag 4, no CIGAR, mate
fields -1, -1, 0): the name up to its first space, R2's bases (A, C, G, T
in either case to their codes, any other letter to N) and qualities (the
FASTQ's less 33), and the string tags CR and CY (R1's barcode span and its
qualities), UR and UY (the UMI span), SR and SY (I1), and CB, the whitelist
barcode that ``reference.whitelist`` gives for CR, where there is one. A
cell barcode (CB, else CR) never spans two shards. The program's counters
are the reads, and of them those whose CB equals CR (correct), those given
another CB (corrected) and those given none (uncorrectable).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .bamread import Records

_NIBBLE = np.full(256, 15, dtype=np.uint8)
_NIBBLE[list(b"ACGTacgt")] = (1, 2, 4, 8, 1, 2, 4, 8)
FIXED = dict(ref=-1, pos=-1, mapq=0, bin=4680, n_cigar=0, flag=4, next_ref=-1, next_pos=-1, tlen=0)


def expected(triplets: dict, whitelist: np.ndarray, index: np.ndarray, cb_span, umi_span) -> dict:
    """The records and counters due for ``triplets``, given each read's
    whitelist ``index`` from ``reference.whitelist``."""
    r1, r1q = triplets["r1"], triplets["r1_qual"]
    r2 = triplets["r2"]
    if r2.shape[1] % 2:
        r2 = np.concatenate([r2, np.zeros((len(r2), 1), np.uint8)], axis=1)
    packed = (_NIBBLE[r2[:, 0::2]] << 4) | _NIBBLE[r2[:, 1::2]]
    if triplets["r2"].shape[1] % 2:
        packed[:, -1] &= 0xF0
    cb_lo, cb_hi = cb_span
    umi_lo, umi_hi = umi_span
    cr = r1[:, cb_lo:cb_hi]
    cb = whitelist[np.maximum(index, 0)]
    hit = index >= 0
    same = hit & (cb == cr).all(axis=1)
    tags = {b"CR": cr, b"CY": r1q[:, cb_lo:cb_hi], b"UR": r1[:, umi_lo:umi_hi], b"UY": r1q[:, umi_lo:umi_hi],
            b"SR": triplets["i1"], b"SY": triplets["i1_qual"]}
    return dict(
        n=len(r1), packed=packed, phred=triplets["r2_qual"] - 33, l_seq=triplets["r2"].shape[1],
        tags=tags, cb=cb, hit=hit, key=np.where(hit[:, None], cb, cr),
        counters={"total_reads": len(r1), "correct": int(same.sum()), "corrected": int((hit & ~same).sum()),
                  "uncorrectable": int((~hit).sum())},
    )


def read_index(records: Records, n: int) -> np.ndarray:
    """Each record's read number from its name ``r<digits>``; -1 where the
    name is not one of the ``n`` reads'."""
    out = np.full(len(records), -1, dtype=np.int64)
    for length in np.unique(records.l_name):
        rows = np.flatnonzero(records.l_name == length)
        digits = int(length) - 2  # 'r', the digits, the NUL
        if digits < 1:
            continue
        block = records.fixed(records.name_at[rows], int(length)).astype(np.int64)
        numeric = (block[:, 1:-1] >= ord("0")) & (block[:, 1:-1] <= ord("9"))
        ok = (block[:, 0] == ord("r")) & numeric.all(axis=1) & (block[:, -1] == 0)
        value = ((block[:, 1:-1] - ord("0")) * 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)).sum(axis=1)
        ok &= value < n
        out[rows[ok]] = value[ok]
    return out


def check(shards: List[Records], want: dict, counters: Dict[str, int]) -> Dict[str, int]:
    """The numbers compared for one pass, each of which has to be 0:
    ``reads_wrong`` (reads missing, written twice or written wrong, and
    records that are no read of the lane), ``barcodes_split`` (cell
    barcodes in more than one shard) and ``counters_wrong`` (the program's
    counters that differ from the reference's)."""
    n = want["n"]
    seen = np.zeros(n, dtype=np.int64)
    wrong = np.zeros(n, dtype=bool)
    strays = 0
    keys, key_shards = [], []
    l_seq = want["l_seq"]
    for shard, records in enumerate(shards):
        if not len(records):
            continue
        index = read_index(records, n)
        strays += int((index < 0).sum())
        rows = np.flatnonzero(index >= 0)
        reads = index[rows]
        np.add.at(seen, reads, 1)
        ok = np.ones(rows.size, dtype=bool)
        for field, value in FIXED.items():
            ok &= getattr(records, field)[rows] == value
        sized = records.l_seq[rows] == l_seq
        ok &= sized
        s_rows, s_reads = rows[sized], reads[sized]
        packed = records.fixed(records.seq_at[s_rows], want["packed"].shape[1])
        phred = records.fixed(records.qual_at[s_rows], l_seq)
        ok[sized] &= (packed == want["packed"][s_reads]).all(axis=1) & (phred == want["phred"][s_reads]).all(axis=1)
        ok &= records.end[rows] >= records.tags_at[rows]
        tags = records.tags()
        count = np.zeros(len(records), dtype=np.int64)
        got_cb = np.zeros(len(records), dtype=bool)
        for name, (t_rows, kind, at, length) in tags.items():
            np.add.at(count, t_rows, 1)
            if name == b"CB":
                got_cb[t_rows] = True
            values = want["tags"].get(name, want["cb"] if name == b"CB" else None)
            if values is None:
                continue  # a tag of no read: the count below catches it
            mine = index[t_rows] >= 0
            t_rows, kind, at, length = t_rows[mine], kind[mine], at[mine], length[mine]
            width = values.shape[1]
            good = (kind == ord("Z")) & (length == width)
            good &= (records.z_values(at, length, width) == values[index[t_rows]]).all(axis=1)
            bad_rows = t_rows[~good]
            wrong[index[bad_rows]] = True
        want_count = len(want["tags"]) + want["hit"][reads]
        ok &= count[rows] == want_count
        ok &= got_cb[rows] == want["hit"][reads]
        wrong[reads[~ok]] = True
        keys.append(want["key"][reads])
        key_shards.append(np.full(reads.size, shard))
    wrong |= seen != 1
    split = 0
    if keys:
        width = want["key"].shape[1]
        key = np.ascontiguousarray(np.concatenate(keys)).view(f"S{width}").ravel()
        pairs = np.unique(np.rec.fromarrays([key, np.concatenate(key_shards)]))
        _, per_key = np.unique(pairs["f0"], return_counts=True)
        split = int((per_key > 1).sum())
    counters_wrong = sum(int(counters.get(k, -1) != v) for k, v in want["counters"].items())
    return {"reads_wrong": int(wrong.sum()) + strays, "barcodes_split": split, "counters_wrong": counters_wrong}


def _le(values: np.ndarray, dtype: str, width: int) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values).astype(dtype)).view(np.uint8).reshape(-1, width)


def _z(name: bytes, values: np.ndarray) -> np.ndarray:
    n = len(values)
    return np.concatenate([np.broadcast_to(np.frombuffer(name + b"Z", np.uint8), (n, 3)), values,
                           np.zeros((n, 1), np.uint8)], axis=1)


def record_bytes(want: dict, reads: np.ndarray, digits: int) -> bytes:
    """The unaligned records of ``reads``, in that order, as ``check`` wants
    them (tags CR CY [CB] UR UY SR SY)."""
    hit = want["hit"][reads]
    order_parts, blocks = [], []
    for has_cb in (False, True):
        rows = reads[hit == has_cb]
        m = rows.size
        if not m:
            continue
        names = np.empty((m, digits + 2), np.uint8)
        names[:, 0] = ord("r")
        names[:, 1:-1] = (rows[:, None] // 10 ** np.arange(digits - 1, -1, -1)) % 10 + ord("0")
        names[:, -1] = 0
        tags = want["tags"]
        parts = [
            _le(np.full(m, -1), "<i4", 4), _le(np.full(m, -1), "<i4", 4),
            np.broadcast_to(np.array([digits + 2, 0], np.uint8), (m, 2)),
            np.broadcast_to(_le([4680, 0, 4], "<u2", 2).ravel(), (m, 6)),
            np.broadcast_to(_le([want["l_seq"], -1, -1, 0], "<i4", 4).ravel(), (m, 16)),
            names, want["packed"][rows], want["phred"][rows].astype(np.uint8),
            _z(b"CR", tags[b"CR"][rows]), _z(b"CY", tags[b"CY"][rows]),
        ]
        if has_cb:
            parts.append(_z(b"CB", want["cb"][rows]))
        parts += [_z(b"UR", tags[b"UR"][rows]), _z(b"UY", tags[b"UY"][rows]),
                  _z(b"SR", tags[b"SR"][rows]), _z(b"SY", tags[b"SY"][rows])]
        body = np.concatenate(parts, axis=1)
        blocks.append(np.concatenate([_le(np.full(m, body.shape[1]), "<i4", 4), body], axis=1))
        order_parts.append(rows)
    order = np.argsort(np.concatenate(order_parts), kind="stable")
    # equal-width rows within a group; the groups differ in width, so join row by row
    rows_bytes = [row.tobytes() for block in blocks for row in block]
    return b"".join(rows_bytes[i] for i in order)


def write_shards(directory, want: dict, n_shards: int) -> List[str]:
    """``want``'s records as ``n_shards`` BAM files, each cell barcode in one
    (a single gzip member each, which a BGZF reader also reads)."""
    import zlib

    width = want["key"].shape[1]
    keys = np.ascontiguousarray(want["key"]).view(f"S{width}").ravel()
    shard = np.array([zlib.crc32(k) % n_shards for k in keys.tolist()])
    digits = max(7, len(str(want["n"] - 1)))
    header = b"BAM\1" + (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
    paths = []
    for s in range(n_shards):
        path = f"{directory}/control_{s}.bam"
        data = header + record_bytes(want, np.flatnonzero(shard == s), digits)
        compressor = zlib.compressobj(1, zlib.DEFLATED, 31)
        with open(path, "wb") as f:
            f.write(compressor.compress(data) + compressor.flush())
        paths.append(path)
    return paths
