"""BAM-side inputs made from a seed: a cell-sorted, tagged 10x library.

Frozen copies of ``chip_smoke.py``'s generators as they stood when this
benchmark was written: ``GRCH38`` (lines 592-599), ``gene_names`` (613-617),
``make_reads`` (620-671), ``sort_reads`` (674-681), ``_u8`` and ``_z_tag``
(684-693), ``write_tagged_bam`` (696-771) and ``write_mito_gtf`` (796-805).
They are changed only in what they take and give back:

- the sizes (genes, MT- genes, barcode, UMI and read lengths) come from
  the configuration instead of module constants, and the barcodes and
  their sizes from ``chunk_barcodes`` (the sample's depth, cells and
  barcode figures) instead of 1,000 cells of one lognormal;
- ``write_tagged_bam`` returns the quality matrix it drew, which the
  reference reads (CY, UY and the genomic qualities come from it); it
  draws the bases as random bytes (a different stream from the smoke's),
  formats the names and puts the records in order with numpy instead of a
  loop and a scatter (the same bytes, in less time), and writes its BGZF
  blocks itself
  (``write_bgzf``) instead of through the program's ``io.bgzf``.

Nothing here imports the program.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)

# GRCh38's 25 primary sequences (1-22, X, Y, MT) and their lengths
GRCH38 = [
    ("1", 248956422), ("2", 242193529), ("3", 198295559), ("4", 190214555),
    ("5", 181538259), ("6", 170805979), ("7", 159345973), ("8", 145138636),
    ("9", 138394717), ("10", 133797422), ("11", 135086622), ("12", 133275309),
    ("13", 114364328), ("14", 107043718), ("15", 101991189), ("16", 90338345),
    ("17", 83257441), ("18", 80373285), ("19", 58617616), ("20", 64444167),
    ("21", 46709983), ("22", 50818468), ("X", 156040895), ("Y", 57227415), ("MT", 16569),
]
XF_VALUES = (b"CODING", b"INTRONIC", b"UTR", b"INTERGENIC", b"")  # b"": no XF tag
XF_P = (0.6, 0.15, 0.1, 0.1, 0.05)

# BGZF (SAM/BAM specification, section 4.1): a gzip member with the BC extra
# field, at most 65,280 payload bytes a block, and the 28-byte EOF block
MAX_BLOCK_PAYLOAD = 65280
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def gene_names(n_genes: int, n_mito: int) -> np.ndarray:
    """``n_genes`` names of 10 bytes; the last ``n_mito`` are MT- genes."""
    names = [b"GENE%06d" % i for i in range(n_genes - n_mito)]
    names += [b"MT-G%06d" % i for i in range(n_mito)]
    return np.array(names, dtype="S10")


def chunk_barcodes(n: int, config: dict, traffic: dict) -> tuple:
    """The cell-disjoint chunk's barcodes for ``n`` records: (cells,
    background barcodes, reads a cell, reads a background barcode).

    A sample of ``config["cells"]`` cells read to ``read_pairs_per_cell``
    gives each cell its share ``fraction_reads_in_cells`` of the valid
    reads; the rest fall on background barcodes, spread evenly over the
    whitelist (ambient RNA in droplets without a cell). The chunk holds
    cells and background barcodes in the sample's proportions."""
    valid = config["read_pairs_per_cell"] * traffic["valid_barcodes"]
    in_cells = traffic["fraction_reads_in_cells"]
    cell_reads = valid * in_cells
    background_reads = valid * config["cells"] * (1.0 - in_cells) / config["whitelist_size"]
    n_cells = max(1, round(n * in_cells / cell_reads))
    n_background = round(n * (1.0 - in_cells) / background_reads)
    return n_cells, n_background, cell_reads, background_reads


def miscall(rng, bases: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ``bases`` with each one replaced, with the probability
    ``rate``, by one of the other three."""
    out = bases.copy()
    rows, cols = np.nonzero(rng.random(out.shape) < rate)
    codes = np.searchsorted(LETTERS, out[rows, cols])
    out[rows, cols] = LETTERS[(codes + rng.integers(1, 4, size=rows.size)) % 4]
    return out


def make_reads(rng, n: int, config: dict, traffic: dict) -> dict:
    """Per-read columns of a cell-disjoint chunk of a 10x library, in
    molecule order.

    The barcodes are ``chunk_barcodes``'s, cells with lognormal(0,
    ``cell_sigma``) sizes; about 2.4 reads a molecule, genes Zipf-like over
    the vocabulary with 5% of molecules on MT- genes; ~5% unmapped, ~10%
    duplicates, ~10% spliced (49M1000N49M); XF over
    CODING/INTRONIC/UTR/INTERGENIC/missing with GE only on the first three;
    ~0.5% of GE tags name two genes; NH in {1, 1, 1, 2, 3}; CR and UR are
    CB and UB with each base miscalled with the probability
    ``barcode_base_error``.
    """
    cb_len, umi_len = config["barcode_length"], config["umi_length"]
    n_genes, n_mito = config["genes"], config["mito_genes"]
    n_cells, n_background, cell_reads, background_reads = chunk_barcodes(n, config, traffic)
    n_barcodes = n_cells + n_background
    cells = np.unique(LETTERS[rng.integers(0, 4, size=(n_barcodes + 64, cb_len))].view(f"S{cb_len}").ravel())
    cells = np.sort(rng.choice(cells, n_barcodes, replace=False))
    n_mol = int(n / 2.4 * 1.05)  # 2.4 reads a molecule on average; the surplus is cut
    sizes = np.full(n_barcodes, background_reads)
    is_cell = rng.permutation(n_barcodes) < n_cells
    cell_sizes = rng.lognormal(0, traffic["cell_sigma"], n_cells)
    sizes[is_cell] = cell_reads * cell_sizes / cell_sizes.mean()
    mol_cell = rng.choice(n_barcodes, n_mol, p=sizes / sizes.sum())
    mol_umi = LETTERS[rng.integers(0, 4, size=(n_mol, umi_len))]
    weights = 1.0 / (np.arange(n_genes - n_mito) + 10.0)
    mol_gene = rng.choice(n_genes - n_mito, n_mol, p=weights / weights.sum())
    mito = rng.random(n_mol) < 0.05
    mol_gene[mito] = n_genes - n_mito + rng.integers(0, n_mito, mito.sum())
    mol_ref = np.where(mito, len(GRCH38) - 1, mol_gene % (len(GRCH38) - 1))
    lengths = np.array([length for _, length in GRCH38])
    mol_pos = (rng.random(n_mol) * (lengths[mol_ref] - 2000)).astype(np.int64)
    per_mol = 1 + rng.poisson(1.4, n_mol)
    mol = np.repeat(np.arange(n_mol), per_mol)[:n]
    if mol.size < n:
        raise AssertionError("too few molecules for the record count")
    unmapped = rng.random(n) < 0.05
    xf = rng.choice(len(XF_VALUES), n, p=XF_P)
    xf[unmapped] = len(XF_VALUES) - 1
    names = gene_names(n_genes, n_mito)
    ge = names[mol_gene[mol]].astype("S21")
    multi = (rng.random(n) < 0.005) & (mol_gene[mol] < n_genes - n_mito - 1)
    ge[multi] = np.char.add(np.char.add(names[mol_gene[mol][multi]], b","), names[mol_gene[mol][multi] + 1])
    ge[xf >= 3] = b""
    cb = cells[mol_cell[mol]]
    cr = miscall(rng, cb.view(np.uint8).reshape(n, cb_len), traffic["barcode_base_error"])
    ub = mol_umi[mol]
    ur = miscall(rng, ub, traffic["barcode_base_error"])
    return dict(
        cell=mol_cell[mol], cb=cb.view(np.uint8).reshape(n, cb_len), cr=cr, ub=ub, ur=ur,
        ge=ge, xf=xf, unmapped=unmapped,
        ref=np.where(unmapped, -1, mol_ref[mol]),
        pos=np.where(unmapped, -1, mol_pos[mol] + rng.integers(0, 6, n)),
        reverse=rng.random(n) < 0.5, duplicate=(rng.random(n) < 0.1) & ~unmapped,
        spliced=(rng.random(n) < 0.1) & ~unmapped,
        nh=np.where(unmapped, 0, rng.choice([1, 1, 1, 2, 3], n)),
    )


def umi_codes(ub: np.ndarray) -> np.ndarray:
    """Each UMI row as a base-4 number: its lexicographic order."""
    width = ub.shape[1]
    return (np.searchsorted(LETTERS, ub).astype(np.int64) * (4 ** np.arange(width - 1, -1, -1))).sum(1)


def sort_reads(reads: dict, order: str) -> dict:
    """The reads sorted by (CB, UB, GE) for ``order="cell"``, else by
    (GE, CB, UB); ties keep their order. A missing GE sorts first."""
    _, ge_code = np.unique(reads["ge"], return_inverse=True)
    umi = umi_codes(reads["ub"])
    keys = (ge_code, umi, reads["cell"]) if order == "cell" else (umi, reads["cell"], ge_code)
    perm = np.lexsort(keys)
    return {name: column[perm] for name, column in reads.items()}


def _u8(values, dtype) -> np.ndarray:
    return np.ascontiguousarray(values.astype(dtype)).view(np.uint8).reshape(len(values), np.dtype(dtype).itemsize)


def _z_tag(key: bytes, values: np.ndarray) -> np.ndarray:
    head = np.frombuffer(key + b"Z", dtype=np.uint8)
    n = len(values)
    return np.concatenate(
        [np.broadcast_to(head, (n, 3)), values, np.zeros((n, 1), np.uint8)], axis=1
    )


def _names(idx: np.ndarray) -> np.ndarray:
    """``r%09d`` and a NUL for each record number, as ``[m, 11]`` bytes."""
    out = np.empty((len(idx), 11), dtype=np.uint8)
    out[:, 0] = ord("r")
    out[:, 1:10] = (idx[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    out[:, 10] = 0
    return out


def write_tagged_bam(path: Path, rng, reads: dict, read_length: int) -> np.ndarray:
    """The reads as raw BAM records (tags CB CR CY UB UR UY [GE] [XF] [NH]),
    built with numpy one layout group at a time, BGZF level 1. Returns the
    ``[n, read_length]`` phred qualities drawn for the records: the read's
    qualities, and CY and UY are their first barcode and UMI bases'."""
    n = len(reads["cell"])
    cb_len, umi_len = reads["cb"].shape[1], reads["ub"].shape[1]
    qual_q = rng.integers(2, 42, size=(n, read_length), dtype=np.uint8)
    # two random bases a byte, as their BAM codes (A C G T = 1 2 4 8)
    codes = np.frombuffer(rng.bytes(n * ((read_length + 1) // 2)), np.uint8).reshape(n, -1)
    packed = (np.uint8(1) << ((codes >> 4) & 3) << 4) | (np.uint8(1) << (codes & 3))
    if read_length % 2:
        packed[:, -1] &= 0xF0
    ge_len = np.char.str_len(reads["ge"])
    n_cigar = np.where(reads["unmapped"], 0, np.where(reads["spliced"], 3, 1))
    flag = (np.where(reads["unmapped"], 4, 0) | np.where(reads["reverse"], 16, 0)
            | np.where(reads["duplicate"], 1024, 0))
    half = read_length // 2
    # one layout group a mixed-radix key (GE values stay under 64 bytes)
    key = ((n_cigar * 64 + ge_len) * 8 + reads["xf"]) * 2 + (reads["nh"] > 0)
    groups, group_of = np.unique(key, return_inverse=True)
    blocks = []
    for g, code in enumerate(groups):
        code, has_nh = divmod(int(code), 2)
        code, xf_code = divmod(code, 8)
        cig, glen = divmod(code, 64)
        idx = np.flatnonzero(group_of.ravel() == g)
        m = idx.size
        cigar = {0: [], 1: [read_length << 4],
                 3: [half << 4, (1000 << 4) | 3, (read_length - half) << 4]}[int(cig)]
        parts = [
            None,  # block_size, filled in below
            _u8(reads["ref"][idx], "<i4"), _u8(reads["pos"][idx], "<i4"),
            np.broadcast_to(np.array([11, 0 if cig == 0 else 255], np.uint8), (m, 2)),
            np.zeros((m, 2), np.uint8), np.broadcast_to(_u8(np.array([cig]), "<u2")[0], (m, 2)),
            _u8(flag[idx], "<u2"), np.broadcast_to(_u8(np.array([read_length]), "<i4")[0], (m, 4)),
            np.broadcast_to(_u8(np.array([-1, -1, 0]), "<i4").ravel(), (m, 12)),
            _names(idx),
            np.broadcast_to(_u8(np.array(cigar, np.uint32), "<u4").ravel(), (m, 4 * int(cig))),
            packed[idx], qual_q[idx],
            _z_tag(b"CB", reads["cb"][idx]), _z_tag(b"CR", reads["cr"][idx]),
            _z_tag(b"CY", qual_q[idx, :cb_len] + 33),
            _z_tag(b"UB", reads["ub"][idx]), _z_tag(b"UR", reads["ur"][idx]),
            _z_tag(b"UY", qual_q[idx, cb_len : cb_len + umi_len] + 33),
        ]
        if glen:
            parts.append(_z_tag(b"GE", reads["ge"][idx].astype(f"S{glen}").view(np.uint8).reshape(m, glen)))
        if XF_VALUES[xf_code]:
            parts.append(_z_tag(b"XF", np.broadcast_to(np.frombuffer(XF_VALUES[xf_code], np.uint8),
                                                       (m, len(XF_VALUES[xf_code])))))
        if has_nh:
            parts.append(np.concatenate([np.broadcast_to(np.frombuffer(b"NHC", np.uint8), (m, 3)),
                                         reads["nh"][idx].astype(np.uint8)[:, None]], axis=1))
        width = sum(p.shape[1] for p in parts[1:])
        parts[0] = np.broadcast_to(_u8(np.array([width]), "<i4")[0], (m, 4))
        blocks.append((idx, np.concatenate(parts, axis=1)))
    # the records in their order: each group's rows into one matrix as wide
    # as the widest record, then the bytes of each row up to its width
    widest = max(block.shape[1] for _, block in blocks)
    matrix = np.zeros((n, widest), dtype=np.uint8)
    used = np.zeros((n, widest), dtype=bool)
    for idx, block in blocks:
        matrix[idx, : block.shape[1]] = block
        used[idx, : block.shape[1]] = True
    body = matrix[used]
    text = b"@HD\tVN:1.6\tSO:unsorted\n" + b"".join(
        b"@SQ\tSN:%s\tLN:%d\n" % (name.encode(), length) for name, length in GRCH38)
    header = b"BAM\1" + struct.pack("<I", len(text)) + text + struct.pack("<I", len(GRCH38))
    for name, length in GRCH38:
        header += struct.pack("<I", len(name) + 1) + name.encode() + b"\0" + struct.pack("<I", length)
    write_bgzf(path, header + body.tobytes())
    return qual_q


def bgzf_block(payload: bytes, level: int = 1) -> bytes:
    """One BGZF block of ``payload`` (at most ``MAX_BLOCK_PAYLOAD`` bytes)."""
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = compressor.compress(payload) + compressor.flush()
    head = struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"), ord("C"), 2,
                       len(deflated) + 25)
    return head + deflated + struct.pack("<II", zlib.crc32(payload), len(payload))


def write_bgzf(path: Path, data: bytes) -> None:
    """``data`` as BGZF blocks at level 1, compressed on a pool of threads."""
    view = memoryview(data)
    chunks = [view[i : i + MAX_BLOCK_PAYLOAD] for i in range(0, len(data), MAX_BLOCK_PAYLOAD)]
    with ThreadPoolExecutor(max_workers=8) as pool, open(path, "wb") as out:
        for block in pool.map(bgzf_block, chunks):
            out.write(block)
        out.write(BGZF_EOF)


def write_mito_gtf(path: Path, names: np.ndarray, n_mito: int) -> None:
    """A GTF declaring the MT- genes (gene_id = gene_name, as in the BAM's
    GE tags) and the first 50 others."""
    lines = ["#!genome-build synthetic\n"]
    for i, name in enumerate(list(names[:50]) + list(names[len(names) - n_mito:])):
        chrom = "MT" if name.startswith(b"MT-") else "1"
        lines.append(f'{chrom}\tsmoke\tgene\t{100 * i + 1}\t{100 * i + 90}\t.\t+\t.\t'
                     f'gene_id "{name.decode()}"; gene_name "{name.decode()}";\n')
    Path(path).write_text("".join(lines))
