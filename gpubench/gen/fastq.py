"""FASTQ-side inputs made from a seed: a whitelist and a lane's read triplets.

``make_whitelist``, the R2 read and the quality ranges are frozen copies of
``chip_smoke.py``'s generators as they stood when this benchmark was
written (``LETTERS`` and ``make_whitelist`` at lines 449-516, the R2 read
and its qualities at 2096-2107, ``IUPAC`` 2017). The barcodes are drawn
from the traffic file's figures, each of which names its public source:

- a read comes from a cell with the probability
  ``fraction_reads_in_cells``, else from a barcode drawn uniformly from the
  whitelist (ambient RNA in a droplet without a cell);
- its barcode is invalid with the probability ``1 - valid_barcodes``: two
  substitutions at distinct positions, which a hamming-1 correction cannot
  undo (some land next to another whitelist barcode, as invalid barcodes
  do in a lane);
- every base of a valid barcode is miscalled, as another of A, C, G, T,
  with the probability ``barcode_base_error``.

``edge_cases`` (the CPU tests only; a lane from a sequencer has none) adds
calls no sequencer makes in a barcode or read: an N, a lowercase barcode,
IUPAC and lowercase bases in R2.

The FASTQ text is built as one fixed-width byte matrix per file and the
files are gzipped on a thread pool (zlib releases the GIL). Nothing here
imports the program.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYKMSWBDHVN", dtype=np.uint8)


def make_whitelist(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """[n, length] ASCII letters of a random whitelist."""
    return LETTERS[rng.integers(0, 4, size=(n, length), dtype=np.uint8)]


def lane_sources(rng, n_whitelist: int, n: int, cells: int, in_cells: float, sigma: float) -> np.ndarray:
    """Whitelist rows for ``n`` reads: with the probability ``in_cells``
    from one of ``cells`` whitelist barcodes with lognormal(0, ``sigma``)
    sizes, else uniform over the whitelist."""
    cell_rows = rng.choice(n_whitelist, size=cells, replace=False)
    sizes = rng.lognormal(0.0, sigma, cells)
    rows = cell_rows[rng.choice(cells, size=n, p=sizes / sizes.sum())]
    ambient = rng.random(n) >= in_cells
    rows[ambient] = rng.integers(0, n_whitelist, size=int(ambient.sum()))
    return rows


def _substitute(rng, out: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> None:
    """Each base ``out[rows, cols]`` replaced by one of the other three."""
    codes = np.searchsorted(LETTERS, out[rows, cols])
    out[rows, cols] = LETTERS[(codes + rng.integers(1, 4, size=rows.size)) % 4]


def lane_barcodes(rng, whitelist: np.ndarray, source: np.ndarray, traffic: dict) -> np.ndarray:
    """The barcodes read for ``whitelist[source]``, as ASCII ``[n, L]``."""
    n, length = len(source), whitelist.shape[1]
    out = whitelist[source].copy()
    invalid = np.flatnonzero(rng.random(n) >= traffic["valid_barcodes"])
    first = rng.integers(0, length, size=invalid.size)
    second = (first + 1 + rng.integers(0, length - 1, size=invalid.size)) % length
    _substitute(rng, out, invalid, first)
    _substitute(rng, out, invalid, second)
    miscalled = rng.random((n, length)) < traffic["barcode_base_error"]
    miscalled[invalid] = False
    rows, cols = np.nonzero(miscalled)
    _substitute(rng, out, rows, cols)
    edge = traffic.get("edge_cases", {})
    if edge.get("n_call"):
        rows = np.flatnonzero(rng.random(n) < edge["n_call"])
        out[rows, rng.integers(0, length, size=rows.size)] = ord("N")
    if edge.get("lowercase_barcode"):
        out[rng.random(n) < edge["lowercase_barcode"]] += ord("a") - ord("A")
    return out


def make_triplets(rng, whitelist: np.ndarray, n: int, config: dict, traffic: dict) -> dict:
    """``n`` read triplets: R1 = the barcode then random bases, R2 and I1
    random bases; qualities '#'..'J'."""
    r1_length, cb_length = config["r1_length"], config["barcode_length"]
    r2_length, i1_length = config["r2_length"], config["i1_length"]
    source = lane_sources(rng, whitelist.shape[0], n, config["cells"], traffic["fraction_reads_in_cells"],
                          traffic["cell_sigma"])
    cb = lane_barcodes(rng, whitelist, source, traffic)
    r1 = np.concatenate([cb, LETTERS[rng.integers(0, 4, size=(n, r1_length - cb_length), dtype=np.uint8)]],
                        axis=1)
    r2 = LETTERS[rng.integers(0, 4, size=(n, r2_length), dtype=np.uint8)]
    odd_share = traffic.get("edge_cases", {}).get("r2_odd_bases", 0.0)
    if odd_share:  # half IUPAC codes, half lowercase
        odd = rng.random((n, r2_length))
        iupac = odd < odd_share / 2
        r2[iupac] = IUPAC[rng.integers(0, IUPAC.size, size=int(iupac.sum()))]
        r2[(odd >= odd_share / 2) & (odd < odd_share)] += ord("a") - ord("A")
    return dict(
        source=source,
        r1=r1, r1_qual=rng.integers(35, 75, size=(n, r1_length), dtype=np.uint8),
        r2=r2, r2_qual=rng.integers(35, 75, size=(n, r2_length), dtype=np.uint8),
        i1=LETTERS[rng.integers(0, 4, size=(n, i1_length), dtype=np.uint8)],
        i1_qual=rng.integers(35, 75, size=(n, i1_length), dtype=np.uint8),
    )


def read_names(first: int, n: int, digits: int) -> np.ndarray:
    """[n, digits + 1] bytes ``r%0<digits>d`` for reads first .. first + n - 1."""
    numbers = np.arange(first, first + n, dtype=np.int64)
    powers = 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)
    out = np.empty((n, digits + 1), dtype=np.uint8)
    out[:, 0] = ord("r")
    out[:, 1:] = (numbers[:, None] // powers) % 10 + ord("0")
    return out


def name_digits(n: int) -> int:
    return max(7, len(str(n - 1)))


COMMENT = b" 1:N:0:1"  # an Illumina comment: the program cuts the name at the space


def fastq_bytes(names: np.ndarray, seq: np.ndarray, qual: np.ndarray) -> bytes:
    """The FASTQ text of equal-width records, built as one byte matrix."""
    n = len(names)

    def const(text: bytes) -> np.ndarray:
        return np.broadcast_to(np.frombuffer(text, dtype=np.uint8), (n, len(text)))

    return np.concatenate([const(b"@"), names, const(COMMENT + b"\n"), seq, const(b"\n+\n"),
                           qual, const(b"\n")], axis=1).tobytes()


def _gzip(data: bytes) -> bytes:
    compressor = zlib.compressobj(1, zlib.DEFLATED, 31)
    return compressor.compress(data) + compressor.flush()


def write_triplet_files(directory: Path, triplets: dict, n_files: int) -> dict:
    """The triplets as ``n_files`` gzipped FASTQ files of each of R1, R2 and
    I1, cut into equal runs of reads; returns {kind: [paths]}."""
    n = len(triplets["r1"])
    digits = name_digits(n)
    cuts = [(n * f // n_files, n * (f + 1) // n_files) for f in range(n_files)]
    jobs, paths = [], {"r1": [], "r2": [], "i1": []}
    for kind in paths:
        for f, (lo, hi) in enumerate(cuts):
            path = directory / f"{kind}_{f}.fastq.gz"
            paths[kind].append(str(path))
            jobs.append((path, kind, lo, hi))

    def one(job):
        path, kind, lo, hi = job
        text = fastq_bytes(read_names(lo, hi - lo, digits), triplets[kind][lo:hi], triplets[kind + "_qual"][lo:hi])
        Path(path).write_bytes(_gzip(text))

    with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as pool:
        list(pool.map(one, jobs))
    return paths


def write_whitelist(path: Path, whitelist: np.ndarray) -> None:
    newline = np.full((whitelist.shape[0], 1), ord("\n"), dtype=np.uint8)
    Path(path).write_bytes(np.concatenate([whitelist, newline], axis=1).tobytes())
