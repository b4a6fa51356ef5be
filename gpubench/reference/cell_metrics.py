"""Per-cell QC metrics of a cell-sorted library, worked out from its columns.

The function is sctools' ``CellMetrics`` (src/sctools/metrics/aggregator.py),
as its CSV states it: one row per cell barcode, 35 columns in the header
order below. A molecule is a distinct (CB, UB, GE), a missing GE counting as
one gene of its own; a fragment a distinct (reference, position, strand, CB,
UB, GE) of a mapped read. Its quirks stay: a read with XF INTERGENIC counts
as mapped-intergenic, a read without XF as unmapped; the gene histogram
counts reads, so ``n_mitochondrial_molecules`` is read-weighted; variances
are sample variances, NaN below two reads; ``noise_reads``,
``antisense_reads`` and ``reads_mapped_too_many_loci`` are always 0.

``table`` computes the float columns in the dtype it is given: float64 is
the reference, and bfloat16, the precision below the float32 that the
configuration states, is the control. The integer columns are exact in
both.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List

import numpy as np
import torch

COMMON = [
    "n_reads", "noise_reads", "perfect_molecule_barcodes", "reads_mapped_exonic",
    "reads_mapped_intronic", "reads_mapped_utr", "reads_mapped_uniquely", "reads_mapped_multiple",
    "duplicate_reads", "spliced_reads", "antisense_reads",
    "molecule_barcode_fraction_bases_above_30_mean", "molecule_barcode_fraction_bases_above_30_variance",
    "genomic_reads_fraction_bases_quality_above_30_mean",
    "genomic_reads_fraction_bases_quality_above_30_variance",
    "genomic_read_quality_mean", "genomic_read_quality_variance", "n_molecules", "n_fragments",
    "reads_per_molecule", "reads_per_fragment", "fragments_per_molecule",
    "fragments_with_single_read_evidence", "molecules_with_single_read_evidence",
]
COLUMNS = COMMON + [
    "perfect_cell_barcodes", "reads_mapped_intergenic", "reads_unmapped", "reads_mapped_too_many_loci",
    "cell_barcode_fraction_bases_above_30_variance", "cell_barcode_fraction_bases_above_30_mean",
    "n_genes", "genes_detected_multiple_observations", "n_mitochondrial_genes",
    "n_mitochondrial_molecules", "pct_mitochondrial_molecules",
]
FLOATS = [c for c in COLUMNS if c.endswith(("_mean", "_variance")) or c.startswith(("reads_per", "fragments_per"))
          or c == "pct_mitochondrial_molecules"]
INTS = [c for c in COLUMNS if c not in FLOATS]
HIGH_QUALITY = 30
XF_CODING, XF_INTRONIC, XF_UTR, XF_INTERGENIC, XF_NONE = range(5)


def _distinct_per(cell: np.ndarray, *keys: np.ndarray, n_cells: int):
    """Per cell, the number of distinct key tuples, and how many of them
    occur exactly once and more than once."""
    table = np.stack([cell, *keys], axis=1)
    unique, counts = np.unique(table, axis=0, return_counts=True)
    owner = unique[:, 0]
    return (np.bincount(owner, minlength=n_cells), np.bincount(owner[counts == 1], minlength=n_cells),
            np.bincount(owner[counts > 1], minlength=n_cells))


def table(reads: dict, qual: np.ndarray, mito_genes: set, dtype=torch.float64) -> Dict[str, dict]:
    """{cell barcode: {column: value}} for the reads of ``gen.bam.make_reads``
    and the qualities ``write_tagged_bam`` drew; ``mito_genes`` holds GE
    values (bytes)."""
    cell = reads["cell"].astype(np.int64)
    n_cells = int(cell.max()) + 1
    cb_len, umi_len = reads["cb"].shape[1], reads["ub"].shape[1]
    mapped = ~reads["unmapped"]
    xf = reads["xf"]
    ge_values, ge_code = np.unique(reads["ge"], return_inverse=True)
    ge_code = ge_code.ravel()
    umi = (np.searchsorted(np.frombuffer(b"ACGT", np.uint8), reads["ub"]).astype(np.int64)
           * (4 ** np.arange(umi_len - 1, -1, -1))).sum(1)

    def count(mask) -> np.ndarray:
        return np.bincount(cell[mask], minlength=n_cells)

    out: Dict[str, np.ndarray] = {}
    out["n_reads"] = n_reads = np.bincount(cell, minlength=n_cells)
    zero = np.zeros(n_cells, dtype=np.int64)
    out["noise_reads"] = out["antisense_reads"] = out["reads_mapped_too_many_loci"] = zero
    out["perfect_molecule_barcodes"] = count((reads["ur"] == reads["ub"]).all(axis=1))
    out["reads_mapped_exonic"] = count(mapped & (xf == XF_CODING))
    out["reads_mapped_intronic"] = count(mapped & (xf == XF_INTRONIC))
    out["reads_mapped_utr"] = count(mapped & (xf == XF_UTR))
    out["reads_mapped_uniquely"] = count(mapped & (reads["nh"] == 1))
    out["reads_mapped_multiple"] = count(mapped & (reads["nh"] != 1))
    out["duplicate_reads"] = count(mapped & reads["duplicate"])
    out["spliced_reads"] = count(mapped & reads["spliced"])
    out["perfect_cell_barcodes"] = count((reads["cr"] == reads["cb"]).all(axis=1))
    out["reads_mapped_intergenic"] = count(xf == XF_INTERGENIC)
    out["reads_unmapped"] = count(xf == XF_NONE)
    n_mol, mol_single, _ = _distinct_per(cell, umi, ge_code, n_cells=n_cells)
    out["n_molecules"], out["molecules_with_single_read_evidence"] = n_mol, mol_single
    m = mapped
    n_frag, frag_single, _ = _distinct_per(cell[m], reads["ref"][m], reads["pos"][m],
                                           reads["reverse"][m].astype(np.int64), umi[m], ge_code[m],
                                           n_cells=n_cells)
    out["n_fragments"], out["fragments_with_single_read_evidence"] = n_frag, frag_single
    n_genes, _, multiple = _distinct_per(cell, ge_code, n_cells=n_cells)
    out["n_genes"], out["genes_detected_multiple_observations"] = n_genes, multiple
    is_mito = np.isin(ge_values, np.array(sorted(mito_genes), dtype=ge_values.dtype)) if mito_genes else \
        np.zeros(len(ge_values), bool)
    on_mito = is_mito[ge_code]
    out["n_mitochondrial_genes"], _, _ = _distinct_per(cell[on_mito], ge_code[on_mito], n_cells=n_cells)
    out["n_mitochondrial_molecules"] = mito_reads = count(on_mito)

    # the float columns, each value formed in ``dtype``
    index = torch.from_numpy(cell)
    n = torch.from_numpy(n_reads).to(dtype)

    def moments(values: torch.Tensor):
        values = values.to(dtype)
        total = torch.zeros(n_cells, dtype=dtype).index_add_(0, index, values)
        mean = total / n
        dev = values - mean[index]
        ss = torch.zeros(n_cells, dtype=dtype).index_add_(0, index, dev * dev)
        var = ss / (n - 1)
        var = torch.where(torch.from_numpy(n_reads) < 2, torch.full_like(var, math.nan), var)
        return mean, var

    q = torch.from_numpy(qual.astype(np.int64))
    high = (q > HIGH_QUALITY).to(dtype)

    def fraction(lo: int, hi: int) -> torch.Tensor:
        return high[:, lo:hi].sum(dim=1, dtype=dtype) / torch.tensor(hi - lo, dtype=dtype)

    columns = {
        "molecule_barcode_fraction_bases_above_30": fraction(cb_len, cb_len + umi_len),
        "genomic_reads_fraction_bases_quality_above_30": fraction(0, qual.shape[1]),
        "genomic_read_quality": q.to(dtype).sum(dim=1, dtype=dtype) / torch.tensor(qual.shape[1], dtype=dtype),
        "cell_barcode_fraction_bases_above_30": fraction(0, cb_len),
    }
    floats = {}
    for stem, values in columns.items():
        floats[stem + "_mean"], floats[stem + "_variance"] = moments(values)

    def ratio(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
        num, den = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
        return torch.where(den == 0, torch.full_like(num, math.nan), num / den)

    floats["reads_per_molecule"] = ratio(n_reads, n_mol)
    floats["reads_per_fragment"] = ratio(n_reads, n_frag)
    floats["fragments_per_molecule"] = ratio(n_frag, n_mol)
    pct = ratio(mito_reads, n_reads) * torch.tensor(100.0, dtype=dtype)
    floats["pct_mitochondrial_molecules"] = torch.where(torch.from_numpy(mito_reads) == 0, torch.zeros_like(pct), pct)
    for name, value in floats.items():
        out[name] = value.to(torch.float64).numpy()

    first = np.zeros(n_cells, dtype=np.int64)
    first[cell[::-1]] = np.arange(len(cell))[::-1]
    present = np.flatnonzero(n_reads)
    return {reads["cb"][first[c]].tobytes().decode(): {col: out[col][c] for col in COLUMNS} for c in present}


def read_csv(path: str):
    """(header, {index: [values as text]}, duplicated indices) of a metric CSV."""
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    header = lines[0].split(",")[1:] if lines else []
    rows, duplicated = {}, 0
    for line in lines[1:]:
        name, *values = line.split(",")
        duplicated += name in rows
        rows[name] = values
    return header, rows, duplicated


def _scale(values: List[float]) -> float:
    finite = [abs(v) for v in values if not math.isnan(v)]
    return float(np.median(finite)) if finite else 0.0


def compare(want: Dict[str, dict], header: List[str], got: Dict[str, list], duplicated: int) -> Dict[str, float]:
    """The numbers compared for one CSV: ``cells_wrong`` (cells missing,
    extra or written twice, every row if the header differs), ``counts_wrong``
    (integer cells that differ) and ``float_gap`` (the widest gap of a float
    value from the reference's, over the larger of the reference value's
    size and its column's median size)."""
    if header != COLUMNS:
        return {"cells_wrong": len(want) + len(got), "counts_wrong": 0, "float_gap": math.inf}
    cells_wrong = len(set(want) ^ set(got)) + duplicated
    counts_wrong = 0
    gap = 0.0
    scales = {c: _scale([row[c] for row in want.values()]) for c in FLOATS}
    position = {c: i for i, c in enumerate(COLUMNS)}
    for name in set(want) & set(got):
        row, text = want[name], got[name]
        if len(text) != len(COLUMNS):
            cells_wrong += 1
            continue
        try:
            values = [float(v) for v in text]
        except ValueError:
            cells_wrong += 1
            continue
        for c in INTS:
            counts_wrong += values[position[c]] != row[c]
        for c in FLOATS:
            mine, ref = values[position[c]], float(row[c])
            if math.isnan(mine) or math.isnan(ref):
                g = 0.0 if math.isnan(mine) and math.isnan(ref) else math.inf
            else:
                g = abs(mine - ref) / max(abs(ref), scales[c], 1e-300)
            gap = max(gap, g)
    return {"cells_wrong": int(cells_wrong), "counts_wrong": int(counts_wrong), "float_gap": gap}


def write_csv(path: str, rows: Dict[str, dict]) -> None:
    """``rows`` as a metric CSV: the header, then each cell's values."""
    lines = ["," + ",".join(COLUMNS)]
    for name, row in rows.items():
        lines.append(name + "," + ",".join(str(int(row[c])) if c in INTS else str(float(row[c])) for c in COLUMNS))
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("\n".join(lines) + "\n")
