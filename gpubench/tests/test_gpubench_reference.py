"""The plain reference on hand-made cases."""

import math

import numpy as np
import torch

from gpubench.reference import bamread, cell_metrics, fastq_lane, whitelist


def rows(*barcodes):
    return np.frombuffer(b"".join(barcodes), dtype=np.uint8).reshape(len(barcodes), -1)


def test_whitelist_hamming_one_and_the_tie_rule():
    wl = rows(b"AAAA", b"CCCC", b"AAAT", b"GGGG", b"CCCC")
    table = whitelist.Table(wl)
    queries = rows(b"AAAA", b"AAAC", b"CCCA", b"NCCC", b"NNCC", b"aCCC", b"TTTT", b"GGTT", b"AAAT", b"GGGN")
    # AAAA: itself (0) and AAAT (2) at distance 1: the last wins. AAAC: 0 and
    # 2 at distance 1. CCCA: CCCC, duplicated at 1 and 4: the last. NCCC: one
    # bad base, CCCC. NNCC: two bad bases. aCCC: lowercase is a bad base.
    # TTTT: nothing. GGTT: two substitutions. AAAT: itself and AAAA.
    assert table.correct(queries).tolist() == [2, 2, 4, 4, -1, 4, -1, -1, 2, 3]
    first = whitelist.Table(wl, tie="first")
    assert first.correct(queries).tolist() == [0, 0, 1, 1, -1, 1, -1, -1, 0, 3]
    assert table.correct(queries, lengths=[4, 3, 4, 4, 4, 4, 4, 4, 4, 4]).tolist()[:2] == [2, -1]


def test_whitelist_without_bitmap_agrees():
    rng = np.random.default_rng(5)
    wl = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(3000, 17))]
    q = wl[rng.integers(0, 3000, size=500)].copy()
    q[::3, 4] = ord("N")
    q[1::3, 7] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=len(q[1::3]))]
    big = whitelist.Table(wl)  # 17 bases: no bitmap
    assert big.bitmap is None
    small = whitelist.Table(wl[:, :16])
    assert small.bitmap is not None
    assert (big.correct(q) >= 0).sum() > 400
    assert (small.correct(q[:, :16]) >= 0).sum() > 400


def test_bam_records_round_trip_and_the_lane_check(tmp_path):
    trip = {
        "r1": rows(b"AAAACCGG", b"CCCCTTAA", b"GGGGAAAA"), "r1_qual": rows(b"IIIIJJJJ", b"########", b"ABCDEFGH"),
        "r2": rows(b"ACGTa", b"NNRYc", b"TTTTT"), "r2_qual": rows(b"#####", b"JJJJJ", b"AAAAA"),
        "i1": rows(b"AC", b"GT", b"TT"), "i1_qual": rows(b"II", b"JJ", b"##"),
    }
    wl = rows(b"AAAA", b"CCCA")
    index = whitelist.Table(wl).correct(trip["r1"][:, :4])
    assert index.tolist() == [0, 1, -1]
    want = fastq_lane.expected(trip, wl, index, (0, 4), (4, 8))
    assert want["counters"] == {"total_reads": 3, "correct": 1, "corrected": 1, "uncorrectable": 1}
    paths = fastq_lane.write_shards(tmp_path, want, 2)
    shards = [bamread.read_bam(p) for p in paths]
    assert sum(len(s) for s in shards) == 3
    assert fastq_lane.check(shards, want, want["counters"]) == {"reads_wrong": 0, "barcodes_split": 0,
                                                                "counters_wrong": 0}
    # the same records in the wrong shards, a read twice, a wrong base
    everything = fastq_lane.write_shards(tmp_path, want, 1)
    doubled = [bamread.read_bam(everything[0]), bamread.read_bam(paths[0])]
    assert fastq_lane.check(doubled, want, want["counters"])["reads_wrong"] >= 1
    other = dict(want, phred=want["phred"].copy())
    other["phred"][2, 1] += 1
    bad = [bamread.read_bam(p) for p in fastq_lane.write_shards(tmp_path, other, 2)]
    assert fastq_lane.check(bad, want, want["counters"])["reads_wrong"] == 1
    assert fastq_lane.check(shards, want, dict(want["counters"], correct=2))["counters_wrong"] == 1


def library():
    """Two cells by hand: cell 0 has 3 reads (2 molecules, one on an MT-
    gene), cell 1 has 1 unmapped read with no GE and no XF."""
    b = lambda *v: rows(*v)  # noqa: E731
    return dict(
        cell=np.array([0, 0, 0, 1]), cb=b(b"AC", b"AC", b"AC", b"GT"), cr=b(b"AC", b"AN", b"AC", b"GT"),
        ub=b(b"AA", b"AA", b"CC", b"GG"), ur=b(b"AA", b"AA", b"CN", b"GG"),
        ge=np.array([b"G1", b"G1", b"MT-1", b""], dtype="S21"), xf=np.array([0, 0, 3, 4]),
        unmapped=np.array([False, False, False, True]), ref=np.array([1, 1, 24, -1]),
        pos=np.array([10, 10, 50, -1]), reverse=np.array([False, False, True, False]),
        duplicate=np.array([False, True, False, False]), spliced=np.array([True, False, False, False]),
        nh=np.array([1, 1, 2, 0]),
    )


def test_cell_metrics_by_hand():
    qual = np.array([[40, 40, 40, 40, 20, 10], [10, 40, 40, 40, 40, 40], [31, 30, 31, 30, 31, 30],
                     [2, 2, 2, 2, 2, 2]], dtype=np.uint8)
    got = cell_metrics.table(library(), qual, {b"MT-1"})
    a, b = got["AC"], got["GT"]
    assert (a["n_reads"], a["n_molecules"], a["n_fragments"], a["n_genes"]) == (3, 2, 2, 2)
    assert (a["perfect_cell_barcodes"], a["perfect_molecule_barcodes"]) == (2, 2)
    assert (a["reads_mapped_exonic"], a["reads_mapped_intergenic"], a["reads_unmapped"]) == (2, 1, 0)
    assert (a["reads_mapped_uniquely"], a["reads_mapped_multiple"], a["duplicate_reads"]) == (2, 1, 1)
    assert (a["spliced_reads"], a["molecules_with_single_read_evidence"]) == (1, 1)
    assert (a["fragments_with_single_read_evidence"], a["genes_detected_multiple_observations"]) == (1, 1)
    assert (a["n_mitochondrial_genes"], a["n_mitochondrial_molecules"]) == (1, 1)
    assert math.isclose(a["pct_mitochondrial_molecules"], 100 / 3)
    # CY is the first 2 qualities, UY the next 2; > 30 counts
    assert math.isclose(a["cell_barcode_fraction_bases_above_30_mean"], (1 + 0.5 + 0.5) / 3)
    assert math.isclose(a["molecule_barcode_fraction_bases_above_30_mean"], (1 + 1 + 0.5) / 3)
    assert math.isclose(a["molecule_barcode_fraction_bases_above_30_variance"], np.var([1, 1, 0.5], ddof=1))
    assert math.isclose(a["genomic_read_quality_mean"], np.mean([np.mean(r) for r in qual[:3].astype(float)]))
    assert math.isclose(a["reads_per_molecule"], 1.5) and math.isclose(a["fragments_per_molecule"], 1.0)
    assert (b["n_reads"], b["reads_unmapped"], b["n_fragments"], b["n_genes"]) == (1, 1, 0, 1)
    assert math.isnan(b["reads_per_fragment"]) and math.isnan(b["genomic_read_quality_variance"])
    assert b["pct_mitochondrial_molecules"] == 0.0


def test_csv_compare(tmp_path):
    qual = np.full((4, 6), 35, dtype=np.uint8)
    want = cell_metrics.table(library(), qual, {b"MT-1"})
    path = str(tmp_path / "c.csv.gz")
    cell_metrics.write_csv(path, want)
    assert cell_metrics.compare(want, *cell_metrics.read_csv(path)) == {"cells_wrong": 0, "counts_wrong": 0,
                                                                         "float_gap": 0.0}
    off = {k: dict(v) for k, v in want.items()}
    off["AC"]["n_genes"] += 1
    off["AC"]["reads_per_molecule"] *= 1.01
    del off["GT"]
    cell_metrics.write_csv(path, off)
    numbers = cell_metrics.compare(want, *cell_metrics.read_csv(path))
    assert numbers["cells_wrong"] == 1 and numbers["counts_wrong"] == 1
    assert 0.009 < numbers["float_gap"] < 0.011
    lower = cell_metrics.table(library(), qual, {b"MT-1"}, torch.bfloat16)
    assert set(lower) == set(want)
