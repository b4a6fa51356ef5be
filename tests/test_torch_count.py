"""The port's count and merge paths against the JAX package, on the CPU.

The same inputs, made from a ``random`` or numpy seed through
``tests/helpers.py`` and ``test_count.SyntheticCountData``, go through
``sctools_tpu`` (JAX on the CPU) and through ``sctools_tpu_torch`` with
``device="cpu"``:

- ``count_molecules``: all five outputs equal, position by position, on
  random columns (padding, ineligible rows, missing CB/UB, queries grouped
  or scattered) and on the columns of a decoded BAM;
- ``CountMatrix`` and the ``CreateCountMatrix`` command: ``data``,
  ``indices``, ``indptr``, shape and dtype equal, and ``_row_index.npy`` /
  ``_col_index.npy`` equal byte for byte (the ``.npz`` bytes carry the time
  of the save, so the matrix is compared through its loaded arrays);
- the three merges: count matrices as above, metric CSVs equal byte for
  byte once decompressed (the JAX merge writes through pandas, the port's
  through ``csv`` and numpy).

Equality is exact everywhere: counting is integer work, and the merge's
float64 arithmetic replays pandas' and numpy's order.
"""

from __future__ import annotations

import gzip
import random

import numpy as np
import pytest
import torch

from sctools_tpu import count as jax_count
from sctools_tpu import gtf as jax_gtf
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.io import packed as jax_packed
from sctools_tpu.metrics import gatherer as jax_gatherer
from sctools_tpu.metrics import merge as jax_merge
from sctools_tpu.ops import counting as jax_counting
from sctools_tpu_torch import count as port_count
from sctools_tpu_torch import gtf as port_gtf
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io import packed as port_packed
from sctools_tpu_torch.metrics import merge as port_merge
from sctools_tpu_torch.ops import counting as port_counting

from helpers import make_header, make_record, write_bam, write_gtf
from test_count import GENE_TO_INDEX, GENES, N_GENES, SyntheticCountData
from test_metrics import random_tagged_records


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array))  # a copy: JAX's arrays are read-only


def _assert_outputs_equal(port, jax_out):
    assert set(port) == set(jax_out)
    for key in jax_out:
        a, b = port[key].numpy(), np.asarray(jax_out[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


def _random_cols(rng, n: int, grouped: bool):
    """Count columns with few codes (many collisions), a padded tail, ~20%
    ineligible rows and ~5% missing CB or UB."""
    qname = np.sort(rng.integers(0, max(1, n // 2), n)).astype(np.int32)
    if not grouped:
        qname = rng.permutation(qname)
    return dict(
        qname=qname,
        cell=rng.integers(0, 5, n).astype(np.int32),
        umi=rng.integers(0, 6, n).astype(np.int32),
        gene=rng.integers(0, 4, n).astype(np.int32),
        eligible=rng.random(n) < 0.8,
        cb_ok=rng.random(n) < 0.95,
        ub_ok=rng.random(n) < 0.95,
        valid=np.arange(n) < n - n // 7,
    )


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "scattered"])
@pytest.mark.parametrize("n", [1, 64, 1000, 4096])
def test_count_molecules_matches_jax(n, grouped):
    cols = _random_cols(np.random.default_rng(n + grouped), n, grouped)
    port = port_counting.count_molecules({k: _t(v) for k, v in cols.items()}, num_segments=n)
    jax_out = jax_counting.count_molecules(dict(cols), num_segments=n)
    _assert_outputs_equal(port, jax_out)
    if n > 1:
        assert 0 < int(port["is_molecule"].sum()) < n


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    data = SyntheticCountData()
    path = tmp_path_factory.mktemp("torch_count") / "synthetic.bam"
    write_bam(str(path), data.records(), data.header)
    return data, str(path)


def test_count_columns_and_pass_on_a_decoded_bam_match_jax(synthetic):
    """The host columns (multi-gene names, INTERGENIC, missing tags) and the
    pass over them, from the same BAM decoded by each package."""
    _, path = synthetic
    port_cols = port_count.device_count_columns(port_packed.frame_from_bam(path), pad_to=1024)
    jax_cols = jax_count.device_count_columns(jax_packed.frame_from_bam(path), pad_to=1024)
    assert list(port_cols) == list(jax_cols)
    for key in jax_cols:
        assert port_cols[key].dtype == jax_cols[key].dtype and np.array_equal(port_cols[key], jax_cols[key]), key
    n = len(jax_cols["valid"])
    port = port_counting.count_molecules({k: _t(v) for k, v in port_cols.items()}, num_segments=n)
    _assert_outputs_equal(port, jax_counting.count_molecules(dict(jax_cols), num_segments=n))


def _assert_same_matrix(port, jax_m, tmp_path=None):
    """Loaded arrays equal, and the saved index files byte for byte."""
    a, b = port.matrix, jax_m.matrix
    assert a.format == b.format == "csr" and a.dtype == b.dtype == np.uint32
    assert a.shape == b.shape
    for attr in ("data", "indices", "indptr"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert x.dtype == y.dtype and np.array_equal(x, y), attr
    for attr in ("row_index", "col_index"):
        x, y = getattr(port, attr), getattr(jax_m, attr)
        assert x.dtype == y.dtype and np.array_equal(x, y), attr
    if tmp_path is not None:
        port.save(str(tmp_path / "port"))
        jax_m.save(str(tmp_path / "jax"))
        _assert_same_files(tmp_path / "port", tmp_path / "jax")


def _assert_same_files(port_prefix, jax_prefix):
    for suffix in ("_row_index.npy", "_col_index.npy"):
        with open(f"{port_prefix}{suffix}", "rb") as f, open(f"{jax_prefix}{suffix}", "rb") as g:
            assert f.read() == g.read(), suffix
    with np.load(f"{port_prefix}.npz") as x, np.load(f"{jax_prefix}.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), key


@pytest.mark.parametrize("batch_records", [None, 16, 64], ids=["whole", "b16", "b64"])
def test_count_matrix_matches_jax(synthetic, tmp_path, batch_records):
    """Tiny batches interleave a molecule's queries across batches (the
    generator shuffles them), so the cross-batch dedup and the first-
    observation row order run."""
    data, path = synthetic
    kwargs = {} if batch_records is None else dict(batch_records=batch_records)
    port = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu", **kwargs)
    jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, backend="device", **kwargs)
    _assert_same_matrix(port, jax_m, tmp_path)
    assert int(port.matrix.sum()) == int(data.matrix.sum())
    if batch_records is not None:
        assert len(port.batches) > 1 and {b["padded"] for b in port.batches} == {4096}
        assert sum(b["records"] for b in port.batches) == port_packed.frame_from_bam(path).n_records


def test_frame_source_and_batch_records_reproduce_the_whole_file(synthetic):
    _, path = synthetic
    whole = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu")
    frames = list(port_packed.iter_frames_from_bam(path, 50))
    fed = port_count.CountMatrix.from_sorted_tagged_bam(
        path, GENE_TO_INDEX, device="cpu", batch_records=50, frame_source=lambda: iter(frames)
    )
    _assert_same_matrix(fed, whole)


def test_irregular_barcodes_match_jax(tmp_path):
    """Barcodes that cannot pack to u64 (> 21 bases, non-ACGTN) dedup through
    synthetic ids, across batches."""
    header = make_header()
    cells = ["A" * 25, "ACGTX", "CCCC", "A" * 25, "ACGTX"]
    records = [
        make_record(name=f"q{i}", cb=cb, ub="ACGTACGTAC" if i % 3 else "ZZ", ge=f"GENE{i % 2}",
                    xf="CODING", nh=1, header=header, pos=100 + i)
        for i, cb in enumerate(cells * 3)
    ]
    path = write_bam(str(tmp_path / "irregular.bam"), records, header)
    for batch_records in (2, 1000):
        port = port_count.CountMatrix.from_sorted_tagged_bam(
            path, GENE_TO_INDEX, device="cpu", batch_records=batch_records)
        jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(
            path, GENE_TO_INDEX, backend="device", batch_records=batch_records)
        _assert_same_matrix(port, jax_m)
        assert list(port.row_index) == ["A" * 25, "ACGTX", "CCCC"]


def test_custom_tags_match_jax(synthetic, tmp_path):
    _, path = synthetic
    port = port_count.CountMatrix.from_sorted_tagged_bam(
        path, GENE_TO_INDEX, molecule_barcode_tag="UY", device="cpu")
    jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(
        path, GENE_TO_INDEX, molecule_barcode_tag="UY", backend="device")
    _assert_same_matrix(port, jax_m, tmp_path)
    # UY is constant here: one molecule per (cell, gene)
    assert port.matrix.nnz > 0 and port.matrix.max() == 1


def test_cpu_backend_matches_jax(synthetic, tmp_path):
    _, path = synthetic
    port = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, backend="cpu")
    jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, backend="cpu")
    _assert_same_matrix(port, jax_m, tmp_path)
    device = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu")
    _assert_same_matrix(device, jax_m)


def test_empty_bam_matches_jax(tmp_path):
    path = write_bam(str(tmp_path / "empty.bam"), [])
    port = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu")
    jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX)
    assert port.matrix.shape == (0, N_GENES) and port.batches == []
    _assert_same_matrix(port, jax_m, tmp_path)


def test_unknown_gene_raises(tmp_path):
    records = [make_record(name="q1", cb="AAAA", ub="CCCC", ge="NOT_A_GENE", xf="CODING", nh=1)]
    path = write_bam(str(tmp_path / "unknown.bam"), records)
    with pytest.raises(KeyError, match="NOT_A_GENE"):
        port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu")


def test_barcode_packing_matches_jax():
    rng = random.Random(3)
    values = ["", "A", "T" * 21, "N" * 21, "ACGTN" * 4, "A" * 22, "ACGTX", "acgt"]
    values += ["".join(rng.choice("ACGTN") for _ in range(rng.randrange(1, 22))) for _ in range(300)]
    for value in values:
        packed = port_packed.pack_barcode_u64(value)
        assert packed == jax_packed.pack_barcode_u64(value), value
        if packed is not None:
            assert port_packed.unpack_barcode_u64(packed) == jax_packed.unpack_barcode_u64(packed) == value
    regular = sorted(v for v in values if port_packed.pack_barcode_u64(v) is not None)
    packed = [port_packed.pack_barcode_u64(v) for v in regular]
    assert packed == sorted(packed)  # integer order is string order
    assert port_packed.IRREGULAR_BARCODE_BASE == jax_packed.IRREGULAR_BARCODE_BASE
    assert port_packed.BARCODE_U64_MAX_LEN == jax_packed.BARCODE_U64_MAX_LEN


def _gtf_with_repeats(tmp_path):
    genes = [dict(gene_id=f"ENSG{i}", gene_name=name) for i, name in enumerate(GENES)]
    genes.insert(3, dict(gene_id="ENSG99", gene_name=GENES[1]))  # a repeat
    genes.append(dict(gene_id="ENSG98", gene_name="EXON_ONLY", feature="exon"))
    return write_gtf(str(tmp_path / "genes.gtf"), genes)


def test_extract_gene_names_matches_jax(tmp_path, caplog):
    path = _gtf_with_repeats(tmp_path)
    got = port_gtf.extract_gene_names(path)
    assert got == jax_gtf.extract_gene_names(path) == GENE_TO_INDEX
    assert any("Multiple entries" in r.getMessage() and "sctools_tpu_torch" in r.name for r in caplog.records)


@pytest.mark.parametrize("suffix,extra", [
    (".bam", []), (".bam", ["--batch-records", "32"]), (".sam", []),
    (".bam", ["--backend", "cpu"]), (".bam", ["--backend", "tpu", "-m", "UY", "-g", "GE", "-n"]),
], ids=["bam", "batched", "sam", "backend-cpu", "tpu-tags"])
def test_create_count_matrix_command_matches_jax(synthetic, tmp_path, suffix, extra):
    data, bam = synthetic
    if suffix == ".sam":
        bam = write_bam(str(tmp_path / "in.sam"), data.records(), data.header, mode="w")
    gtf_path = _gtf_with_repeats(tmp_path)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["-b", bam, "-a", gtf_path] + extra
    assert port_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", port_out], device="cpu") == 0
    assert jax_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", jax_out]) == 0
    _assert_same_files(port_out, jax_out)
    port = port_count.CountMatrix.load(port_out)
    assert port.matrix.nnz > 0 and port.matrix.dtype == np.uint32


def test_merge_count_matrices_command_matches_jax(synthetic, tmp_path):
    _, path = synthetic
    whole = jax_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX)
    prefixes = []
    for i, rows in enumerate((slice(0, 5), slice(5, 9), slice(9, None))):
        part = jax_count.CountMatrix(whole.matrix[rows].tocsr(), whole.row_index[rows], whole.col_index)
        prefixes.append(str(tmp_path / f"part{i}"))
        part.save(prefixes[-1])
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_platform.GenericPlatform.merge_count_matrices(["-i", *prefixes, "-o", port_out]) == 0
    jax_platform.GenericPlatform.merge_count_matrices(["-i", *prefixes, "-o", jax_out])
    _assert_same_files(port_out, jax_out)
    merged = port_count.CountMatrix.load(port_out)
    assert (merged.matrix != whole.matrix).nnz == 0
    assert np.array_equal(merged.row_index, whole.row_index)


def test_merge_rejects_mismatched_columns(synthetic, tmp_path):
    _, path = synthetic
    cm = port_count.CountMatrix.from_sorted_tagged_bam(path, GENE_TO_INDEX, device="cpu")
    other = port_count.CountMatrix(cm.matrix, cm.row_index, np.asarray(["X"] * len(cm.col_index)))
    cm.save(str(tmp_path / "a"))
    other.save(str(tmp_path / "b"))
    with pytest.raises(ValueError, match="disagree"):
        port_count.CountMatrix.merge_matrices([str(tmp_path / "a"), str(tmp_path / "b")])


# ------------------------------------------------------------------ metrics


def _gz(path) -> bytes:
    with gzip.open(str(path), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def chunk_csvs(tmp_path_factory):
    """Per kind, three chunk CSVs from the JAX gatherer (its host backend,
    which writes float64 means and variances): the records split
    by cell, so the gene chunks share genes (and each has a "None" gene
    row for its records without GE)."""
    tmp = tmp_path_factory.mktemp("torch_count_merge")
    records, header = random_tagged_records(seed=8, n_records=600, n_cells=9)
    out = {"cell": [], "gene": []}
    for chunk in range(3):
        mine = [r for r in records if _chunk_of(r) == chunk]
        for kind, tags, cls in (("cell", ["CB", "UB", "GE"], jax_gatherer.GatherCellMetrics),
                                ("gene", ["GE", "CB", "UB"], jax_gatherer.GatherGeneMetrics)):
            bam = write_bam(str(tmp / f"{kind}{chunk}.bam"), list(sort_by_tags_and_queryname(mine, tags)), header)
            stem = str(tmp / f"{kind}{chunk}")
            cls(bam, stem, backend="cpu").extract_metrics()
            out[kind].append(stem + ".csv.gz")
    return out


def _chunk_of(record) -> int:
    cell = record.get_tag("CB") if record.has_tag("CB") else ""
    return sum(map(ord, cell)) % 3


def _merge_both(tmp_path, kind, files):
    cls = "MergeCellMetrics" if kind == "cell" else "MergeGeneMetrics"
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    getattr(port_merge, cls)(files, port_out).execute()
    getattr(jax_merge, cls)(files, jax_out).execute()
    port_bytes = _gz(port_out + ".csv.gz")
    assert port_bytes == _gz(jax_out + ".csv.gz")
    return port_bytes.decode()


@pytest.mark.parametrize("n_files", [1, 2, 3])
@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_metric_merges_match_jax(chunk_csvs, tmp_path, kind, n_files):
    text = _merge_both(tmp_path, kind, chunk_csvs[kind][:n_files])
    lines = text.strip().split("\n")
    if kind == "gene" and n_files > 1:
        # three chunks fold twice; the "None" gene (no GE) reads as NA and drops
        assert lines[0].split(",")[-3:] == ["reads_per_molecule", "fragments_per_molecule", "reads_per_fragment"]
        assert not any(line.startswith(("None,", ",")) for line in lines[1:])
        names = [line.split(",")[0] for line in lines[1:]]
        assert names == sorted(names) and len(names) == len(set(names))
    if kind == "cell":
        assert len(lines) - 1 == sum(_gz(f).count(b"\n") - 1 for f in chunk_csvs[kind][:n_files])


def _write_csv(path, header, rows):
    with gzip.open(path, "wt") as f:
        f.write(",".join(header) + "\n" + "".join(",".join(row) + "\n" for row in rows))
    return str(path)


def test_gene_merge_edge_values_match_jax(tmp_path):
    """n_molecules summing to 0 (x/0 = inf, 0/0 = NaN), empty fields, int
    columns upcast by a float part, 17-digit floats, a "None" gene, and
    two different first header cells."""
    count = port_merge.MergeGeneMetrics.COUNT_COLUMNS_TO_SUM
    weighted = port_merge.MergeGeneMetrics.READ_WEIGHTED_COLUMNS
    header = count + weighted + ["reads_per_molecule"]

    def row(name, **values):
        return [name] + [values.get(c, "2") for c in header]

    a = _write_csv(tmp_path / "a.csv.gz", [""] + header, [
        row("ZED", n_molecules="0", genomic_read_quality_mean="0.30000001192092896"),
        row("ACT", noise_reads="", n_reads="0", n_fragments="0", n_molecules="0"),
        row("None"),
        row("MYC", molecule_barcode_fraction_bases_above_30_mean="inf"),
    ])
    b = _write_csv(tmp_path / "b.csv.gz", ["idx"] + header[::-1], [
        row("ZED", n_molecules="0", n_reads="7", genomic_read_quality_mean="12.345678901234567"),
        row("ACT", noise_reads="1.5", n_reads="3", n_fragments="0", n_molecules="0"),
        row("GAP", genomic_read_quality_variance=""),
    ])
    text = _merge_both(tmp_path, "gene", [a, b])
    assert text.startswith(",n_reads,") and ",inf," in text and "\nACT," in text
    _merge_both(tmp_path, "cell", [a, b])


@pytest.mark.parametrize("float_weights", [False, True], ids=["int-reads", "float-reads"])
def test_gene_merge_large_groups_match_jax(tmp_path, float_weights):
    """Genes repeated within a chunk make groups of 1 to 40 rows, so the
    float sums and ``np.average`` run past numpy's 8-element pairwise block."""
    count = port_merge.MergeGeneMetrics.COUNT_COLUMNS_TO_SUM
    weighted = port_merge.MergeGeneMetrics.READ_WEIGHTED_COLUMNS
    header = count + weighted
    rng = np.random.default_rng(17 + float_weights)

    def rows(repeats):
        out = []
        for gene, k in repeats.items():
            for _ in range(k):
                values = {c: str(int(rng.integers(1, 1000))) for c in count}
                if float_weights:
                    values["n_reads"] = repr(float(rng.random() * 1000.0))
                    values["noise_reads"] = repr(float(rng.random()))
                values.update({c: repr(float(rng.random() * 40.0)) for c in weighted})
                out.append([gene] + [values[c] for c in header])
        rng.shuffle(out)
        return out

    a = _write_csv(tmp_path / "a.csv.gz", [""] + header, rows({"AAA": 1, "BBB": 9, "CCC": 17, "DDD": 40}))
    b = _write_csv(tmp_path / "b.csv.gz", [""] + header, rows({"BBB": 1, "CCC": 2, "EEE": 23}))
    text = _merge_both(tmp_path, "gene", [a, b])
    assert [line.split(",")[0] for line in text.strip().split("\n")[1:]] == ["AAA", "BBB", "CCC", "DDD", "EEE"]


@pytest.mark.parametrize("entry", ["merge_gene_metrics", "merge_cell_metrics"])
def test_metric_merge_commands_match_jax(chunk_csvs, tmp_path, entry):
    kind = "gene" if "gene" in entry else "cell"
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert getattr(port_platform.GenericPlatform, entry)([*chunk_csvs[kind], "-o", port_out]) == 0
    getattr(jax_platform.GenericPlatform, entry)([*chunk_csvs[kind], "-o", jax_out])
    assert _gz(port_out + ".csv.gz") == _gz(jax_out + ".csv.gz")


def test_float_converter_matches_pandas():
    """The merge's float parse against pandas' own, on the spellings a
    metric CSV holds and on edge spellings."""
    import io

    import pandas as pd

    rng = np.random.default_rng(11)
    values = rng.random(3000) * 10.0 ** rng.integers(-9, 9, 3000)
    texts = [repr(float(np.float32(v))) for v in values] + [repr(float(v)) for v in values]
    texts += [f"{-v:.25e}" for v in values[:300]] + [
        "0", "-0.0", "3.", ".5", "+2.5", "1E5", "123456789012345678901234",
        "2.2250738585072014e-308", "4.9e-324", "1e-320", "inf", "-inf", "Infinity",
    ]
    expected = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"].to_numpy()
    got = np.array([port_merge._parse_float(text) for text in texts], dtype=np.float64)
    assert expected.dtype == np.float64
    assert np.array_equal(got.view(np.int64), expected.view(np.int64))


# ------------------------------------------------------------------ surface


def test_default_device_needs_a_gpu(synthetic, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a GPU")
    _, path = synthetic
    with pytest.raises(RuntimeError, match="CUDA"):
        port_platform.GenericPlatform.bam_to_count_matrix(
            ["-b", path, "-a", _gtf_with_repeats(tmp_path), "-o", str(tmp_path / "o")])
    assert not list(tmp_path.glob("o*"))
