"""The port's CUDA kernel and its attach path on the card, against the plain version.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips, with its reason, where ``torch.cuda.is_available()`` is false. The
file imports neither JAX nor ``sctools_tpu`` and builds its own inputs, so
it also runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The metrics engine (plain torch ops, no hand kernel) is held here to its own
CPU results bit for bit, floats included, on a run-keyed prepacked batch and
a plain unsorted one, at 5,000 records and at 2^20 (where the scan's stride
loop runs to 2^19), and one ``GatherCellMetrics`` CSV on the card to the
same on the CPU. The count pass (plain torch ops too) is held to its CPU
results at 5,000 records and at 2^19, the count's batch width, and one
``CreateCountMatrix`` run on the card to the same on the CPU. FastqProcess
(BAM and FASTQ shards, compared decompressed), SampleFastq and
CheckBarcodePartition on the card equal the same calls on the CPU, and
the kernel launches equal the batches; FastqProcess and attach take the
native loops there, with compressed shards that do not depend on the BGZF
pool's threads. A fused TagSortBam (the sort on the
host, the metrics pass on the card) gives the CSV and the sorted BAM it
gives on the CPU, for both tag orders, and launches no hand kernel. The
native host layer builds on the machine and decodes a small library to the
frames the port's Python decoder gives.

The JAX comparisons of the same functions run on the CPU in
``test_torch_whitelist.py``, ``test_torch_attach.py``,
``test_torch_metrics.py``, ``test_torch_count.py`` and
``test_torch_fastqprocess.py``.
"""

import gzip
import shutil

import numpy as np
import pytest
import torch

from sctools_tpu_torch import attach as port_attach
from sctools_tpu_torch import fastqprocess as port_fqp
from sctools_tpu_torch import kernels, native
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch import samplefastq as port_sample
from sctools_tpu_torch.io import packed as port_packed
from sctools_tpu_torch.io.packed import ReadFrame
from sctools_tpu_torch.io.sam import AlignmentWriter, BamHeader, BamRecord
from sctools_tpu_torch.metrics import device as port_device
from sctools_tpu_torch.metrics import gatherer as port_gatherer
from sctools_tpu_torch.ops import counting as port_counting
from sctools_tpu_torch.ops import segments as port_seg
from sctools_tpu_torch.ops import whitelist as port_whitelist

pytestmark = pytest.mark.cuda

LETTERS = np.array(list("ACGT"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _barcodes(rng, n, length):
    return ["".join(row) for row in rng.choice(LETTERS, size=(n, length))]


def _queries(rng, whitelist, n):
    """Exact, one substitution, one N, random, lowercase, and short."""
    length = len(whitelist[0])
    out = []
    for i in range(n):
        barcode = whitelist[rng.integers(len(whitelist))]
        p = int(rng.integers(length))
        kind = i % 6
        if kind == 1:
            barcode = barcode[:p] + rng.choice([c for c in "ACGT" if c != barcode[p]]) + barcode[p + 1:]
        elif kind == 2:
            barcode = barcode[:p] + "N" + barcode[p + 1:]
        elif kind == 3:
            barcode = _barcodes(rng, 1, length)[0]
        elif kind == 4:
            barcode = barcode.lower()
        elif kind == 5:
            barcode = barcode[: length // 2]
        out.append(barcode)
    return out


@pytest.mark.parametrize("length", [1, 14, 16, 17, 24, 32, 33, 49, 64])
def test_kernel_matches_plain(cuda_device, length):
    rng = np.random.default_rng(length)
    whitelist = _barcodes(rng, 5000 + 13, length)  # off any tile multiple
    whitelist[7] = "N" + whitelist[7][1:]
    whitelist.append(whitelist[11])  # a duplicate: the last copy wins
    queries = _queries(rng, whitelist, 3001) + [whitelist[11]]
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, length)).to(cuda_device)
    )
    q = torch.from_numpy(port_whitelist.barcode_codes(queries, length)).to(cuda_device)
    before = kernels.launches["whitelist_correct"]
    got = port_whitelist.correct_codes(q, table)
    torch.cuda.synchronize()
    assert kernels.launches["whitelist_correct"] == before + 1
    expected = port_whitelist.correct_plain(q, table)
    np.testing.assert_array_equal(got.cpu().numpy(), expected.cpu().numpy())
    assert got[-1].item() == len(whitelist) - 1


def _table(codes, device):
    return port_whitelist.make_table(torch.from_numpy(codes).to(device))


@pytest.mark.parametrize("length", [1, 16, 64])
def test_only_hit_in_the_last_partial_slice(cuda_device, length):
    # 2 * 512 + 77 entries: the kernel's last 512-row slice is ragged, and
    # the one entry every query can reach lies in it
    rng = np.random.default_rng(40 + length)
    n_w = 2 * 512 + 77
    whitelist = port_whitelist.barcode_codes(_barcodes(rng, n_w, length), length)
    whitelist[: n_w - 1] = 4  # all N: no hit at L >= 2
    target = whitelist[-1].copy()
    queries = np.repeat(target[None, :], 300, axis=0)
    rows = np.arange(1, 300, 2)
    cols = rng.integers(length, size=rows.size)
    queries[rows, cols] = (queries[rows, cols] + 1) % 4  # one substitution
    got = port_whitelist.correct_codes(
        torch.from_numpy(queries).to(cuda_device), _table(whitelist, cuda_device)
    )
    torch.cuda.synchronize()
    expected = port_whitelist.correct_plain(torch.from_numpy(queries), _table(whitelist, "cpu"))
    np.testing.assert_array_equal(got.cpu().numpy(), expected.numpy())
    assert (got.cpu().numpy() == n_w - 1).all()


@pytest.mark.parametrize("n_q", [1, 129])
@pytest.mark.parametrize("length", [1, 16])
def test_ragged_query_counts(cuda_device, n_q, length):
    rng = np.random.default_rng(n_q + length)
    whitelist = _barcodes(rng, 3000, length)
    queries = _queries(rng, whitelist, n_q)
    table = _table(port_whitelist.barcode_codes(whitelist, length), cuda_device)
    q = torch.from_numpy(port_whitelist.barcode_codes(queries, length)).to(cuda_device)
    got = port_whitelist.correct_codes(q, table)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), port_whitelist.correct_plain(q, table).cpu().numpy()
    )


def test_corrector_matches_on_cpu_and_card(cuda_device):
    rng = np.random.default_rng(3)
    whitelist = _barcodes(rng, 2000, 16)
    queries = _queries(rng, whitelist, 5000)
    on_card = port_whitelist.WhitelistCorrector(whitelist, device="cuda")
    on_cpu = port_whitelist.WhitelistCorrector(whitelist, device="cpu")
    np.testing.assert_array_equal(
        on_card.correct_indices(queries), on_cpu.correct_indices(queries)
    )


def test_wrapper_refuses_mixed_devices(cuda_device):
    whitelist = _barcodes(np.random.default_rng(4), 10, 16)
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, 16)).to(cuda_device)
    )
    with pytest.raises(ValueError):
        port_whitelist.correct_codes(torch.zeros((2, 16), dtype=torch.uint8), table)


def test_attach_on_the_card_matches_the_cpu(cuda_device, tmp_path, capsys):
    rng = np.random.default_rng(5)
    whitelist = _barcodes(rng, 100, 16)
    (tmp_path / "wl.txt").write_text("\n".join(whitelist) + "\n")
    n = 700
    r1 = [q.ljust(16, "A") + s for q, s in zip(_queries(rng, whitelist, n), _barcodes(rng, n, 12))]
    i1 = _barcodes(rng, n, 8)
    for name, reads in (("r1", r1), ("i1", i1)):
        with open(tmp_path / f"{name}.fastq", "w") as f:
            for i, seq in enumerate(reads):
                f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    header = BamHeader("@HD\tVN:1.6\tSO:unsorted\n")
    with AlignmentWriter(str(tmp_path / "u2.bam"), header) as out:
        for i, seq in enumerate(_barcodes(rng, n, 50)):
            out.write(BamRecord(query_name=f"r{i}", sequence=seq, quality=[30] * 50))

    outputs, errors = [], []
    for device in ("cpu", "cuda"):
        output = str(tmp_path / f"{device}.bam")
        before = kernels.launches["whitelist_correct"]
        capsys.readouterr()
        port_platform.TenXV2.attach_barcodes(
            ["--r1", str(tmp_path / "r1.fastq"), "--u2", str(tmp_path / "u2.bam"),
             "--i1", str(tmp_path / "i1.fastq"), "-o", output, "-w", str(tmp_path / "wl.txt")],
            device=device,
        )
        errors.append(capsys.readouterr().err)
        assert kernels.launches["whitelist_correct"] == before + (device == "cuda")
        with open(output, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    assert errors[0] == errors[1] and "Total barcodes:700" in errors[0]


def test_attach_takes_the_native_loop_and_launches_once_a_batch(cuda_device, tmp_path):
    """Attach -w on the card runs the native loop (``native.calls``), one
    kernel launch per batch, and writes the CPU's bytes."""
    rng = np.random.default_rng(12)
    whitelist = _barcodes(rng, 100, 16)
    (tmp_path / "wl.txt").write_text("\n".join(whitelist) + "\n")
    n = 700
    r1 = [q.ljust(16, "A") + s for q, s in zip(_queries(rng, whitelist, n), _barcodes(rng, n, 12))]
    with gzip.open(tmp_path / "r1.fastq.gz", "wt") as f:
        f.writelines(f"@r{i}\n{seq}\n+\n{'F' * len(seq)}\n" for i, seq in enumerate(r1))
    header = BamHeader("@HD\tVN:1.6\tSO:unsorted\n")
    with AlignmentWriter(str(tmp_path / "u2.bam"), header) as out:
        for i, seq in enumerate(_barcodes(rng, n, 50)):
            out.write(BamRecord(query_name=f"r{i}", sequence=seq, quality=[30] * 50))
    outputs = []
    for device in ("cpu", "cuda"):
        native.reset_calls()
        before = kernels.launches["whitelist_correct"]
        written = port_attach.attach_barcodes(
            str(tmp_path / "r1.fastq.gz"), str(tmp_path / "u2.bam"), str(tmp_path / f"{device}.bam"),
            [(0, 16)], [(16, 26)], whitelist=str(tmp_path / "wl.txt"), device=device, batch_size=128)
        assert written == n and native.calls["attach"] == 1
        assert kernels.launches["whitelist_correct"] - before == (-(-n // 128) if device == "cuda" else 0)
        outputs.append((tmp_path / f"{device}.bam").read_bytes())
    assert outputs[0] == outputs[1]


# ------------------------------------------------------------------ metrics


def _synthetic_frame(rng, n: int, n_cells: int = 300) -> ReadFrame:
    """A cell-sorted frame of ``n`` records: ~3 reads a molecule, runs of a
    molecule adjacent, every flag and quality field populated."""
    n_mol = n // 3 + 1
    mol = np.sort(rng.integers(0, n_mol, n))
    mol_cell = np.sort(rng.integers(0, n_cells, n_mol))
    cell, gene, umi = mol_cell[mol], rng.integers(0, 500, n_mol)[mol], rng.integers(0, 4000, n_mol)[mol]
    order = np.lexsort((gene, umi, cell))
    unmapped = rng.random(n) < 0.05

    def names(prefix, count):
        return [f"{prefix}{i:07d}" for i in range(count)]

    above, length = rng.integers(0, 17, n), np.full(n, 16)
    return ReadFrame(
        cell=cell[order].astype(np.int32), umi=umi[order].astype(np.int32),
        gene=gene[order].astype(np.int32), qname=np.arange(n, dtype=np.int32),
        cell_names=names("C", n_cells), umi_names=names("U", 4000),
        gene_names=names("G", 500), qname_names=names("Q", n),
        ref=np.where(unmapped, -1, rng.integers(0, 25, n)).astype(np.int32),
        pos=np.where(unmapped, -1, rng.integers(0, 1 << 28, n)).astype(np.int32),
        strand=rng.integers(0, 2, n).astype(np.int8), unmapped=unmapped,
        duplicate=rng.random(n) < 0.1, spliced=rng.random(n) < 0.1,
        xf=rng.integers(0, 6, n).astype(np.int8), nh=rng.choice([-1, 1, 1, 2], n).astype(np.int32),
        perfect_umi=rng.integers(-1, 2, n).astype(np.int8),
        perfect_cb=rng.integers(-1, 2, n).astype(np.int8),
        umi_qual=((rng.integers(0, 11, n) << 8) | 10).astype(np.uint16),
        cb_qual=((above << 8) | length).astype(np.uint16),
        genomic_qual=((rng.integers(0, 99, n) << 16) | 98).astype(np.uint32),
        genomic_total=rng.integers(200, 4000, n).astype(np.uint32),
    )


def _bits(tensor: torch.Tensor) -> np.ndarray:
    array = tensor.cpu().numpy()
    return array.view(np.int32) if array.dtype == np.float32 else array


@pytest.mark.parametrize("n", [5000, 1 << 20])
@pytest.mark.parametrize("schema", ["runkeyed", "plain_unsorted"])
def test_metrics_engine_on_the_card_matches_the_cpu(cuda_device, schema, n):
    rng = np.random.default_rng(n)
    frame = _synthetic_frame(rng, n)
    is_mito = np.zeros(len(frame.gene_names), dtype=bool)
    is_mito[-20:] = True
    padded = port_seg.bucket_size(n)
    if schema == "runkeyed":
        starts = np.ones(n, dtype=bool)
        starts[1:] = (np.diff(frame.cell) != 0) | (np.diff(frame.gene) != 0) | (np.diff(frame.umi) != 0)
        cols, flags = port_gatherer._pad_columns(
            frame, is_mito, pad_to=padded, prepacked_keys=("cell", "gene", "umi"),
            pair_mito=True, small_ref=True, run_keys_bucket=port_seg.bucket_size(int(starts.sum())),
            run_starts=starts,
        )
        cols = {"wire": port_gatherer._pack_wire(cols, flags)}
        kwargs = dict(presorted=True, prepacked=True, **flags)
    else:
        cols, _ = port_gatherer._pad_columns(frame, is_mito, pad_to=padded)
        perm = rng.permutation(padded)
        cols = {name: value[perm] for name, value in cols.items()}
        kwargs = dict(presorted=False)
    results = {}
    for device in ("cpu", "cuda"):
        staged = {name: torch.from_numpy(value).to(device) for name, value in cols.items()}
        results[device] = port_device.compute_entity_metrics(
            staged, num_segments=padded, kind="cell", **kwargs
        )
    cpu, card = results["cpu"], results["cuda"]
    assert int(card["n_entities"]) == int(cpu["n_entities"]) > 100
    for key in cpu:
        np.testing.assert_array_equal(_bits(card[key]), _bits(cpu[key]), err_msg=key)
    int_names, float_names = port_gatherer.wire_result_names(port_gatherer.CELL_COLUMNS)
    k = port_seg.entity_bucket(int(cpu["n_entities"]), padded)
    np.testing.assert_array_equal(
        port_device.compact_results_wire(card, int_names, float_names, k).cpu().numpy(),
        port_device.compact_results_wire(cpu, int_names, float_names, k).numpy(),
    )


def _cell_library(rng):
    """(header, records) of 300 cells x 7 molecules x 3 reads, sorted by
    (CB, UB), ~5% unmapped."""
    header = BamHeader.from_text(
        "@HD\tVN:1.6\tSO:unsorted\n" + "".join(f"@SQ\tSN:chr{i}\tLN:1000000\n" for i in range(3))
    )
    records = []
    for cell in sorted(_barcodes(rng, 300, 16)):
        for umi in sorted(_barcodes(rng, 7, 10)):
            gene = f"G{int(rng.integers(0, 40)):03d}"
            for i in range(3):
                unmapped = bool(rng.random() < 0.05)
                tags = {"CB": ("Z", cell), "CR": ("Z", cell), "CY": ("Z", "I" * 16),
                        "UB": ("Z", umi), "UR": ("Z", umi), "UY": ("Z", "5" * 10)}
                if not unmapped:
                    tags.update(GE=("Z", gene), XF=("Z", "CODING"), NH=("i", int(rng.integers(1, 3))))
                records.append(BamRecord(
                    query_name=f"{cell}{umi}{i}", flag=4 if unmapped else 0,
                    reference_id=-1 if unmapped else int(rng.integers(0, 3)),
                    pos=-1 if unmapped else int(rng.integers(0, 5000)),
                    cigar=[] if unmapped else [(0, 50)], sequence="A" * 50,
                    quality=[int(q) for q in rng.integers(2, 41, 50)], tags=tags,
                ))
    return header, records


def test_cell_metrics_csv_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """> 4,096 records with ~3 reads a molecule: the run-keyed wire engages."""
    header, records = _cell_library(np.random.default_rng(6))
    bam = str(tmp_path / "cells.bam")
    with AlignmentWriter(bam, header) as out:
        for record in records:
            out.write(record)
    csv = {}
    for device in ("cpu", "cuda"):
        gatherer = port_gatherer.GatherCellMetrics(
            bam, str(tmp_path / device), {"G000", "G001"}, device=device
        )
        gatherer.extract_metrics()
        assert gatherer.run_keyed_batches >= 1
        with gzip.open(tmp_path / f"{device}.csv.gz", "rb") as f:
            csv[device] = f.read()
    assert csv["cuda"] == csv["cpu"] and csv["cpu"].count(b"\n") == 301


@pytest.mark.parametrize("tags,flag", [(["CB", "UB", "GE"], "--cell-metrics-output"),
                                       (["GE", "CB", "UB"], "--gene-metrics-output")], ids=["cell", "gene"])
def test_fused_tag_sort_on_the_card_matches_the_cpu(cuda_device, tmp_path, tags, flag):
    """TagSortBam with a metrics output, on a shuffled library in 3 partials:
    the CSV and the sorted BAM on the card equal those on the CPU, and no
    hand kernel launches."""
    rng = np.random.default_rng(7)
    header, records = _cell_library(rng)
    bam = str(tmp_path / "shuffled.bam")
    with AlignmentWriter(bam, header) as out:
        for i in rng.permutation(len(records)):
            out.write(records[i])
    outputs = {}
    for device in ("cpu", "cuda"):
        before = dict(kernels.launches)
        assert port_platform.GenericPlatform.tag_sort_bam(
            ["-i", bam, "-t", *tags, flag, str(tmp_path / device), "-o", str(tmp_path / f"{device}.bam"),
             "--records-per-chunk", "2500"], device=device) == 0
        assert dict(kernels.launches) == before
        with gzip.open(tmp_path / f"{device}.csv.gz", "rb") as f, gzip.open(tmp_path / f"{device}.bam", "rb") as g:
            outputs[device] = (f.read(), g.read())
    assert outputs["cuda"] == outputs["cpu"] and outputs["cpu"][0].count(b"\n") > 30


def test_native_layer_builds_here_and_matches_the_python_decoder(cuda_device, tmp_path):
    """The native layer builds with this machine's g++ and zlib, and its
    frames (query names included) equal the port's Python decoder's on a
    small library, batch by batch."""
    rng = np.random.default_rng(11)
    header, records = _cell_library(rng)
    bam = str(tmp_path / "library.bam")
    with AlignmentWriter(bam, header) as out:
        for record in records:
            out.write(record)
    native.reset_calls()
    frames = list(port_packed.iter_frames_from_bam(bam, 1000))
    python = list(port_packed._python_frames(bam, 1000, port_packed.DEFAULT_TAG_KEYS))
    assert native.calls["stream_frames"] == 1 and native.library_path().exists()
    assert [f.n_records for f in frames] == [f.n_records for f in python] and len(frames) == 7
    for a, b in zip(frames, python):
        for name in port_packed._PER_RECORD_FIELDS:
            assert getattr(a, name).dtype == getattr(b, name).dtype, name
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        for name in port_packed._CODED_FIELDS:
            assert getattr(a, f"{name}_names") == getattr(b, f"{name}_names"), name


# -------------------------------------------------------------------- count


def _count_columns(rng, n: int):
    """Count columns of ``n`` records: ~1.6 alignments a query in scattered
    order, a padded tail, ~15% ineligible, ~1% without CB or UB."""
    n_q = int(n / 1.6)
    return dict(
        qname=rng.permutation(np.sort(rng.integers(0, n_q, n))).astype(np.int32),
        cell=rng.integers(0, 1000, n).astype(np.int32),
        umi=rng.integers(0, 50_000, n).astype(np.int32),
        gene=rng.integers(0, 30_000, n).astype(np.int32),
        eligible=rng.random(n) < 0.85,
        cb_ok=rng.random(n) < 0.99,
        ub_ok=rng.random(n) < 0.99,
        valid=np.arange(n) < n - n // 9,
    )


@pytest.mark.parametrize("n", [5000, 1 << 19])
def test_count_molecules_on_the_card_matches_the_cpu(cuda_device, n):
    cols = _count_columns(np.random.default_rng(n), n)
    results = {
        device: port_counting.count_molecules(
            {name: torch.from_numpy(value).to(device) for name, value in cols.items()}, num_segments=n
        )
        for device in ("cpu", "cuda")
    }
    assert int(results["cpu"]["is_molecule"].sum()) > n // 20
    for key, value in results["cpu"].items():
        np.testing.assert_array_equal(results["cuda"][key].cpu().numpy(), value.numpy(), err_msg=key)


def test_count_matrix_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """A queryname-grouped BAM of shuffled queries, counted in 2,000-record
    batches (three batches padded to 4,096 and cross-batch duplicates)."""
    rng = np.random.default_rng(8)
    genes = [f"G{i:03d}" for i in range(40)]
    gtf = tmp_path / "genes.gtf"
    gtf.write_text("".join(
        f'chr1\tt\tgene\t{i * 100 + 1}\t{i * 100 + 90}\t.\t+\t.\tgene_id "{g}"; gene_name "{g}";\n'
        for i, g in enumerate(genes)))
    header = BamHeader.from_text("@HD\tVN:1.6\tSO:queryname\n@SQ\tSN:chr1\tLN:1000000\n")
    cells, umis = _barcodes(rng, 60, 16), _barcodes(rng, 30, 10)
    queries = []
    for q in range(4000):
        cell, umi = cells[rng.integers(60)], umis[rng.integers(30)]
        tags = {"UB": ("Z", umi)} if rng.random() > 0.01 else {}
        if rng.random() > 0.01:
            tags["CB"] = ("Z", cell)
        first = genes[rng.integers(40)]
        hits = []
        for _ in range(int(rng.choice([1, 1, 1, 2, 3]))):
            gene = first if rng.random() < 0.7 else genes[rng.integers(40)]
            extra = {"GE": ("Z", gene), "XF": ("Z", "CODING")} if rng.random() < 0.85 else {
                "XF": ("Z", "INTERGENIC")}
            hits.append(dict(tags, **extra))
        queries.append(hits)
    order = rng.permutation(len(queries))
    bam = str(tmp_path / "grouped.bam")
    with AlignmentWriter(bam, header) as out:
        for rank, q in enumerate(order):
            for tags in queries[q]:
                out.write(BamRecord(query_name=f"q{rank:06d}", flag=0, reference_id=0, pos=100,
                                    cigar=[(0, 20)], sequence="A" * 20, quality=[30] * 20, tags=tags))
    files = {}
    for device in ("cpu", "cuda"):
        prefix = str(tmp_path / device)
        port_platform.GenericPlatform.bam_to_count_matrix(
            ["-b", bam, "-a", str(gtf), "-o", prefix, "--batch-records", "2000"], device=device)
        files[device] = [open(prefix + suffix, "rb").read() for suffix in ("_row_index.npy", "_col_index.npy")]
        with np.load(prefix + ".npz") as npz:
            files[device] += [npz[key] for key in sorted(npz.files)]
    for cpu, card in zip(files["cpu"], files["cuda"]):
        if isinstance(cpu, bytes):
            assert cpu == card
        else:
            np.testing.assert_array_equal(card, cpu)
    assert len(files["cpu"][2]) > 100  # data: molecules were counted


# -------------------------------------------------------------------- fastq


def _write_fastq(path, reads):
    with open(path, "w") as f:
        f.writelines(f"@{name}\n{seq}\n+\n{qual}\n" for name, seq, qual in reads)
    return str(path)


@pytest.fixture
def triplets(tmp_path):
    """Two 10x v2 triplets of 350 reads, R1 from ``_queries`` (exact, one
    error, N, random, lowercase, short), R2 with IUPAC and lowercase bases."""
    rng = np.random.default_rng(9)
    whitelist = _barcodes(rng, 100, 16)
    (tmp_path / "wl.txt").write_text("\n".join(whitelist) + "\n")
    files = {"wl": str(tmp_path / "wl.txt"), "r1": [], "r2": [], "i1": []}
    for t in range(2):
        r1, r2, i1 = [], [], []
        for i, barcode in enumerate(_queries(rng, whitelist, 350)):
            read = barcode + _barcodes(rng, 1, 12)[0] if len(barcode) == 16 else barcode
            r1.append((f"t{t}r{i} 1:N", read, "I" * len(read)))
            seq = _barcodes(rng, 1, 50)[0]
            seq = seq[:10] + "R" + seq[11:20].lower() + seq[20:]
            r2.append((f"t{t}r{i}", seq, "".join(chr(35 + int(q)) for q in rng.integers(0, 40, 50))))
            i1.append((f"t{t}r{i}", _barcodes(rng, 1, 8)[0], "F" * 8))
        for kind, reads in (("r1", r1), ("r2", r2), ("i1", i1)):
            files[kind].append(_write_fastq(tmp_path / f"{kind}_{t}.fastq", reads))
    return files


@pytest.mark.parametrize("output_format", ["BAM", "FASTQ"])
def test_fastq_process_on_the_card_matches_the_cpu(cuda_device, tmp_path, triplets, capsys, output_format):
    batch_size, n_shards = 128, 3
    shards, summaries = {}, {}
    for device in ("cpu", "cuda"):
        prefix = str(tmp_path / device)
        before = kernels.launches["whitelist_correct"]
        capsys.readouterr()
        stats = port_fqp.fastq_process(
            triplets["r1"], triplets["r2"], prefix, [(0, 16)], [(16, 26)], [(0, 8)], triplets["i1"],
            whitelist=triplets["wl"], n_shards=n_shards, output_format=output_format,
            batch_size=batch_size, device=device)
        summaries[device] = (stats, capsys.readouterr().err)
        launched = kernels.launches["whitelist_correct"] - before
        assert launched == (-(-700 // batch_size) if device == "cuda" else 0)
        paths = port_fqp.shard_paths(prefix, n_shards, output_format)
        shards[device] = [gzip.decompress(open(p, "rb").read()) for p in paths]
    assert summaries["cuda"] == summaries["cpu"] and summaries["cpu"][0]["corrected"] > 100
    assert shards["cuda"] == shards["cpu"] and all(shards["cpu"])
    if output_format == "BAM":
        bams = port_fqp.shard_paths(str(tmp_path / "cuda"), n_shards, "BAM")
        shutil.copy(bams[0], tmp_path / "copy.bam")
        for files, want in ((bams, 0), ([bams[0], str(tmp_path / "copy.bam")], 1)):
            results = []
            for device in ("cpu", "cuda"):
                rc = port_platform.GenericPlatform.check_barcode_partition(["-b", *files], device=device)
                results.append((rc, capsys.readouterr().err))
            assert results[0] == results[1] and results[0][0] == want


def test_fastq_process_native_loop_on_the_card(cuda_device, tmp_path, triplets, capsys, monkeypatch):
    """FastqProcess -w on the card runs the native loop: the CPU's
    decompressed shards and counters, one launch per batch, and compressed
    shards that do not depend on the BGZF pool's threads."""
    shards, summaries = {}, {}
    for device, threads in (("cpu", "8"), ("cuda", "8"), ("cuda", "1")):
        monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
        prefix = str(tmp_path / f"{device}{threads}")
        native.reset_calls()
        before = kernels.launches["whitelist_correct"]
        capsys.readouterr()
        stats = port_fqp.fastq_process(
            triplets["r1"], triplets["r2"], prefix, [(0, 16)], [(16, 26)], [(0, 8)], triplets["i1"],
            whitelist=triplets["wl"], n_shards=2, batch_size=256, device=device)
        summaries[device, threads] = (stats, capsys.readouterr().err)
        assert native.calls["fastqprocess"] == 1
        assert kernels.launches["whitelist_correct"] - before == (-(-700 // 256) if device == "cuda" else 0)
        shards[device, threads] = [open(p, "rb").read() for p in port_fqp.shard_paths(prefix, 2)]
    assert summaries["cuda", "8"] == summaries["cpu", "8"] == summaries["cuda", "1"]
    assert shards["cuda", "8"] == shards["cuda", "1"]
    assert [gzip.decompress(s) for s in shards["cuda", "8"]] == [gzip.decompress(s) for s in shards["cpu", "8"]]


def test_sample_fastq_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(10)
    whitelist = _barcodes(rng, 300, 14)
    (tmp_path / "wl.txt").write_text("\n".join(whitelist) + "\n")
    r1, r2 = [], []
    for i, barcode in enumerate(_queries(rng, whitelist, 600)):
        read = barcode[:8] + _barcodes(rng, 1, 18)[0] + barcode[8:] + _barcodes(rng, 1, 10)[0]
        r1.append((f"s{i}", read, "F" * len(read)))
        r2.append((f"s{i}", _barcodes(rng, 1, 40)[0], "I" * 40))
    r1_files = [_write_fastq(tmp_path / "r1a.fastq", r1[:250]), _write_fastq(tmp_path / "r1b.fastq", r1[250:])]
    r2_files = [_write_fastq(tmp_path / "r2.fastq", r2)]
    outputs = {}
    for device in ("cpu", "cuda"):
        before = kernels.launches["whitelist_correct"]
        kept = port_sample.sample_fastq(r1_files, r2_files, str(tmp_path / "wl.txt"), "8C18X6C9M1X",
                                        str(tmp_path / device), batch_size=128, device=device)
        assert kernels.launches["whitelist_correct"] - before == (5 if device == "cuda" else 0)
        outputs[device] = (kept, [open(tmp_path / f"{device}{s}", "rb").read() for s in (".R1", ".R2")])
    assert outputs["cuda"] == outputs["cpu"] and 200 < outputs["cpu"][0][0] < 600
