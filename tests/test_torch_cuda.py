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
same on the CPU.

The JAX comparisons of the same functions run on the CPU in
``test_torch_whitelist.py``, ``test_torch_attach.py`` and
``test_torch_metrics.py``.
"""

import gzip

import numpy as np
import pytest
import torch

from sctools_tpu_torch import kernels
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io.packed import ReadFrame
from sctools_tpu_torch.io.sam import AlignmentWriter, BamHeader, BamRecord
from sctools_tpu_torch.metrics import device as port_device
from sctools_tpu_torch.metrics import gatherer as port_gatherer
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


def test_cell_metrics_csv_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """> 4,096 records with ~3 reads a molecule: the run-keyed wire engages."""
    rng = np.random.default_rng(6)
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
