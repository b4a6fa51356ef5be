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
same on the CPU, also through the ingest ring at depth 1 under the frame
witness with its slots reused. The count pass (plain torch ops too) is held to its CPU
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
frames the port's Python decoder gives. The mesh: on ``[cuda:0, cuda:0]``
(two shards on one card, where every copy between shards is a no-op) the
sharded gatherers, the sharded count, the collective merges, the reshard,
the distributed step, the sample sort and the preflight equal a 2-shard CPU
mesh and one device; on a machine with 2 or 4 cards, ``--devices 2`` and
``--devices 4`` on distinct cards give one device's outputs too (fewer
cards: those two skip); more devices than cards is JAX's parser error.
The chunk queue: two chunks through ``run_process_cell_metrics`` on cuda
(its default) merge to the one-shot card CSV, and ``collective_merge_parts``
on the card mesh and on a repeated card gives ``merge_sorted_csv_parts``'s
bytes. The serving plane: the engine's pass captured as a CUDA graph on
one full 2^20 batch replays a second batch of the same signature with no
new capture, and each replayed block equals the eager block byte for
byte, for a presorted and for a device-sorted batch; capturing a key
twice raises; a worker on cuda warms its graphs on a calibration BAM and
drains a two-tenant journal in one pack, each artifact equal to the job's
eager solo CSV; a cuda worker without a GPU raises before any lease. The
global mesh: two processes joined by ``initialize_distributed``, one shard
each, on one card (both on cuda:0, exchanging over gloo) and on two
distinct cards (over NCCL; a machine with one card skips it), give the
in-process ``[cuda:0, cuda:0]`` mesh's ``distributed_metrics_step`` bit for
bit.

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


def test_ring_cell_metrics_csv_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch):
    """The ingest ring at depth 1, under the frame witness, with 1,000-record
    batches: 7 frames over 4 slots, so every slot is reused; the CSV on the
    card equals the CPU's, and no prefetch thread is left."""
    import threading

    from sctools_tpu_torch import ingest
    from sctools_tpu_torch.ingest import framedebug

    monkeypatch.setenv("SCTOOLS_TPU_PREFETCH_DEPTH", "1")
    monkeypatch.setenv(framedebug.ENV_FLAG, "1")
    header, records = _cell_library(np.random.default_rng(8))
    bam = str(tmp_path / "cells.bam")
    with AlignmentWriter(bam, header) as out:
        for record in records:
            out.write(record)
    csv = {}
    for device in ("cpu", "cuda"):
        native.reset_calls()
        framedebug.reset()
        gatherer = port_gatherer.GatherCellMetrics(
            bam, str(tmp_path / device), {"G000", "G001"}, batch_records=1000, device=device
        )
        gatherer.extract_metrics()
        assert native.calls["batch_stream"] == 1 and gatherer.ring_batches == 7 > ingest.ring_slots()
        assert framedebug.stamped_count() == 7 and framedebug.violations() == []
        assert not [t for t in threading.enumerate() if t.name == "sctools-prefetch" and t.is_alive()]
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


# --------------------------------------------------------------------- mesh


def _card_and_cpu_meshes():
    """A 2-shard mesh that repeats the first card, and 2 CPU shards."""
    from sctools_tpu_torch import parallel as port_par

    card = torch.device("cuda", 0)
    return port_par.make_mesh(devices=[card, card]), port_par.make_mesh(2, device="cpu")


def _gz(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def test_mesh_metrics_and_merges_on_a_repeated_card_match_the_cpu_mesh(cuda_device, tmp_path):
    """The sharded cell and gene gatherers on [cuda:0, cuda:0] write the
    CPU mesh's CSVs, which equal the one-device CSV; the collective merges
    of those CSVs in two parts equal the host merges."""
    from sctools_tpu_torch import bam as port_bam
    from sctools_tpu_torch import parallel as port_par
    from sctools_tpu_torch.metrics import collective, merge

    header, records = _cell_library(np.random.default_rng(9))
    paths = {}
    for kind, tags in (("cell", ["CB", "UB", "GE"]), ("gene", ["GE", "CB", "UB"])):
        paths[kind] = str(tmp_path / f"{kind}.bam")
        with AlignmentWriter(paths[kind], header) as out:
            for record in port_bam.sort_by_tags_and_queryname(records, tags):
                out.write(record)
    card, cpu = _card_and_cpu_meshes()
    csv = {}
    for kind in ("cell", "gene"):
        cls = port_par.sharded_gatherer_cls(kind)
        mito = {"G000", "G001"} if kind == "cell" else set()
        before = dict(kernels.launches)
        for name, mesh in (("card", card), ("cpu", cpu)):
            gatherer = cls(paths[kind], str(tmp_path / f"{kind}_{name}"), mito, mesh=mesh, batch_records=3000)
            gatherer.extract_metrics()
            assert len(gatherer.batches) > 2 and gatherer.batches[0]["prepacked"]
            csv[kind, name] = _gz(tmp_path / f"{kind}_{name}.csv.gz")
        single = port_gatherer.GatherCellMetrics if kind == "cell" else port_gatherer.GatherGeneMetrics
        single(paths[kind], str(tmp_path / f"{kind}_one"), mito, device="cpu").extract_metrics()
        assert dict(kernels.launches) == before
        assert csv[kind, "card"] == csv[kind, "cpu"] == _gz(tmp_path / f"{kind}_one.csv.gz")
    assert csv["cell", "card"].count(b"\n") == 301

    for kind in ("cell", "gene"):
        lines = csv[kind, "card"].decode().split("\n")
        half = len(lines) // 2
        parts = []
        for i, chunk in enumerate((lines[1:half], lines[half:-1])):
            parts.append(str(tmp_path / f"{kind}_part{i}.csv.gz"))
            with gzip.open(parts[-1], "wt") as f:
                f.write("\n".join([lines[0]] + chunk) + "\n")
        files = parts if kind == "cell" else [parts[0], parts[1], parts[0]]
        host = merge.MergeCellMetrics if kind == "cell" else merge.MergeGeneMetrics
        host(files, str(tmp_path / f"{kind}_merged_host")).execute()
        want = _gz(tmp_path / f"{kind}_merged_host.csv.gz")
        mesh_cls = collective.CollectiveMergeCellMetrics if kind == "cell" else collective.CollectiveMergeGeneMetrics
        for name, mesh in (("card", card), ("cpu", cpu)):
            mesh_cls(files, str(tmp_path / f"{kind}_merged_{name}"), mesh=mesh).execute()
            assert _gz(tmp_path / f"{kind}_merged_{name}.csv.gz") == want


def test_mesh_count_on_a_repeated_card_matches_the_cpu_mesh(cuda_device, tmp_path):
    from sctools_tpu_torch import count as port_count
    from sctools_tpu_torch import parallel as port_par

    rng = np.random.default_rng(12)
    genes = {f"G{i:03d}": i for i in range(40)}
    header = BamHeader.from_text("@HD\tVN:1.6\tSO:queryname\n@SQ\tSN:chr1\tLN:1000000\n")
    cells, umis = _barcodes(rng, 60, 16), _barcodes(rng, 30, 10)
    bam = str(tmp_path / "grouped.bam")
    with AlignmentWriter(bam, header) as out:
        for q in range(3000):
            tags = {"CB": ("Z", cells[rng.integers(60)]), "UB": ("Z", umis[rng.integers(30)])}
            for _ in range(int(rng.choice([1, 1, 2]))):
                gene = f"G{int(rng.integers(40)):03d}"
                out.write(BamRecord(query_name=f"q{q:06d}", flag=0, reference_id=0, pos=100, cigar=[(0, 20)],
                                    sequence="A" * 20, quality=[30] * 20,
                                    tags=dict(tags, GE=("Z", gene), XF=("Z", "CODING"))))
    card, cpu = _card_and_cpu_meshes()
    matrices = [port_count.CountMatrix.from_sorted_tagged_bam(bam, genes, batch_records=1500, mesh=mesh)
                for mesh in (card, cpu)]
    matrices.append(port_count.CountMatrix.from_sorted_tagged_bam(bam, genes, batch_records=1500, device="cpu"))
    for other in matrices[1:]:
        for attr in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(matrices[0].matrix, attr), getattr(other.matrix, attr))
        np.testing.assert_array_equal(matrices[0].row_index, other.row_index)
    assert len(matrices[0].batches) > 1 and matrices[0].matrix.nnz > 100


def test_mesh_collectives_on_a_repeated_card_match_the_cpu_mesh(cuda_device):
    """On [cuda:0, cuda:0] every ``.to`` between shards is a no-op, so an
    exchange that wrote in place would read its own output: the reshard's
    received columns, the sample sort, the distributed step and the
    preflight must equal the CPU mesh's."""
    from sctools_tpu_torch import parallel as port_par
    from sctools_tpu_torch.parallel import metrics as par_metrics

    card, cpu = _card_and_cpu_meshes()
    frame = _synthetic_frame(np.random.default_rng(13), 6000)
    cols = port_gatherer._pad_columns(frame, np.zeros(len(frame.gene_names), bool))[0]
    stacked = port_par.partition_columns(cols, 2, key="cell")
    required = port_par.required_reshard_capacity(stacked, "gene", 2)
    received = {}
    for name, mesh in (("card", card), ("cpu", cpu)):
        out, dropped = port_par.reshard_by_key(par_metrics.place(stacked, mesh), "gene", mesh, capacity=required)
        received[name] = port_par.stack_to_host({k: [shard[k] for shard in out] for k in out[0]})
        assert sum(int(d.cpu()) for d in dropped) == 0
    for key, want in received["cpu"].items():
        np.testing.assert_array_equal(received["card"][key], want)
    assert int(received["card"]["valid"].sum()) == frame.n_records

    steps = {name: port_par.distributed_metrics_step(stacked, mesh) for name, mesh in (("card", card), ("cpu", cpu))}
    for i in range(2):
        got, want = (port_par.stack_to_host(steps[name][i]) for name in ("card", "cpu"))
        for key in want:
            np.testing.assert_array_equal(_bits(torch.from_numpy(got[key])), _bits(torch.from_numpy(want[key])))
    keys = {"k1": frame.cell.reshape(2, -1), "k2": frame.umi.reshape(2, -1),
            "payload": np.arange(6000, dtype=np.int32).reshape(2, -1), "valid": np.ones((2, 3000), bool)}
    sorted_ = {name: port_par.stack_to_host(port_par.distributed_sort(keys, ["k1", "k2"], mesh))
               for name, mesh in (("card", card), ("cpu", cpu))}
    for key, want in sorted_["cpu"].items():
        np.testing.assert_array_equal(sorted_["card"][key], want)
    assert port_par.collective_preflight(card) == port_par.collective_preflight(cpu) == {"devices": 2, "total": 28}


def test_more_devices_than_cards_stop_at_the_parser(cuda_device, tmp_path, capsys):
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as stop:
        port_platform.GenericPlatform.calculate_cell_metrics(
            ["-i", "missing.bam", "-o", str(tmp_path / "o"), "--devices", str(n)])
    assert stop.value.code == 2
    assert f"requested {n} devices, only {n - 1} available" in capsys.readouterr().err


@pytest.mark.parametrize("n", [2, 4])
def test_devices_on_distinct_cards_match_one_device(cuda_device, tmp_path, n):
    """``--devices n`` on n cards (a machine with fewer skips): the cell and
    gene CSVs, the count, the collective merges and the fused TagSortBam
    equal one device's, and the exchanges equal a CPU mesh's; every shard's
    results come back through its own card's stream."""
    from sctools_tpu_torch import bam as port_bam
    from sctools_tpu_torch import parallel as port_par
    from sctools_tpu_torch.parallel import metrics as par_metrics

    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, this machine has {torch.cuda.device_count()}")
    rng = np.random.default_rng(14)
    header, records = _cell_library(rng)
    bams = {}
    for kind, tags in (("cell", ["CB", "UB", "GE"]), ("gene", ["GE", "CB", "UB"]), ("shuffled", None)):
        bams[kind] = str(tmp_path / f"{kind}.bam")
        ordered = port_bam.sort_by_tags_and_queryname(records, tags) if tags else (
            records[i] for i in rng.permutation(len(records)))
        with AlignmentWriter(bams[kind], header) as out:
            for record in ordered:
                out.write(record)
    gtf = tmp_path / "genes.gtf"
    gtf.write_text("".join(
        f'chr1\tt\tgene\t{i * 100 + 1}\t{i * 100 + 90}\t.\t+\t.\tgene_id "G{i:03d}"; gene_name "G{i:03d}";\n'
        for i in range(40)))
    devices = ["--devices", str(n)]
    before = dict(kernels.launches)
    for side, extra in (("one", []), ("mesh", devices)):
        kwargs = {} if side == "mesh" else {"device": "cpu"}
        generic = port_platform.GenericPlatform
        generic.calculate_cell_metrics(["-i", bams["cell"], "-o", str(tmp_path / f"cell_{side}")] + extra, **kwargs)
        generic.calculate_gene_metrics(["-i", bams["gene"], "-o", str(tmp_path / f"gene_{side}")] + extra, **kwargs)
        generic.bam_to_count_matrix(["-b", bams["shuffled"], "-a", str(gtf), "-o", str(tmp_path / f"count_{side}")]
                                    + extra, **kwargs)
        generic.tag_sort_bam(["-i", bams["shuffled"], "-t", "CB", "UB", "GE", "--cell-metrics-output",
                              str(tmp_path / f"fused_{side}")] + extra, **kwargs)
        parts = [str(tmp_path / "cell_one.csv.gz"), str(tmp_path / "cell_one.csv.gz")]
        generic.merge_gene_metrics([str(tmp_path / "gene_one.csv.gz")] * 3 + ["-o", str(tmp_path / f"mg_{side}")]
                                   + extra, **kwargs)
        generic.merge_cell_metrics(parts + ["-o", str(tmp_path / f"mc_{side}")] + extra, **kwargs)
    assert dict(kernels.launches) == before
    for stem in ("cell", "gene", "fused", "mg", "mc"):
        assert _gz(tmp_path / f"{stem}_mesh.csv.gz") == _gz(tmp_path / f"{stem}_one.csv.gz"), stem
    for suffix in ("_row_index.npy", "_col_index.npy"):
        assert (tmp_path / f"count_mesh{suffix}").read_bytes() == (tmp_path / f"count_one{suffix}").read_bytes()
    with np.load(tmp_path / "count_mesh.npz") as got, np.load(tmp_path / "count_one.npz") as want:
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])

    cards, cpu = port_par.make_mesh(n), port_par.make_mesh(n, device="cpu")
    assert [d.index for d in cards.devices] == list(range(n))
    frame = _synthetic_frame(np.random.default_rng(15), 8000)
    cols = port_gatherer._pad_columns(frame, np.zeros(len(frame.gene_names), bool))[0]
    stacked = port_par.partition_columns(cols, n, key="cell")
    required = port_par.required_reshard_capacity(stacked, "gene", n)
    received = {}
    for name, mesh in (("cards", cards), ("cpu", cpu)):
        out, _ = port_par.reshard_by_key(par_metrics.place(stacked, mesh), "gene", mesh, capacity=required)
        assert [shard["gene"].device for shard in out] == list(mesh.devices)
        received[name] = port_par.stack_to_host({k: [shard[k] for shard in out] for k in out[0]})
    for key, want in received["cpu"].items():
        np.testing.assert_array_equal(received["cards"][key], want)
    for i in range(2):
        got, want = (port_par.stack_to_host(port_par.distributed_metrics_step(stacked, mesh)[i])
                     for mesh in (cards, cpu))
        for key in want:
            np.testing.assert_array_equal(_bits(torch.from_numpy(got[key])), _bits(torch.from_numpy(want[key])))
    keys = {"k1": frame.cell.reshape(n, -1), "k2": frame.umi.reshape(n, -1),
            "payload": np.arange(8000, dtype=np.int32).reshape(n, -1), "valid": np.ones((n, 8000 // n), bool)}
    got, want = (port_par.stack_to_host(port_par.distributed_sort(keys, ["k1", "k2"], mesh)) for mesh in (cards, cpu))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert port_par.collective_preflight(cards) == port_par.collective_preflight(cpu)


def _scheduled_parts(tmp_path):
    """The cell library in two cell-disjoint chunks through the chunk queue
    on the card: returns the one-shot BAM, the parts' pattern, the journal
    and the worker's summary of committed parts."""
    from sctools_tpu_torch import bam as port_bam
    from sctools_tpu_torch.parallel import launch

    header, records = _cell_library(np.random.default_rng(12))
    records = list(port_bam.sort_by_tags_and_queryname(records, ["CB", "UB", "GE"]))
    cells = sorted({r.get_tag("CB") for r in records})
    bam = str(tmp_path / "cells.bam")
    (tmp_path / "chunks").mkdir()
    chunks = [str(tmp_path / "chunks" / f"chunk_{i}.bam") for i in range(2)]
    with AlignmentWriter(bam, header) as whole, AlignmentWriter(chunks[0], header) as first, \
            AlignmentWriter(chunks[1], header) as second:
        for record in records:
            whole.write(record)
            (first if record.get_tag("CB") < cells[len(cells) // 2] else second).write(record)
    committed = launch.run_process_cell_metrics(
        chunks, str(tmp_path / "proc0"), 1, 0, frozenset({"G000", "G001"}), lease_ttl=30.0
    )
    return bam, str(tmp_path / "metrics.part*.csv.gz"), str(tmp_path / "sched-journal"), committed


def test_scheduled_run_on_the_card_matches_the_one_shot_csv(cuda_device, tmp_path):
    """Two chunks through ``run_process_cell_metrics`` on cuda (its
    default), merged with the journal's checks, equal the one-shot card
    CSV byte for byte; no hand kernel launches."""
    from sctools_tpu_torch.parallel import launch

    before = dict(kernels.launches)
    bam, pattern, journal, committed = _scheduled_parts(tmp_path)
    assert sorted(committed) == [str(tmp_path / f"metrics.part{i:04d}.csv.gz") for i in range(2)]
    n = launch.merge_sorted_csv_parts(pattern, str(tmp_path / "merged.csv.gz"), journal_dir=journal,
                                      expected_parts=2)
    port_gatherer.GatherCellMetrics(bam, str(tmp_path / "one"), {"G000", "G001"}).extract_metrics()
    assert n == 300 and _gz(tmp_path / "merged.csv.gz") == _gz(tmp_path / "one.csv.gz")
    assert dict(kernels.launches) == before


def test_collective_merge_parts_on_the_card_matches_the_text_merge(cuda_device, tmp_path):
    """``collective_merge_parts`` on the card mesh (every card) and on a
    repeated card gives ``merge_sorted_csv_parts``'s bytes."""
    from sctools_tpu_torch.metrics.collective import collective_merge_parts
    from sctools_tpu_torch.parallel import launch

    _, pattern, journal, _ = _scheduled_parts(tmp_path)
    launch.merge_sorted_csv_parts(pattern, str(tmp_path / "text.csv.gz"), journal_dir=journal, expected_parts=2)
    card, _ = _card_and_cpu_meshes()
    for name, mesh in (("local", launch.local_mesh()), ("repeated", card)):
        n = collective_merge_parts(pattern, str(tmp_path / f"{name}.csv.gz"), mesh=mesh, journal_dir=journal,
                                   expected_parts=2)
        assert n == 300 and _gz(tmp_path / f"{name}.csv.gz") == _gz(tmp_path / "text.csv.gz")


def _graph_batch(rng, schema: str, n: int):
    """One batch's engine inputs as the gatherer ships them: the run-keyed
    prepacked wire of a presorted batch, or the plain columns of a batch
    the engine sorts on the device."""
    frame = _synthetic_frame(rng, n)
    is_mito = np.zeros(len(frame.gene_names), dtype=bool)
    is_mito[-20:] = True
    padded = port_seg.bucket_size(n)
    if schema == "presorted":
        starts = np.ones(n, dtype=bool)
        starts[1:] = (np.diff(frame.cell) != 0) | (np.diff(frame.gene) != 0) | (np.diff(frame.umi) != 0)
        cols, flags = port_gatherer._pad_columns(
            frame, is_mito, pad_to=padded, prepacked_keys=("cell", "gene", "umi"),
            pair_mito=True, small_ref=True, run_keys_bucket=port_seg.bucket_size(int(starts.sum())),
            run_starts=starts,
        )
        return {"wire": port_gatherer._pack_wire(cols, flags)}, dict(
            num_segments=padded, kind="cell", presorted=True, prepacked=True, **flags)
    cols, _ = port_gatherer._pad_columns(frame, is_mito, pad_to=padded)
    perm = rng.permutation(padded)
    return {name: value[perm] for name, value in cols.items()}, dict(
        num_segments=padded, kind="cell", presorted=False)


def _pulled_block(result, kwargs) -> np.ndarray:
    int_names, float_names = port_gatherer.wire_result_names(port_gatherer.CELL_COLUMNS)
    k = port_seg.entity_bucket(int(result["n_entities"]), kwargs["num_segments"])
    return port_device.compact_results_wire(result, int_names, float_names, k).cpu().numpy()


@pytest.mark.parametrize("schema", ["presorted", "device_sorted"])
def test_graph_replay_equals_eager_bytes(cuda_device, schema):
    """A graph captured on one full 2^20 batch replays a second batch of
    the same signature with no new capture, and the pulled block of each
    replay equals the eager block byte for byte, floats included."""
    from sctools_tpu_torch.serve.graphs import GraphSet

    rng = np.random.default_rng(61)
    graphs = GraphSet(cuda_device)
    first_cols, kwargs = _graph_batch(rng, schema, 1 << 20)
    for _ in range(3):
        cols, batch_kwargs = _graph_batch(rng, schema, 1 << 20)
        if batch_kwargs == kwargs:
            break
    assert batch_kwargs == kwargs, "no second batch of the same signature"
    for host in (first_cols, cols):
        staged = {name: torch.from_numpy(value).to(cuda_device) for name, value in host.items()}
        eager = _pulled_block(port_device.compute_entity_metrics(staged, **kwargs), kwargs)
        replayed = _pulled_block(graphs.run(staged, **kwargs), kwargs)
        np.testing.assert_array_equal(replayed, eager)
    assert (graphs.captures, graphs.replays, len(graphs)) == (1, 2, 1)


def test_graph_key_captured_twice_raises(cuda_device):
    from sctools_tpu_torch.serve.graphs import GraphCaptureError, GraphSet

    cols, kwargs = _graph_batch(np.random.default_rng(62), "presorted", 5000)
    staged = {name: torch.from_numpy(value).to(cuda_device) for name, value in cols.items()}
    graphs = GraphSet(cuda_device)
    graphs.run(staged, **kwargs)
    with pytest.raises(GraphCaptureError, match="captured twice"):
        graphs.capture(staged, **kwargs)
    assert graphs.captures == 1


def test_serve_worker_on_the_card_matches_eager_solo_runs(cuda_device, tmp_path):
    """A worker on cuda (its default) warms its graph set on a calibration
    BAM, then drains a two-tenant journal in one pack whose stream is not
    ascending; each artifact equals the job's eager solo CSV on the card,
    decompressed, and no hand kernel launches."""
    from sctools_tpu_torch.sched import Journal
    from sctools_tpu_torch.serve.api import ServeJob
    from sctools_tpu_torch.serve.cli import submit_jobs
    from sctools_tpu_torch.serve.engine import ServeWorker

    header, records = _cell_library(np.random.default_rng(63))
    cells = sorted({r.get_tag("CB") for r in records})
    paths = {name: str(tmp_path / f"{name}.bam") for name in ("all", "low", "high")}
    with AlignmentWriter(paths["all"], header) as whole, AlignmentWriter(paths["low"], header) as low, \
            AlignmentWriter(paths["high"], header) as high:
        for record in records:
            whole.write(record)
            (low if record.get_tag("CB") < cells[len(cells) // 2] else high).write(record)
    # tenant "ta" holds the high cells: the packed stream runs high, then low
    jobs = [ServeJob("ta", paths["high"], str(tmp_path / "out" / "ta")),
            ServeJob("tb", paths["low"], str(tmp_path / "out" / "tb"))]
    journal_dir = str(tmp_path / "journal")
    assert submit_jobs(journal_dir, jobs) == 2
    before = dict(kernels.launches)
    # a 2^14 bucket holds both jobs' file-size estimates: one pack
    with ServeWorker(journal_dir, worker_id="card", batch_records=1 << 14, lease_ttl=30.0,
                     poll_interval=0.05) as worker:
        assert worker.device.type == "cuda"
        worker.warmup(calibration_bam=paths["all"])
        assert worker.warmup_captures >= 1
        assert worker.serve_forever(drain=True, idle_timeout_s=60.0) == 2
    assert worker.packs_run == 1 and worker.packs_degraded == 0
    assert worker.graph_stats()["replays"] >= 3
    assert dict(kernels.launches) == before
    journal = Journal(journal_dir, worker_id="check")
    _, states = journal.replay()
    assert sorted(st.state for st in states.values()) == ["committed"] * 2
    assert [len(e["pack_members"]) for e in journal.events() if e.get("event") == "committed"] == [2, 2]
    for job in jobs:
        solo = str(tmp_path / f"solo_{job.tenant}")
        port_gatherer.GatherCellMetrics(job.bam, solo, batch_records=1 << 14).extract_metrics()
        assert _gz(job.out + ".csv.gz") == _gz(solo + ".csv.gz")


def test_cuda_serve_worker_without_a_gpu_raises_before_any_lease(cuda_device, tmp_path, monkeypatch):
    from sctools_tpu_torch.sched import Journal
    from sctools_tpu_torch.serve.api import ServeJob
    from sctools_tpu_torch.serve.cli import main as serve_main
    from sctools_tpu_torch.serve.cli import submit_jobs
    from sctools_tpu_torch.serve.engine import ServeWorker

    journal_dir = tmp_path / "journal"
    submit_jobs(str(journal_dir), [ServeJob("ta", str(tmp_path / "a.bam"), str(tmp_path / "a"))])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        ServeWorker(str(journal_dir))
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        serve_main(["worker", str(journal_dir), "--drain"])
    _, states = Journal(str(journal_dir), worker_id="check").replay()
    assert [st.state for st in states.values()] == ["pending"]
    assert not list((journal_dir / "leases").glob("*.lock"))


# ------------------------------------------------------------ global mesh

# One process of a global mesh on the card: argv = process_id coordinator
# workdir card. Joins the group on cuda:<card>, feeds its row of
# <workdir>/stacked.npz through host_local_to_global into
# distributed_metrics_step and writes its shard's outputs to out<p>.npz.
DIST_WORKER = """
import json, os, sys
import numpy as np
import torch
from sctools_tpu_torch import kernels
from sctools_tpu_torch import parallel as par

pid, coordinator, workdir, card = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
device = torch.device("cuda", card)
transport = par.initialize_distributed(coordinator, 2, pid, device=device, timeout=120.0)
mesh = par.global_mesh(devices=[device])
with np.load(os.path.join(workdir, "stacked.npz")) as f:
    local = {k: f[k][mesh.local_shards] for k in f.files}
cell, gene = par.distributed_metrics_step(par.host_local_to_global(local, mesh), mesh)
out = {}
for kind, result in (("cell", cell), ("gene", gene)):
    for row, columns in par.addressable_to_host(result).items():
        out.update({f"{kind}/{row}/{name}": value for name, value in columns.items()})
np.savez(os.path.join(workdir, f"out{pid}.npz"), **out)
par.sync_processes("written")
par.distributed.shutdown()
print("REPORT " + json.dumps({"transport": transport, "shards": mesh.local_shards,
                              "crossed": dict(par.collective.crossed), "launches": dict(kernels.launches)}),
      flush=True)
"""


@pytest.mark.parametrize("cards,transport", [((0, 0), "gloo"), ((0, 1), "nccl")], ids=["one-card", "two-cards"])
def test_two_processes_on_the_card_match_the_in_process_mesh(cuda_device, tmp_path, cards, transport):
    """Two processes joined into one global mesh, one shard each: on one
    card (both on cuda:0) their exchange goes over gloo, on two distinct
    cards over NCCL (a machine with one card skips that case); every
    per-shard output equals the in-process [cuda:0, cuda:0] mesh's step,
    bit for bit, and no hand kernel launches."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from sctools_tpu_torch import parallel as port_par

    if torch.cuda.device_count() <= max(cards):
        pytest.skip(f"needs {max(cards) + 1} CUDA devices, this machine has {torch.cuda.device_count()}")
    frame = _synthetic_frame(np.random.default_rng(15), 6000)
    cols = port_gatherer._pad_columns(frame, np.zeros(len(frame.gene_names), bool))[0]
    stacked = port_par.partition_columns(cols, 2, key="cell")
    np.savez(tmp_path / "stacked.npz", **stacked)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, str(p), coordinator, str(tmp_path), str(card)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for p, card in enumerate(cards)]
    try:
        outputs = [proc.communicate(timeout=240)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = []
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, out[-4000:]
        reports.append(json.loads(next(line for line in out.splitlines() if line.startswith("REPORT "))[7:]))
    assert [r["shards"] for r in reports] == [[0], [1]]
    assert all(r["transport"] == transport and r["crossed"]["all_to_all"] > 0 for r in reports)
    assert all(not any(r["launches"].values()) for r in reports)
    card = torch.device("cuda", 0)
    want = [port_par.stack_to_host(result)
            for result in port_par.distributed_metrics_step(stacked, port_par.make_mesh(devices=[card, card]))]
    for p in range(2):
        with np.load(tmp_path / f"out{p}.npz") as got:
            for kind, result in zip(("cell", "gene"), want):
                for name, value in result.items():
                    np.testing.assert_array_equal(_bits(torch.from_numpy(got[f"{kind}/{p}/{name}"])),
                                                  _bits(torch.from_numpy(np.asarray(value[p]))), err_msg=f"{kind} {name}")
