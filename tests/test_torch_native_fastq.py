"""The FASTQ half of the port's native host layer against the JAX package's.

``sctools_tpu_torch.native`` runs FastqProcess, the attach commands,
SampleFastq and FastqMetrics in C++ (the port's copies of the JAX package's
``fastqprocess.cpp``, ``attach.cpp`` and ``fastqtools.cpp``) and renders the
metrics CSV blocks (``csvformat.cpp``). Small inputs made with a numpy seed
go through the port with ``device="cpu"`` (the whitelist kernel's plain
version) and through ``sctools_tpu.native``. Tolerance: exact.

- FastqProcess: BAM and FASTQ shards, 1 and 3 shards, with and without a
  whitelist and I1, batches of 1, 7 and 65,536 reads, ``16C10M`` and
  ``8C18X6C9M1X``, over short, lowercase and N barcodes, names with a space,
  a last line without its newline and two triplet files. Shards compared
  decompressed (the layers compress with zlib and libdeflate), counters and
  stderr equal; every length-mismatch error and unreadable input raises
  JAX's exception and message and leaves no shard.
- The pooled BGZF writer: the same compressed shards with one thread and
  with eight, equal to the port's Python ``io.bgzf.BgzfWriter`` at level 6
  over the same stream; a failure in mid-run, in the input or in the
  kernel, leaves no shard.
- Attach: ``test_torch_attach.py``'s cases take the native loop
  (``native.calls``) and equal JAX's native route; two r1 files, a u2 that
  is not gzip and sample spans without i1 take the Python loop; a failure
  leaves no output.
- SampleFastq at three batch sizes; a quality shorter than its read is
  sliced; an R1/R2 count mismatch is a ``ValueError``.
- FastqMetrics: ties across shards keep file order, with one thread and
  with eight; a short read is a ``ValueError``.
- ``format_csv_block`` equals JAX's and Python's ``str()`` on the hard
  values and on random doubles of every magnitude; ``MetricCSVWriter``
  renders float32 and bool columns through it as ``str()`` of their casts.
"""

import gzip
import math
from pathlib import Path

import numpy as np
import pytest

from sctools_tpu import fastq_metrics as jax_metrics
from sctools_tpu import native as jax_native
from sctools_tpu import platform as jax_platform
from sctools_tpu import samplefastq as jax_sample
from sctools_tpu_torch import attach as port_attach
from sctools_tpu_torch import fastq_metrics as port_metrics
from sctools_tpu_torch import fastqprocess as port_fqp
from sctools_tpu_torch import native
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch import samplefastq as port_sample
from sctools_tpu_torch.fastq import ReadStructure
from sctools_tpu_torch.io import bgzf
from sctools_tpu_torch.metrics.writer import MetricCSVWriter
from sctools_tpu_torch.ops import whitelist as port_whitelist

from test_torch_attach import CASES as ATTACH_CASES
from test_torch_attach import _args as attach_args
from test_torch_attach import _records as attach_records
from test_torch_attach import inputs  # noqa: F401  (the attach cases' fixture)
from test_torch_fastqprocess import _barcode, _qual, _r2_sequence, _seq, _write

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="JAX native layer unavailable")

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    """Two triplets (gzipped; plain, each R1/R2 ending without a newline) of
    10x v2 reads and of 8C18X6C9M1X reads, whitelists of 16 and 14 bases."""
    tmp = tmp_path_factory.mktemp("native_fastq")
    rng = np.random.default_rng(808)
    files = {"tmp": tmp}
    for name, n, length in (("wl", 128, 16), ("wl14", 96, 14)):
        whitelist = [_seq(rng, length) for _ in range(n)]
        files[name + "_list"] = whitelist
        files[name] = str(tmp / f"{name}.txt")
        Path(files[name]).write_text("\n".join(whitelist) + "\n")
    for kind in ("tenx", "slide"):
        files[kind] = {"r1": [], "r2": [], "i1": []}
        for t, n in enumerate((90, 80)):
            r1, r2, i1 = [], [], []
            for i in range(n):
                name = f"@{kind}{t}r{i}" + (" 1:N:0:1" if i % 9 == 2 else "")
                if kind == "tenx":
                    barcode = _barcode(rng, files["wl_list"], i % 6)
                    read = barcode + _seq(rng, 12) if len(barcode) == 16 else barcode
                else:
                    barcode = _barcode(rng, files["wl14_list"], i % 6)
                    read = (barcode[:8] + _seq(rng, 18) + barcode[8:] + _seq(rng, 10)
                            if len(barcode) == 14 else barcode)
                r1.append((name, read, _qual(rng, len(read))))
                seq = _r2_sequence(rng)
                r2.append((name, seq, _qual(rng, len(seq) - 5 if i == 13 else len(seq))))
                i1.append((name, _seq(rng, 8), _qual(rng, 8)))
            stem = tmp / f"{kind}{t}"
            files[kind]["r1"].append(_write(Path(f"{stem}_R1.fastq"), r1, compress=t == 0,
                                            newline_at_end=t == 0))
            files[kind]["r2"].append(_write(Path(f"{stem}_R2.fastq"), r2, compress=t == 0,
                                            newline_at_end=t == 0))
            files[kind]["i1"].append(_write(Path(f"{stem}_I1.fastq"), i1))
            files[kind][f"records{t}"] = (r1, r2, i1)
    return files


def _decompressed(paths):
    return [gzip.decompress(Path(p).read_bytes()) for p in paths]


def _spans(structure):
    rs = ReadStructure(structure)
    return rs.spans("C"), rs.spans("M")


# case -> (reads, format, shards, whitelist, I1, the port's batch size, read structure)
PROCESS_CASES = {
    "bam_1_shard_w_i1_batch1": ("tenx", "BAM", 1, "wl", True, 1, "16C10M"),
    "bam_3_shards_w_i1_batch7": ("tenx", "BAM", 3, "wl", True, 7, "16C10M"),
    "bam_3_shards_batch65536": ("tenx", "BAM", 3, None, False, 1 << 16, "16C10M"),
    "fastq_1_shard_i1_batch7": ("tenx", "FASTQ", 1, None, True, 7, "16C10M"),
    "fastq_3_shards_w_batch1": ("tenx", "FASTQ", 3, "wl", False, 1, "16C10M"),
    "bam_3_shards_slideseq_w_i1_batch7": ("slide", "BAM", 3, "wl14", True, 7, "8C18X6C9M1X"),
    "fastq_3_shards_slideseq_w_batch65536": ("slide", "FASTQ", 3, "wl14", False, 1 << 16, "8C18X6C9M1X"),
}


@pytest.mark.parametrize("case", PROCESS_CASES)
def test_fastq_process_matches_jax(fq, tmp_path, capsys, case):
    kind, fmt, n_shards, whitelist, with_i1, batch_size, structure = PROCESS_CASES[case]
    cb_spans, umi_spans = _spans(structure)
    common = dict(
        cb_spans=cb_spans, umi_spans=umi_spans, sample_spans=[(0, 8)] if with_i1 else None,
        i1_files=fq[kind]["i1"] if with_i1 else None, whitelist=fq[whitelist] if whitelist else None,
        n_shards=n_shards, output_format=fmt, sample_id="S2",
    )
    stats, errors = {}, {}
    capsys.readouterr()
    stats["jax"] = jax_native.fastqprocess_native(fq[kind]["r1"], fq[kind]["r2"], str(tmp_path / "jax"),
                                                  **common)
    errors["jax"] = capsys.readouterr().err
    native.reset_calls()
    stats["port"] = port_fqp.fastq_process(fq[kind]["r1"], fq[kind]["r2"], str(tmp_path / "port"),
                                           batch_size=batch_size, device="cpu", **common)
    errors["port"] = capsys.readouterr().err
    assert native.calls == {**dict.fromkeys(native.calls, 0), "fastqprocess": 1}
    assert stats["port"] == stats["jax"] and stats["jax"]["total_reads"] == 170
    assert errors["port"] == errors["jax"]
    if whitelist:
        assert stats["jax"]["correct"] > 20 and stats["jax"]["corrected"] > 20
        assert errors["jax"].startswith("Total barcodes:170\n")
    jax_shards = _decompressed(port_fqp.shard_paths(str(tmp_path / "jax"), n_shards, fmt))
    assert _decompressed(port_fqp.shard_paths(str(tmp_path / "port"), n_shards, fmt)) == jax_shards
    assert all(jax_shards)
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("port")) == sorted(
        Path(p).name for p in port_fqp.shard_paths(str(tmp_path / "port"), n_shards, fmt))


def _triplet_with(fq, tmp_path, which, records, t=1):
    files = {key: list(fq["tenx"][key]) for key in ("r1", "r2", "i1")}
    if isinstance(records, bytes):
        path = tmp_path / f"bad_{which}.fastq.gz"
        path.write_bytes(records)
        files[which][t] = str(path)
    else:
        files[which][t] = _write(tmp_path / f"bad_{which}.fastq", records)
    return files


def _error_files(fq, tmp_path, case):
    r1, r2, i1 = fq["tenx"]["records1"]
    if case == "r1_ended_before_r2":
        return _triplet_with(fq, tmp_path, "r1", r1[:-2])
    if case == "r2_ended_before_r1":
        return _triplet_with(fq, tmp_path, "r2", r2[:-2])
    if case == "i1_ended_before_r1":
        return _triplet_with(fq, tmp_path, "i1", i1[:40])
    if case == "long_name":
        r2 = list(r2)
        r2[30] = ("@" + "x" * 255, r2[30][1], r2[30][2])
        return _triplet_with(fq, tmp_path, "r2", r2)
    if case == "missing_r2":
        files = {key: list(fq["tenx"][key]) for key in ("r1", "r2", "i1")}
        files["r2"][1] = str(tmp_path / "no_such_R2.fastq")
        return files
    if case == "corrupt_gzip_r1":  # a gzip header, then bytes that do not inflate
        return _triplet_with(fq, tmp_path, "r1", gzip.compress(b"@a\nACGT\n+\nIIII\n")[:10] + b"\xff" * 64)
    raise AssertionError(case)


FASTQ_PROCESS_ERRORS = ("r1_ended_before_r2", "r2_ended_before_r1", "i1_ended_before_r1", "long_name",
                        "missing_r2", "corrupt_gzip_r1")


@pytest.mark.parametrize("case", FASTQ_PROCESS_ERRORS)
def test_fastq_process_errors_match_jax_and_leave_no_shard(fq, tmp_path, case):
    files = _error_files(fq, tmp_path, case)
    common = dict(cb_spans=[(0, 16)], umi_spans=[(16, 26)], sample_spans=[(0, 8)], i1_files=files["i1"],
                  whitelist=fq["wl"], n_shards=3)
    raised = {}
    for route in ("jax", "port"):
        prefix = str(tmp_path / route)
        with pytest.raises(Exception) as error:
            if route == "jax":
                jax_native.fastqprocess_native(files["r1"], files["r2"], prefix, **common)
            else:
                port_fqp.fastq_process(files["r1"], files["r2"], prefix, batch_size=7, device="cpu",
                                       **common)
        raised[route] = (type(error.value), str(error.value))
        assert not list(tmp_path.glob(f"{route}_*")), f"{route} left shards"
    assert raised["port"] == raised["jax"] and raised["jax"][0] is RuntimeError


def test_progress_line_every_multiple(fq, tmp_path, capsys, monkeypatch):
    """The native loop's cadence (one line per multiple of the step, the
    multiple printed), here at a step of 50 reads."""
    monkeypatch.setattr(native, "PROGRESS_EVERY", 50)
    capsys.readouterr()
    port_fqp.fastq_process(fq["tenx"]["r1"], fq["tenx"]["r2"], str(tmp_path / "p"), [(0, 16)], [(16, 26)],
                           batch_size=7, device="cpu")
    assert capsys.readouterr().err.splitlines() == [f"[fastqprocess] {k} reads processed" for k in (50, 100, 150)]


# ------------------------------------------------------------ pooled writer


@pytest.fixture(scope="module")
def big_triplet(tmp_path_factory):
    """3,000 10x v2 triplets in one file each: ~12 BGZF blocks a run."""
    tmp = tmp_path_factory.mktemp("native_fastq_big")
    rng = np.random.default_rng(4242)
    n = 3000
    whitelist = LETTERS[rng.integers(0, 4, size=(64, 16))]
    (tmp / "wl.txt").write_bytes(b"".join(row.tobytes() + b"\n" for row in whitelist))
    cells = whitelist[rng.integers(0, 64, size=n)]
    r1 = np.concatenate([cells, LETTERS[rng.integers(0, 4, size=(n, 12))]], axis=1)
    r2 = LETTERS[rng.integers(0, 4, size=(n, 98))]
    files = {"wl": str(tmp / "wl.txt")}
    for kind, rows in (("r1", r1), ("r2", r2), ("i1", LETTERS[rng.integers(0, 4, size=(n, 8))])):
        quals = rng.integers(35, 75, size=rows.shape, dtype=np.uint8)
        text = b"".join(b"@b%d\n%s\n+\n%s\n" % (i, rows[i].tobytes(), quals[i].tobytes()) for i in range(n))
        files[kind] = str(tmp / f"{kind}.fastq.gz")
        Path(files[kind]).write_bytes(gzip.compress(text, compresslevel=1))
        files[kind + "_text"] = text
    return files


@pytest.mark.parametrize("fmt", ["BAM", "FASTQ"])
def test_pooled_writer_bytes_do_not_depend_on_threads(big_triplet, tmp_path, monkeypatch, fmt):
    shards = {}
    for threads in ("1", "8"):
        monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
        assert native.pool_threads() == int(threads)
        prefix = str(tmp_path / f"t{threads}")
        port_fqp.fastq_process([big_triplet["r1"]], [big_triplet["r2"]], prefix, [(0, 16)], [(16, 26)],
                               [(0, 8)], [big_triplet["i1"]], whitelist=big_triplet["wl"], n_shards=3,
                               output_format=fmt, batch_size=1000, device="cpu")
        shards[threads] = [Path(p).read_bytes() for p in port_fqp.shard_paths(prefix, 3, fmt)]
    assert shards["1"] == shards["8"]
    payloads = [gzip.decompress(compressed) for compressed in shards["8"]]
    assert max(map(len, payloads)) > 3 * bgzf.MAX_BLOCK_PAYLOAD
    for compressed, payload in zip(shards["8"], payloads):
        path = tmp_path / "python.bgzf"
        with bgzf.BgzfWriter(str(path), level=6) as out:
            out.write(payload)
        assert compressed == path.read_bytes()


@pytest.mark.parametrize("threads", ["1", "8"])
def test_failure_in_mid_run_leaves_no_shard(big_triplet, tmp_path, monkeypatch, threads):
    monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
    # the input: R2 ends 10 reads before R1, after most blocks were written
    r2 = tmp_path / "short_R2.fastq"
    lines = big_triplet["r2_text"].split(b"\n")
    r2.write_bytes(b"\n".join(lines[: -1 - 40]) + b"\n")
    with pytest.raises(RuntimeError, match="r2 fastq ended before r1"):
        port_fqp.fastq_process([big_triplet["r1"]], [str(r2)], str(tmp_path / "a"), [(0, 16)], [(16, 26)],
                               n_shards=3, batch_size=500, device="cpu")
    # the kernel: its third batch fails
    launches = []
    plain = port_whitelist.correct_codes

    def failing(queries, table):
        launches.append(1)
        if len(launches) == 3:
            raise RuntimeError("whitelist_correct launch failed: cudaError_t 700")
        return plain(queries, table)

    monkeypatch.setattr(port_whitelist, "correct_codes", failing)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        port_fqp.fastq_process([big_triplet["r1"]], [big_triplet["r2"]], str(tmp_path / "b"), [(0, 16)],
                               [(16, 26)], whitelist=big_triplet["wl"], n_shards=3, output_format="FASTQ",
                               batch_size=500, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["short_R2.fastq"]


# ------------------------------------------------------------------- attach


def _run_jax_attach(case, inputs, output, monkeypatch):
    name = ATTACH_CASES[case][0]
    cls = getattr(jax_platform, name)
    if name == "BarcodePlatform":  # the JAX class keeps the last call's geometry on itself
        for attr in ("cell_barcode", "molecule_barcode", "sample_barcode"):
            monkeypatch.setattr(cls, attr, None)
    assert cls.attach_barcodes(attach_args(case, inputs, output)) == 0


@pytest.mark.parametrize("case", sorted(ATTACH_CASES))
def test_attach_cases_take_the_native_loop(case, inputs, capsys, monkeypatch):  # noqa: F811
    output = str(inputs["tmp"] / f"native_fastq_{case}.bam")
    native.reset_calls()
    capsys.readouterr()
    cls = getattr(port_platform, ATTACH_CASES[case][0])
    assert cls.attach_barcodes(attach_args(case, inputs, output), device="cpu") == 0
    port_err = capsys.readouterr().err
    assert native.calls == {**dict.fromkeys(native.calls, 0), "attach": 1}
    jax_output = str(inputs["tmp"] / f"native_fastq_{case}_jax.bam")
    _run_jax_attach(case, inputs, jax_output, monkeypatch)
    assert capsys.readouterr().err == port_err
    assert attach_records(output) == attach_records(jax_output)


def test_attach_python_loop_routes(inputs, tmp_path, monkeypatch):  # noqa: F811
    """Two r1 files, a u2 that is not gzip, and sample spans read from r1
    take the Python loop, which writes what the native loop writes."""
    lines = gzip.decompress(Path(inputs["r1"]).read_bytes()).split(b"\n")
    first, second = tmp_path / "a.fastq", tmp_path / "b.fastq"
    first.write_bytes(b"\n".join(lines[:200]) + b"\n")
    second.write_bytes(b"\n".join(lines[200:]))
    both = tmp_path / "both.fastq"
    both.write_bytes(first.read_bytes() + second.read_bytes())
    spans = dict(cb_spans=[(0, 16)], umi_spans=[(16, 26)], whitelist=inputs["wl"], device="cpu")
    native.reset_calls()
    port_attach.attach_barcodes([str(first), str(second)], inputs["u2"], str(tmp_path / "py.bam"), **spans)
    assert native.calls["attach"] == 0
    port_attach.attach_barcodes(str(both), inputs["u2"], str(tmp_path / "native.bam"), **spans)
    assert native.calls["attach"] == 1
    assert (tmp_path / "py.bam").read_bytes() == (tmp_path / "native.bam").read_bytes()

    plain = tmp_path / "u2.bam"  # the payload of u2, not gzip
    plain.write_bytes(gzip.decompress(Path(inputs["u2"]).read_bytes()))
    with pytest.raises(ValueError, match="is not a BAM file"):
        port_attach.attach_barcodes(inputs["r1"], str(plain), str(tmp_path / "x.bam"), **spans)
    port_attach.attach_barcodes(inputs["r1"], inputs["u2"], str(tmp_path / "s.bam"), [(0, 16)], [(16, 26)],
                                [(26, 28)], device="cpu")
    assert native.calls["attach"] == 1
    sr = [dict(record[4]).get("SR") for record in attach_records(str(tmp_path / "s.bam"))]
    assert all(value is not None and len(value[1]) == 2 for value in sr)


def test_attach_failure_leaves_no_output(inputs, tmp_path, monkeypatch):  # noqa: F811
    payload = gzip.decompress(Path(inputs["u2"]).read_bytes())
    truncated = tmp_path / "truncated.bam"
    with bgzf.BgzfWriter(str(truncated)) as out:
        out.write(payload[:-30])
    output = tmp_path / "out.bam"
    raised = []
    for route in ("jax", "port"):
        with pytest.raises(RuntimeError) as error:
            if route == "jax":
                jax_native.attach_barcodes_native(inputs["r1"], str(truncated), str(output), [(0, 16)],
                                                  [(16, 26)], whitelist=inputs["wl"])
            else:
                port_attach.attach_barcodes(inputs["r1"], str(truncated), str(output), [(0, 16)], [(16, 26)],
                                            whitelist=inputs["wl"], device="cpu")
        raised.append(str(error.value))
        assert not output.exists()
    assert raised[0] == raised[1] == "attach write failed: truncated u2 record"

    def broken(queries, table):
        raise RuntimeError("whitelist_correct launch failed: cudaError_t 700")

    monkeypatch.setattr(port_whitelist, "correct_codes", broken)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        port_attach.attach_barcodes(inputs["r1"], inputs["u2"], str(output), [(0, 16)], [(16, 26)],
                                    whitelist=inputs["wl"], device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["truncated.bam"]


def test_attach_progress_line(inputs, tmp_path, capsys, monkeypatch):  # noqa: F811
    monkeypatch.setattr(native, "PROGRESS_EVERY", 50)
    capsys.readouterr()
    port_attach.attach_barcodes(inputs["r1"], inputs["u2"], str(tmp_path / "p.bam"), [(0, 16)], [(16, 26)],
                                device="cpu", batch_size=7)
    # the JAX route's cadence: the running total, once it reaches each step
    assert capsys.readouterr().err.splitlines() == [f"[attach] {k} reads processed" for k in (56, 105, 154, 200)]


# -------------------------------------------------------------- SampleFastq


@pytest.mark.parametrize("batch_size", [1, 7, 1 << 16])
def test_sample_fastq_matches_jax(fq, tmp_path, batch_size):
    files = fq["slide"]
    native.reset_calls()
    port = port_sample.sample_fastq(files["r1"], files["r2"], fq["wl14"], "8C18X6C9M1X",
                                    str(tmp_path / "port"), batch_size=batch_size, device="cpu")
    assert native.calls == {**dict.fromkeys(native.calls, 0), "sample_fastq": 1}
    jax = jax_sample.sample_fastq(files["r1"], files["r2"], fq["wl14"], "8C18X6C9M1X", str(tmp_path / "jax"))
    assert port == jax and jax[1] == 170 and 20 < jax[0] < 170
    for suffix in (".R1", ".R2"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()


def test_sample_fastq_slices_a_short_quality(fq, tmp_path):
    """A kept read whose quality ends inside its barcode: the barcode's
    quality is cut at the same head and sliced, never read past its end."""
    whitelist = fq["wl14_list"]
    reads = []
    for i, qual_length in enumerate((42, 5, 30, 0)):
        barcode = whitelist[i]
        sequence = barcode[:8] + "A" * 18 + barcode[8:] + "CCCCCCCCCG"
        reads.append((f"@q{i}", sequence, "".join(chr(40 + k % 30) for k in range(qual_length))))
    r1 = _write(tmp_path / "r1.fastq", reads)
    r2 = _write(tmp_path / "r2.fastq", [(f"@q{i}", "ACGT", "IIII") for i in range(4)])
    assert port_sample.sample_fastq([r1], [r2], fq["wl14"], "8C18X6C9M1X", str(tmp_path / "out"),
                                    device="cpu") == (4, 4)
    want = b""
    for name, sequence, quality in reads:
        seq, qual = sequence.encode(), quality.encode()
        barcode, barcode_qual = seq[:8] + seq[26:32], qual[:8] + qual[26:32]
        umi, umi_qual = seq[32:41], qual[32:41]
        want += b"%s\n%s%s%s%sT\n+\n%s%s%s%sF\n" % (
            name.encode(), barcode[:8], b"CTTCAGCGTTCCCGAGAG", barcode[8:], umi,
            barcode_qual[:8], b"F" * 18, barcode_qual[8:], umi_qual)
    assert (tmp_path / "out.R1").read_bytes() == want
    assert b"\n" + b"F" * 18 + b"F\n" in want  # the empty quality: linker and T only


@pytest.mark.parametrize("longer", ["r1", "r2"])
def test_sample_fastq_count_mismatch_is_a_value_error(fq, tmp_path, longer):
    r1, r2, _ = fq["slide"]["records1"]
    r1, r2 = (r1, r2[:-1]) if longer == "r1" else (r1[:-1], r2)
    files = [_write(tmp_path / "r1.fastq", r1)], [_write(tmp_path / "r2.fastq", r2)]
    messages = []
    for route, module, kwargs in (("jax", jax_sample, {}), ("port", port_sample, {"device": "cpu"})):
        with pytest.raises(ValueError) as error:
            module.sample_fastq(*files, fq["wl14"], "8C18X6C9M1X", str(tmp_path / route), **kwargs)
        messages.append(str(error.value))
    assert messages[0] == messages[1] == "R1 and R2 hold different read counts"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["r1.fastq", "r2.fastq"]


# ------------------------------------------------------------- FastqMetrics


METRICS_SUFFIXES = (".numReads_perCell_XM.txt", ".numReads_perCell_XC.txt",
                    ".barcode_distribution_XC.txt", ".barcode_distribution_XM.txt")


def test_fastq_metrics_ties_across_shards_in_file_order(tmp_path, monkeypatch):
    """Barcodes first seen in later shards tie with earlier ones: the table
    keeps the order of first appearance over the files in order, whatever
    shard a thread finishes first."""
    rng = np.random.default_rng(5)
    codes = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(8)]
    # codes 2s and 2s+1 first seen in shard s, five times each; one more of
    # code 2s+3 (mod 8): counts of 6 and of 5, each tied across shards
    shards = [[codes[2 * s], codes[2 * s + 1]] * 5 + [codes[(2 * s + 3) % 8]] for s in range(4)]
    files = []
    for s, cells in enumerate(shards):
        reads = [(f"@m{s}_{i}", cell + _seq(rng, 10) + ("n" if i % 5 == 0 else "R"), "I" * 27)
                 for i, cell in enumerate(cells)]
        files.append(_write(tmp_path / f"m{s}.fastq", reads, compress=s == 2))
    jax_metrics.compute_fastq_metrics(files, "16C10M", str(tmp_path / "jax"))
    want = [(tmp_path / f"jax{suffix}").read_bytes() for suffix in METRICS_SUFFIXES]
    order = list(dict.fromkeys(cell for cells in shards for cell in cells))
    counts = {cell: sum(cells.count(cell) for cells in shards) for cell in order}
    assert want[1] == b"".join(b"%d\t%s\n" % (counts[c], c.encode())
                               for c in sorted(order, key=lambda c: -counts[c]))
    for threads in ("1", "8"):
        monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
        native.reset_calls()
        assert port_metrics.compute_fastq_metrics(files, "16C10M", str(tmp_path / threads)) == 44
        assert native.calls == {**dict.fromkeys(native.calls, 0), "fastq_metrics": 1}
        assert [(tmp_path / f"{threads}{suffix}").read_bytes() for suffix in METRICS_SUFFIXES] == want


def test_fastq_metrics_short_read_is_a_value_error(tmp_path):
    good = _write(tmp_path / "good.fastq", [("@a", "A" * 28, "I" * 28)] * 3)
    short = _write(tmp_path / "short.fastq", [("@b", "C" * 28, "I" * 28), ("@c", "G" * 21, "I" * 21)])
    messages = []
    for module in (jax_metrics, port_metrics):
        with pytest.raises(ValueError) as error:
            module.compute_fastq_metrics([good, short], "16C10M", str(tmp_path / "out"))
        messages.append(str(error.value))
    assert messages[0] == messages[1] == f"{short}: read of length 21 is shorter than read structure (needs 26)"


# --------------------------------------------------------- format_csv_block

HARD_FLOATS = [
    math.nan, math.inf, -math.inf, -0.0, 0.0, 1e-05, 1e-4, 0.0001234, 1e16, 1e15, 9999999999999998.0,
    0.1 + 0.2, 1.0, 3.0, -2.0, 100.0, 123456789.0, 1e22, 1.5e-07, 5e-324, 2.2250738585072014e-308,
    1.7976931348623157e308, 123456789.125, 0.5, 1 / 3, 2 / 3, 12345.678, -0.000123, 1e100,
]
INT_EXTREMES = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1, 10**15, -(10**18)]


def _python_rows(index, columns):
    return "".join(f"{name}," + ",".join(str(col[i]) for col in columns) + "\n"
                   for i, name in enumerate(index)).encode()


def test_format_csv_block_renders_str():
    n = len(HARD_FLOATS)
    floats = np.array(HARD_FLOATS, dtype=np.float64)
    ints = np.resize(np.array(INT_EXTREMES, dtype=np.int64), n)
    index = [f"cell{i}" for i in range(n)]
    columns = [floats, ints, floats[::-1].copy(), np.arange(n, dtype=np.int64)]
    native.reset_calls()
    block = native.format_csv_block(index, columns)
    assert native.calls["format_csv_block"] == 1
    assert block == jax_native.format_csv_block(index, columns)
    assert block == _python_rows(index, [[float(v) for v in floats], [int(v) for v in ints],
                                         [float(v) for v in floats[::-1]], list(range(n))])
    assert b"nan,-9223372036854775808,1e+100" in block and b",1e-05," in block and b",1e+16," in block
    assert native.format_csv_block([], []) == b""


def test_format_csv_block_random_doubles():
    rng = np.random.default_rng(77)
    bits = rng.integers(0, 2**63, size=20_000, dtype=np.int64) * rng.choice([1, -1], size=20_000)
    values = bits.view(np.float64)
    values = values[np.isfinite(values)]
    values = np.concatenate([values, rng.random(2000) * 10.0 ** rng.integers(-8, 20, 2000),
                             np.round(rng.random(1000) * 1e6)])
    index = [str(i) for i in range(len(values))]
    block = native.format_csv_block(index, [values])
    assert block == "".join(f"{i},{v!r}\n" for i, v in zip(index, values.tolist())).encode()
    assert block == jax_native.format_csv_block(index, [values])


def test_writer_renders_canonical_casts_through_the_formatter(tmp_path):
    f32 = np.array([0.1, 1.0, 3.5, np.nan, 1e-6], dtype=np.float32)
    flags = np.array([True, False, True, True, False])
    i32 = np.array([1, -2, 3, 2**31 - 1, 0], dtype=np.int32)
    index = ["a", "b", "c", "d", "e"]
    writer = MetricCSVWriter(str(tmp_path / "m"))
    writer.write_header({"f32": 0, "flag": 0, "i32": 0, "_private": 0})
    native.reset_calls()
    writer.write_block(index, [f32, flags, i32])
    writer.close()
    assert native.calls["format_csv_block"] == 1
    text = gzip.decompress((tmp_path / "m.csv.gz").read_bytes()).decode()
    want = ",f32,flag,i32\n" + "".join(
        f"{name},{float(a)},{int(b)},{int(c)}\n" for name, a, b, c in zip(index, f32, flags, i32))
    assert text == want and "0.10000000149011612" in text
    with pytest.raises(ValueError, match="needs CSV quoting"):
        MetricCSVWriter(str(tmp_path / "q")).write_block(["x,y"], [np.zeros(1)])
