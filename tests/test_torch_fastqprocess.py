"""The port's FASTQ front (FastqProcess, SampleFastq, FastqMetrics,
CheckBarcodePartition) against the JAX package's native route.

Small inputs made with a numpy seed (whitelists of 64 to 256 barcodes,
three triplets of 120 to 150 reads) go through ``sctools_tpu_torch`` with
``device="cpu"`` and through ``sctools_tpu`` (its native layer with the
JAX whitelist corrector). Tolerance: exact.

- FastqProcess: the shards equal JAX's byte for byte once decompressed (the
  BGZF writers differ: libdeflate against zlib), in BAM and FASTQ modes, for
  1 and 3 shards, with the port's batches of 16 and 64 reads; the counters
  and the stderr summary equal JAX's. The inputs hold exact, one-error, N,
  short and lowercase barcodes, IUPAC and lowercase R2 bases, a quality
  shorter than its sequence, names with a space and with a tab, a gzipped
  triplet, a last line without its newline and a longer I1.
- The CLIs, the read-structure cases (a split barcode; S segments without
  ``--i1``; no C span) and no whitelist; each truncation error with its
  message and no shard left behind; a 255-byte name; a whitelist of the
  wrong length.
- SampleFastq's ``.R1``/``.R2`` as files, over R1 and R2 streams split
  over different files; FastqMetrics' four files; CheckBarcodePartition's
  exit codes and stderr.
"""

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest

from sctools_tpu import fastq_metrics as jax_metrics
from sctools_tpu import native as jax_native
from sctools_tpu import platform as jax_platform
from sctools_tpu import samplefastq as jax_sample
from sctools_tpu_torch import fastq_metrics as port_metrics
from sctools_tpu_torch import fastqprocess as port_fqp
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch import samplefastq as port_sample
from sctools_tpu_torch.fastq import BatchReader
from sctools_tpu_torch.ops import whitelist as port_whitelist

pytestmark = pytest.mark.skipif(not jax_native.available(), reason="JAX native layer unavailable")

BASES = np.array(list("ACGT"))
IUPAC = list("RYKMSWBDHVN")
CB, UMI = [(0, 16)], [(16, 26)]


def _seq(rng, length):
    return "".join(rng.choice(BASES, size=length))


def _qual(rng, length):
    return "".join(chr(33 + int(q)) for q in rng.integers(0, 41, size=length))


def _write(path: Path, records, compress=False, newline_at_end=True) -> str:
    """FASTQ of (name line, sequence, quality) records."""
    text = "".join(f"{name}\n{seq}\n+\n{qual}\n" for name, seq, qual in records)
    if not newline_at_end:
        text = text[:-1]
    data = text.encode()
    if compress:
        path = path.with_suffix(path.suffix + ".gz")
        data = gzip.compress(data)
    path.write_bytes(data)
    return str(path)


def _barcode(rng, whitelist, kind):
    """A cell barcode of one kind: exact, one substitution, one N, a short
    one, lowercase, or random."""
    barcode = whitelist[int(rng.integers(len(whitelist)))]
    p = int(rng.integers(len(barcode)))
    if kind == 1:
        barcode = barcode[:p] + rng.choice([c for c in "ACGT" if c != barcode[p]]) + barcode[p + 1:]
    elif kind == 2:
        barcode = barcode[:p] + "N" + barcode[p + 1:]
    elif kind == 3:
        barcode = barcode[: int(rng.integers(3, len(barcode)))]
    elif kind == 4:
        barcode = barcode.lower()
    elif kind == 5:
        barcode = _seq(rng, len(barcode))
    return barcode


def _r2_sequence(rng):
    seq = list(_seq(rng, int(rng.integers(30, 61))))
    for _ in range(int(rng.integers(0, 3))):  # IUPAC codes and lowercase bases
        p = int(rng.integers(len(seq)))
        seq[p] = rng.choice(IUPAC) if rng.random() < 0.5 else seq[p].lower()
    return "".join(seq)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fastqprocess")
    rng = np.random.default_rng(55)
    files = {"tmp": tmp}
    for name, n, length in (("wl", 256, 16), ("wl8", 64, 8), ("wl12", 64, 12), ("wl14", 128, 14)):
        whitelist = [_seq(rng, length) for _ in range(n)]
        files[name + "_list"] = whitelist
        files[name] = str(tmp / f"{name}.txt")
        Path(files[name]).write_text("\n".join(whitelist) + "\n")
    files["r1"], files["r2"], files["i1"] = [], [], []
    for t, n in enumerate((150, 120, 130)):
        r1, r2, i1 = [], [], []
        for i in range(n):
            name = f"@t{t}r{i}"
            if i == 5:
                name += " comment after a space"
            elif i == 7:
                name += "\twith_a_tab"
            barcode = _barcode(rng, files["wl_list"], i % 6)
            read = barcode + _seq(rng, 12) if len(barcode) == 16 else barcode
            r1.append((name, read, _qual(rng, len(read))))
            seq = _r2_sequence(rng)
            qual = _qual(rng, len(seq) - 7 if i == 11 else len(seq))  # a short quality
            r2.append((name, seq, qual))
            i1.append((name, _seq(rng, 8), _qual(rng, 8)))
        if t == 1:  # a longer I1 is ignored
            i1.append(("@extra", _seq(rng, 8), _qual(rng, 8)))
        stem = tmp / f"t{t}"
        files["r1"].append(_write(Path(f"{stem}_R1.fastq"), r1, compress=t == 0, newline_at_end=t != 2))
        files["r2"].append(_write(Path(f"{stem}_R2.fastq"), r2, compress=t == 0))
        files["i1"].append(_write(Path(f"{stem}_I1.fastq"), i1))
        files[f"records{t}"] = (r1, r2, i1)
    return files


def _decompressed(paths):
    return [gzip.decompress(Path(p).read_bytes()) for p in paths]


# case -> (output format, shards, the port's batch size, whitelist, I1)
PROCESS_CASES = {
    "bam_1_shard_batch16": ("BAM", 1, 16, "wl", True),
    "bam_3_shards_batch64": ("BAM", 3, 64, "wl", True),
    "fastq_1_shard_batch64": ("FASTQ", 1, 64, "wl", True),
    "fastq_3_shards_batch16": ("FASTQ", 3, 16, "wl", False),
    "bam_3_shards_no_whitelist": ("BAM", 3, 64, None, True),
}


@pytest.mark.parametrize("case", PROCESS_CASES)
def test_fastq_process_matches_jax(inputs, tmp_path, capsys, case):
    output_format, n_shards, batch_size, whitelist, with_i1 = PROCESS_CASES[case]
    common = dict(
        cb_spans=CB, umi_spans=UMI, sample_spans=[(0, 8)] if with_i1 else None,
        i1_files=inputs["i1"] if with_i1 else None,
        whitelist=inputs[whitelist] if whitelist else None, n_shards=n_shards,
        output_format=output_format, sample_id="S1",
    )
    stats, errors = {}, {}
    for route in ("jax", "port"):
        prefix = str(tmp_path / route)
        capsys.readouterr()
        if route == "jax":
            stats[route] = jax_native.fastqprocess_native(inputs["r1"], inputs["r2"], prefix, **common)
        else:
            stats[route] = port_fqp.fastq_process(
                inputs["r1"], inputs["r2"], prefix, batch_size=batch_size, device="cpu", **common)
        errors[route] = capsys.readouterr().err
    assert stats["port"] == stats["jax"] and stats["jax"]["total_reads"] == 400
    assert errors["port"] == errors["jax"]
    if whitelist:
        assert stats["jax"]["correct"] > 50 and stats["jax"]["corrected"] > 100
        assert "Total barcodes:400" in errors["jax"]
    jax_shards = _decompressed(port_fqp.shard_paths(str(tmp_path / "jax"), n_shards, output_format))
    port_shards = _decompressed(port_fqp.shard_paths(str(tmp_path / "port"), n_shards, output_format))
    assert port_shards == jax_shards
    if n_shards > 1:
        assert all(len(shard) > 1000 for shard in port_shards)


def _cli_args(inputs, extra, bam_size="0.00001"):
    return ["--r1", *inputs["r1"], "--r2", *inputs["r2"], "--bam-size", bam_size, *extra]


# case -> (extra arguments, output format)
CLI_CASES = {
    "whitelist_i1": (["-w", "{wl}", "--i1", "{i1}", "--sample-id", "S7"], "BAM"),
    "split_barcode_4C2X4C6M": (["-w", "{wl8}", "--read-structure", "4C2X4C6M", "--i1", "{i1}"], "BAM"),
    "s_segments_without_i1": (["-w", "{wl}", "--read-structure", "16C10M2S"], "BAM"),
    "no_whitelist": ([], "BAM"),
    "no_c_span": (["--read-structure", "16X10M"], "BAM"),
    "fastq_format": (["-w", "{wl}", "--output-format", "FASTQ"], "FASTQ"),
}


def _fill(args, inputs):
    out = []
    for arg in args:
        if arg == "{i1}":
            out += inputs["i1"]
        else:
            out.append(arg.format(**{k: v for k, v in inputs.items() if isinstance(v, str)}))
    return out


@pytest.mark.parametrize("case", CLI_CASES)
def test_fastq_process_cli_matches_jax(inputs, tmp_path, capsys, case):
    extra, output_format = CLI_CASES[case]
    errors = {}
    for route, platform in (("jax", jax_platform), ("port", port_platform)):
        args = _cli_args(inputs, _fill(extra, inputs)) + ["-o", str(tmp_path / route)]
        capsys.readouterr()
        if route == "jax":
            assert platform.TenXV2.fastq_process(args) == 0
        else:
            assert platform.TenXV2.fastq_process(args, device="cpu") == 0
        errors[route] = capsys.readouterr().err
    assert errors["port"] == errors["jax"] and "reads" in errors["jax"]
    n_shards = int(errors["jax"].strip().splitlines()[-1].split()[1])
    assert n_shards > 1
    jax_shards = _decompressed(port_fqp.shard_paths(str(tmp_path / "jax"), n_shards, output_format))
    assert _decompressed(port_fqp.shard_paths(str(tmp_path / "port"), n_shards, output_format)) == jax_shards
    if case == "s_segments_without_i1":
        assert b"SRZ" not in b"".join(jax_shards)
    if case == "no_c_span":
        assert b"CRZ" not in b"".join(jax_shards)


def _triplet_copy(inputs, tmp_path, t, which, records):
    """The inputs' file lists with file ``which`` of triplet ``t`` replaced."""
    path = _write(tmp_path / f"bad_{which}.fastq", records)
    files = {key: list(inputs[key]) for key in ("r1", "r2", "i1")}
    files[which][t] = path
    return files


def _error_inputs(inputs, tmp_path, case):
    r1, r2, i1 = inputs["records1"]
    if case == "r1_ended_before_r2":
        return _triplet_copy(inputs, tmp_path, 1, "r1", r1[:-3])
    if case == "r2_ended_before_r1":
        return _triplet_copy(inputs, tmp_path, 1, "r2", r2[:-3])
    if case == "i1_ended_before_r1":
        return _triplet_copy(inputs, tmp_path, 1, "i1", i1[:50])
    if case == "long_name":  # 255 bytes: one more than l_read_name can carry
        r2 = list(r2)
        r2[60] = ("@" + "n" * 255, r2[60][1], r2[60][2])
        return _triplet_copy(inputs, tmp_path, 1, "r2", r2)
    return {key: list(inputs[key]) for key in ("r1", "r2", "i1")}


ERROR_CASES = {
    "r1_ended_before_r2": "fastqprocess read failed: r1 fastq ended before r2",
    "r2_ended_before_r1": "fastqprocess read failed: r2 fastq ended before r1",
    "i1_ended_before_r1": "fastqprocess read failed: i1 fastq ended before r1",
    "long_name": "fastqprocess read failed: read name longer than 254 characters: " + "n" * 255,
    "whitelist_length": "whitelist barcode length 12 does not match the cell barcode span length 16",
}


@pytest.mark.parametrize("case", ERROR_CASES)
def test_fastq_process_errors_match_jax_and_leave_no_shard(inputs, tmp_path, case):
    files = _error_inputs(inputs, tmp_path, case)
    whitelist = inputs["wl12" if case == "whitelist_length" else "wl"]
    common = dict(cb_spans=CB, umi_spans=UMI, sample_spans=[(0, 8)], i1_files=files["i1"],
                  whitelist=whitelist, n_shards=3)
    messages = {}
    for route in ("jax", "port"):
        prefix = str(tmp_path / route)
        with pytest.raises(RuntimeError) as raised:
            if route == "jax":
                jax_native.fastqprocess_native(files["r1"], files["r2"], prefix, **common)
            else:
                port_fqp.fastq_process(files["r1"], files["r2"], prefix, batch_size=16,
                                       device="cpu", **common)
        messages[route] = str(raised.value)
        assert not list(tmp_path.glob(f"{route}_*")), f"{route} left shards"
    assert messages["port"] == messages["jax"] == ERROR_CASES[case]


def test_launch_failure_fails_the_command_and_leaves_no_shard(inputs, tmp_path, monkeypatch):
    def broken(queries, table):
        raise RuntimeError("whitelist_correct launch failed: cudaError_t 700")

    monkeypatch.setattr(port_whitelist, "correct_codes", broken)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        port_fqp.fastq_process(inputs["r1"], inputs["r2"], str(tmp_path / "port"), CB, UMI,
                               whitelist=inputs["wl"], n_shards=3, batch_size=64, device="cpu")
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        port_sample.sample_fastq(inputs["r1"], inputs["r2"], inputs["wl"], "16C10M",
                                 str(tmp_path / "sampled"), device="cpu")
    assert not list(tmp_path.iterdir())


def test_default_device_needs_a_gpu(inputs, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_fqp.fastq_process(inputs["r1"], inputs["r2"], str(tmp_path / "port"), CB, UMI)
    with pytest.raises(RuntimeError, match="is_available"):
        port_platform.TenXV2.fastq_process(_cli_args(inputs, ["-o", str(tmp_path / "cli")]))
    assert not list(tmp_path.iterdir())


def test_batch_reader_names_and_ends(tmp_path):
    """Names without '@', cut at the first space only; a last line without
    its newline counts; each file's partial record is dropped."""
    first = tmp_path / "a.fastq"
    first.write_bytes(b"@r1 x y\nACGT\n+\nIIII\nr2\tz\nAC\n+\nII\n@partial\nAC\n")
    second = tmp_path / "b.fastq.gz"
    second.write_bytes(gzip.compress(b"@r3\nGG\n+\n!!\n@r4 q\nT\n+\nF"))
    reader = BatchReader([str(first), str(second)])
    assert reader.take(3) == ([b"r1", b"r2\tz", b"r3"], [b"ACGT", b"AC", b"GG"], [b"IIII", b"II", b"!!"])
    assert reader.take(3) == ([b"r4"], [b"T"], [b"F"])
    assert reader.take(3) == ([], [], [])


# ---------------------------------------------------------------- SampleFastq


@pytest.fixture(scope="module")
def slideseq(inputs):
    """8C18X6C9M1X reads: R1 in two files, R2 in three, split elsewhere."""
    tmp = inputs["tmp"]
    rng = np.random.default_rng(77)
    r1, r2 = [], []
    for i in range(230):
        barcode = _barcode(rng, inputs["wl14_list"], i % 6)
        read = barcode[:8] + _seq(rng, 18) + barcode[8:] + _seq(rng, 10) if len(barcode) == 14 else barcode
        name = f"@s{i}" + (" comment" if i == 3 else "")
        r1.append((name, read, _qual(rng, len(read))))
        seq = _r2_sequence(rng)
        r2.append((f"@s{i}\tq", seq, _qual(rng, len(seq))))
    r1_files = [_write(tmp / "s_r1a.fastq", r1[:100], compress=True), _write(tmp / "s_r1b.fastq", r1[100:])]
    r2_files = [_write(tmp / f"s_r2{k}.fastq", r2[lo:hi])
                for k, (lo, hi) in enumerate(((0, 40), (40, 170), (170, 230)))]
    short_r2 = [_write(tmp / "s_r2_short.fastq", r2[:-1])]
    return dict(r1=r1_files, r2=r2_files, short_r2=short_r2)


@pytest.mark.parametrize("batch_size", [16, 64])
def test_sample_fastq_matches_jax(inputs, slideseq, tmp_path, batch_size):
    results = {
        "jax": jax_sample.sample_fastq(slideseq["r1"], slideseq["r2"], inputs["wl14"],
                                       "8C18X6C9M1X", str(tmp_path / "jax")),
        "port": port_sample.sample_fastq(slideseq["r1"], slideseq["r2"], inputs["wl14"],
                                         "8C18X6C9M1X", str(tmp_path / "port"),
                                         batch_size=batch_size, device="cpu"),
    }
    assert results["port"] == results["jax"]
    kept, total = results["jax"]
    assert total == 230 and 100 < kept < total
    for suffix in (".R1", ".R2"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()


def test_sample_fastq_cli_matches_jax(inputs, slideseq, tmp_path, capsys):
    out = {}
    for route, platform in (("jax", jax_platform), ("port", port_platform)):
        args = ["--R1", *slideseq["r1"], "--R2", *slideseq["r2"], "--white-list", inputs["wl14"],
                "--read-structure", "8C18X6C9M1X", "--output-prefix", str(tmp_path / route)]
        capsys.readouterr()
        rc = platform.GenericPlatform.sample_fastq(args, **({"device": "cpu"} if route == "port" else {}))
        out[route] = (rc, capsys.readouterr().out)
    assert out["port"] == out["jax"] and out["jax"][1].startswith("kept ")


@pytest.mark.parametrize("case", ["count_mismatch", "whitelist_length"])
def test_sample_fastq_errors_match_jax(inputs, slideseq, tmp_path, case):
    r2 = slideseq["short_r2"] if case == "count_mismatch" else slideseq["r2"]
    whitelist = inputs["wl" if case == "whitelist_length" else "wl14"]
    error = ValueError if case == "count_mismatch" else RuntimeError
    messages = []
    for route, module, kwargs in (("jax", jax_sample, {}), ("port", port_sample, {"device": "cpu"})):
        with pytest.raises(error) as raised:
            module.sample_fastq(slideseq["r1"], r2, whitelist, "8C18X6C9M1X", str(tmp_path / route), **kwargs)
        messages.append(str(raised.value))
    assert messages[0] == messages[1]
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------- FastqMetrics


@pytest.fixture(scope="module")
def metrics_r1(inputs):
    """Full-length 16C10M reads in three files, with many ties in the counts,
    lowercase, N and other bytes."""
    tmp = inputs["tmp"]
    rng = np.random.default_rng(99)
    barcodes = [_seq(rng, 16) for _ in range(12)]
    umis = [_seq(rng, 10) for _ in range(9)]
    files = []
    for f in range(3):
        records = []
        for i in range(70):
            barcode = barcodes[int(rng.integers(len(barcodes)))]
            if i % 7 == 3:
                barcode = barcode[:5] + "n" + barcode[6:].lower()
            if i % 11 == 4:
                barcode = "NNNN" + barcode[4:10] + "R." + barcode[12:]
            read = barcode + umis[int(rng.integers(len(umis)))] + _seq(rng, 2)
            records.append((f"@m{f}_{i}", read, _qual(rng, len(read))))
        files.append(_write(tmp / f"metrics_{f}.fastq", records, compress=f == 1))
    short = _write(tmp / "metrics_short.fastq", [("@a", _seq(rng, 28), "I" * 28), ("@b", _seq(rng, 20), "I" * 20)])
    return dict(files=files, short=short)


METRICS_SUFFIXES = (".numReads_perCell_XM.txt", ".numReads_perCell_XC.txt",
                    ".barcode_distribution_XC.txt", ".barcode_distribution_XM.txt")


def test_fastq_metrics_matches_jax(metrics_r1, tmp_path, capsys):
    jax_metrics.compute_fastq_metrics(metrics_r1["files"], "16C10M", str(tmp_path / "jax"))
    assert port_metrics.compute_fastq_metrics(metrics_r1["files"], "16C10M", str(tmp_path / "port")) == 210
    assert port_platform.GenericPlatform.fastq_metrics(
        ["--R1", *metrics_r1["files"], "--read-structure", "16C10M", "--sample-id", str(tmp_path / "cli")],
        device="cpu") == 0
    for suffix in METRICS_SUFFIXES:
        want = (tmp_path / f"jax{suffix}").read_bytes()
        assert (tmp_path / f"port{suffix}").read_bytes() == want
        assert (tmp_path / f"cli{suffix}").read_bytes() == want
    counts = (tmp_path / "jax.numReads_perCell_XC.txt").read_text().splitlines()
    values = [int(line.split("\t")[0]) for line in counts]
    assert values == sorted(values, reverse=True) and len(set(values)) < len(values)  # ties


def test_fastq_metrics_short_read_is_a_value_error(metrics_r1, tmp_path):
    messages = []
    for module in (jax_metrics, port_metrics):
        with pytest.raises(ValueError) as raised:
            module.compute_fastq_metrics([metrics_r1["files"][0], metrics_r1["short"]], "16C10M",
                                         str(tmp_path / "out"))
        messages.append(str(raised.value))
    assert messages[0] == messages[1] and "read of length 20" in messages[0]


# ------------------------------------------------------ CheckBarcodePartition


def test_check_barcode_partition_matches_jax(inputs, tmp_path, capsys):
    prefix = str(tmp_path / "port")
    port_fqp.fastq_process(inputs["r1"], inputs["r2"], prefix, CB, UMI, whitelist=inputs["wl"],
                           n_shards=3, device="cpu")
    shards = port_fqp.shard_paths(prefix, 3, "BAM")
    copy = str(tmp_path / "copy_of_0.bam")
    shutil.copy(shards[0], copy)
    for bams, want in ((shards, 0), ([shards[0], copy], 1)):
        results = []
        for platform, kwargs in ((jax_platform, {}), (port_platform, {"device": "cpu"})):
            capsys.readouterr()
            rc = platform.GenericPlatform.check_barcode_partition(["-b", *bams], **kwargs)
            results.append((rc, capsys.readouterr().err))
        assert results[0] == results[1] and results[0][0] == want
    assert "partition OK" in results[0][1] or "INVALID" in results[0][1]
