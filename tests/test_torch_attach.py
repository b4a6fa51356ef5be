"""The port's barcode attach against the JAX package's two routes.

Small inputs (200 reads, a 50-barcode whitelist) made with a numpy seed go
through ``sctools_tpu_torch.platform`` with ``device="cpu"`` and through
``sctools_tpu.platform``:

- against the JAX native route (the one that runs the whitelist kernel), the
  port's records (name, flag, sequence, quality, tags in order) and its
  stderr summary must be equal in every case;
- against the JAX Python route, forced by making ``_attach_with_native``
  return False, the port's BAM must be byte-identical wherever the two JAX
  routes agree on tags: full-length reads, and no ``BarcodePlatform --i1``;
- the two cases where the JAX routes differ are pinned, with the port on
  the native route's side.
"""

import argparse
import gzip

import numpy as np
import pytest

from sctools_tpu import native as jax_native
from sctools_tpu import platform as jax_platform
from sctools_tpu.io.sam import AlignmentReader
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.fastq import Reader, iter_batches

from helpers import make_header, make_record, write_bam, write_fastq

N_READS = 200
BASES = np.array(list("ACGT"))


def _seqs(rng, n, length):
    return ["".join(row) for row in rng.choice(BASES, size=(n, length))]


def _quals(rng, n, length):
    return ["".join(chr(33 + q) for q in row) for row in rng.integers(0, 41, size=(n, length))]


def _barcode_reads(rng, whitelist, n, tail_length):
    """Reads that start with a cell barcode: exact, one error, or random."""
    length = len(whitelist[0])
    barcodes = []
    for i in range(n):
        barcode = whitelist[rng.integers(len(whitelist))]
        if i % 4 == 1:  # one substitution or one N: corrected
            p = int(rng.integers(length))
            barcode = barcode[:p] + rng.choice([c for c in "ACGTN" if c != barcode[p]]) + barcode[p + 1:]
        elif i % 4 == 2:  # random: usually uncorrectable
            barcode = _seqs(rng, 1, length)[0]
        barcodes.append(barcode)
    tails = _seqs(rng, n, tail_length)
    return [b + t for b, t in zip(barcodes, tails)]


def _fastq(path, sequences, rng, compress=False):
    reads = [
        (f"r{i}", seq, qual)
        for i, (seq, qual) in enumerate(zip(sequences, _quals(rng, len(sequences), max(map(len, sequences)))))
    ]
    reads = [(name, seq, qual[: len(seq)]) for name, seq, qual in reads]
    path = write_fastq(path, reads)
    if compress:
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            dst.write(src.read())
        return path + ".gz"
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_attach")
    rng = np.random.default_rng(2024)
    files = {}
    whitelist = _seqs(rng, 50, 16)
    files["wl"] = str(tmp / "wl.txt")
    (tmp / "wl.txt").write_text("\n".join(whitelist) + "\n")
    whitelist14 = _seqs(rng, 50, 14)
    files["wl14"] = str(tmp / "wl14.txt")
    (tmp / "wl14.txt").write_text("\n".join(whitelist14) + "\n")

    files["r1"] = _fastq(str(tmp / "r1.fastq"), _barcode_reads(rng, whitelist, N_READS, 12), rng, compress=True)
    files["i1"] = _fastq(str(tmp / "i1.fastq"), _seqs(rng, N_READS, 8), rng)
    short = _barcode_reads(rng, whitelist, N_READS, 12)
    for i in range(0, N_READS, 3):  # every third read ends inside a span
        short[i] = short[i][: int(rng.integers(4, 24))]
    files["r1_short"] = _fastq(str(tmp / "r1_short.fastq"), short, rng)
    # read structure 8C18X6C9M1X: the cell barcode split around a linker
    structured = []
    for read in _barcode_reads(rng, whitelist14, N_READS, 0):
        structured.append(read[:8] + _seqs(rng, 1, 18)[0] + read[8:] + _seqs(rng, 1, 10)[0])
    files["r1_structure"] = _fastq(str(tmp / "r1_structure.fastq"), structured, rng)

    header = make_header()
    records = [
        make_record(name=f"r{i}", unmapped=True, sequence=seq, quality=[30] * 24, header=header)
        for i, seq in enumerate(_seqs(rng, N_READS, 24))
    ]
    files["u2"] = write_bam(str(tmp / "u2.bam"), records, header)
    files["u2_short"] = write_bam(str(tmp / "u2_short.bam"), records[:150], header)
    files["tmp"] = tmp
    return files


# case -> (platform class name, arguments, JAX routes agree on tags)
CASES = {
    "tenx_whitelist": ("TenXV2", ["--r1", "{r1}", "--u2", "{u2}", "-w", "{wl}"], True),
    "tenx_plain": ("TenXV2", ["--r1", "{r1}", "--u2", "{u2}"], True),
    "tenx_i1_whitelist": ("TenXV2", ["--r1", "{r1}", "--u2", "{u2}", "--i1", "{i1}", "-w", "{wl}"], True),
    "tenx_i1": ("TenXV2", ["--r1", "{r1}", "--u2", "{u2}", "--i1", "{i1}"], True),
    "custom_whitelist": (
        "BarcodePlatform",
        ["--r1", "{r1}", "--u2", "{u2}", "-w", "{wl}",
         "--cell-barcode-start-position", "0", "--cell-barcode-length", "16",
         "--molecule-barcode-start-position", "16", "--molecule-barcode-length", "10"],
        True,
    ),
    "custom_i1": (
        "BarcodePlatform",
        ["--r1", "{r1}", "--u2", "{u2}", "--i1", "{i1}",
         "--cell-barcode-start-position", "2", "--cell-barcode-length", "8",
         "--molecule-barcode-start-position", "12", "--molecule-barcode-length", "6",
         "--sample-barcode-start-position", "1", "--sample-barcode-length", "6"],
        False,  # SR/SY order differs between the JAX routes
    ),
    "read_structure": (
        "BarcodePlatform",
        ["--r1", "{r1_structure}", "--u2", "{u2}", "-w", "{wl14}",
         "--read-structure", "8C18X6C9M1X"],
        True,
    ),
    "short_reads": ("TenXV2", ["--r1", "{r1_short}", "--u2", "{u2}", "-w", "{wl}"], False),
    "u2_shorter_than_r1": ("TenXV2", ["--r1", "{r1}", "--u2", "{u2_short}", "-w", "{wl}"], True),
}


def _args(case, inputs, output):
    _, template, _ = CASES[case]
    return [a.format(**inputs) for a in template] + ["-o", output]


def _records(path):
    with AlignmentReader(path) as reader:
        return [
            (r.query_name, r.flag, r.sequence, r.quality, list(r.tags.items()))
            for r in reader
        ]


def _run_port(case, inputs, capsys, device="cpu"):
    output = str(inputs["tmp"] / f"port_{case}_{device}.bam")
    cls = getattr(port_platform, CASES[case][0])
    capsys.readouterr()
    assert cls.attach_barcodes(_args(case, inputs, output), device=device) == 0
    return output, capsys.readouterr().err


def _run_jax(case, inputs, capsys, monkeypatch, route):
    name = CASES[case][0]
    cls = getattr(jax_platform, name)
    if name == "BarcodePlatform":
        # the JAX class keeps the last call's geometry on itself
        for attr in ("cell_barcode", "molecule_barcode", "sample_barcode"):
            monkeypatch.setattr(cls, attr, None)
    if route == "python":
        monkeypatch.setattr(cls, "_attach_with_native", classmethod(lambda c, *a, **k: False))
    elif not jax_native.available():
        pytest.skip("the JAX native layer (sctools_tpu.native) is not available")
    output = str(inputs["tmp"] / f"jax_{route}_{case}.bam")
    capsys.readouterr()
    assert cls.attach_barcodes(_args(case, inputs, output)) == 0
    err = capsys.readouterr().err
    assert "native attach failed" not in err
    return output, err


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_match_the_jax_native_route(case, inputs, capsys, monkeypatch):
    jax_out, jax_err = _run_jax(case, inputs, capsys, monkeypatch, "native")
    port_out, port_err = _run_port(case, inputs, capsys)
    expected = _records(jax_out)
    assert _records(port_out) == expected
    assert port_err == jax_err
    assert len(expected) == (150 if case == "u2_shorter_than_r1" else N_READS)
    if "-w" in CASES[case][1]:
        assert "Total barcodes:" in port_err
        assert 0 < sum("CB" in dict(r[4]) for r in expected) < len(expected)


@pytest.mark.parametrize("case", sorted(c for c, (_, _, agree) in CASES.items() if agree))
def test_bam_bytes_match_the_jax_python_route(case, inputs, capsys, monkeypatch):
    jax_out, _ = _run_jax(case, inputs, capsys, monkeypatch, "python")
    port_out, _ = _run_port(case, inputs, capsys)
    with open(jax_out, "rb") as a, open(port_out, "rb") as b:
        assert a.read() == b.read()


def test_sample_tags_come_last_as_on_the_native_route(inputs, capsys, monkeypatch):
    """Divergence 1: BarcodePlatform with --i1. The JAX Python route writes
    SR/SY first, the native route last; the port follows the native route."""
    python_out, _ = _run_jax("custom_i1", inputs, capsys, monkeypatch, "python")
    port_out, _ = _run_port("custom_i1", inputs, capsys)
    port_keys = [k for k, _ in _records(port_out)[0][4]]
    python_keys = [k for k, _ in _records(python_out)[0][4]]
    assert port_keys == ["CR", "CY", "UR", "UY", "SR", "SY"]
    assert python_keys == ["SR", "SY", "CR", "CY", "UR", "UY"]


def test_short_reads_carry_no_newline_as_on_the_native_route(inputs, capsys, monkeypatch):
    """Divergence 2: a read shorter than a span. The JAX Python route keeps
    the FASTQ line's newline inside CR/CY; the native route and the port do
    not."""
    python_out, _ = _run_jax("short_reads", inputs, capsys, monkeypatch, "python")
    port_out, _ = _run_port("short_reads", inputs, capsys)
    python_cr = [dict(r[4])["CR"][1] for r in _records(python_out)]
    port_cr = [dict(r[4])["CR"][1] for r in _records(port_out)]
    short = [i for i, cr in enumerate(port_cr) if len(cr) < 16]
    assert short
    for i in short:
        assert python_cr[i] == port_cr[i] + "\n"
        assert "\n" not in port_cr[i]


def test_attach_rejects_length_without_position():
    with pytest.raises((SystemExit, Exception)):
        port_platform.BarcodePlatform.attach_barcodes(
            ["--r1", "x", "--u2", "y", "-o", "z", "--cell-barcode-length", "8"],
            device="cpu",
        )


def test_attach_rejects_overlapping_cell_and_molecule():
    with pytest.raises(argparse.ArgumentTypeError):
        port_platform.BarcodePlatform.attach_barcodes(
            [
                "--r1", "x", "--u2", "y", "-o", "z",
                "--cell-barcode-start-position", "0",
                "--cell-barcode-length", "16",
                "--molecule-barcode-start-position", "8",
                "--molecule-barcode-length", "10",
            ],
            device="cpu",
        )


def test_attach_rejects_sample_barcode_without_i1():
    with pytest.raises(argparse.ArgumentTypeError):
        port_platform.BarcodePlatform.attach_barcodes(
            [
                "--r1", "x", "--u2", "y", "-o", "z",
                "--sample-barcode-start-position", "0",
                "--sample-barcode-length", "8",
            ],
            device="cpu",
        )


@pytest.mark.parametrize(
    "extra",
    [["--cell-barcode-start-position", "0"], ["--i1", "x"]],
    ids=["position_args", "i1"],
)
def test_read_structure_rejects_other_geometry(extra):
    with pytest.raises(argparse.ArgumentTypeError):
        port_platform.BarcodePlatform.attach_barcodes(
            ["--r1", "x", "--u2", "y", "-o", "z", "--read-structure", "16C10M"] + extra,
            device="cpu",
        )


def test_whitelist_length_must_match_the_cell_span(inputs):
    output = str(inputs["tmp"] / "mismatch.bam")
    with pytest.raises(ValueError, match="does not match"):
        port_platform.TenXV2.attach_barcodes(
            ["--r1", inputs["r1"], "--u2", inputs["u2"], "-o", output, "-w", inputs["wl14"]],
            device="cpu",
        )


def test_batches_cut_anywhere_give_the_same_bam(inputs, capsys):
    from sctools_tpu_torch import attach

    outputs = []
    for batch_size in (7, 64, 1 << 16):
        output = str(inputs["tmp"] / f"batch_{batch_size}.bam")
        attach.attach_barcodes(
            inputs["r1"], inputs["u2"], output, [(0, 16)], [(16, 26)],
            whitelist=inputs["wl"], device="cpu", batch_size=batch_size,
        )
        with open(output, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1] == outputs[2]


def test_fastq_copy_reads_like_the_jax_reader(inputs):
    from sctools_tpu import fastq as jax_fastq

    for mode in ("r", "rb"):
        port = [tuple(r._lines) for r in Reader(inputs["r1"], mode=mode)]
        jax = [tuple(r._lines) for r in jax_fastq.Reader(inputs["r1"], mode=mode)]
        assert port == jax and len(port) == N_READS
    batches = list(iter_batches(inputs["r1"], 64))
    assert [len(s) for s, _ in batches] == [64, 64, 64, 8]
    assert batches[0][0][0] == port[0][1].rstrip(b"\n")
