"""The port's library API (``bam``, ``fastq``, ``gtf``, ``fastq_metrics``,
``io.sam.AlignmentFile``, the frame witness's dump) against JAX's, on the CPU.

**Mirrored cases.** The cases of ``tests/test_bam.py``, ``test_fastq.py``,
``test_gtf.py``, ``test_io_sam.py`` (all of them), and those of
``test_read_structure.py`` and ``test_fastq_metrics.py`` that run no
command on a device or JAX's native layer, run here against the port under
their own names: each file is read, its ``sctools_tpu`` imports are pointed
at ``sctools_tpu_torch`` and the rewritten module is executed. The shared
helpers (``tests/helpers.py``) still write their BAMs with JAX's writer.

**JAX parity**, on inputs made from a numpy seed and run through both
packages:

- ``bam.Tagger`` over each package's generators writes the bytes JAX's
  writes: both write through copies of the same ``AlignmentWriter`` (zlib
  at level 6, 64 KiB blocks), so the compressed files are equal, not only
  their records;
- the generators' tuples, list for list: full-length reads, short reads
  (the FASTQ line's ``"\\n"`` stays in CR/CY and UR/UY), reads within
  distance 1 of two whitelist barcodes (the later one wins) and a read
  structure with split C segments, with and without a whitelist;
- ``SubsetAlignments`` on a BAM and on a SAM: the same indices and the
  same warnings;
- ``GTFRecord`` and ``Reader.filter`` record for record, and
  ``extract_extended_gene_names`` / ``extract_gene_exons`` dict for dict;
- ``FastQMetrics`` over two shards merged by ``+=``: its four files equal
  JAX's and the port's native ``compute_fastq_metrics``'s byte for byte;
- ``AlignmentFile``'s modes and errors, the sort orders,
  ``get_barcode_for_alignment``, ``process_chunks``, and the frame
  witness's ``snapshot`` / ``dump`` and its exit hook.

**JAX's calls**, made as JAX's callers make them (positionally where the
port once took another order) on both packages:

- ``GatherCellMetrics`` / ``GatherGeneMetrics(bam, stem, mito, False)``:
  a plain ``.csv``, the keyword run's bytes and JAX's (``*_variance``
  within ``VARIANCE_RTOL``, as ``test_torch_metrics`` holds them);
  ``extract_metrics(mode="r")`` over a SAM copy equals JAX's and the port's
  BAM run, on both backends;
- ``iter_frames_from_bam``, ``frame_from_bam`` and ``ring_frames`` with
  each ``mode`` on BAM and SAM (the same frames, or the same exception
  type), and with their defaults (no query names from the native
  stream); ``ring_frames(depth=, slots=)``: the queue's depth and the
  arenas made, frames equal to JAX's;
- ``NativeBatchStream(path, 2)``, ``stream_frames`` /
  ``frame_from_bam`` / ``fastq_metrics`` with a thread count: batches,
  vocabularies, filled arenas and files equal to JAX's;
- ``tagsort_stream_frames`` in JAX's order: a level-6 tee with the
  records of level 1 and of JAX's level 6, in fewer bytes, its default
  scratch prefix beside the tee; ``want_qname=True`` gives the query
  names of the sorted BAM;
- ``local_mesh("rows")``, and ``record_dispatch(..., bucket)`` with
  ``pull(value, site, False)``: the registry, ledger and counters equal
  JAX's.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from sctools_tpu import bam as jax_bam
from sctools_tpu import fastq as jax_fastq
from sctools_tpu import fastq_metrics as jax_fqm
from sctools_tpu import gtf as jax_gtf
from sctools_tpu.io import sam as jax_sam
from sctools_tpu.parallel import launch as jax_launch
from sctools_tpu_torch import bam as port_bam
from sctools_tpu_torch import fastq as port_fastq
from sctools_tpu_torch import fastq_metrics as port_fqm
from sctools_tpu_torch import gtf as port_gtf
from sctools_tpu_torch import native as port_native
from sctools_tpu_torch.io import sam as port_sam
from sctools_tpu_torch.parallel import launch as port_launch

from helpers import make_header, make_record, write_bam
from test_torch_metrics import assert_csv_match
from test_torch_native import assert_frames_equal
from test_torch_steer import _ported

REPO = Path(__file__).resolve().parent.parent

# ------------------------------------------------------------ mirrored cases

# per JAX test module, the cases left out and why
_LEFT_OUT = {
    "test_bam": {},
    "test_fastq": {},
    "test_gtf": {},
    "test_io_sam": {},
    "test_read_structure": {
        "test_attach_barcodes_read_structure_cli": "runs Attach on the default device (cuda here)",
        "test_read_structure_rejects_position_args": "runs Attach on the default device (cuda here)",
    },
    "test_fastq_metrics": {
        "test_sample_fastq": "runs SampleFastq on the default device (cuda here)",
        "test_sample_fastq_mismatched_shards_error": "runs SampleFastq on the default device (cuda here)",
        "test_short_read_raises_native": "probes JAX's native.available(); the port's layer has no fallback",
        "TestNativeMatchesOracle": "switches JAX's native layer off; the port has one route",
    },
}
_MODULES = {name: _ported(name) for name in _LEFT_OUT}
_CASES = {}
for _module_name, _left_out in _LEFT_OUT.items():
    _module = _MODULES[_module_name]
    _names = {n for n in vars(_module) if n.startswith(("test_", "Test"))}
    assert set(_left_out) <= _names, (_module_name, set(_left_out) - _names)
    for _name in sorted(_names - set(_left_out)):
        assert _name not in _CASES, f"{_name} is in two mirrored modules"
        _CASES[_name] = getattr(_module, _name)
del _module_name, _left_out, _module, _names, _name
globals().update(_CASES)
# the mirrored modules' fixtures, under their own names
fastq_file = _MODULES["test_fastq"].fastq_file
gtf_file = _MODULES["test_gtf"].gtf_file


def test_mirrored_modules_reach_the_port():
    assert len(_CASES) == 53, sorted(_CASES)
    assert _MODULES["test_bam"].Tagger is port_bam.Tagger
    assert _MODULES["test_bam"].SubsetAlignments is port_bam.SubsetAlignments
    assert _MODULES["test_fastq"].fastq is port_fastq
    assert _MODULES["test_gtf"].gtf is port_gtf
    assert _MODULES["test_io_sam"].AlignmentFile is port_sam.AlignmentFile
    assert _MODULES["test_read_structure"].ReadStructureBarcodeGenerator is port_fastq.ReadStructureBarcodeGenerator
    assert _MODULES["test_fastq_metrics"].FastQMetrics is port_fqm.FastQMetrics


# ------------------------------------------------------------ seeded inputs

_LETTERS = np.array(list("ACGT"))
CB = (0, 16)
UMI = (16, 26)
SAMPLE = (0, 8)


def _seqs(rng, n, length):
    return ["".join(row) for row in _LETTERS[rng.integers(0, 4, size=(n, length))]]


def _quals(rng, n, length):
    return ["".join(chr(c) for c in row) for row in rng.integers(35, 75, size=(n, length))]


def _substitute(rng, seq, position, alphabet="ACGT"):
    choices = [c for c in alphabet if c != seq[position]]
    return seq[:position] + choices[rng.integers(0, len(choices))] + seq[position + 1 :]


def _whitelist_with_ambiguity(rng, n, length, n_ambiguous):
    """A whitelist of ``n`` barcodes whose last ``n_ambiguous`` each lie at
    distance 2 from an earlier one, and for each pair a query at distance 1
    from both (the later barcode is the correction)."""
    whitelist = list(dict.fromkeys(_seqs(rng, 2 * n, length)))[:n]
    queries = []
    for k in range(n_ambiguous):
        first, second = k, n - n_ambiguous + k
        p, q = rng.choice(length, size=2, replace=False)
        moved = _substitute(rng, _substitute(rng, whitelist[first], p), q)
        whitelist[second] = moved
        queries.append((whitelist[first][:p] + moved[p] + whitelist[first][p + 1 :], moved))
    assert len(set(whitelist)) == n
    return whitelist, queries


def _write_fastq(path, names, seqs, quals, compress):
    text = "".join(f"@{a}\n{b}\n+\n{c}\n" for a, b, c in zip(names, seqs, quals)).encode()
    Path(path).write_bytes(gzip.compress(text, mtime=0) if compress else text)
    return str(path)


def _library_inputs(tmp_path, seed, n=300, short=0):
    """A whitelist, R1 (26 bp, ``short`` of them cut to 20 bp) and I1 (8 bp)
    reads whose cell barcodes are exact, one substitution (N included),
    ambiguous or random, and an unmapped u2 BAM of the same names."""
    rng = np.random.default_rng(seed)
    whitelist, ambiguous = _whitelist_with_ambiguity(rng, 120, 16, 8)
    kinds = rng.choice(4, size=n, p=(0.6, 0.2, 0.1, 0.1))
    kinds[rng.choice(n, size=2 * len(ambiguous), replace=False)] = 2  # every ambiguous query, twice at least
    cells = []
    for i, kind in enumerate(kinds):
        if kind == 0:
            cells.append(whitelist[rng.integers(0, len(whitelist))])
        elif kind == 1:
            cells.append(_substitute(rng, whitelist[rng.integers(0, len(whitelist))], rng.integers(0, 16), "ACGTN"))
        elif kind == 2:
            cells.append(ambiguous[i % len(ambiguous)][0])
        else:
            cells.append(_seqs(rng, 1, 16)[0])
    r1 = [c + u for c, u in zip(cells, _seqs(rng, n, 10))]
    r1_qual = _quals(rng, n, 26)
    for i in rng.choice(n, size=short, replace=False):
        r1[i], r1_qual[i] = r1[i][:20], r1_qual[i][:20]
    names = [f"read{i}:{seed}" for i in range(n)]
    (tmp_path / "wl.txt").write_text("".join(w + "\n" for w in whitelist))
    header = make_header()
    records = [make_record(name=name, unmapped=True, sequence=s, header=header)
               for name, s in zip(names, _seqs(rng, n, 50))]
    return {
        "whitelist": str(tmp_path / "wl.txt"),
        "ambiguous": ambiguous,
        "r1": _write_fastq(tmp_path / "r1.fastq.gz", names, r1, r1_qual, True),
        "i1": _write_fastq(tmp_path / "i1.fastq", names, _seqs(rng, n, 8), _quals(rng, n, 8), False),
        "u2": write_bam(tmp_path / "u2.bam", records, header),
        "n": n,
    }


def _embedded(fastq, span, seq_tag, qual_tag):
    return fastq.EmbeddedBarcode(start=span[0], end=span[1], sequence_tag=seq_tag, quality_tag=qual_tag)


def _generators(fastq, inputs):
    """The attach route's generators in the library: CR/CY/CB and UR/UY
    from R1, SR/SY from I1."""
    return [
        fastq.BarcodeGeneratorWithCorrectedCellBarcodes(
            inputs["r1"], _embedded(fastq, CB, "CR", "CY"), inputs["whitelist"],
            [_embedded(fastq, UMI, "UR", "UY")],
        ),
        fastq.EmbeddedBarcodeGenerator(inputs["i1"], [_embedded(fastq, SAMPLE, "SR", "SY")]),
    ]


# ------------------------------------------------------------ Tagger

@pytest.mark.parametrize("seed,short", [(0, 0), (1, 0), (2, 25)])
def test_tagger_writes_jax_bytes(tmp_path, seed, short):
    inputs = _library_inputs(tmp_path, seed, short=short)
    port_out, jax_out = tmp_path / "port.bam", tmp_path / "jax.bam"
    port_bam.Tagger(inputs["u2"]).tag(str(port_out), _generators(port_fastq, inputs))
    jax_bam.Tagger(inputs["u2"]).tag(str(jax_out), _generators(jax_fastq, inputs))
    # equal compressed bytes: both write through the same writer and zlib level
    assert port_out.read_bytes() == jax_out.read_bytes()
    records = list(port_sam.AlignmentReader(str(port_out), "rb"))
    assert len(records) == inputs["n"]
    tags = [dict(r.get_tags()) for r in records]
    assert [list(t) for t in tags if "CB" in t][0] == ["CR", "CY", "CB", "UR", "UY", "SR", "SY"]
    assert sum("CB" not in t for t in tags) > 0
    for query, corrected in inputs["ambiguous"]:
        hits = [t for t in tags if t["CR"] == query]
        assert hits and all(t["CB"] == corrected for t in hits)
    if short:  # the FASTQ line's newline stays in the cut UMI
        assert sum(t["UR"].endswith("\n") for t in tags) == short


def test_tagger_takes_port_generators_and_jax_generators_alike(tmp_path):
    inputs = _library_inputs(tmp_path, 3)
    mixed, port_out = tmp_path / "mixed.bam", tmp_path / "port.bam"
    port_bam.Tagger(inputs["u2"]).tag(str(mixed), _generators(jax_fastq, inputs))
    port_bam.Tagger(inputs["u2"]).tag(str(port_out), _generators(port_fastq, inputs))
    assert mixed.read_bytes() == port_out.read_bytes()


def test_tagger_rejects_a_path_that_is_not_str(tmp_path):
    for bad in (Path(tmp_path / "x.bam"), 7, None):
        with pytest.raises(TypeError) as port_error:
            port_bam.Tagger(bad)
        with pytest.raises(TypeError) as jax_error:
            jax_bam.Tagger(bad)
        assert str(port_error.value) == str(jax_error.value)


# ------------------------------------------------------------ generators

def _tuples(generator):
    return [list(entry) for entry in generator]


@pytest.mark.parametrize("seed,short", [(4, 0), (5, 40)])
def test_generators_yield_jax_tuples(tmp_path, seed, short):
    inputs = _library_inputs(tmp_path, seed, short=short)
    port, jax = _generators(port_fastq, inputs), _generators(jax_fastq, inputs)
    for port_gen, jax_gen in zip(port, jax):
        assert _tuples(port_gen) == _tuples(jax_gen)
    cells = _tuples(port[0])
    if short:
        cut = [entry for entry in cells if entry[0][1].endswith("\n") or entry[3][1].endswith("\n")]
        assert len(cut) == short and all(len(entry[3][1]) == 5 for entry in cut)  # 4 bases + "\n"
    by_query = {entry[0][1]: entry for entry in cells}
    for query, corrected in inputs["ambiguous"]:
        if query in by_query:
            assert by_query[query][2] == ("CB", corrected, "Z")


def test_extract_barcode_equals_jax_on_str_and_bytes_records(tmp_path):
    inputs = _library_inputs(tmp_path, 6, short=30)
    for mode in ("r", "rb"):
        port_records = list(port_fastq.Reader(inputs["r1"], mode=mode))
        jax_records = list(jax_fastq.Reader(inputs["r1"], mode=mode))
        for span in (CB, UMI, (20, 40)):
            for port_r, jax_r in zip(port_records, jax_records):
                assert port_fastq.extract_barcode(port_r, _embedded(port_fastq, span, "XA", "XB")) == \
                    jax_fastq.extract_barcode(jax_r, _embedded(jax_fastq, span, "XA", "XB"))


@pytest.mark.parametrize("structure", ["8C4X8C4M2S", "12C2X8M", "5C3X5C2M"])
@pytest.mark.parametrize("with_whitelist", [False, True])
def test_read_structure_generator_equals_jax(tmp_path, structure, with_whitelist):
    rng = np.random.default_rng(7)
    rs = jax_fastq.ReadStructure(structure)
    length, cell_length = rs.length, rs.barcode_length("C")
    whitelist, ambiguous = _whitelist_with_ambiguity(rng, 40, cell_length, 4)
    (tmp_path / "wl.txt").write_text("".join(w + "\n" for w in whitelist))
    cells = whitelist[:20] + [q for q, _ in ambiguous] + _seqs(rng, 10, cell_length)
    seqs = []
    for cell in cells:
        seq = list(_seqs(rng, 1, length)[0])
        bases = iter(cell)
        for start, end in rs.spans("C"):
            for pos in range(start, end):
                seq[pos] = next(bases)
        seqs.append("".join(seq))
    seqs[-1] = seqs[-1][: length - 2]  # a short read
    path = _write_fastq(tmp_path / "r1.fastq", [f"r{i}" for i in range(len(seqs))], seqs,
                        _quals(rng, len(seqs), length), False)
    wl = str(tmp_path / "wl.txt") if with_whitelist else None
    port = _tuples(port_fastq.ReadStructureBarcodeGenerator(path, structure, whitelist=wl))
    jax = _tuples(jax_fastq.ReadStructureBarcodeGenerator(path, jax_fastq.ReadStructure(structure), whitelist=wl))
    assert port == jax
    corrected = [dict((t[0], t[1]) for t in entry).get("CB") for entry in port]
    if with_whitelist:
        assert corrected[20:24] == [c for _, c in ambiguous]
    else:
        assert not any(corrected)


def test_corrected_generator_errors_equal_jax(tmp_path):
    inputs = _library_inputs(tmp_path, 8, n=20)
    for bad in ("UR", {"a": 1}, None, iter([])):
        errors = []
        for fastq in (port_fastq, jax_fastq):
            with pytest.raises(TypeError) as error:
                fastq.BarcodeGeneratorWithCorrectedCellBarcodes(
                    inputs["r1"], _embedded(fastq, CB, "CR", "CY"), inputs["whitelist"], bad)
            errors.append(str(error.value))
        assert errors[0] == errors[1]


# ------------------------------------------------------------ SubsetAlignments

def _aligned_records(seed, n=200):
    rng = np.random.default_rng(seed)
    header = make_header()  # chr1, chr2, chrM
    refs = rng.integers(-1, 3, size=n)
    records = [make_record(name=f"r{i}", reference_id=int(max(ref, 0)), unmapped=bool(ref < 0),
                           pos=int(rng.integers(1, 10_000)), header=header) for i, ref in enumerate(refs)]
    return header, records


def _subset_calls(package_bam, path, calls):
    out = []
    for args in calls:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = package_bam.SubsetAlignments(path).indices_by_chromosome(*args)
        out.append((got, [str(w.message) for w in caught]))
    return out


@pytest.mark.parametrize("suffix,mode", [(".bam", "wb"), (".sam", "w")])
def test_subset_alignments_equals_jax(tmp_path, suffix, mode):
    header, records = _aligned_records(9)
    path = write_bam(tmp_path / f"aligned{suffix}", records, header, mode=mode)
    calls = [(5, "chr1"), (10, "chrM", 7), (1000, "chr2"), (3, "chr2", 1000), (4, "chrUn_x"), (0, "1", 2)]
    port = _subset_calls(port_bam, path, calls)
    assert port == _subset_calls(jax_bam, path, calls)
    warned = [bool(messages) for _, messages in port]
    assert warned == [False, False, True, True, True, False]


def test_subset_alignments_suffix_errors_equal_jax():
    for name in ("reads.cram", "reads.bam.gz", "reads"):
        errors = []
        for package_bam in (port_bam, jax_bam):
            with pytest.raises(ValueError) as error:
                package_bam.SubsetAlignments(name)
            errors.append(str(error.value))
        assert errors[0] == errors[1]


# ------------------------------------------------------------ GTF

def _gtf_text(seed, n=60):
    rng = np.random.default_rng(seed)
    lines = ["#!genome-build test\n", "#!genome-version 1\n"]
    chromosomes = ["chr2", "chr1", "chrM", "chrX"]
    for i in range(n):
        chrom = chromosomes[int(rng.integers(0, 4))]
        gene = f"G{int(rng.integers(0, n // 3))}"
        start = int(rng.integers(1, 100_000))
        end = start + int(rng.integers(0, 5_000))
        feature = ("gene", "exon", "transcript")[int(rng.integers(0, 3))]
        attrs = f'gene_id "ID{gene}"; gene_name "{gene}"; tag "t{i}";'
        if i % 7 == 0:
            attrs = attrs.rstrip(";")  # a last attribute without ';'
        lines.append("\t".join([chrom, "src", feature, str(start), str(end), ".", "+-"[i % 2], ".", attrs]) + "\n")
    return "".join(lines)


@pytest.mark.parametrize("seed", [10, 11])
def test_gtf_records_and_filter_equal_jax(tmp_path, seed):
    path = tmp_path / "a.gtf"
    path.write_text(_gtf_text(seed))
    port_records, jax_records = list(port_gtf.Reader(str(path))), list(jax_gtf.Reader(str(path)))
    assert len(port_records) == len(jax_records) == 60
    fields = ("seqname", "chromosome", "source", "feature", "start", "end", "score", "strand", "frame", "size")
    for port_r, jax_r in zip(port_records, jax_records):
        assert [getattr(port_r, f) for f in fields] == [getattr(jax_r, f) for f in fields]
        for key in ("gene_id", "gene_name", "tag", "missing"):
            assert port_r.get_attribute(key) == jax_r.get_attribute(key)
        port_r.set_attribute("extra", "v")
        jax_r.set_attribute("extra", "v")
        assert (str(port_r), bytes(port_r), repr(port_r), hash(port_r)) == \
            (str(jax_r), bytes(jax_r), repr(jax_r), hash(jax_r))
    fresh = next(iter(port_gtf.Reader(str(path))))
    assert fresh != port_records[0]
    fresh.set_attribute("extra", "v")
    assert fresh == port_records[0] and hash(fresh) == hash(port_records[0]) and port_records[0] != port_records[1]
    assert port_records[0] != str(port_records[0])
    for kinds in (["exon"], ["gene", "transcript"], []):
        assert [str(r) for r in port_gtf.Reader(str(path)).filter(kinds)] == \
            [str(r) for r in jax_gtf.Reader(str(path)).filter(kinds)]


def test_gtf_record_negative_size_errors_equal_jax():
    line = 'chr1\tsrc\tgene\t500\t100\t.\t+\t.\tgene_id "X";\n'
    errors = []
    for package_gtf in (port_gtf, jax_gtf):
        with pytest.raises(ValueError) as error:
            package_gtf.GTFRecord(line).size  # noqa: B018
        errors.append(str(error.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [12, 13, 14])
def test_gene_intervals_equal_jax(tmp_path, seed):
    path = tmp_path / "a.gtf"
    path.write_text(_gtf_text(seed, n=120))
    port_names = port_gtf.extract_extended_gene_names(str(path))
    assert port_names == jax_gtf.extract_extended_gene_names(str(path))
    port_exons = port_gtf.extract_gene_exons(str(path))
    assert port_exons == jax_gtf.extract_gene_exons(str(path))
    assert list(port_names) == list(jax_gtf.extract_extended_gene_names(str(path)))  # first-seen order
    assert list(port_exons) == list(jax_gtf.extract_gene_exons(str(path)))
    assert sum(len(v) for v in port_exons.values()) > 10


# ------------------------------------------------------------ FastQMetrics

_FQM_FILES = (".numReads_perCell_XM.txt", ".numReads_perCell_XC.txt",
              ".barcode_distribution_XC.txt", ".barcode_distribution_XM.txt")


@pytest.mark.parametrize("structure", ["8C4X6C9M3X", "16C10M"])
def test_fastq_metrics_shards_merge_to_jax_and_native_bytes(tmp_path, structure):
    rng = np.random.default_rng(15)
    shards = []
    for s, n in enumerate((700, 500)):
        seqs = ["".join(row) for row in np.array(list("ACGTNacgt"))[rng.integers(0, 9, size=(n, 30))]]
        seqs = [s_ if i % 5 else s_[:8] * 3 + s_[24:] for i, s_ in enumerate(seqs)]  # repeated barcodes
        shards.append(_write_fastq(tmp_path / f"s{s}.fastq.gz", [f"s{s}r{i}" for i in range(n)], seqs,
                                   _quals(rng, n, 30), True))
    outputs = {}
    for name, module in (("port", port_fqm), ("jax", jax_fqm)):
        total = module.FastQMetrics(structure)
        second = module.FastQMetrics(structure)
        assert total.ingest(shards[0]) == 700 and second.ingest(shards[1]) == 500
        total += second
        total.write(str(tmp_path / name))
        outputs[name] = total
    assert port_fqm.compute_fastq_metrics(shards, structure, str(tmp_path / "native")) == 1200
    for suffix in _FQM_FILES:
        port = (tmp_path / f"port{suffix}").read_bytes()
        assert port == (tmp_path / f"jax{suffix}").read_bytes() == (tmp_path / f"native{suffix}").read_bytes(), suffix
    np.testing.assert_array_equal(outputs["port"].barcode_pwm.counts, outputs["jax"].barcode_pwm.counts)
    assert outputs["port"].umi_counts == outputs["jax"].umi_counts


def test_fastq_metrics_class_is_not_the_command_route(tmp_path, monkeypatch):
    path = _write_fastq(tmp_path / "r1.fastq", ["a", "b"], ["AAAACCGGG", "CCCCAAGGG"], ["I" * 9] * 2, False)
    monkeypatch.setattr(port_fqm, "FastQMetrics", None)  # the command never reaches the class
    port_native.reset_calls()
    assert port_fqm.compute_fastq_metrics(path, "4C2X3M", str(tmp_path / "out")) == 2
    assert port_native.calls["fastq_metrics"] == 1


# ------------------------------------------------------------ io.sam and sort orders

def test_alignment_file_modes_and_errors_equal_jax(tmp_path):
    header, records = _aligned_records(16, n=20)
    source = write_bam(tmp_path / "in.bam", records, header)
    outputs = {}
    for name, sam in (("port", port_sam), ("jax", jax_sam)):
        reader = sam.AlignmentFile(source, "rb")
        assert isinstance(reader, sam.AlignmentReader)
        bam_writer = sam.AlignmentFile(str(tmp_path / f"{name}.bam"), "wb", template=reader)
        sam_writer = sam.AlignmentFile(str(tmp_path / f"{name}.sam"), "w",
                                       header=sam.BamHeader.from_text(header.text))
        assert isinstance(bam_writer, sam.AlignmentWriter)
        for record in reader:
            bam_writer.write(record)
            sam_writer.write(record)
        for handle in (reader, bam_writer, sam_writer):
            handle.close()
        with sam.AlignmentFile(str(tmp_path / f"{name}.sam"), "r") as text:
            outputs[name] = [r.query_name for r in text]
        errors = []
        for args, kwargs in ((("x.bam", "wb"), {}), (("x.bam", "a"), {}), (("x.bam", "rw"), {"header": header})):
            with pytest.raises(ValueError) as error:
                sam.AlignmentFile(str(tmp_path / args[0]), args[1], **kwargs)
            errors.append(str(error.value))
        outputs[name + "_errors"] = errors
    assert (tmp_path / "port.bam").read_bytes() == (tmp_path / "jax.bam").read_bytes()
    assert (tmp_path / "port.sam").read_text() == (tmp_path / "jax.sam").read_text()
    assert outputs["port"] == outputs["jax"] == [f"r{i}" for i in range(20)]
    assert outputs["port_errors"] == outputs["jax_errors"]


def test_sort_orders_equal_jax():
    _, records = _aligned_records(17, n=30)
    rng = np.random.default_rng(17)
    for record, name in zip(records, rng.permutation(30)):
        record.query_name = f"q{name:03d}"
    port_order, jax_order = port_bam.QueryNameSortOrder(), jax_bam.QueryNameSortOrder()
    assert repr(port_order) == repr(jax_order) == "query_name"
    assert isinstance(port_order, port_bam.AlignmentSortOrder)
    assert sorted(records, key=port_order.key_generator) == sorted(records, key=jax_order.key_generator)
    assert [port_bam.QueryNameSortOrder.get_sort_key(r) for r in records] == \
        [jax_bam.QueryNameSortOrder.get_sort_key(r) for r in records]
    with pytest.raises(NotImplementedError):
        port_bam.AlignmentSortOrder().key_generator  # noqa: B018


def test_get_barcode_for_alignment_equals_jax():
    rng = np.random.default_rng(18)
    header = make_header()
    tags = ["CB", "CR"]
    for i in range(40):
        cb, cr = (_seqs(rng, 1, 8)[0] if rng.random() < 0.5 else None for _ in range(2))
        record = make_record(name=f"r{i}", cb=cb, cr=cr, header=header)
        results = []
        for package_bam in (port_bam, jax_bam):
            for raise_missing in (False, True):
                try:
                    results.append(package_bam.get_barcode_for_alignment(record, tags, raise_missing))
                except RuntimeError as error:
                    results.append(("RuntimeError", str(error)))
        assert results[:2] == results[2:]
        assert results[0] == (cb if cb is not None else cr)


# ------------------------------------------------------------ the rest of the surface

@pytest.mark.parametrize("n_chunks,n_processes", [(7, 3), (10, 1), (2, 4)])
def test_process_chunks_equals_jax(n_chunks, n_processes):
    rng = np.random.default_rng(n_chunks)
    chunks = [f"chunks/chunk{i:04d}.bam" for i in rng.permutation(n_chunks)]
    shares = [port_launch.process_chunks(chunks, n_processes, p) for p in range(n_processes)]
    assert shares == [jax_launch.process_chunks(chunks, n_processes, p) for p in range(n_processes)]
    assert sorted(path for share in shares for _, path in share) == sorted(chunks)


def test_frame_witness_snapshot_and_dump_equal_jax(monkeypatch, tmp_path):
    from sctools_tpu.ingest import framedebug as jax_framedebug
    from sctools_tpu_torch.ingest import framedebug as port_framedebug

    monkeypatch.setenv("SCTOOLS_TPU_FRAME_DEBUG", "1")
    monkeypatch.delenv("SCTOOLS_TPU_TRACE", raising=False)
    for module in (port_framedebug, jax_framedebug):
        module.reset()
        assert module.dump() is None  # no trace directory: nothing to write
    try:
        port_framedebug._violations.append({"slot": 1, "column": "cell"})
        jax_framedebug._violations.append({"slot": 1, "column": "cell"})
        assert port_framedebug.snapshot() == jax_framedebug.snapshot()
        monkeypatch.setenv("SCTOOLS_TPU_TRACE", str(tmp_path))
        monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w0")
        port_path = port_framedebug.dump()
        assert port_path == str(tmp_path / "frames.w0.json")
        jax_path = jax_framedebug.dump(str(tmp_path / "jax.json"))
        assert Path(port_path).read_bytes() == Path(jax_path).read_bytes()
        assert not list(tmp_path.glob("*.tmp.*"))
        assert port_framedebug.dump(str(tmp_path / "missing" / "x.json")) is None
    finally:
        port_framedebug.reset()
        jax_framedebug.reset()


_EXIT_DUMP = """
import numpy as np
from sctools_tpu_torch.ingest import arena
slot = arena.ColumnArena(64)
slot.frame(4, ["a"], ["b"], ["c"])
slot.frame(2, ["a"], ["b"], ["c"])
"""


def test_frame_witness_dumps_at_exit(tmp_path):
    env = dict(os.environ, SCTOOLS_TPU_FRAME_DEBUG="1", SCTOOLS_TPU_TRACE=str(tmp_path),
               SCTOOLS_TPU_TRACE_WORKER="exiting", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", _EXIT_DUMP], env=env, check=True, timeout=120)
    payload = json.loads((tmp_path / "frames.exiting.json").read_text())
    assert payload == {"enabled": True, "stamped": 2, "violations": []}
    env.pop("SCTOOLS_TPU_FRAME_DEBUG")
    env["SCTOOLS_TPU_TRACE_WORKER"] = "off"
    subprocess.run([sys.executable, "-c", _EXIT_DUMP], env=env, check=True, timeout=120)
    assert not (tmp_path / "frames.off.json").exists()  # nothing stamped, no hook


# ------------------------------------------------------------ JAX's calls


@pytest.fixture(scope="module")
def tagged(tmp_path_factory):
    """A cell-sorted tagged BAM, its SAM text copy, and the same records
    unsorted, from a seed."""
    from test_metrics import random_tagged_records

    tmp = tmp_path_factory.mktemp("calls")
    records, header = random_tagged_records(seed=21, n_records=600)
    ordered = list(jax_bam.sort_by_tags_and_queryname(records, ["CB", "UB", "GE"]))
    return dict(
        bam=write_bam(str(tmp / "cell.bam"), ordered, header),
        sam=write_bam(str(tmp / "cell.sam"), ordered, header, mode="w"),
        unsorted=write_bam(str(tmp / "unsorted.bam"), records, header),
    )


def _assert_frames_equal(port, jax):
    assert [f.n_records for f in port] == [f.n_records for f in jax]
    for a, b in zip(port, jax):
        assert_frames_equal(a, b)


def _frames_or_error(call):
    """The frames a reader gives, each copied as it comes (ring frames view
    recycled slots), or the type of the exception it raises."""
    from sctools_tpu_torch.io import packed

    try:
        result = call()
        return [packed.copy_frame(f) for f in ([result] if hasattr(result, "n_records") else result)]
    except Exception as error:  # compared by type with JAX's
        return type(error)


def _copied(frames):
    from sctools_tpu_torch.io import packed

    return [packed.copy_frame(f) for f in frames]


def _same_outcome(port, jax):
    if isinstance(port, type) or isinstance(jax, type):
        assert port is jax
    else:
        _assert_frames_equal(port, jax)


@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_gatherer_compress_given_positionally_equals_jax(tagged, tmp_path, kind):
    from sctools_tpu.metrics import gatherer as jax_gatherer
    from sctools_tpu_torch.metrics import gatherer as port_gatherer

    name = "GatherCellMetrics" if kind == "cell" else "GatherGeneMetrics"
    mito = {"MT-GENE"}
    getattr(jax_gatherer, name)(tagged["bam"], str(tmp_path / "jax"), mito, False).extract_metrics()
    getattr(port_gatherer, name)(tagged["bam"], str(tmp_path / "port"), mito, False, device="cpu").extract_metrics()
    getattr(port_gatherer, name)(tagged["bam"], str(tmp_path / "keyword"), mito, compress=False,
                                 device="cpu").extract_metrics()
    port = (tmp_path / "port.csv").read_bytes()
    assert port == (tmp_path / "keyword.csv").read_bytes() and port.count(b"\n") > 2
    assert not list(tmp_path.glob("*.gz"))
    for name in ("port", "jax"):  # the repo's CSV rule: bytes, but *_variance within VARIANCE_RTOL
        (tmp_path / f"{name}.csv.gz").write_bytes(gzip.compress((tmp_path / f"{name}.csv").read_bytes()))
    assert_csv_match(tmp_path / "port.csv.gz", tmp_path / "jax.csv.gz")


@pytest.mark.parametrize("backend", ["device", "cpu"])
def test_extract_metrics_mode_r_reads_sam_as_jax(tagged, tmp_path, backend):
    from sctools_tpu.metrics.gatherer import GatherCellMetrics as JaxCell
    from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics

    JaxCell(tagged["sam"], str(tmp_path / "jax"), backend=backend).extract_metrics(mode="r")
    GatherCellMetrics(tagged["sam"], str(tmp_path / "sam"), backend=backend, device="cpu").extract_metrics(mode="r")
    GatherCellMetrics(tagged["bam"], str(tmp_path / "bam"), backend=backend, device="cpu").extract_metrics()
    assert gzip.decompress((tmp_path / "sam.csv.gz").read_bytes()) == \
        gzip.decompress((tmp_path / "bam.csv.gz").read_bytes())
    assert_csv_match(tmp_path / "sam.csv.gz", tmp_path / "jax.csv.gz")


@pytest.mark.parametrize("mode", [None, "rb", "r"])
@pytest.mark.parametrize("source", ["bam", "sam"])
def test_frame_readers_take_jax_s_mode(tagged, source, mode):
    from sctools_tpu.ingest import ring as jax_ring
    from sctools_tpu.io import packed as jax_packed
    from sctools_tpu_torch.ingest import ring as port_ring
    from sctools_tpu_torch.io import packed as port_packed

    path = tagged[source]
    for port, jax in (
        (lambda: port_packed.iter_frames_from_bam(path, 128, mode),
         lambda: jax_packed.iter_frames_from_bam(path, 128, mode)),
        (lambda: port_packed.frame_from_bam(path, mode), lambda: jax_packed.frame_from_bam(path, mode)),
        (lambda: port_ring.ring_frames(path, 128, mode), lambda: jax_ring.ring_frames(path, 128, mode)),
    ):
        port_frames, jax_frames = _frames_or_error(port), _frames_or_error(jax)
        _same_outcome(port_frames, jax_frames)
        # the right mode reads the file; the wrong one fails as JAX's does
        assert isinstance(port_frames, list) == (mode is None or (mode == "r") == (source == "sam"))


@pytest.mark.parametrize("source", ["bam", "sam"])
def test_frame_readers_defaults_equal_jax(tagged, source):
    """No query names unless asked for, as JAX's readers (the native
    stream's qname column stays empty; the Python decoder fills it)."""
    from sctools_tpu.ingest import ring as jax_ring
    from sctools_tpu.io import packed as jax_packed
    from sctools_tpu_torch.ingest import ring as port_ring
    from sctools_tpu_torch.io import packed as port_packed

    path = tagged[source]
    for want_qname in (False, True):
        _assert_frames_equal(_frames_or_error(lambda: port_packed.iter_frames_from_bam(path, 128, None, want_qname)),
                             _frames_or_error(lambda: jax_packed.iter_frames_from_bam(path, 128, None, want_qname)))
        _assert_frames_equal(_frames_or_error(lambda: port_ring.ring_frames(path, 128, None, want_qname)),
                             _frames_or_error(lambda: jax_ring.ring_frames(path, 128, None, want_qname)))
    default = _frames_or_error(lambda: port_packed.iter_frames_from_bam(path, 128))
    _assert_frames_equal(default, _frames_or_error(lambda: jax_packed.iter_frames_from_bam(path, 128)))
    assert (default[0].qname_names == [""]) == (source == "bam")
    _assert_frames_equal(_frames_or_error(lambda: port_packed.frame_from_bam(path)),
                         _frames_or_error(lambda: jax_packed.frame_from_bam(path)))


@pytest.mark.parametrize("depth,slots", [(1, 6), (3, 9)])
def test_ring_frames_depth_and_slots_equal_jax(tagged, monkeypatch, depth, slots):
    from sctools_tpu.ingest import ring as jax_ring
    from sctools_tpu_torch.ingest import ring as port_ring

    arenas, depths = [], []
    arena, prefetch = port_ring.ColumnArena, port_ring.prefetch_iterator
    monkeypatch.setattr(port_ring, "ColumnArena", lambda capacity: arenas.append(capacity) or arena(capacity))
    monkeypatch.setattr(port_ring, "prefetch_iterator", lambda it, d: depths.append(d) or prefetch(it, d))
    port = _frames_or_error(lambda: port_ring.ring_frames(tagged["bam"], 64, depth=depth, slots=slots))
    assert len(arenas) == slots and depths == [depth] and len(port) == 10
    _assert_frames_equal(port, _frames_or_error(
        lambda: jax_ring.ring_frames(tagged["bam"], 64, depth=depth, slots=slots)))
    depths.clear()
    _frames_or_error(lambda: port_ring.ring_frames(source=iter(port), depth=depth))
    assert depths == [depth]


def test_native_batch_stream_takes_threads_second_as_jax(tagged):
    from sctools_tpu import native as jax_native
    from sctools_tpu_torch.ingest.arena import arena_nbytes

    capacity = 256
    with port_native.NativeBatchStream(tagged["bam"], 2) as port, jax_native.NativeBatchStream(tagged["bam"], 2) as jax:
        batches = 0
        while True:
            n = port.next(capacity)
            assert n == jax.next(capacity)
            if n == 0:
                break
            batches += 1
            for name in ("cell", "umi", "gene", "qname"):
                assert port.vocab(name) == jax.vocab(name), name
            assert port.vocab("qname") == [""]  # 2 is the thread count, not want_qname
            mine, theirs = (np.zeros(arena_nbytes(capacity), np.uint8) for _ in range(2))
            assert port.fill_arena(mine, capacity) == jax.fill_arena(theirs, capacity) == n
            assert np.array_equal(mine, theirs)
    assert batches == 3


def test_native_decoders_take_threads_as_jax(tagged, tmp_path):
    from sctools_tpu import native as jax_native

    for threads in (1, 3):
        _assert_frames_equal(list(port_native.stream_frames(tagged["bam"], 100, threads)),
                             list(jax_native.stream_frames_native(tagged["bam"], 100, threads)))
        _assert_frames_equal([port_native.frame_from_bam(tagged["bam"], threads)],
                             [jax_native.frame_from_bam_native(tagged["bam"], threads)])
    rng = np.random.default_rng(22)
    shards = [_write_fastq(tmp_path / f"s{s}.fastq.gz", [f"s{s}r{i}" for i in range(300)],
                           ["".join(row) for row in np.array(list("ACGTN"))[rng.integers(0, 5, size=(300, 26))]],
                           _quals(rng, 300, 26), True) for s in range(3)]
    for threads in (1, 2):
        assert port_native.fastq_metrics(shards, [(0, 16)], [(16, 26)], 26, str(tmp_path / f"p{threads}"),
                                         threads) == 900
        assert jax_native.fastq_metrics_native(shards, [(0, 16)], [(16, 26)], 26, str(tmp_path / f"j{threads}"),
                                               threads) == 900
        for suffix in _FQM_FILES:
            port = (tmp_path / f"p{threads}{suffix}").read_bytes()
            assert port == (tmp_path / f"j{threads}{suffix}").read_bytes() == (tmp_path / f"p1{suffix}").read_bytes()


_TAGS = ("CB", "UB", "GE")


def test_tagsort_stream_tee_level_equals_jax(tagged, tmp_path):
    """JAX's positional order: batch, sort batch, tee, level. The tee at
    level 6 holds the records of level 1 and JAX's level 6, and its
    scratch partials go beside it and are gone at the end."""
    from sctools_tpu import native as jax_native

    runs = {}
    for name, stream, level in (("port6", port_native.tagsort_stream_frames, 6),
                                ("port1", port_native.tagsort_stream_frames, 1),
                                ("jax6", jax_native.tagsort_stream_frames, 6)):
        tee = str(tmp_path / f"{name}.bam")
        frames = _copied(stream(tagged["unsorted"], _TAGS, 128, 1000, tee, level))
        runs[name] = frames, Path(tee).read_bytes()
    _assert_frames_equal(runs["port6"][0], runs["jax6"][0])
    _assert_frames_equal(runs["port6"][0], runs["port1"][0])
    records = gzip.decompress(runs["port6"][1])
    assert records == gzip.decompress(runs["port1"][1]) == gzip.decompress(runs["jax6"][1])
    # the level reached the tee (JAX's deflate is another library, so its
    # compressed bytes differ from the port's at any level)
    assert len(runs["port6"][1]) < len(runs["port1"][1])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax6.bam", "port1.bam", "port6.bam"]


def test_tagsort_stream_qnames_equal_the_sorted_bam_s(tagged, tmp_path):
    from sctools_tpu import native as jax_native
    from sctools_tpu_torch.io import packed as port_packed

    tee = str(tmp_path / "sorted.bam")
    port = _copied(port_native.tagsort_stream_frames(
        tagged["unsorted"], _TAGS, 128, 1000, tee, 1, str(tmp_path / "scratch"), 2, True))
    jax = list(jax_native.tagsort_stream_frames(
        tagged["unsorted"], _TAGS, 128, 1000, None, 1, str(tmp_path / "jax_scratch"), 2, True))
    _assert_frames_equal(port, jax)
    reread = list(port_packed.iter_frames_from_bam(tee, 128, want_qname=True))
    names = [[f.qname_names[i] for i in f.qname] for f in port]
    assert names == [[f.qname_names[i] for i in f.qname] for f in reread]
    assert sum(map(len, names)) == 600 and len(set(sum(names, []))) == 600


def test_local_mesh_takes_the_axis_name_first():
    import jax
    from sctools_tpu.parallel.mesh import mesh_fingerprint as jax_fingerprint
    from sctools_tpu_torch.parallel import mesh_fingerprint

    assert jax_launch.local_mesh("rows").axis_names == ("rows",)
    for axis in ("shard", "rows"):
        mesh = port_launch.local_mesh(axis, device="cpu")
        assert mesh.axis_names == (axis,)
        assert mesh_fingerprint(mesh) == jax_fingerprint(jax.sharding.Mesh(np.asarray(jax.local_devices()[:1]),
                                                                            (axis,)))
    assert port_launch.local_mesh(device="cpu").axis_names == jax_launch.local_mesh().axis_names


def test_record_dispatch_takes_bucket_and_pull_record_third_as_jax():
    import jax.numpy as jnp
    import torch
    from sctools_tpu import obs as jax_obs
    from sctools_tpu.ingest import wire as jax_wire
    from sctools_tpu.obs import xprof as jax_xprof
    from sctools_tpu_torch import obs as port_obs
    from sctools_tpu_torch.ingest import wire as port_wire
    from sctools_tpu_torch.obs import xprof as port_xprof

    registries = []
    for obs, xprof in ((port_obs, port_xprof), (jax_obs, jax_xprof)):
        obs.enable()
        obs.reset()
        xprof.reset()
        try:
            xprof.record_dispatch("calls.site", 3, 8, 8)
            xprof.record_dispatch("calls.site", 5, 8, bucket=8)
            xprof.record_dispatch("calls.site", 16, 16)
            value = torch.arange(8, dtype=torch.int32) if xprof is port_xprof else jnp.arange(8, dtype=jnp.int32)
            (port_wire if xprof is port_xprof else jax_wire).pull(value, "calls.silent", False)
            (port_wire if xprof is port_xprof else jax_wire).pull(value, "calls.pull", wasted=12)
            registries.append((xprof.snapshot()["sites"]["calls.site"], xprof.ledger_totals(),
                               {k: v for k, v in obs.counters().items() if k.startswith("xprof_")}))
        finally:
            obs.disable()
            obs.reset()
            xprof.reset()
    port, jax = registries
    assert port == jax
    assert port[0]["dispatches"] == 3 and port[0]["real_rows"] == 24 and port[0]["padded_rows"] == 32
    assert "calls.silent" not in str(port[1]) and "calls.pull" in str(port[1])
