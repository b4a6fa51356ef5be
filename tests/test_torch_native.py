"""The port's native host layer against the JAX package's, on the CPU.

``sctools_tpu_torch.native`` is the port's copy of the BAM half of
``sctools_tpu.native`` (the streaming decoder and the out-of-core tag sort),
over zlib where the JAX copy uses libdeflate. It builds here with g++ at
first use. The same BAMs, made from a ``random`` seed through
``tests/helpers.py`` (or by ``native.synth_bam_native``), go through both
layers and through the port's own Python decoder:

- ``stream_frames`` at 1, 7, 4,096 and more records than the file a batch,
  with and without query names, over tagged BAMs with every kind of record
  the decoder branches on, a synthetic BAM, BGZF levels 0, 1 and 6, a plain
  ``"BAM\\1"`` file and a header-only BAM; ``frame_from_bam`` on whole files.
  Frames must agree in every column, dtype and vocabulary;
- malformed inputs: the port's route raises what the JAX route raises and
  leaves no output;
- the tag sort: decompressed record bodies equal JAX's ``tagsort_native``
  output for every key order the commands take, at several chunk sizes;
  the fused pass's CSV and sorted BAM equal JAX's, and its partials go;
- ``native.calls`` says which route ran.

Compressed bytes differ between the two layers (zlib against libdeflate), so
every comparison is on decompressed records.
"""

from __future__ import annotations

import functools
import gzip
import itertools
import random

import numpy as np
import pytest

from sctools_tpu import native as jax_native
from sctools_tpu import platform as jax_platform
from sctools_tpu.io import packed as jax_packed
from sctools_tpu_torch import native
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io import bgzf, packed
from sctools_tpu_torch.io.sam import iter_raw_records, read_raw_header
from sctools_tpu_torch.metrics.gatherer import MetricGatherer

from helpers import make_header, make_record, write_bam, write_gtf
from test_torch_metrics import assert_csv_match

CELL, GENE = ["CB", "UB", "GE"], ["GE", "CB", "UB"]


def _records(n: int, seed: int):
    """``n`` records in random order covering the decoder's branches:
    missing CB / UB / GE / XF / NH, CB and UB that cannot pack to 3-bit codes
    (non-ACGTN, longer than 21 bases), unmapped, duplicate, reverse and
    spliced reads, absent qualities (all 0xff), and runs of ties on the tags
    and the name."""
    rng = random.Random(seed)
    header = make_header()
    cells = ["".join(rng.choice("ACGT") for _ in range(16)) for _ in range(20)]
    odd_cells = ["ACGTX", "A" * 25, "acgt", "NNNNNNNN"]
    records = []
    while len(records) < n:
        unmapped = rng.random() < 0.1
        cb = rng.choice(cells + [None] + (odd_cells if rng.random() < 0.1 else []))
        record = make_record(
            name=f"q{rng.randrange(3000):05d}",
            cb=cb, cr=rng.choice([cb, rng.choice(cells), None]), cy=rng.choice(["IIII?III", None, ""]),
            ub=rng.choice(["".join(rng.choice("ACGT") for _ in range(10)), None, "ZZ", "AAAAAAAAAA"]),
            ur=rng.choice(["ACGTACGTAC", None]), uy=rng.choice(["IIIII#IIII", None]),
            ge=rng.choice(["G1", "G2", "mt-X", "ACTB,GAPDH", None]),
            xf=None if unmapped else rng.choice(["CODING", "INTRONIC", "UTR", "INTERGENIC", "ODD", None]),
            nh=None if unmapped or rng.random() < 0.1 else rng.choice([1, 2, 300]),
            unmapped=unmapped, duplicate=rng.random() < 0.2, reverse=rng.random() < 0.5,
            spliced=rng.random() < 0.3, pos=rng.randrange(100000),
            quality=[rng.randrange(2, 41) for _ in range(26)], header=header,
        )
        if rng.random() < 0.05:
            record.quality = None  # written as 0xff
        copies = 1 + (rng.randrange(1, 4) if len(records) % 10 == 0 else 0)
        records.extend([record] * copies)
    return records[:n], header


def _write_level(path, raw: bytes, level: int) -> str:
    with bgzf.BgzfWriter(str(path), level=level) as out:
        out.write(raw)
    return str(path)


def _raw(path) -> bytes:
    """The uncompressed BAM stream of a BGZF file."""
    with bgzf.open_bgzf_reader(str(path)) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> (path, BGZF path of the same records for the Python decoder)."""
    root = tmp_path_factory.mktemp("native")
    records, header = _records(600, seed=21)
    tagged = write_bam(root / "tagged.bam", records, header)
    raw = _raw(tagged)
    out = {"tagged": (tagged, tagged)}
    for level in (0, 1, 6):
        path = _write_level(root / f"level{level}.bam", raw, level)
        out[f"level{level}"] = (path, path)
    plain = root / "plain.bam"
    plain.write_bytes(raw)
    out["plain"] = (str(plain), tagged)
    synth = str(root / "synth.bam")
    jax_native.synth_bam_native(synth, 24, molecules_per_cell=6, reads_per_molecule=3, seed=5)
    out["synth"] = (synth, synth)
    empty = write_bam(root / "header_only.bam", [], header)
    out["header-only"] = (empty, empty)
    return out


def assert_frames_equal(port, other, qname=True):
    fields = [f for f in packed._PER_RECORD_FIELDS if qname or f != "qname"]
    for name in fields:
        a, b = getattr(port, name), np.asarray(getattr(other, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    for name in packed._CODED_FIELDS:
        if qname or name != "qname":
            assert getattr(port, f"{name}_names") == list(getattr(other, f"{name}_names")), name


def _python_frames(path, batch):
    return list(packed._python_frames(path, batch, packed.DEFAULT_TAG_KEYS))


INPUTS = ["tagged", "level0", "level1", "level6", "plain", "synth", "header-only"]


@pytest.mark.parametrize("want_qname", [True, False], ids=["qname", "no-qname"])
@pytest.mark.parametrize("batch", [1, 7, 4096, 100000])
@pytest.mark.parametrize("name", INPUTS)
def test_stream_frames_match_jax_and_python(inputs, name, batch, want_qname):
    path, bgzf_path = inputs[name]
    port = list(native.stream_frames(path, batch, want_qname=want_qname))
    jax = list(jax_native.stream_frames_native(path, batch, want_qname=want_qname))
    python = _python_frames(bgzf_path, batch)
    assert len(port) == len(jax) == len(python)
    assert [f.n_records for f in port] == [f.n_records for f in python]
    for a, b, c in zip(port, jax, python):
        assert_frames_equal(a, b)
        assert_frames_equal(a, c, qname=want_qname)
        if not want_qname:
            assert a.qname_names == [""] and not a.qname.any()


@pytest.mark.parametrize("name", INPUTS)
def test_frame_from_bam_matches_jax_and_python(inputs, name):
    path, bgzf_path = inputs[name]
    whole = native.frame_from_bam(path)
    assert_frames_equal(whole, jax_native.frame_from_bam_native(path))
    python = _python_frames(bgzf_path, 10**6)
    if python:
        assert_frames_equal(whole, python[0])
    else:
        assert whole.n_records == 0 and whole.cell_names == whole.qname_names == []
    if name != "plain":  # the route reads plain files as SAM text, as JAX's does
        native.reset_calls()
        assert_frames_equal(packed.frame_from_bam(path), jax_packed.frame_from_bam(path))
        assert native.calls["frame_from_bam"] == 1


def test_route_counts_calls(inputs, tmp_path):
    """A BGZF input takes the native stream; custom tag keys and SAM text
    take the Python decoder, with the same frames as JAX's route."""
    path = inputs["tagged"][0]
    native.reset_calls()
    frames = list(packed.iter_frames_from_bam(path, 250))
    assert native.calls == {"stream_frames": 1, "frame_from_bam": 0, "tagsort": 0,
                            "tagsort_stream_frames": 0}
    for a, b in zip(frames, jax_packed.iter_frames_from_bam(path, 250, want_qname=True)):
        assert_frames_equal(a, b)
    custom = ("CR", "UR", "GE")
    frames = list(packed.iter_frames_from_bam(path, 250, tag_keys=custom))
    for a, b in zip(frames, jax_packed.iter_frames_from_bam(path, 250, tag_keys=custom)):
        assert_frames_equal(a, b)
    records, header = _records(50, seed=2)
    sam = write_bam(tmp_path / "x.sam", records, header, mode="w")
    for a, b in zip(packed.iter_frames_from_bam(sam, 20), jax_packed.iter_frames_from_bam(sam, 20)):
        assert_frames_equal(a, b)
    assert native.calls["stream_frames"] == 1


def _malformed(tmp_path, inputs, kind):
    raw = _raw(inputs["tagged"][0])
    path = tmp_path / "in" / f"{kind}.bam"
    path.parent.mkdir(exist_ok=True)
    if kind == "truncated":  # its last data block cut short, the EOF block gone
        data = open(inputs["level1"][0], "rb").read()
        path.write_bytes(data[: len(data) - len(bgzf.BGZF_EOF) - 10])
    elif kind == "bad-magic":
        _write_level(path, b"BAM\2" + raw[4:], 1)
    elif kind == "gzip-not-bgzf":  # valid for the Python reader, refused natively
        path.write_bytes(gzip.compress(raw))
    return str(path)


def _outcome(call):
    """The frames a call yields, or the class of what it raised."""
    try:
        return list(call())
    except Exception as error:  # the class is what is compared
        return type(error)


@pytest.mark.parametrize("kind", ["truncated", "bad-magic", "gzip-not-bgzf"])
def test_malformed_inputs_fail_like_jax(tmp_path, inputs, kind):
    """Where the native decoder refuses the input at its first batch, the
    route gives the Python reader's records or exception, as JAX's does; a
    later batch's failure raises RuntimeError in both. A failed command
    leaves no output."""
    bad = _malformed(tmp_path, inputs, kind)
    for batch in (100, 1 << 20):
        port, jax = (_outcome(lambda: decode(bad, batch))
                     for decode in (packed.iter_frames_from_bam, jax_packed.iter_frames_from_bam))
        if isinstance(jax, type):
            assert port is jax
        else:
            assert len(port) == len(jax)
            for a, b in zip(port, jax):
                assert_frames_equal(a, b, qname=False)
    if kind == "truncated":  # a whole-file batch fails first; 100 records do not
        assert port is jax is EOFError
        assert _outcome(lambda: packed.iter_frames_from_bam(bad, 100)) is RuntimeError
    for command, flag in (("calculate_cell_metrics", "-i"), ("bam_to_count_matrix", "-b")):
        raised = []
        for entry, kwargs in ((port_platform, {"device": "cpu"}), (jax_platform, {})):
            out = tmp_path / f"{command}_{entry.__name__.split('.')[0]}"
            out.mkdir()
            args = [flag, bad, "-o", str(out / "x")] + (["-a", _gtf(tmp_path)] if flag == "-b" else [])
            raised.append(_outcome(lambda: [getattr(entry.GenericPlatform, command)(args, **kwargs)]))
            if isinstance(raised[-1], type):
                assert not list(out.iterdir())
        assert raised[0] == raised[1] or not isinstance(raised[1], type)


def _gtf(tmp_path):
    path = tmp_path / "genes.gtf"
    if not path.exists():
        write_gtf(str(path), [dict(gene_id=g, gene_name=g) for g in ("G1", "G2", "mt-X")])
    return str(path)


@pytest.mark.parametrize("threads", ["1", "3", "32"])
def test_thread_counts_give_the_same_output(tmp_path, inputs, sort_input, monkeypatch, threads):
    """``SCTOOLS_TPU_THREADS`` sets the decoder's workers and the sort's
    writer threads (1: partials written inline, no asynchronous sink):
    one worker, or more than the cores, give the same frames and the same
    sorted records."""
    monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
    assert native.default_threads() == int(threads)
    path = inputs["tagged"][0]
    port = list(native.stream_frames(path, 300, want_qname=True))
    jax = list(jax_native.stream_frames_native(path, 300, n_threads=1, want_qname=True))
    assert len(port) == len(jax) == 2
    for a, b in zip(port, jax):
        assert_frames_equal(a, b)
    native.tagsort(sort_input, str(tmp_path / "port.bam"), GENE, batch_records=1000)
    jax_native.tagsort_native(sort_input, str(tmp_path / "jax.bam"), GENE, batch_records=1000)
    assert _bodies(tmp_path / "port.bam") == _bodies(tmp_path / "jax.bam")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "bamdecode.cpp").write_text("int broken(\n")
    (tmp_path / "tagsort.cpp").write_text("")
    (tmp_path / "native_io.h").write_text("")
    monkeypatch.setattr(native, "_SOURCE_DIR", tmp_path)
    target = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="building the native layer failed:\n.*error"):
        native._build(target)
    assert not list(tmp_path.glob("lib*"))
    assert native.library_path() != native.library_path().with_name("x")  # hash-named


# ------------------------------------------------------------------ sorting


@pytest.fixture(scope="module")
def sort_input(tmp_path_factory):
    """2,500 records with ties on the tags and the name: 3 partials at the
    native sort's 1,000-record chunk floor."""
    records, header = _records(2500, seed=33)
    return write_bam(tmp_path_factory.mktemp("native_sort") / "in.bam", records, header)


def _bodies(path):
    with bgzf.open_bgzf_reader(str(path)) as fh:
        return read_raw_header(fh), list(iter_raw_records(fh))


ORDERS = [list(p) for p in itertools.permutations(CELL)] + [["CR", "UR", "SR"]]


@pytest.mark.parametrize("chunk", ["1", "100", "unset"])
@pytest.mark.parametrize("tags", ORDERS, ids=["-".join(t) for t in ORDERS])
def test_tagsort_matches_jax(tmp_path, sort_input, tags, chunk):
    """``--records-per-chunk`` 1 and 100 run TagSortBam on both packages
    (both floor the chunk at 1,000: 3 partials); unset, the native sorts
    are called directly with their default chunk (one batch)."""
    port_out, jax_out = tmp_path / "port.bam", tmp_path / "jax.bam"
    native.reset_calls()
    if chunk == "unset":
        assert native.tagsort(sort_input, str(port_out), tags) == 2500
        jax_native.tagsort_native(sort_input, str(jax_out), tags)
    else:
        for entry, out in ((port_platform, port_out), (jax_platform, jax_out)):
            args = ["-i", sort_input, "-o", str(out), "-t", *tags, "--records-per-chunk", chunk]
            assert entry.GenericPlatform.tag_sort_bam(args) == 0
    assert native.calls["tagsort"] == 1
    port, jax = _bodies(port_out), _bodies(jax_out)
    assert port == jax and len(port[1]) == 2500
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.bam", "port.bam"]


@pytest.mark.parametrize("tags,flag", [(CELL, "--cell-metrics-output"), (GENE, "--gene-metrics-output")],
                         ids=["cell", "gene"])
def test_fused_pass_matches_jax_and_cleans_up(tmp_path, sort_input, tags, flag):
    """3 partials merged into the gatherer and teed to ``-o``: the CSV and
    the sorted records equal JAX's, and no partial is left."""
    gtf = _gtf(tmp_path)
    native.reset_calls()
    for side, entry in (("jax", jax_platform), ("port", port_platform)):
        args = ["-i", sort_input, "-t", *tags, flag, str(tmp_path / side), "-a", gtf,
                "-o", str(tmp_path / f"{side}.bam"), "--records-per-chunk", "1000"]
        kwargs = {"device": "cpu"} if entry is port_platform else {}
        assert entry.GenericPlatform.tag_sort_bam(args, **kwargs) == 0
    assert native.calls["tagsort_stream_frames"] == 1 and native.calls["stream_frames"] == 0
    assert_csv_match(str(tmp_path / "port.csv.gz"), str(tmp_path / "jax.csv.gz"))
    assert _bodies(tmp_path / "port.bam") == _bodies(tmp_path / "jax.bam")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "genes.gtf", "jax.bam", "jax.csv.gz", "port.bam", "port.csv.gz"]


def test_fused_stream_closed_early_leaves_nothing(tmp_path):
    """A consumer that stops after one frame closes the pipe: the sort
    fails behind it and removes its partials and the half-written tee. (The
    decoder reads the pipe 16 MiB at a time, so the sorted stream here
    outgrows that: some 90,000 records, 3 partials.)"""
    big = str(tmp_path / "big.bam")
    total = jax_native.synth_bam_native(big, 1400, molecules_per_cell=16, reads_per_molecule=4, seed=9)
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    frames = native.tagsort_stream_frames(
        big, GENE, str(scratch / "partial"), {}, batch_records=1000,
        sort_batch_records=total // 3 + 1, bam_output=str(tmp_path / "sorted.bam"))
    assert next(frames).n_records == 1000
    frames.close()
    assert not list(scratch.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["big.bam", "scratch"]


def test_fused_stream_reports_its_phases(tmp_path, sort_input):
    stats = {}
    frames = list(native.tagsort_stream_frames(
        sort_input, GENE, str(tmp_path / "partial"), stats, sort_batch_records=1000))
    assert sum(f.n_records for f in frames) == 2500
    assert sorted(stats) == ["merge", "partial_files", "partials", "read", "sort"]
    assert stats["partial_files"] == 3
    assert all(value >= 0 for value in stats.values()) and stats["merge"] > 0
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("worker", ["running", "done"])
def test_fused_gatherer_failure_leaves_nothing(tmp_path, sort_input, monkeypatch, worker):
    """The gatherer fails on its first frame, as a device error would: the
    fused TagSortBam raises that error and leaves no CSV, no ``-o`` and no
    scratch directory, whether the sort's worker is still blocked on the
    pipe (frames of 1,000 records out of some 90,000, so the stream outgrows
    the decoder's 16 MiB reads; 3 partials) or has already finished and
    written ``-o`` (2,500 records in one frame)."""
    if worker == "running":
        source = str(tmp_path / "big.bam")
        jax_native.synth_bam_native(source, 1400, molecules_per_cell=16, reads_per_molecule=4, seed=9)
        monkeypatch.setattr(native, "tagsort_stream_frames",
                            functools.partial(native.tagsort_stream_frames, batch_records=1000))
        chunk = "30000"
    else:
        source, chunk = sort_input, "1000"

    def device_lost(self, *args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(MetricGatherer, "_dispatch_device_batch", device_lost)
    out = tmp_path / "out"
    out.mkdir()
    args = ["-i", source, "-t", *CELL, "--cell-metrics-output", str(out / "cell"),
            "-o", str(out / "sorted.bam"), "--records-per-chunk", chunk]
    with pytest.raises(RuntimeError, match="device lost") as failure:
        port_platform.GenericPlatform.tag_sort_bam(args, device="cpu")
    # checked while the traceback, which holds the gatherer's frame, lives
    assert failure.tb is not None and not list(out.iterdir())
