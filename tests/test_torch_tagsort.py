"""The port's TagSortBam and VerifyBamSort against the JAX package, on the CPU.

The same BAMs, made from a ``random`` seed through ``tests/helpers.py``, go
through ``sctools_tpu.platform`` and ``sctools_tpu_torch.platform``. The
sorted outputs are compared as decompressed record bodies, in order (the two
packages' BGZF writers differ, and JAX's own routes write at different
levels); every input holds ties on the whole key (paired mates, duplicates
and multi-mappers under one name and one tag triple), so stable order is
checked on every route. Each test names the JAX route it follows:

- in memory: ``bam.sort_by_tags_and_queryname`` over decoded records;
- the native route: three string tags on a BGZF input, sorted by
  ``native.tagsort_native`` (``--records-per-chunk``) or streamed into the
  metrics gatherer by ``native.tagsort_stream_frames`` (the fused pass);
  the port's copy of that sort (``sctools_tpu_torch.native``), whose
  partial count follows ``--records-per-chunk`` floored at 1,000 records;
- the Python route: ``tagsort.tag_sort_bam_out_of_core``'s chunked sort and
  heap merge over decoded records (other tags, a file named ``.sam``), and
  the fused pass's two-pass fallback through it, which the port's single
  raw pass matches.

The fused CSVs are compared as ``test_torch_metrics.py`` compares the
metrics CSVs: byte for byte but for the six ``*_variance`` columns, held to
rtol 1e-6.
"""

from __future__ import annotations

import gzip
import random

import pytest

from sctools_tpu import bam as jax_bam
from sctools_tpu import platform as jax_platform
from sctools_tpu_torch import bam as port_bam
from sctools_tpu_torch import native
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch import tagsort as port_tagsort
from sctools_tpu_torch.io import bgzf
from sctools_tpu_torch.io.sam import aux_fields, iter_raw_records, read_raw_header

from helpers import make_header, make_record, write_bam, write_gtf
from test_torch_metrics import assert_csv_match

CELL, GENE = ["CB", "UB", "GE"], ["GE", "CB", "UB"]


def _messy_records(n: int, seed: int):
    """``n`` tagged records in random order: missing CB / UB / GE, unmapped
    reads without XF and NH, and every tenth record followed by 1-3 copies
    under its name and tags (mates, duplicates, multi-mappers) at other
    positions and flags."""
    rng = random.Random(seed)
    header = make_header()
    cells = ["".join(rng.choice("ACGT") for _ in range(8)) for _ in range(12)]
    records = []
    while len(records) < n:
        unmapped = rng.random() < 0.1
        fields = dict(
            name=f"q{rng.randrange(5000):05d}",
            cb=rng.choice(cells + [None]), cr=rng.choice(cells), cy="IIIIIIII",
            ub=rng.choice(["".join(rng.choice("ACGT") for _ in range(6)), None, "AAAAAA"]),
            ur="ACGTAC", uy="IIIIII",
            ge=rng.choice(["G1", "G2", "mt-X", None]),
            xf=None if unmapped else rng.choice(["CODING", "INTRONIC", "UTR", "INTERGENIC"]),
            nh=None if unmapped else rng.choice([1, 2]),
            unmapped=unmapped, header=header,
        )
        copies = 1 + (rng.randrange(1, 4) if len(records) % 10 == 0 else 0)
        for _ in range(copies):
            records.append(make_record(
                pos=rng.randrange(100000), duplicate=rng.random() < 0.2,
                spliced=rng.random() < 0.3, reverse=rng.random() < 0.5, **fields))
    return records[:n], header


@pytest.fixture(scope="module")
def messy_bam(tmp_path_factory):
    records, header = _messy_records(600, seed=7)
    return write_bam(tmp_path_factory.mktemp("tagsort") / "messy.bam", records, header)


@pytest.fixture(scope="module")
def large_messy_bam(tmp_path_factory):
    """Large enough for the native sort's 1,000-record chunk floor to make
    partials."""
    records, header = _messy_records(2600, seed=11)
    return write_bam(tmp_path_factory.mktemp("tagsort_large") / "messy.bam", records, header)


@pytest.fixture(scope="module")
def mito_gtf(tmp_path_factory):
    path = tmp_path_factory.mktemp("tagsort_gtf") / "mito.gtf"
    return write_gtf(str(path), [dict(gene_id="G1", gene_name="G1"),
                                 dict(gene_id="mt-X", gene_name="mt-X")])


def _bodies(path):
    """(raw header, record bodies in order) of a BAM, decompressed."""
    with bgzf.open_bgzf_reader(str(path)) as fh:
        return read_raw_header(fh), list(iter_raw_records(fh))


def _sort_both(tmp_path, bam, tags, extra=()):
    """Run TagSortBam on both packages; returns the port's (header, bodies)
    after asserting they equal JAX's."""
    out = {}
    for side, entry in (("jax", jax_platform), ("port", port_platform)):
        path = str(tmp_path / f"{side}_sorted.bam")
        assert entry.GenericPlatform.tag_sort_bam(["-i", bam, "-o", path, "-t", *tags, *extra]) == 0
        out[side] = _bodies(path)
    assert out["port"] == out["jax"]
    return out["port"]


def test_in_memory_matches_jax(tmp_path, messy_bam):
    """JAX route: in memory (no --records-per-chunk); missing tags first."""
    header, bodies = _sort_both(tmp_path, messy_bam, CELL)
    assert len(bodies) == 600 and header == _bodies(messy_bam)[0]
    assert b"CB" not in aux_fields(bodies[0])


@pytest.mark.parametrize("chunk,partials", [(5000, 0), (2600, 0), (2599, 2), (1000, 3), (37, 3)])
def test_out_of_core_matches_jax(tmp_path, large_messy_bam, chunk, partials):
    """JAX route: native (``tagsort_native``); the port's native sort with
    1 chunk (no partials), a full chunk at EOF, 2 and 3 partials, and a
    chunk below the 1,000-record floor. A sort that makes partials fails,
    and leaves nothing, when its first partial's path is taken."""
    native.reset_calls()
    _sort_both(tmp_path, large_messy_bam, CELL, ["--records-per-chunk", str(chunk)])
    assert native.calls["tagsort"] == 1
    assert [p.name for p in tmp_path.iterdir() if "partial" in p.name] == []
    out = tmp_path / "blocked.bam"
    (tmp_path / "blocked.bam.tagsort_partial_0").mkdir()
    args = ["-i", large_messy_bam, "-o", str(out), "-t", *CELL, "--records-per-chunk", str(chunk)]
    if partials:
        with pytest.raises(RuntimeError, match="cannot open"):
            port_platform.GenericPlatform.tag_sort_bam(args)
        assert not out.exists()
    else:
        assert port_platform.GenericPlatform.tag_sort_bam(args) == 0
        assert _bodies(out) == _bodies(tmp_path / "port_sorted.bam")


def test_gene_order_matches_jax(tmp_path, messy_bam):
    """JAX route: native, GE CB UB (and CR UR SR, all string tags)."""
    _sort_both(tmp_path, messy_bam, GENE, ["--records-per-chunk", "100"])
    _sort_both(tmp_path, messy_bam, ["CR", "UR", "SR"], ["--records-per-chunk", "100"])


def test_nh_key_orders_numerically(tmp_path):
    """JAX route: Python (``-t NH``, an integer tag): 2 < 10 numerically."""
    header = make_header()
    records = [make_record(name=f"r{i}", cb="AAAA", nh=nh, header=header)
               for i, nh in enumerate([10, 2, 1, 2, 10, 3])]
    bam = write_bam(tmp_path / "nh.bam", records, header)
    for extra in ([], ["--records-per-chunk", "2"]):
        _, bodies = _sort_both(tmp_path, bam, ["NH"], extra)
        names = [body[32:34] for body in bodies]
        assert names == [b"r2", b"r1", b"r3", b"r5", b"r0", b"r4"]


def test_nh_key_with_a_missing_tag_fails_like_jax(tmp_path):
    """JAX route: Python; a missing NH sorts as "" against ints: TypeError."""
    header = make_header()
    records = [make_record(name="a", nh=1, header=header), make_record(name="b", header=header)]
    bam = write_bam(tmp_path / "nh.bam", records, header)
    for entry in (jax_platform, port_platform):
        with pytest.raises(TypeError):
            entry.GenericPlatform.tag_sort_bam(["-i", bam, "-o", str(tmp_path / "o.bam"), "-t", "NH"])


def test_bam_named_sam_takes_the_python_route(tmp_path, messy_bam):
    """JAX route: Python (a BGZF BAM whose name ends in ``.sam`` is kept off
    the native route by its name)."""
    named_sam = tmp_path / "renamed.sam"
    named_sam.write_bytes(open(messy_bam, "rb").read())
    assert not port_tagsort.raw_route(str(named_sam), CELL)
    _sort_both(tmp_path, str(named_sam), CELL, ["--records-per-chunk", "150"])


@pytest.mark.parametrize(
    "extra", [[], ["--records-per-chunk", "5"], ["--cell-metrics-output", "m"]],
    ids=["in-memory", "python", "fused"])
def test_sam_text_fails_like_jax(tmp_path, extra, monkeypatch):
    """JAX routes: in memory, Python, and the fused pass's two-pass
    fallback; all read the input as BAM, so a SAM text input raises gzip's
    error, and the fused pass leaves nothing behind."""
    monkeypatch.chdir(tmp_path)
    header = make_header()
    sam = write_bam(tmp_path / "x.sam", [make_record(name="a", cb="AC", header=header)], header, mode="w")
    for entry in (jax_platform, port_platform):
        kwargs = {"device": "cpu"} if entry is port_platform else {}
        with pytest.raises(gzip.BadGzipFile):
            entry.GenericPlatform.tag_sort_bam(
                ["-i", sam, "-o", str(tmp_path / "o.bam"), "-t", *CELL, *extra], **kwargs)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["x.sam"]


def test_sort_key_skips_every_aux_type(tmp_path):
    """The native key walks past A c C s S i I f H B fields, and an integer
    value keys as its decimal digits: the port's sort of such records equals
    JAX's native sort. A record cut inside its last field fails both."""
    from sctools_tpu.native import tagsort_native as jax_tagsort
    from sctools_tpu_torch.io.sam import BamRecord

    header = make_header()
    bodies = []
    for i, (cb, ge) in enumerate([("ACGT", 42), ("ACGT", 7), ("AAXA", 100), ("", -5), ("ACGT", 42)]):
        tags = {
            "XA": ("A", "x"), "Xc": ("c", -3), "XC": ("C", 200), "Xs": ("s", -300),
            "XS": ("S", 60000), "Xi": ("i", -70000), "XI": ("I", 3000000000), "Xf": ("f", 1.5),
            "XH": ("H", "BEEF"), "XB": ("B", ("s", [1, -2, 3])), "Xb": ("B", ("f", [0.5])),
            "GE": ("i", ge),
        }
        if cb:
            tags["CB"] = ("Z", cb)
        record = BamRecord(query_name=f"q{4 - i}", sequence="ACGT", quality=[30] * 4, tags=tags)
        bodies.append(record.to_bam_bytes()[4:])
    raw_header = _bodies(write_bam(tmp_path / "h.bam", [], header))[0]

    def write(path, records):
        with bgzf.BgzfWriter(str(path)) as out:
            out.write(raw_header + b"".join(len(b).to_bytes(4, "little") + b for b in records))
        return str(path)

    good = write(tmp_path / "types.bam", bodies)
    sorted_sides = []
    for sort in (jax_tagsort, native.tagsort):
        out = str(tmp_path / f"{len(sorted_sides)}.bam")
        assert sort(good, out, ["CB", "GE", "UB"]) == 5
        sorted_sides.append(_bodies(out)[1])
    assert sorted_sides[1] == sorted_sides[0]
    # "" < "AAXA" < "ACGT", then "42" < "7" as digits, then the query name
    assert [b[32:34] for b in sorted_sides[1]] == [b"q1", b"q2", b"q0", b"q4", b"q3"]
    cut = write(tmp_path / "cut.bam", bodies[:-1] + [bodies[-1][:-3]])
    for sort in (jax_tagsort, native.tagsort):
        with pytest.raises(RuntimeError, match="malformed aux tags"):
            sort(cut, str(tmp_path / "cut_sorted.bam"), ["CB", "GE", "UB"])
        assert not (tmp_path / "cut_sorted.bam").exists()


def test_raw_header_parses_as_the_reader_does(tmp_path, messy_bam):
    """The native sort keeps the input's raw header bytes: the sorted BAM
    reads back with the same text and references as the JAX package's
    reader gives for the input."""
    from sctools_tpu.io.sam import AlignmentReader as JaxReader
    from sctools_tpu_torch.io.sam import AlignmentReader

    out = str(tmp_path / "sorted.bam")
    native.tagsort(messy_bam, out, CELL, compress_level=1)
    with AlignmentReader(out) as port, JaxReader(messy_bam, "rb") as jax:
        assert (port.header.text, port.header.references) == (jax.header.text, jax.header.references)
        assert port.header.references and port.header.text.startswith("@HD")


def test_cli_errors_match_jax(tmp_path, messy_bam, capsys):
    cases = [
        ["-i", messy_bam, "-t", *CELL],  # no -o without a metrics output
        ["-i", messy_bam, "-o", str(tmp_path / "o.bam"), "-t", *CELL, "--devices", "2"],
        ["-i", messy_bam, "-t", *GENE, "--cell-metrics-output", str(tmp_path / "m")],
        ["-i", messy_bam, "-t", *CELL, "--gene-metrics-output", str(tmp_path / "m")],
        ["-i", messy_bam, "-t", *CELL, "--cell-metrics-output", "a", "--gene-metrics-output", "b"],
    ]
    for args in cases:
        errors = []
        for entry in (jax_platform, port_platform):
            with pytest.raises(SystemExit) as stop:
                entry.GenericPlatform.tag_sort_bam(args, **({"device": "cpu"} if entry is port_platform else {}))
            assert stop.value.code == 2
            errors.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errors[1] == errors[0]
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------- fused pass


@pytest.mark.parametrize("tags,flag", [(CELL, "--cell-metrics-output"), (GENE, "--gene-metrics-output")],
                         ids=["cell", "gene"])
@pytest.mark.parametrize("with_bam", [True, False], ids=["with-o", "without-o"])
def test_fused_matches_jax(tmp_path, messy_bam, mito_gtf, tags, flag, with_bam):
    """JAX route: native (``tagsort_stream_frames`` into the device
    gatherer); the port's copy of it into its gatherer."""
    sorted_bodies = {}
    for side, entry in (("jax", jax_platform), ("port", port_platform)):
        args = ["-i", messy_bam, "-t", *tags, flag, str(tmp_path / side), "-a", mito_gtf,
                "--records-per-chunk", "250"]
        if with_bam:
            args += ["-o", str(tmp_path / f"{side}.bam")]
        kwargs = {"device": "cpu"} if entry is port_platform else {}
        assert entry.GenericPlatform.tag_sort_bam(args, **kwargs) == 0
        if with_bam:
            sorted_bodies[side] = _bodies(tmp_path / f"{side}.bam")
    assert_csv_match(str(tmp_path / "port.csv.gz"), str(tmp_path / "jax.csv.gz"))
    assert sorted_bodies.get("port") == sorted_bodies.get("jax")
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == sorted(["jax.csv.gz", "port.csv.gz"] + (["jax.bam", "port.bam"] if with_bam else []))


def test_fused_bam_named_sam_takes_one_pass(tmp_path, messy_bam, monkeypatch):
    """JAX route: the two-pass fallback (a Python sort to a temporary BAM,
    then the gatherer), on a BGZF BAM named ``.sam``; the port sorts it in
    its single raw pass, with the same CSV and sorted records."""
    named_sam = tmp_path / "renamed.sam"
    named_sam.write_bytes(open(messy_bam, "rb").read())
    for side, entry in (("jax", jax_platform), ("port", port_platform)):
        kwargs = {"device": "cpu"} if entry is port_platform else {}
        if entry is port_platform:
            monkeypatch.setattr(port_tagsort, "tag_sort_bam_out_of_core", None)  # no second pass
        entry.GenericPlatform.tag_sort_bam(
            ["-i", str(named_sam), "-t", *CELL, "--cell-metrics-output", str(tmp_path / side),
             "-o", str(tmp_path / f"{side}.bam"), "--records-per-chunk", "250"], **kwargs)
    assert_csv_match(str(tmp_path / "port.csv.gz"), str(tmp_path / "jax.csv.gz"))
    assert _bodies(tmp_path / "port.bam") == _bodies(tmp_path / "jax.bam")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax.bam", "jax.csv.gz", "port.bam", "port.csv.gz", "renamed.sam"]


@pytest.mark.parametrize("cut", ["truncated", "bad-aux"])
def test_fused_failure_leaves_nothing(tmp_path, messy_bam, cut):
    """A truncated input or a malformed aux field fails the pass with
    RuntimeError, as the JAX native route does, and leaves no CSV, no
    sorted BAM and no partials."""
    bad = tmp_path / "in" / "bad.bam"
    bad.parent.mkdir()
    if cut == "truncated":
        data = open(messy_bam, "rb").read()
        bad.write_bytes(data[: len(data) // 2])
    else:
        header, bodies = _bodies(messy_bam)
        i = next(i for i in range(450, 600) if bodies[i][-7:-5] == b"NH")
        body = bytearray(bodies[i])
        body[-5] = ord("Q")  # the type byte of its last field, NH: no such type
        bodies[i] = bytes(body)
        with bgzf.BgzfWriter(str(bad)) as out:
            out.write(header + b"".join(len(b).to_bytes(4, "little") + b for b in bodies))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    for entry in (jax_platform, port_platform):
        kwargs = {"device": "cpu"} if entry is port_platform else {}
        with pytest.raises(RuntimeError):
            entry.GenericPlatform.tag_sort_bam(
                ["-i", str(bad), "-t", *CELL, "--cell-metrics-output", str(out_dir / "broken"),
                 "-o", str(out_dir / "sorted.bam"), "--records-per-chunk", "100"], **kwargs)
        assert not list(out_dir.iterdir())


def test_fused_default_device_needs_a_gpu(tmp_path, messy_bam):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the failure without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_platform.GenericPlatform.tag_sort_bam(
            ["-i", messy_bam, "-t", *CELL, "--cell-metrics-output", str(tmp_path / "m")])
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------ VerifyBamSort


def _verify_inputs(tmp_path, tags):
    """An unsorted BAM and its JAX in-memory sort, every record with NH."""
    records, header = _messy_records(200, seed=3)
    for record in records:
        record.set_tag("NH", record.tags.get("NH", ("i", 0))[1], "i")
    bam = write_bam(tmp_path / "in.bam", records, header)
    sorted_bam = str(tmp_path / "sorted.bam")
    jax_platform.GenericPlatform.tag_sort_bam(["-i", bam, "-o", sorted_bam, "-t", *tags])
    return bam, sorted_bam


@pytest.mark.parametrize("tags", [CELL, GENE], ids=["cell", "gene"])
def test_verify_matches_jax(tmp_path, capsys, tags):
    bam, sorted_bam = _verify_inputs(tmp_path, tags)
    outputs = []
    for entry in (jax_platform, port_platform):
        assert entry.GenericPlatform.verify_bam_sort(["-i", sorted_bam, "-t", *tags]) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] and "is correctly sorted" in outputs[0]
    messages = []
    for entry, error in ((jax_platform, jax_bam.SortError), (port_platform, port_bam.SortError)):
        with pytest.raises(error) as raised:
            entry.GenericPlatform.verify_bam_sort(["-i", bam, "-t", *tags])
        messages.append(str(raised.value))
    assert messages[1] == messages[0] and "TagSortableRecord(tags:" in messages[0]


def test_verify_integer_tag_fails_like_jax(tmp_path):
    """The check starts from an all-"" sentinel, so an integer tag (NH)
    cannot be compared with it: TypeError in both, as typed values reach
    the comparison the same way."""
    _, sorted_bam = _verify_inputs(tmp_path, ["NH"])
    for entry in (jax_platform, port_platform):
        with pytest.raises(TypeError):
            entry.GenericPlatform.verify_bam_sort(["-i", sorted_bam, "-t", "NH"])
