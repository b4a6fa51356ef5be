"""The port's SplitBam (``sctools_tpu_torch.bam.split``) against the JAX package.

Which chunk a barcode lands in depends on the iteration order of a ``set``
of str, so on ``PYTHONHASHSEED``. One subprocess with a pinned seed runs the
JAX ``bam.split`` and then the port's on the same BAMs, each in its own
working directory (the scratch directories go in the CWD), and reports the
chunk names, each chunk's record bodies in order and the barcode -> chunk
map; both must agree, the port's ``CheckBarcodePartition`` must pass on its
chunks, and no scratch directory may be left. The error paths run here, on
both packages alike.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from sctools_tpu import bam as jax_bam
from sctools_tpu import platform as jax_platform
from sctools_tpu_torch import bam as port_bam
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io import bgzf
from sctools_tpu_torch.io.sam import aux_fields, aux_value, iter_raw_records, read_raw_header

from helpers import make_header, make_record, write_bam

REPO = Path(__file__).resolve().parent.parent

_RUN_BOTH = r"""
import hashlib, json, os, sys
from sctools_tpu import bam as jax_bam
from sctools_tpu_torch import bam as port_bam
from sctools_tpu_torch.io import bgzf
from sctools_tpu_torch.io.sam import aux_fields, aux_value, iter_raw_records, read_raw_header

work, cases = sys.argv[1], json.loads(sys.argv[2])
results = []
for case, kwargs in enumerate(cases):
    result = {}
    for side, module in (("jax", jax_bam), ("port", port_bam)):
        os.makedirs(os.path.join(work, str(case), side))
        os.chdir(os.path.join(work, str(case), side))
        module.split(**kwargs)
        chunks = sorted(os.listdir("."))
        bodies, owner = [], {}
        for index, name in enumerate(chunks):
            with bgzf.open_bgzf_reader(name) as fh:
                read_raw_header(fh)
                chunk = list(iter_raw_records(fh))
            bodies.append([hashlib.sha1(body).hexdigest() for body in chunk])
            for body in chunk:
                fields = aux_fields(body)
                if b"CB" in fields:
                    owner[aux_value(body, fields[b"CB"])] = index
        result[side] = dict(chunks=chunks, bodies=bodies, owner=owner)
    results.append(result)
print(json.dumps(results))
"""
TAG_CASES = (["CB"], ["CB", "CR"])
HASH_SEED = 12345


@pytest.fixture(scope="module")
def split_both(tmp_path_factory):
    """Both packages' ``split`` of the same three BAMs into 4 chunks with 2
    workers and ``raise_missing=False``, for each of TAG_CASES, in one
    subprocess with PYTHONHASHSEED pinned: (work dir, inputs, results)."""
    tmp_path = tmp_path_factory.mktemp("split")
    paths = _inputs(tmp_path)
    size_mb = sum(os.path.getsize(p) for p in paths) * 1e-6
    cases = [dict(in_bams=paths, out_prefix="chunk", tags=tags, approx_mb_per_split=size_mb / 4,
                  raise_missing=False, num_processes=2) for tags in TAG_CASES]
    env = dict(os.environ, PYTHONHASHSEED=str(HASH_SEED), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run(
        [sys.executable, "-c", _RUN_BOTH, str(tmp_path / "work"), json.dumps(cases)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    return tmp_path / "work", paths, json.loads(done.stdout.strip().splitlines()[-1])


def _inputs(tmp_path, n_files=3, n_cells=40, per_file=120, missing=0):
    """BAMs over a shared cell pool, CB on most records and CR as the
    second tag on all; the last ``missing`` records of each file carry
    neither."""
    header = make_header()
    paths = []
    for f in range(n_files):
        records = []
        for i in range(per_file):
            cell = f"CELL{(i * 7 + f * 13) % n_cells:03d}ACGT"
            records.append(make_record(
                name=f"f{f}q{i:04d}", cb=None if i % 9 == 0 else cell, cr=cell, ub="ACGTAC",
                ge="G1", pos=i, header=header))
        for i in range(missing):
            records.append(make_record(name=f"f{f}m{i}", ub="ACGTAC", header=header))
        paths.append(write_bam(tmp_path / f"in{f}.bam", records, header))
    return paths


@pytest.mark.parametrize("case", range(len(TAG_CASES)), ids=["cb", "cb-then-cr"])
def test_split_matches_jax_under_one_hash_seed(split_both, case):
    work, paths, results = split_both
    tags = TAG_CASES[case]
    jax, port = results[case]["jax"], results[case]["port"]
    assert port == jax
    assert port["chunks"] == [f"chunk_{i}.bam" for i in range(4)]
    chunks = [str(work / str(case) / "port" / name) for name in port["chunks"]]
    assert port_platform.GenericPlatform.check_barcode_partition(["-b", *chunks]) == 0
    n_in = sum(len(_bodies(p)) for p in paths)
    n_out = sum(len(bodies) for bodies in port["bodies"])
    dropped = sum(1 for p in paths for body in _bodies(p) if not _has_any(body, tags))
    assert n_out == n_in - dropped and (dropped > 0) == (tags == ["CB"])
    assert sorted(os.listdir(work / str(case) / "port")) == port["chunks"]  # no scratch left


def _bodies(path):
    with bgzf.open_bgzf_reader(path) as fh:
        read_raw_header(fh)
        return list(iter_raw_records(fh))


def _has_any(body, tags):
    fields = aux_fields(body)
    return any(tag.encode() in fields for tag in tags)


def test_split_prints_the_chunks(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    paths = _inputs(tmp_path, n_files=1)
    assert port_platform.GenericPlatform.split_bam(
        ["-b", *paths, "-p", "out", "-t", "CB", "CR", "--num-processes", "1"]) == 0
    printed = capsys.readouterr().out.split()
    assert printed == [os.path.realpath("out_0.bam")]
    # every barcode in one chunk: CB where present, else CR
    (chunk,) = printed
    values = {aux_value(b, aux_fields(b).get(b"CB") or aux_fields(b)[b"CR"]) for b in _bodies(chunk)}
    assert len(_bodies(chunk)) == 120 and len(values) == 40
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in0.bam", "out_0.bam"]


def test_missing_tag_raises_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = _inputs(tmp_path, n_files=1, missing=1)
    for module in (jax_bam, port_bam):
        with pytest.raises(RuntimeError, match=r"missing \['CB', 'CR'\] tag"):
            module.split(paths, "x", ["CB", "CR"], num_processes=1)
    # the scan fails first: no scratch directory was made
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in0.bam"]


def test_drop_missing_matches_jax_count(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = _inputs(tmp_path, n_files=1, missing=5)
    counts = []
    for module in (jax_bam, port_bam):
        out = module.split(paths, str(tmp_path / module.__name__.split(".")[0]), ["CB", "CR"],
                           raise_missing=False, num_processes=1)
        counts.append(sum(len(_bodies(p)) for p in out))
    assert counts == [120, 120]


@pytest.mark.parametrize("module", [jax_bam, port_bam], ids=["jax", "port"])
def test_empty_tags_and_subfile_guard(tmp_path, module):
    with pytest.raises(ValueError, match="At least one tag must be passed"):
        module.split([str(tmp_path / "a.bam")], "x", [])
    big = tmp_path / "big.bam"
    big.write_bytes(b"\0" * 2_000_000)
    with pytest.raises(ValueError, match=r"Number of requested subfiles \(2000\) exceeds 1000"):
        module.split([str(big)], "x", ["CB"], approx_mb_per_split=0.001)


def test_split_bam_cli_without_tags_fails_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = _inputs(tmp_path, n_files=1)
    for entry in (jax_platform, port_platform):
        with pytest.raises(ValueError, match="At least one tag"):
            entry.GenericPlatform.split_bam(["-b", *paths, "-p", "x"])


@pytest.mark.parametrize(
    "sequence,quality",
    [
        ("ACGTN", [30, 31, 32, 33, 2]),                     # odd length
        ("acgtnRYKMSWBDHV=", list(range(16))),              # lowercase, every IUPAC code
        ("AC.GT X\tZ", [0, 93, 255, 300, 1000, 7, 8, 9, 10]),  # unknown bases, qualities past 255
        ("ACGÅ€", None),                                     # characters past ASCII and past one byte
        ("", None),
        ("G" * 99, bytes(range(99))),
    ],
)
def test_record_bytes_equal_jax(sequence, quality):
    """The record encoder that SplitBam, the object sort route and attach's
    Python loop write through: the JAX package's bytes on edge cases."""
    from sctools_tpu.io.sam import BamRecord as JaxRecord
    from sctools_tpu_torch.io.sam import BamRecord as PortRecord

    fields = dict(query_name="r1", flag=16, reference_id=0, pos=7, cigar=[(0, len(sequence))],
                  sequence=sequence, quality=quality, tags={"CB": ("Z", "AAAC"), "NH": ("i", 2)})
    assert PortRecord(**fields).to_bam_bytes() == JaxRecord(**fields).to_bam_bytes()


def test_split_rewrites_raw_records_as_jax(tmp_path, monkeypatch):
    """The port's scatter copies records undecoded; the bins' merge must
    still write JAX's decode-and-re-encode bytes. Input records carry what a
    re-encode changes (a nonzero bin field, an odd sequence's nonzero pad
    nibble, a repeated tag) and what it keeps (every aux type, a sequence
    with no qualities)."""
    from sctools_tpu_torch.io.sam import AlignmentReader, AlignmentWriter

    header = make_header()
    records = [
        make_record(name=f"q{i:03d}", cb=f"CELL{i % 5}", ub="ACGTAC", ge="G1", nh=i % 3 + 1, pos=i,
                    sequence="ACGTN"[: i % 5 + 1] * 3, quality=None if i % 4 == 0 else [30 + i % 9] * (3 * (i % 5 + 1)),
                    header=header)
        for i in range(60)
    ]
    for i, record in enumerate(records):
        record.set_tag("XA", "A" if i % 2 else "z", "A")
        record.set_tag("XF", 0.25 * i, "f")
        record.set_tag("XB", ("s", [i, -i, 7]), "B")
    plain = write_bam(tmp_path / "plain.bam", records, header)
    raw = str(tmp_path / "raw.bam")
    with AlignmentReader(plain, "rb") as reader, AlignmentWriter(raw, reader.header, "wb") as writer:
        for i, body in enumerate(reader.raw_records()):
            body = bytearray(body)
            body[10:12] = (4681 + i).to_bytes(2, "little")  # bin
            l_read_name, n_cigar = body[8], int.from_bytes(body[12:14], "little")
            l_seq = int.from_bytes(body[16:20], "little")
            if l_seq % 2:  # the pad nibble after an odd sequence's last base
                body[32 + l_read_name + 4 * n_cigar + l_seq // 2] |= 0x7
            if i % 3 == 0:  # a repeated tag: the last value wins, at the first's place
                body += b"NHC" + bytes([9])
            writer.write_body(bytes(body))
    chunks = {}
    for side, module in (("jax", jax_bam), ("port", port_bam)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        (out,) = module.split([raw], "chunk", ["CB"], approx_mb_per_split=100.0, num_processes=1)
        chunks[side] = _bodies(out)
    assert len(chunks["port"]) == 60
    assert chunks["port"] == chunks["jax"]
    assert chunks["port"] != _bodies(raw)
