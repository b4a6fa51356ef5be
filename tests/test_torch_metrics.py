"""The port's metrics path against the JAX package, on the CPU.

The same inputs, made from a ``random`` or numpy seed through
``tests/helpers.py``, go through ``sctools_tpu`` (JAX on the CPU) and through
``sctools_tpu_torch`` with ``device="cpu"``:

- every ported primitive of ``ops/segments.py``, on int32 keys with
  INT32_MAX pads and negatives and on int32/float32 [N] and [N, C] columns,
  at N = 1, a power of two and a non-power;
- the packed frame (``frame_from_records``), every ``_pad_columns`` schema
  and the ``_pack_wire`` block;
- ``compute_entity_metrics`` on one padded dict per case, then
  ``compact_results_wire``;
- the ``CalculateCellMetrics`` / ``CalculateGeneMetrics`` CSVs, on
  test_metrics' seeds and on the streaming cases of test_streaming;
- the mitochondrial gene set of ``-a``, and the CLI surface.

Bit equality is the rule, floats included, with one named exception: the
sample-variance columns (``*_variance``). XLA's CPU backend always allows
LLVM to contract a multiply into a following add (a fused multiply-add), and
for some records, depending on how XLA fuses the stride loop, it does so
with the JAX engine's ``centered * centered`` products and the first adds of
the scan over them. The port computes the product and the adds as separate
IEEE operations in the source's order, so those columns may differ from the
JAX ones in their last bits: by at most 3 float32 ulps (a relative 1.95e-7)
on this file's inputs. Their terms are non-negative squares, so the
contraction's error stays relative to the total; they are held to rtol 1e-6
(8 to 16 ulps) with no absolute slack, and every other column, the means
included, is compared bit for bit. The card tests (``test_torch_cuda.py``) hold the port's CUDA
results to its CPU results bit for bit in every column.
"""

from __future__ import annotations

import gzip
import random

import numpy as np
import pytest
import torch

from sctools_tpu import gtf as jax_gtf
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.io import packed as jax_packed
from sctools_tpu.metrics import device as jax_device
from sctools_tpu.metrics import gatherer as jax_gatherer
from sctools_tpu.ops import segments as jax_seg
from sctools_tpu_torch import gtf as port_gtf
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io import packed as port_packed
from sctools_tpu_torch.metrics import device as port_device
from sctools_tpu_torch.metrics import gatherer as port_gatherer
from sctools_tpu_torch.metrics import schema as port_schema
from sctools_tpu_torch.ops import segments as port_seg

from helpers import make_header, make_record, write_bam, write_gtf
from test_metrics import MITO_GENES, random_tagged_records

I32_MAX = np.iinfo(np.int32).max
VARIANCE_RTOL = 1e-6  # for *_variance only: FMA contraction (module docstring)
CELL_TAGS, GENE_TAGS = ["CB", "UB", "GE"], ["GE", "CB", "UB"]


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array))  # a copy: JAX's arrays are read-only


def _assert_same(name, port, jax_value, tolerant=False):
    a, b = _np(port), _np(jax_value)
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    if tolerant:
        np.testing.assert_allclose(a, b, rtol=VARIANCE_RTOL, atol=0, equal_nan=True, err_msg=name)
    else:
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name


# ------------------------------------------------------------------ segments


def _key_columns(rng, n, n_keys=3):
    """int32 keys with few distinct values (long runs), negatives, and
    INT32_MAX pads at the end."""
    keys = [np.sort(rng.integers(-3, 4, n)).astype(np.int32)]
    keys += [rng.integers(-2, 3, n).astype(np.int32) for _ in range(n_keys - 1)]
    n_pad = n // 5
    for key in keys:
        if n_pad:
            key[-n_pad:] = I32_MAX
    return keys


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_segment_primitives_match_jax(n):
    rng = np.random.default_rng(n)
    keys = _key_columns(rng, n)
    f1 = (rng.standard_normal(n) * 7).astype(np.float32)
    f2 = (rng.standard_normal((n, 3)) * 7).astype(np.float32)
    i1 = rng.integers(-50, 50, n).astype(np.int32)
    i2 = rng.integers(-50, 50, (n, 4)).astype(np.int32)
    tk = [_t(k) for k in keys]

    _assert_same("sort_permutation", port_seg.sort_permutation(tk), jax_seg.sort_permutation(keys))
    (pk, pv), (jk, jv) = port_seg.lexsort(tk, [_t(f1), _t(i1)]), jax_seg.lexsort(keys, [f1, i1])
    for name, a, b in zip(("k0", "k1", "k2", "f1", "i1"), pk + pv, list(jk) + list(jv)):
        _assert_same(f"lexsort {name}", a, b)

    # run structure on the sorted keys, and on unsorted flags
    sorted_keys = [np.asarray(k) for k in jk]
    starts = jax_seg.run_starts(sorted_keys)
    _assert_same("run_starts", port_seg.run_starts([_t(k) for k in sorted_keys]), starts)
    flags = rng.random(n) < 0.3
    for name, jax_starts in (("sorted", np.asarray(starts)), ("random", flags)):
        ts = _t(jax_starts)
        _assert_same(f"segment_ids {name}", port_seg.segment_ids_from_starts(ts),
                     jax_seg.segment_ids_from_starts(jax_starts))
        _assert_same(f"singleton {name}", port_seg.run_is_singleton(ts), jax_seg.run_is_singleton(jax_starts))
        _assert_same(f"plural {name}", port_seg.run_is_plural(ts), jax_seg.run_is_plural(jax_starts))
        for cname, col in (("f1", f1), ("f2", f2), ("i1", i1), ("i2", i2)):
            _assert_same(f"scan_sum {name} {cname}", port_seg.segmented_scan_sum(_t(col), ts),
                         jax_seg.segmented_scan_sum(col, jax_starts))
        for cname, col in (("i1", i1), ("i2", i2)):
            _assert_same(f"scan_min {name} {cname}", port_seg.segmented_scan_min(_t(col), ts),
                         jax_seg.segmented_scan_min(col, jax_starts))
        pb, jb = port_seg.RunBounds(ts), jax_seg.RunBounds(jax_starts)
        for attr in ("start_pos", "next_pos", "used"):
            _assert_same(f"RunBounds.{attr} {name}", getattr(pb, attr), getattr(jb, attr))
        for cname, col in (("f2", f2), ("i1", i1), ("i2", i2)):
            _assert_same(f"RunBounds.sum {name} {cname}", pb.sum(_t(col)), jb.sum(col))
        _assert_same(f"RunBounds.first {name}", pb.first(_t(i1), I32_MAX), jb.first(i1, I32_MAX))
        _assert_same(f"RunBounds.min {name}", pb.min(_t(i1), -7), jb.min(i1, -7))


def test_bucket_helpers_match_jax():
    for n in [0, 1, 63, 64, 65, 4095, 4096, 4097, 100_000, 1 << 20, (1 << 20) + 1]:
        assert port_seg.bucket_size(n) == jax_seg.bucket_size(n)
        assert port_seg.bucket_size(n, minimum=8) == jax_seg.bucket_size(n, minimum=8)
        assert port_seg.entity_bucket(n, 1 << 16) == jax_seg.entity_bucket(n, 1 << 16)
        assert port_seg.pad_to(n, 128) == jax_seg.pad_to(n, 128)
    assert port_seg.RECORD_BUCKET_MIN == jax_seg.RECORD_BUCKET_MIN
    assert port_seg.ENTITY_BUCKET_MIN == jax_seg.ENTITY_BUCKET_MIN


# -------------------------------------------------------------- packed frame


def _sorted_bam(tmp_path, name, records, header, tags):
    records = list(sort_by_tags_and_queryname(records, tags))
    return write_bam(tmp_path / f"{name}.bam", records, header)


def _wide_records(seed=5, n_cells=6, n_refs=200):
    """Long aligned windows (> 255 bases) on a header of ``n_refs``
    references: the wide genomic lanes and, past 127 references, the int32
    m_ref lane."""
    rng = random.Random(seed)
    header = make_header(references=[(f"chr{i}", 10_000_000) for i in range(n_refs)])
    cells = sorted("".join(rng.choice("ACGT") for _ in range(8)) for _ in range(n_cells))
    records = []
    for cb in cells:
        for i in range(6):
            records.append(make_record(
                name=f"{cb}{i}", cb=cb, cr=cb, cy="IIII",
                ub="".join(rng.choice("ACGT") for _ in range(4)), ur="ACGT", uy="IIII",
                ge=rng.choice(["G1", "G2"]), xf="CODING", nh=1, pos=rng.randrange(1000),
                reference_id=rng.randrange(n_refs), sequence="ACGT" * 80, header=header,
            ))
    return records, header


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(port frame, JAX frame, kind) per BAM: random_tagged_records seed 0
    sorted for each axis, and the wide records."""
    tmp = tmp_path_factory.mktemp("torch_metrics_frames")
    records, header = random_tagged_records(seed=0)
    wide, wide_header = _wide_records()
    out = {}
    for name, recs, hdr, kind in (
        ("cell", records, header, "cell"),
        ("gene", records, header, "gene"),
        ("wide", wide, wide_header, "cell"),
    ):
        bam = _sorted_bam(tmp, name, recs, hdr, CELL_TAGS if kind == "cell" else GENE_TAGS)
        out[name] = (port_packed.frame_from_bam(bam), jax_packed.frame_from_bam(bam), kind)
    return out


def test_frame_from_records_matches_jax(frames):
    for port_frame, jax_frame, _ in frames.values():
        for field in port_packed._PER_RECORD_FIELDS:
            _assert_same(field, getattr(port_frame, field), getattr(jax_frame, field))
            assert getattr(port_frame, field).dtype == getattr(jax_frame, field).dtype, field
        for field in port_packed._CODED_FIELDS:
            assert getattr(port_frame, f"{field}_names") == getattr(jax_frame, f"{field}_names")
        for view in ("umi_frac30", "cb_frac30", "genomic_frac30", "genomic_mean"):
            _assert_same(view, getattr(port_frame, view), getattr(jax_frame, view))


def _run_starts(frame):
    starts = np.ones(frame.n_records, dtype=bool)
    starts[1:] = (
        (frame.cell[1:] != frame.cell[:-1])
        | (frame.gene[1:] != frame.gene[:-1])
        | (frame.umi[1:] != frame.umi[:-1])
    )
    return starts


def _pad_kwargs(frame, kind, schema):
    """``_pad_columns`` keyword arguments of one schema case."""
    if schema == "plain":
        return {}
    kwargs = dict(
        prepacked_keys=("cell", "gene", "umi") if kind == "cell" else ("gene", "cell", "umi"),
        pair_mito=kind == "cell", include_cb=kind == "cell",
        small_ref=schema in ("runkeyed", "small_ref"),
    )
    if schema == "runkeyed":
        starts = _run_starts(frame)
        kwargs.update(run_keys_bucket=port_seg.bucket_size(int(starts.sum())), run_starts=starts)
    return kwargs


def _is_mito(frame):
    return np.asarray([name in MITO_GENES for name in frame.gene_names], dtype=bool)


@pytest.mark.parametrize("case", [
    ("cell", "plain"), ("cell", "dense"), ("cell", "runkeyed"), ("cell", "small_ref"),
    ("wide", "dense"), ("gene", "plain"), ("gene", "runkeyed"),
])
def test_pad_columns_and_wire_match_jax(frames, case):
    name, schema = case
    port_frame, jax_frame, kind = frames[name]
    port_cols, port_flags = port_gatherer._pad_columns(
        port_frame, _is_mito(port_frame), **_pad_kwargs(port_frame, kind, schema))
    jax_cols, jax_flags = jax_gatherer._pad_columns(
        jax_frame, _is_mito(jax_frame), **_pad_kwargs(jax_frame, kind, schema))
    assert port_flags == jax_flags
    assert list(port_cols) == list(jax_cols)
    for col in port_cols:
        assert port_cols[col].dtype == jax_cols[col].dtype, col
        _assert_same(col, port_cols[col], jax_cols[col])
    if schema != "plain":
        _assert_same("wire", port_gatherer._pack_wire(port_cols, port_flags),
                     jax_gatherer._pack_wire(jax_cols, jax_flags))
    if name == "wide":
        assert port_flags["wide_genomic"] and not port_flags["small_ref"]


# -------------------------------------------------------------------- engine

# (frame, kind, schema, transport): transport "wire" packs the prepacked
# columns into the one int32 block, "dict" ships them as named columns
ENGINE_CASES = [
    ("cell", "cell", "runkeyed", "wire"),
    ("cell", "cell", "dense", "wire"),
    ("cell", "cell", "small_ref", "dict"),
    ("wide", "cell", "dense", "wire"),
    ("cell", "cell", "plain", "presorted"),
    ("cell", "cell", "plain", "unsorted"),
    ("gene", "gene", "runkeyed", "wire"),
    ("gene", "gene", "plain", "presorted"),
]


def _engine_inputs(frames, case):
    name, kind, schema, transport = case
    frame = frames[name][0]
    cols, flags = port_gatherer._pad_columns(frame, _is_mito(frame), **_pad_kwargs(frame, kind, schema))
    n = len(cols["flags"])
    presorted = transport != "unsorted"
    if transport == "wire":
        cols = {"wire": port_gatherer._pack_wire(cols, flags)}
    elif transport == "unsorted":
        # records (and pads) in a random order: the engine sorts them first
        perm = np.random.default_rng(9).permutation(n)
        cols = {key: value[perm] for key, value in cols.items()}
    kwargs = dict(num_segments=n, kind=kind, presorted=presorted, prepacked=schema != "plain", **flags)
    return cols, kwargs


@pytest.mark.parametrize("case", ENGINE_CASES, ids=["-".join(c) for c in ENGINE_CASES])
def test_engine_matches_jax(frames, case):
    cols, kwargs = _engine_inputs(frames, case)
    port = port_device.compute_entity_metrics({k: _t(v) for k, v in cols.items()}, **kwargs)
    jax_result = jax_device.compute_entity_metrics(dict(cols), **kwargs)
    assert set(port) == set(jax_result)
    assert int(port["n_entities"]) == int(jax_result["n_entities"]) > 1
    for key in port:
        _assert_same(key, port[key], jax_result[key], tolerant=key.endswith("_variance"))

    # the compaction alone, bit for bit: both packages compact the same result
    columns = port_schema.CELL_COLUMNS if kwargs["kind"] == "cell" else port_schema.GENE_COLUMNS
    int_names, float_names = port_gatherer.wire_result_names(columns)
    assert (int_names, float_names) == jax_gatherer.wire_result_names(columns)
    same = {key: _np(value) for key, value in jax_result.items()}
    k = port_seg.entity_bucket(int(port["n_entities"]), kwargs["num_segments"])
    block = port_device.compact_results_wire({k_: _t(v) for k_, v in same.items()}, int_names, float_names, k)
    _assert_same("compact_results_wire", block,
                 jax_device.compact_results_wire(same, int_names, float_names, k))
    assert block.dtype == torch.int32 and block.shape == (len(int_names) + len(float_names), k)
    for name, port_part, jax_part in zip(
        ("ints", "floats"),
        port_device.compact_results({k_: _t(v) for k_, v in same.items()}, int_names, float_names, k),
        jax_device.compact_results(same, int_names, float_names, k),
    ):
        _assert_same(f"compact_results {name}", port_part, jax_part)


def test_wire_block_views_back_without_copy():
    int_names, float_names = port_gatherer.wire_result_names(port_schema.CELL_COLUMNS)
    block = np.arange((len(int_names) + len(float_names)) * 128, dtype=np.int32).reshape(-1, 128)
    captured = {}

    class _Spy(port_gatherer.GatherCellMetrics):
        def _write_device_rows(self, names, n, ints_names, flts_names, ints, floats, out):
            captured.update(ints=ints, floats=floats)

    _Spy.__new__(_Spy)._do_finalize_device_batch(["e"], block, 1, int_names, float_names, out=None)
    assert np.shares_memory(captured["ints"], block) and np.shares_memory(captured["floats"], block)
    assert captured["floats"].dtype == np.float32


# ----------------------------------------------------------------------- CLI


def _csv(path) -> bytes:
    with gzip.open(str(path), "rb") as f:
        return f.read()


def assert_csv_match(port_path, jax_path):
    """Decompressed CSVs equal byte for byte, but for the *_variance fields,
    which match within VARIANCE_RTOL (see the module docstring)."""
    port_lines = _csv(port_path).decode().split("\n")
    jax_lines = _csv(jax_path).decode().split("\n")
    assert port_lines[0] == jax_lines[0] and len(port_lines) == len(jax_lines)
    header = port_lines[0].split(",")
    variance = [i for i, column in enumerate(header) if column.endswith("_variance")]
    for port_line, jax_line in zip(port_lines[1:], jax_lines[1:]):
        if port_line == jax_line:
            continue
        a, b = port_line.split(","), jax_line.split(",")
        assert [f for i, f in enumerate(a) if i not in variance] == [
            f for i, f in enumerate(b) if i not in variance
        ], f"{port_line!r} != {jax_line!r}"
        np.testing.assert_allclose(
            [float(a[i]) for i in variance], [float(b[i]) for i in variance],
            rtol=VARIANCE_RTOL, atol=0, equal_nan=True, err_msg=port_line,
        )


@pytest.fixture(scope="module")
def mito_gtf(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_metrics_gtf") / "mito.gtf"
    return write_gtf(str(path), [
        dict(gene_id="ACTB", gene_name="ACTB"),
        dict(gene_id="mt-Nd1", gene_name="mt-Nd1"),
        dict(gene_id="GAPDH", gene_name="GAPDH"),
    ])


@pytest.mark.parametrize("kind,seed", [("cell", 0), ("cell", 1), ("cell", 2), ("gene", 0), ("gene", 3)])
def test_cli_csv_matches_jax(tmp_path, mito_gtf, kind, seed):
    records, header = random_tagged_records(seed=seed)
    bam = _sorted_bam(tmp_path, "in", records, header, CELL_TAGS if kind == "cell" else GENE_TAGS)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    extra = ["-a", mito_gtf] if kind == "cell" else []
    entry = f"calculate_{kind}_metrics"
    assert getattr(port_platform.GenericPlatform, entry)(["-i", bam, "-o", port_out] + extra, device="cpu") == 0
    getattr(jax_platform.GenericPlatform, entry)(["-i", bam, "-o", jax_out, "--backend", "device"] + extra)
    assert_csv_match(port_out + ".csv.gz", jax_out + ".csv.gz")
    lines = _csv(port_out + ".csv.gz").decode().strip().split("\n")
    assert len(lines[0].split(",")) == (36 if kind == "cell" else 27)
    if kind == "gene":
        assert not any(line.split(",")[0] == "ACTB,GAPDH" or line.startswith('"') for line in lines)
        assert "ACTB" in {line.split(",")[0] for line in lines}


def _both(tmp_path, name, bam, kind="cell", **kwargs):
    """Run the port and the JAX gatherer on ``bam``; returns (port gatherer,
    port csv path, JAX csv path)."""
    port_cls = port_gatherer.GatherCellMetrics if kind == "cell" else port_gatherer.GatherGeneMetrics
    jax_cls = jax_gatherer.GatherCellMetrics if kind == "cell" else jax_gatherer.GatherGeneMetrics
    port_out, jax_out = tmp_path / f"{name}_port.csv.gz", tmp_path / f"{name}_jax.csv.gz"
    gatherer = port_cls(bam, str(port_out), device="cpu", **kwargs)
    gatherer.extract_metrics()
    jax_cls(bam, str(jax_out), backend="device", **kwargs).extract_metrics()
    assert_csv_match(port_out, jax_out)
    return gatherer, port_out, jax_out


def test_batch_size_invariance_matches_jax(tmp_path):
    records, header = random_tagged_records(seed=4, n_records=300, n_cells=9)
    bam = _sorted_bam(tmp_path, "inv", records, header, CELL_TAGS)
    _, whole, _ = _both(tmp_path, "whole", bam)
    for batch_records in (7, 64, 1000):
        gatherer, batched, _ = _both(tmp_path, f"b{batch_records}", bam, batch_records=batch_records)
        assert _csv(batched) == _csv(whole)
        # the last cell always goes as the carried tail
        assert (len(gatherer.batches) == 2) == (batch_records == 1000)


def test_entity_larger_than_batch_matches_jax(tmp_path):
    records = [
        make_record(name=f"a{i}", cb="AAAA", cr="AAAA", ub="CCCC", ur="CCCC", uy="IIII",
                    ge="G1", xf="CODING", nh=1, pos=100 + i)
        for i in range(50)
    ] + [
        make_record(name=f"b{i}", cb="TTTT", cr="TTTT", ub="GGGG", ur="GGGG", uy="IIII",
                    ge="G2", xf="CODING", nh=1, pos=500 + i)
        for i in range(3)
    ]
    bam = write_bam(str(tmp_path / "big.bam"), records)
    _, batched, _ = _both(tmp_path, "big", bam, batch_records=8)
    lines = _csv(batched).decode().strip().split("\n")
    assert len(lines) == 3 and lines[1].startswith("AAAA,50")


def test_grouped_but_descending_matches_jax(tmp_path):
    records = [
        make_record(name=f"{cb}_{i}", cb=cb, cr=cb, cy="IIII", ub=f"CC{'AG'[i % 2]}C",
                    ur=f"CC{'AG'[i % 2]}C", uy="IIII", ge="G1", xf="CODING", nh=1, pos=100 + i)
        for cb in ("TTTT", "GGGG", "AAAA")
        for i in range(6)
    ]
    bam = write_bam(str(tmp_path / "desc.bam"), records)
    gatherer, _, _ = _both(tmp_path, "desc", bam)
    # the first two cells go device-sorted; the last one is the tail
    assert [b["presorted"] for b in gatherer.batches] == [False, True]


def test_wide_genomic_ratchet_matches_jax(tmp_path):
    rng = random.Random(11)
    cells = sorted("".join(rng.choice("ACGT") for _ in range(8)) for _ in range(9))
    records = [
        make_record(name=f"{cb}{i}", cb=cb, cr=cb, cy="IIII",
                    ub="".join(rng.choice("ACGT") for _ in range(4)), ur="ACGT", uy="IIII",
                    ge=rng.choice(["G1", "G2"]), xf="CODING", nh=1, pos=rng.randrange(1000),
                    sequence="ACGT" * (80 if idx == 0 else 20))
        for idx, cb in enumerate(cells)
        for i in range(6)
    ]
    bam = write_bam(str(tmp_path / "ratchet.bam"), records)
    gatherer, _, _ = _both(tmp_path, "ratchet", bam, batch_records=8)
    assert len(gatherer.batches) > 2 and gatherer._wide_genomic


def test_run_keyed_wire_matches_jax(tmp_path):
    rng = random.Random(17)
    cells = sorted("".join(rng.choice("ACGT") for _ in range(8)) for _ in range(700))
    records = []
    for cb in cells:
        for ub in sorted("".join(rng.choice("ACGT") for _ in range(6)) for _ in range(3)):
            ge = rng.choice(["G1", "G2"])
            records += [
                make_record(name=f"{cb}{ub}{i}", cb=cb, cr=cb, cy="IIII", ub=ub, ur=ub,
                            uy="IIII", ge=ge, xf="CODING", nh=1, pos=rng.randrange(1000))
                for i in range(3)
            ]
    assert len(records) > 4096
    bam = write_bam(str(tmp_path / "rk.bam"), records)
    gatherer, whole, _ = _both(tmp_path, "rk", bam)
    assert gatherer.run_keyed_batches >= 1
    assert gatherer.batches[0]["prepacked"] and gatherer.batches[0]["run_keyed"]
    batched_gatherer, batched, _ = _both(tmp_path, "rk4097", bam, batch_records=4097)
    assert _csv(batched) == _csv(whole) and len(batched_gatherer.batches) >= 2


def test_failed_batch_publishes_nothing(tmp_path, monkeypatch):
    records = [
        make_record(name=f"e{i}", cb="AAAA" if i < 5 else "TTTT", ub="CCCC", ur="CCCC",
                    uy="IIII", ge="G1", xf="CODING", nh=1, pos=i)
        for i in range(10)
    ]
    bam = write_bam(str(tmp_path / "fail.bam"), records)
    out = tmp_path / "partial.csv.gz"

    def boom(*args, **kwargs):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(port_device, "compute_entity_metrics", boom)
    with pytest.raises(RuntimeError, match="injected"):
        port_gatherer.GatherCellMetrics(bam, str(out), device="cpu").extract_metrics()
    assert not out.exists() and not list(tmp_path.glob("partial.csv.gz.inflight.*"))


# ------------------------------------------------------- mitochondrial genes


@pytest.mark.parametrize("genes", [
    [dict(gene_id="ACTB", gene_name="ACTB"), dict(gene_id="mt-Nd1", gene_name="mt-Nd1")],
    [dict(gene_id="ENSG1", gene_name="MT-CO1"), dict(gene_id="ENSG2", gene_name="mt-Co2"),
     dict(gene_id="ENSG3", gene_name="Mt-x"), dict(gene_id="ENSG4", gene_name="MTX1"),
     dict(gene_id="ENSG5", gene_name="ACTB")],
    [dict(gene_id="ENSG1", gene_name="MT-ND1"), dict(gene_id="ENSG1", gene_name="MT-ND1"),
     dict(gene_id="ENSG2", gene_name="MT-ND1"), dict(gene_id="ENSG3", gene_name="GAPDH"),
     dict(gene_id="ENSG9", gene_name="MT-ATP8", feature="exon")],
], ids=["mt-lower", "mixed-case", "duplicate-rows"])
def test_mitochondrial_gene_names_match_jax(tmp_path, genes):
    path = write_gtf(str(tmp_path / "g.gtf"), genes)
    got = port_gtf.get_mitochondrial_gene_names(path)
    assert got == jax_gtf.get_mitochondrial_gene_names(path) and got


def test_mitochondrial_gene_names_need_gene_name(tmp_path):
    path = tmp_path / "bad.gtf"
    path.write_text('chr1\tt\tgene\t1\t10\t.\t+\t.\tgene_id "X";\n')
    for module in (port_gtf, jax_gtf):
        with pytest.raises(ValueError, match="gene_name"):
            module.get_mitochondrial_gene_names(str(path))


# ------------------------------------------------------------------ surface


@pytest.mark.parametrize("entry", ["calculate_cell_metrics", "calculate_gene_metrics"])
@pytest.mark.parametrize("option", [["--backend", "cpu"], ["--devices", "2"]])
def test_unported_options_stop_at_the_parser(tmp_path, capsys, entry, option):
    with pytest.raises(SystemExit) as stop:
        getattr(port_platform.GenericPlatform, entry)(
            ["-i", "missing.bam", "-o", str(tmp_path / "o")] + option, device="cpu")
    assert stop.value.code == 2
    assert "ROADMAP queue 1" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a GPU")
    records, header = random_tagged_records(seed=0, n_records=20)
    bam = _sorted_bam(tmp_path, "x", records, header, CELL_TAGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_platform.GenericPlatform.calculate_cell_metrics(["-i", bam, "-o", str(tmp_path / "o")])
    assert not list(tmp_path.glob("o.csv*"))
