"""The port's ingest ring against the JAX package's, on the CPU.

``sctools_tpu_torch.ingest`` is the port's copy of ``sctools_tpu.ingest``'s
ring: a prefetch thread (``utils.prefetch.prefetch_iterator``) decodes BAM
batches into recycled packed column arenas (``ingest.arena``) through the
native stream (``native.NativeBatchStream``). The same BAMs, made from a
``random`` seed through ``tests/helpers.py``, go through both packages:

- the arena ABI: sizes, and the bytes of every section for the same batch,
  equal JAX's; the prepacked ``flags`` and ``ps`` equal the host packers';
  in-place padding writes the ``PAD_FILLS`` sentinels;
- the ring's frames equal ``native.stream_frames``' and JAX's ring's, with
  and without query names; SAM text and custom tag keys take the Python
  decoder behind the same queue; a failure at the head of the file falls
  back to it, one mid-stream raises at its batch and never falls back;
  an abandoned or failed ring leaves no thread and no open stream;
- the frame witness (``SCTOOLS_TPU_FRAME_DEBUG=1``) catches a stale read;
- ``prefetch_iterator``'s contract, as ``tests/test_prefetch.py`` holds
  JAX's, and the ``SCTOOLS_TPU_PREFETCH_DEPTH`` window;
- the cell, gene and count outputs equal JAX's at prefetch depths 1 and 2
  under the witness, with batches small enough that every slot is reused
  many times: the consumers keep to the ring's retention window. Each
  command reads through ``ingest.ring_frames`` (``native.calls``). The
  tolerances are test_torch_metrics': bit for bit, but the ``*_variance``
  columns at rtol 1e-6.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import pytest

from sctools_tpu import count as jax_count
from sctools_tpu import ingest as jax_ingest
from sctools_tpu import native as jax_native
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.ingest import arena as jax_arena
from sctools_tpu.metrics import gatherer as jax_gatherer
from sctools_tpu_torch import count as port_count
from sctools_tpu_torch import ingest, native
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.ingest import arena, framedebug, ring
from sctools_tpu_torch.io import packed
from sctools_tpu_torch.metrics import gatherer as port_gatherer
from sctools_tpu_torch.utils.prefetch import prefetch_depth, prefetch_iterator

from helpers import write_bam, write_gtf
from test_count import GENE_TO_INDEX, SyntheticCountData
from test_metrics import MITO_GENES, random_tagged_records
from test_torch_count import _assert_same_matrix
from test_torch_metrics import assert_csv_match
from test_torch_native import _records, assert_frames_equal

I32_MAX = np.iinfo(np.int32).max
CELL_TAGS, GENE_TAGS = ["CB", "UB", "GE"], ["GE", "CB", "UB"]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "sctools-prefetch" and t.is_alive()]


def _wait_for(predicate, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


@pytest.fixture(autouse=True)
def no_thread_left():
    """Every test leaves no prefetch thread behind."""
    yield
    assert _wait_for(lambda: not _prefetch_threads()), _prefetch_threads()


@pytest.fixture(scope="module")
def tagged(tmp_path_factory):
    """600 records of every kind the decoder branches on (test_torch_native's)."""
    records, header = _records(600, seed=21)
    return write_bam(tmp_path_factory.mktemp("ingest") / "tagged.bam", records, header)


@pytest.fixture(scope="module")
def sorted_bams(tmp_path_factory):
    """random_tagged_records sorted for each metrics axis: 900 records."""
    root = tmp_path_factory.mktemp("ingest_sorted")
    records, header = random_tagged_records(seed=8, n_records=900, n_cells=12)
    return {
        kind: write_bam(root / f"{kind}.bam", list(sort_by_tags_and_queryname(records, tags)), header)
        for kind, tags in (("cell", CELL_TAGS), ("gene", GENE_TAGS))
    }


# ------------------------------------------------------------- arena ABI


@pytest.mark.parametrize("capacity", [64, 4096, 1 << 16, 1 << 20])
def test_arena_sizes_match_jax(capacity):
    sizes = {native.arena_nbytes(capacity), arena.arena_nbytes(capacity),
             jax_native.arena_nbytes(capacity), jax_arena.arena_nbytes(capacity)}
    assert sizes == {53 * capacity}
    assert arena.ARENA_SPEC == jax_arena.ARENA_SPEC


@pytest.mark.parametrize("capacity", [0, 65, -64])
def test_arena_refuses_a_capacity_off_the_grid(capacity):
    with pytest.raises(ValueError):
        native.arena_nbytes(capacity)
    with pytest.raises(ValueError):
        arena.arena_nbytes(capacity)
    assert arena.arena_capacity(65) == 128 and arena.arena_capacity(64) == 64


def _fill(stream_cls, arena_cls, capacity_of, path, batch, want_qname):
    """The first batch of ``path`` in an arena, and its vocabularies."""
    with stream_cls(path, want_qname=want_qname) as stream:
        n = stream.next(batch)
        slot = arena_cls(capacity_of(n))
        assert slot.fill(stream) == n
        names = {name: stream.vocab(name) for name in ("cell", "umi", "gene", "qname")}
    return slot, n, names


@pytest.mark.parametrize("want_qname", [True, False], ids=["qname", "no-qname"])
@pytest.mark.parametrize("batch", [7, 1000])
def test_arena_bytes_match_jax_in_every_section(tagged, want_qname, batch):
    port, n, port_names = _fill(native.NativeBatchStream, arena.ColumnArena, arena.arena_capacity,
                                tagged, batch, want_qname)
    jax, m, jax_names = _fill(jax_native.NativeBatchStream, jax_arena.ColumnArena,
                              jax_arena.arena_capacity, tagged, batch, want_qname)
    assert n == m == min(batch, 600) and port.capacity == jax.capacity
    for name, dtype in arena.ARENA_SPEC:
        a, b = port.column(name)[:n], jax.column(name)[:n]
        assert a.dtype == b.dtype == np.dtype(dtype), name
        assert a.tobytes() == b.tobytes(), name
    assert port_names == jax_names


def test_arena_prepacked_columns_equal_the_host_packers(tagged):
    slot, n, _ = _fill(native.NativeBatchStream, arena.ColumnArena, arena.arena_capacity,
                       tagged, 1000, True)
    python = packed._python_frames(tagged, 1000, packed.DEFAULT_TAG_KEYS)
    frame = next(python)
    python.close()
    assert frame.n_records == n
    want_flags = packed.pack_flags(frame.strand, frame.unmapped, frame.duplicate, frame.spliced,
                                   frame.xf, frame.perfect_umi, frame.perfect_cb, frame.nh,
                                   np.zeros(n, dtype=bool))
    assert np.array_equal(slot.column("flags")[:n], want_flags)
    want_ps = (frame.pos.astype(np.int32) << 1) | frame.strand.astype(np.int32)
    assert np.array_equal(slot.column("ps")[:n], want_ps)


def test_pad_in_place_writes_the_sentinels(tagged):
    slot, n, _ = _fill(native.NativeBatchStream, arena.ColumnArena, lambda n: arena.arena_capacity(n + 100),
                       tagged, 1000, False)
    slot.pad_in_place(n, slot.capacity)
    for name, _ in arena.ARENA_SPEC:
        assert np.all(slot.column(name)[n:] == packed.PAD_FILLS.get(name, 0)), name
    assert np.all(slot.column("nh")[n:] == -1) and np.all(slot.column("ps")[n:] == I32_MAX)
    with pytest.raises(ValueError):
        slot.pad_in_place(n, slot.capacity + 1)


# ------------------------------------------------------------------ ring


def _copies(frames):
    """Every frame copied as it arrives: ring frames view recycled slots."""
    return [packed.copy_frame(frame) for frame in frames]


@pytest.mark.parametrize("want_qname", [True, False], ids=["qname", "no-qname"])
@pytest.mark.parametrize("batch", [7, 64, 100000])
def test_ring_frames_match_the_stream_and_jax(tagged, want_qname, batch):
    native.reset_calls()
    got = _copies(ingest.ring_frames(tagged, batch, want_qname=want_qname))
    assert native.calls["batch_stream"] == 1 and native.calls["stream_frames"] == 0
    stream = list(native.stream_frames(tagged, batch, want_qname=want_qname))
    jax = _copies(jax_ingest.ring_frames(tagged, batch, want_qname=want_qname))
    assert [f.n_records for f in got] == [f.n_records for f in stream] == [f.n_records for f in jax]
    for a, b, c in zip(got, stream, jax):
        assert_frames_equal(a, b, qname=want_qname)
        assert_frames_equal(a, c, qname=want_qname)
        assert sorted(a.extras) == sorted(c.extras) == ["flags", "ps"]
        for key in a.extras:
            assert a.extras[key].dtype == c.extras[key].dtype and np.array_equal(a.extras[key], c.extras[key])


def test_fallback_for_sam_text_and_custom_tag_keys(tmp_path, tagged):
    """Python-decoded frames behind the same queue, as JAX's ring gives them."""
    records, header = _records(600, seed=21)
    sam = write_bam(tmp_path / "in.sam", records, header, mode="w")
    custom = ("CR", "UR", "GE")
    native.reset_calls()
    for path, keys in ((sam, None), (tagged, custom)):
        got = _copies(ingest.ring_frames(path, 100, tag_keys=keys))
        jax = _copies(jax_ingest.ring_frames(path, 100, tag_keys=keys))
        assert len(got) == len(jax) == 6
        for a, b in zip(got, jax):
            assert_frames_equal(a, b)
            assert a.extras == {}
    assert native.calls["batch_stream"] == 0


def test_ring_needs_one_input():
    with pytest.raises(ValueError, match="not both"):
        ingest.ring_frames("x.bam", source=iter(()))
    with pytest.raises(ValueError, match="needs"):
        ingest.ring_frames()
    with pytest.raises(ValueError, match="batch_records"):
        ingest.ring_frames("x.bam", 0)


class _Spy:
    """Wraps NativeBatchStream: counts opens, closes and ``next`` calls, and
    raises from the ``dies_at``-th ``next`` on."""

    def __init__(self, monkeypatch, dies_at=None):
        self.opened = self.closed = self.calls = 0
        real_init, real_next, real_close = (native.NativeBatchStream.__init__,
                                            native.NativeBatchStream.next, native.NativeBatchStream.close)
        spy = self

        def init(stream, *args, **kwargs):
            real_init(stream, *args, **kwargs)
            spy.opened += 1

        def next_batch(stream, max_records):
            spy.calls += 1
            if dies_at is not None and spy.calls >= dies_at:
                raise RuntimeError("injected decoder death")
            return real_next(stream, max_records)

        def close(stream):
            if stream._handle is not None:
                spy.closed += 1
            real_close(stream)

        monkeypatch.setattr(native.NativeBatchStream, "__init__", init)
        monkeypatch.setattr(native.NativeBatchStream, "next", next_batch)
        monkeypatch.setattr(native.NativeBatchStream, "close", close)


def _no_python_decoder(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("the Python decoder ran")

    monkeypatch.setattr(ring, "_python_frames", refused)


def test_midstream_failure_raises_at_the_failed_batch(tagged, monkeypatch):
    spy = _Spy(monkeypatch, dies_at=3)
    _no_python_decoder(monkeypatch)
    delivered = 0
    with pytest.raises(ingest.NativeDecodeError, match="injected decoder death") as info:
        for _ in ingest.ring_frames(tagged, 16):
            delivered += 1
    assert delivered == 2 and info.value.batch_index == 2 and info.value.record_offset == 32
    assert "batch_index=2, record_offset~=32" in str(info.value)  # the guard's message, as JAX's
    assert spy.opened == spy.closed == 1


def test_head_failure_falls_back_to_the_python_decoder(tagged, monkeypatch):
    spy = _Spy(monkeypatch, dies_at=1)
    got = _copies(ingest.ring_frames(tagged, 100))
    python = list(packed._python_frames(tagged, 100, packed.DEFAULT_TAG_KEYS))
    assert len(got) == len(python) == 6 and spy.opened == spy.closed == 1
    for a, b in zip(got, python):
        assert_frames_equal(a, b)
        assert a.extras == {}


@pytest.mark.parametrize("taken", [0, 1, 3])
def test_abandoned_ring_closes_the_stream_and_joins_the_thread(tagged, monkeypatch, taken):
    spy = _Spy(monkeypatch)
    frames = ingest.ring_frames(tagged, 16)
    for _ in range(taken):
        next(frames)
    frames.close()
    assert not _prefetch_threads()
    assert spy.opened == spy.closed == (1 if taken else 0)


def test_a_source_is_closed_when_the_ring_is():
    closed = threading.Event()

    def source():
        try:
            while True:
                yield packed.ReadFrame(**_empty_frame_kwargs())
        finally:
            closed.set()

    stats = {}
    frames = ingest.ring_frames(source=source(), stats=stats)
    next(frames)
    frames.close()
    assert closed.is_set() and not _prefetch_threads() and stats["batches"] >= 1


def _empty_frame_kwargs():
    kwargs = {name: np.zeros(1, np.int32) for name in packed._PER_RECORD_FIELDS}
    kwargs.update({f"{name}_names": [""] for name in packed._CODED_FIELDS})
    return kwargs


def test_frame_witness_catches_a_stale_read(tagged, monkeypatch):
    monkeypatch.setenv(framedebug.ENV_FLAG, "1")
    framedebug.reset()
    monkeypatch.setenv("SCTOOLS_TPU_PREFETCH_DEPTH", "1")
    frames = ingest.ring_frames(tagged, 16)
    first = next(frames)
    assert isinstance(first, framedebug.WitnessFrame)
    view, copy = packed.slice_frame(first, 0, 8), packed.copy_frame(first)
    kept = first.cell.copy()
    for _ in frames:  # every slot is refilled
        pass
    for stale in (first, view):
        with pytest.raises(framedebug.StaleFrameError, match="retention window"):
            stale.cell  # noqa: B018
    assert np.array_equal(copy.cell, kept) and type(copy) is packed.ReadFrame
    assert first.cell_names == copy.cell_names  # vocabularies are owned, unchecked
    assert len(framedebug.violations()) == 2 and framedebug.stamped_count() >= 30
    framedebug.reset()


def test_reclaim_poisons_the_slot(monkeypatch):
    monkeypatch.setenv(framedebug.ENV_FLAG, "1")
    slot = arena.ColumnArena(64)
    slot.reclaim()
    assert slot.generation == 1 and np.all(slot.buf == framedebug.POISON_BYTE)
    monkeypatch.delenv(framedebug.ENV_FLAG)
    plain = arena.ColumnArena(64)
    plain.buf[:] = 0
    plain.reclaim()
    assert plain.generation == 1 and not plain.buf.any()


def test_padder_gives_the_same_bytes_with_and_without_extras(tagged):
    """A carry without extras (Python-decoded, or concatenated with one)
    makes the padder derive flags and ps: the same columns either way."""
    arena_frame = _copies(ingest.ring_frames(tagged, 1000))[0]
    plain = packed.ReadFrame(**{k: v for k, v in vars(arena_frame).items() if k != "extras"})
    python = next(packed._python_frames(tagged, 1000, packed.DEFAULT_TAG_KEYS))
    assert arena_frame.extras and not plain.extras and not python.extras
    assert not packed.concat_frames(python, arena_frame).extras
    is_mito = np.array(["mt" in name for name in arena_frame.gene_names])
    for keys in (None, ("cell", "gene", "umi")):
        results = [port_gatherer._pad_columns(f, is_mito, pad_to=1024, prepacked_keys=keys, pair_mito=True)
                   for f in (arena_frame, plain)]
        (cols_a, flags_a), (cols_b, flags_b) = results
        assert flags_a == flags_b and list(cols_a) == list(cols_b)
        for name in cols_a:
            assert cols_a[name].tobytes() == cols_b[name].tobytes(), name


# --------------------------------------------------------------- prefetch


def _order():
    assert list(prefetch_iterator(iter(range(100)), depth=3)) == list(range(100))


def _error_at_the_failed_item():
    def source():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    it = prefetch_iterator(source())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def _immediate_error_promptly():
    def source():
        raise ValueError("bad header")
        yield  # pragma: no cover

    start = time.perf_counter()
    with pytest.raises(ValueError, match="bad header"):
        next(prefetch_iterator(source()))
    assert time.perf_counter() - start < 5.0


def _error_with_a_full_queue():
    def source():
        yield from range(4)
        raise OSError("stream truncated")

    received = []
    with pytest.raises(OSError, match="stream truncated"):
        for item in prefetch_iterator(source(), depth=1):
            received.append(item)
    assert received == list(range(4))


def _abandonment_closes_the_source():
    closed = threading.Event()

    def source():
        try:
            yield from range(1_000_000)
        finally:
            closed.set()

    it = prefetch_iterator(source(), depth=2)
    assert next(it) == 0
    it.close()
    assert closed.wait(timeout=10.0) and not _prefetch_threads()


def _break_closes_the_source():
    closed = threading.Event()

    def source():
        try:
            while True:
                yield 42
        finally:
            closed.set()

    for index, item in enumerate(prefetch_iterator(source(), depth=2)):
        assert item == 42
        if index == 3:
            break
    gc.collect()
    assert closed.wait(timeout=10.0)


def _backpressure():
    produced = []

    def source():
        for i in range(50):
            produced.append(i)
            yield i

    it = prefetch_iterator(source(), depth=2)
    assert next(it) == 0
    time.sleep(0.3)
    assert len(produced) <= 2 + 2  # depth + in-flight slack
    assert list(it) == list(range(1, 50))


def _empty():
    assert list(prefetch_iterator(iter(()))) == []


def _keyboard_interrupt():
    class Stop(KeyboardInterrupt):
        pass

    def source():
        yield 1
        raise Stop()

    it = prefetch_iterator(source())
    assert next(it) == 1
    with pytest.raises(KeyboardInterrupt):
        next(it)


PREFETCH_CASES = [_order, _error_at_the_failed_item, _immediate_error_promptly, _error_with_a_full_queue,
                  _abandonment_closes_the_source, _break_closes_the_source, _backpressure, _empty,
                  _keyboard_interrupt]


@pytest.mark.parametrize("case", PREFETCH_CASES, ids=[c.__name__.strip("_") for c in PREFETCH_CASES])
def test_prefetch_iterator(case):
    case()


@pytest.mark.parametrize("value,want", [(None, 2), ("1", 1), ("64", 64), ("0", 2), ("65", 2), ("x", 2)])
def test_prefetch_depth_window(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("SCTOOLS_TPU_PREFETCH_DEPTH", raising=False)
    else:
        monkeypatch.setenv("SCTOOLS_TPU_PREFETCH_DEPTH", value)
    assert prefetch_depth() == want and ingest.prefetch_depth() == want
    assert ingest.ring_slots() == want + 3 == jax_ingest.ring_slots()


# --------------------------------------------------------- the commands


@pytest.fixture
def ring_calls(monkeypatch):
    """The calls of ``ingest.ring_frames``: 'path' or 'source' each."""
    calls = []
    real = ingest.ring_frames

    def counted(*args, **kwargs):
        calls.append("source" if kwargs.get("source") is not None else "path")
        return real(*args, **kwargs)

    monkeypatch.setattr(ingest, "ring_frames", counted)
    return calls


@pytest.fixture(params=["1", "2"], ids=["depth1", "depth2"])
def witnessed(request, monkeypatch):
    """Prefetch depth 1 or 2, under the frame witness."""
    monkeypatch.setenv("SCTOOLS_TPU_PREFETCH_DEPTH", request.param)
    monkeypatch.setenv(framedebug.ENV_FLAG, "1")
    framedebug.reset()
    yield int(request.param)
    assert framedebug.violations() == []
    framedebug.reset()


BATCH = 48  # 900 records: ~19 batches over 4 or 5 slots


@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_metrics_through_the_ring_match_jax(sorted_bams, tmp_path, witnessed, ring_calls, kind):
    bam = sorted_bams[kind]
    port_cls = port_gatherer.GatherCellMetrics if kind == "cell" else port_gatherer.GatherGeneMetrics
    jax_cls = jax_gatherer.GatherCellMetrics if kind == "cell" else jax_gatherer.GatherGeneMetrics
    native.reset_calls()
    gatherer = port_cls(bam, str(tmp_path / "port.csv.gz"), MITO_GENES, batch_records=BATCH, device="cpu")
    gatherer.extract_metrics()
    assert ring_calls == ["path"] and native.calls["batch_stream"] == 1
    assert gatherer.ring_batches == 19 > ingest.ring_slots(witnessed)
    assert framedebug.stamped_count() == 19
    assert set(gatherer.seconds) == {"decode", "decode.read", "decode.inflate", "decode.parse", "decode.fill",
                                     "start", "decode_wait", "carry", "pack", "dispatch", "wait", "csv",
                                     "close"}
    jax_cls(bam, str(tmp_path / "jax.csv.gz"), MITO_GENES, batch_records=BATCH,
            backend="device").extract_metrics()
    assert_csv_match(tmp_path / "port.csv.gz", tmp_path / "jax.csv.gz")


@pytest.fixture(scope="module")
def count_bam(tmp_path_factory):
    data = SyntheticCountData()
    path = tmp_path_factory.mktemp("ingest_count") / "synthetic.bam"
    write_bam(str(path), data.records(), data.header)
    return str(path)


def test_count_through_the_ring_matches_jax(count_bam, tmp_path, witnessed, ring_calls):
    native.reset_calls()
    port = port_count.CountMatrix.from_sorted_tagged_bam(count_bam, GENE_TO_INDEX, batch_records=16,
                                                         device="cpu")
    assert ring_calls == ["path"] and native.calls["batch_stream"] == 1
    assert port.ring_batches > 2 * ingest.ring_slots(witnessed) and len(port.batches) > 1
    jax_m = jax_count.CountMatrix.from_sorted_tagged_bam(count_bam, GENE_TO_INDEX, batch_records=16,
                                                         backend="device")
    _assert_same_matrix(port, jax_m, tmp_path)


def test_commands_read_through_the_ring(sorted_bams, count_bam, tmp_path, ring_calls):
    """The four BAM commands, through their entry points on a gzip input."""
    gtf = write_gtf(str(tmp_path / "genes.gtf"), [dict(gene_id=g, gene_name=g) for g in GENE_TO_INDEX])
    for entry, bam in (("calculate_cell_metrics", sorted_bams["cell"]),
                       ("calculate_gene_metrics", sorted_bams["gene"])):
        native.reset_calls()
        getattr(port_platform.GenericPlatform, entry)(["-i", bam, "-o", str(tmp_path / entry)], device="cpu")
        assert native.calls["batch_stream"] == 1
    native.reset_calls()
    port_platform.GenericPlatform.bam_to_count_matrix(
        ["-b", count_bam, "-a", gtf, "-o", str(tmp_path / "count")], device="cpu")
    assert native.calls["batch_stream"] == 1
    native.reset_calls()
    port_platform.GenericPlatform.tag_sort_bam(
        ["-i", sorted_bams["gene"], "-t", *CELL_TAGS, "--cell-metrics-output", str(tmp_path / "fused"),
         "-o", str(tmp_path / "sorted.bam")], device="cpu")
    assert native.calls["tagsort_stream_frames"] == 1 and native.calls["batch_stream"] == 0
    assert ring_calls == ["path", "path", "path", "source"]


def test_a_failed_command_leaves_no_thread_and_no_stream(count_bam, monkeypatch):
    spy = _Spy(monkeypatch)
    calls = {"n": 0}
    real = port_count._MoleculeAccumulator.dispatch

    def fails_third(self, block):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device lost")
        return real(self, block)

    monkeypatch.setattr(port_count._MoleculeAccumulator, "dispatch", fails_third)
    with pytest.raises(RuntimeError, match="device lost"):
        port_count.CountMatrix.from_sorted_tagged_bam(count_bam, GENE_TO_INDEX, batch_records=32, device="cpu")
    assert spy.opened == spy.closed == 1 and not _prefetch_threads()
