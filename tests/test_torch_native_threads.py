"""The port's threaded native paths: four threads give one thread's bytes.

The counterpart of ``tests/test_native_threads.py`` for
``sctools_tpu_torch.native``, and the module the sanitizer legs run
(``python -m sctools_tpu_torch.native.sanitize``): under
``SCTOOLS_TPU_THREADS=4`` the BGZF inflate pool of ``stream_frames``,
``NativeBatchStream``, ``tagsort`` (its compression overlap),
``tagsort_stream_frames`` with its tee, the FastqProcess shards' BGZF pool,
FastqMetrics' shard fan-out and ``format_csv_block`` must give the bytes of
an ``SCTOOLS_TPU_THREADS=1`` run.

The legs run it with ``--noconftest`` under a preloaded sanitizer runtime,
so it imports neither JAX, torch, ``sctools_tpu`` nor ``tests/helpers.py``:
its BAMs come from ``native.synth_bam_native`` and its FASTQs are written
here. Nothing in it needs a device (the FASTQ loops run without a
whitelist).
"""

import glob
import gzip
import os
import random

import numpy as np
import pytest

from sctools_tpu_torch import native
from sctools_tpu_torch.io import packed

TAGS = ["UB", "GE", "CB"]
RECORDS = 6400  # 200 cells x 8 molecules x 4 reads
SORT_RUN = 2000  # records a sorted run: four partials


@pytest.fixture(scope="module")
def synth_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("threads") / "synth.bam")
    assert native.synth_bam_native(path, 200, n_genes=64, seq_len=48, seed=7) == RECORDS
    return path


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    """Four R1/R2/I1 gzip FASTQ triplets of 400 reads (16C10M R1)."""
    root = tmp_path_factory.mktemp("threads_fastq")
    rng = random.Random(11)
    cells = ["".join(rng.choice("ACGT") for _ in range(16)) for _ in range(60)]
    files = {"r1": [], "r2": [], "i1": []}
    for shard in range(4):
        handles = {}
        for read in files:
            path = str(root / f"{read}_{shard}.fastq.gz")
            files[read].append(path)
            handles[read] = gzip.open(path, "wt")
        for i in range(400):
            name = f"@r{shard}_{i}"
            r1 = rng.choice(cells) + "".join(rng.choice("ACGTN") for _ in range(10))
            r2 = "".join(rng.choice("ACGT") for _ in range(40))
            i1 = "".join(rng.choice("ACGT") for _ in range(8))
            for read, seq in (("r1", r1), ("r2", r2), ("i1", i1)):
                quals = "".join(rng.choice("#+5?I") for _ in seq)
                handles[read].write(f"{name}\n{seq}\n+\n{quals}\n")
        for handle in handles.values():
            handle.close()
    return files


def at_threads(monkeypatch, threads, fn):
    monkeypatch.setenv("SCTOOLS_TPU_THREADS", str(threads))
    return fn()


def frame_bytes(frames):
    """Every column and vocabulary of a frame list, in order."""
    out = []
    for frame in frames:
        for name in packed._PER_RECORD_FIELDS:
            column = getattr(frame, name)
            if column is not None:
                out.append((name, column.dtype.str, column.tobytes()))
        for name in packed._CODED_FIELDS:
            out.append((name, tuple(getattr(frame, f"{name}_names"))))
    return out


def decompressed(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_loaded_library_is_the_pinned_file():
    native.library()
    pinned = os.environ.get(native.PIN_ENV)
    if pinned:
        assert native.loaded_path() == pinned
        with open("/proc/self/maps") as maps:
            assert os.path.realpath(pinned) in maps.read()
    else:
        assert native.loaded_path() == str(native.library_path())


def test_stream_frames_inflate_pool(synth_bam, monkeypatch):
    runs = [at_threads(monkeypatch, t, lambda: frame_bytes(native.stream_frames(synth_bam, 1500)))
            for t in (1, 4)]
    assert runs[0] == runs[1] and len(runs[0]) > 0


def test_batch_stream_arenas(synth_bam, monkeypatch):
    capacity = 1024

    def decode():
        out = []
        arena = np.zeros(native.arena_nbytes(capacity), np.uint8)
        with native.NativeBatchStream(synth_bam, want_qname=True) as stream:
            while stream.next(capacity):
                n = stream.fill_arena(arena, capacity)
                out.append((n, arena.tobytes(), stream.vocab("cell"), stream.vocab("qname")))
        return out

    one, four = (at_threads(monkeypatch, t, decode) for t in (1, 4))
    assert one == four and sum(n for n, *_ in one) == RECORDS


def test_tagsort_overlap(synth_bam, tmp_path, monkeypatch):
    outs = []
    for threads in (1, 4):
        out = str(tmp_path / f"sorted_{threads}.bam")
        n = at_threads(monkeypatch, threads,
                       lambda: native.tagsort(synth_bam, out, TAGS, batch_records=SORT_RUN))
        assert n == RECORDS
        outs.append(decompressed(out))
    assert outs[0] == outs[1]
    assert not glob.glob(str(tmp_path / "*.tagsort_partial_*"))


def test_tagsort_stream_frames_with_tee(synth_bam, tmp_path, monkeypatch):
    runs = []
    for threads in (1, 4):
        tee = str(tmp_path / f"tee_{threads}.bam")
        stats = {}

        def stream():
            return frame_bytes(native.tagsort_stream_frames(
                synth_bam, TAGS, batch_records=1500, sort_batch_records=SORT_RUN, bam_output=tee,
                scratch_prefix=str(tmp_path / f"scratch_{threads}"), stats=stats))

        frames = at_threads(monkeypatch, threads, stream)
        assert stats["partial_files"] == RECORDS // SORT_RUN + 1
        runs.append((frames, decompressed(tee)))
    assert runs[0] == runs[1]
    assert not glob.glob(str(tmp_path / "scratch_*"))


@pytest.mark.parametrize("output_format", ["BAM", "FASTQ"])
def test_fastqprocess_shards(fastqs, tmp_path, monkeypatch, output_format):
    outs = []
    for threads in (1, 4):
        prefix = str(tmp_path / f"{output_format}_{threads}")
        seconds = {"read": 0.0, "correct": 0.0, "write": 0.0}

        def process():
            return native.fastqprocess(
                fastqs["r1"], fastqs["r2"], prefix, [(0, 16)], [(16, 26)], [(0, 8)],
                fastqs["i1"], None, 3, output_format, "sample", 500, seconds)

        stats = at_threads(monkeypatch, threads, process)
        assert stats["total_reads"] == 1600
        paths = native.shard_paths(prefix, 3, output_format)
        outs.append([open(path, "rb").read() for path in paths])
    assert outs[0] == outs[1]


def test_fastq_metrics_fan_out(fastqs, tmp_path, monkeypatch):
    outs = []
    for threads in (1, 4):
        stem = str(tmp_path / f"fqm_{threads}")
        n = at_threads(monkeypatch, threads, lambda: native.fastq_metrics(
            fastqs["r1"], [(0, 16)], [(16, 26)], 26, stem))
        assert n == 1600
        files = sorted(glob.glob(stem + "*"))
        outs.append({path[len(stem):]: open(path, "rb").read() for path in files})
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_format_csv_block(monkeypatch):
    rng = np.random.default_rng(5)
    index = [f"cell{i}" for i in range(3000)]
    columns = [rng.integers(-10**12, 10**12, 3000), rng.standard_normal(3000) * 1e6,
               np.where(rng.random(3000) < 0.1, np.nan, rng.random(3000))]
    one, four = (at_threads(monkeypatch, t, lambda: native.format_csv_block(index, columns))
                 for t in (1, 4))
    assert one == four
    assert one.splitlines()[0] == f"cell0,{int(columns[0][0])},{float(columns[1][0])},{float(columns[2][0])}".encode()
