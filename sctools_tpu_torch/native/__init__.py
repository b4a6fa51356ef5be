"""The port's native host layer: C++ bound with ``ctypes``.

The port's copy of the JAX package's native layer, over zlib where that
copy uses libdeflate. It is the route of every BAM command and of the FASTQ
commands, as in the JAX package:

- ``stream_frames`` yields ``ReadFrame``s of a BGZF (or plain ``"BAM\\1"``)
  BAM, decoded on a thread pool (``io.packed.iter_frames_from_bam``);
- ``NativeBatchStream`` decodes batch by batch into a caller's packed
  column arena (``scx_batch_fill_arena``), the decoder of the ingest ring
  (``ingest.ring_frames``) under the metrics and count commands;
- ``frame_from_bam`` decodes a whole file into one frame
  (``io.packed.frame_from_bam``);
- ``tagsort`` sorts a BAM by three tags and the query name into a BGZF
  file (``tagsort.tag_sort_bam_out_of_core``);
- ``tagsort_stream_frames`` streams the sort's merge through a pipe into
  the decoder, and may tee the sorted BAM to a file in the same pass (the
  fused ``TagSortBam --cell-metrics-output``);
- ``fastqprocess``, ``attach`` and ``sample_fastq`` run the FASTQ loops of
  FastqProcess, the attach commands and SampleFastq (``fastqprocess.cpp``,
  ``attach.cpp``, ``fastqtools.cpp``): C++ reads, slices and writes, and
  each batch's cell barcodes go to the whitelist kernel in between, as one
  fixed-width block: one upload, one launch, one pull;
- ``fastq_metrics`` is FastqMetrics' scan, one thread per R1 shard;
- ``format_csv_block`` renders a block of metric rows as Python's ``str()``
  would (``metrics.writer.MetricCSVWriter.write_block``);
- ``synth_bam_native`` writes a cell-sorted, fully tagged synthetic BAM
  (``synth.cpp``), the records of the JAX package's generator.

The library is compiled with ``g++`` at first use, never at import (one
compiler process per source, all at once, then the link), into
``_build/`` beside the package (a directory git ignores), under a name that
carries the hash of the sources and the flags. The compiler writes to a
temporary name that ``os.replace`` publishes, under an ``fcntl`` lock, so
that processes sharing the directory build once. A failed build raises
with the compiler's output. The flags name no ``-march``: a library built
on one host runs on any x86-64 host.

``SCTOOLS_TPU_THREADS`` (1..1024) sets the worker threads of the decoder,
of the sort's writer overlap, of the FASTQ loops' BGZF compression pool
and of FastqMetrics' scan, as in the JAX package; the default is the CPU
count, at most 16.

``SCTOOLS_TPU_TORCH_NATIVE_LIB`` pins the library: when it is set,
``library()`` loads that file as it is and binds it, without building it
and without checking its hash, and a pinned file that is missing, does not
load or lacks a symbol raises, naming the path (it never falls back to a
``_build/`` library). It is how the sanitizer legs (``.sanitize``) load an
instrumented build. It is not the JAX package's ``SCTOOLS_TPU_NATIVE_LIB``:
the parity tests load both packages in one process, and one variable would
load either package's library into the other.

``calls`` counts, per function above, the calls that reached the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..analysis.witness import make_lock
from ..guard.watchdog import shielded
from ..io.packed import ReadFrame

_SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SOURCE_DIR.parent / "_build"
SOURCES = ("bamdecode.cpp", "tagsort.cpp", "fastqprocess.cpp", "attach.cpp", "fastqtools.cpp",
           "csvformat.cpp", "synth.cpp")
HEADERS = ("native_io.h",)
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-Wall", "-Wextra"]
LINK_FLAGS = ["-lz", "-lpthread"]
PIN_ENV = "SCTOOLS_TPU_TORCH_NATIVE_LIB"

calls: Dict[str, int] = {
    "stream_frames": 0, "batch_stream": 0, "frame_from_bam": 0, "tagsort": 0,
    "tagsort_stream_frames": 0,
    "format_csv_block": 0, "fastqprocess": 0, "attach": 0, "sample_fastq": 0, "fastq_metrics": 0,
    "synth_bam": 0,
}

COMPRESS_LEVEL = 6  # the FASTQ loops' BGZF level, the JAX package's
PROGRESS_EVERY = 10_000_000  # the reference's cadence (fastq_common.cpp:340)

_lock = make_lock("native.loader")
_lib: Optional[ctypes.CDLL] = None


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def library_path(flags: Sequence[str] = CXX_FLAGS, kind: str = "") -> Path:
    """Where the library of these sources and ``flags`` is built; ``kind``
    names a variant build (``libsctools_native.<kind>-<hash>.so``)."""
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode() + b"\0" + (_SOURCE_DIR / name).read_bytes())
    digest.update(" ".join([*flags, *LINK_FLAGS]).encode())
    stem = f"libsctools_native.{kind}" if kind else "libsctools_native"
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def _build(target: Path, flags: Sequence[str] = CXX_FLAGS) -> None:
    """Compile each source on its own g++ process, all at once, then link."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH: it builds the port's native layer")
    stem = target.with_suffix(f".{os.getpid()}")
    objects = [Path(f"{stem}.{name}.o") for name in SOURCES]
    partial = Path(f"{stem}.tmp")
    try:
        jobs = [
            subprocess.Popen([compiler, *flags, "-c", str(_SOURCE_DIR / name), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objects)
        ]
        outputs = [job.communicate()[0] for job in jobs]
        failed = [out for job, out in zip(jobs, outputs) if job.returncode != 0]
        if not failed:
            link = subprocess.run([compiler, *flags, *map(str, objects), *LINK_FLAGS, "-o",
                                   str(partial)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            if link.returncode != 0:
                failed = [link.stdout]
        if failed:
            raise RuntimeError("building the native layer failed:\n" + "".join(failed))
        os.replace(partial, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        for path in (*objects, partial):
            path.unlink(missing_ok=True)


def ensure_built(flags: Sequence[str] = CXX_FLAGS, kind: str = "") -> Path:
    """The library of these sources and ``flags``, built unless it is there
    already; an ``fcntl`` lock lets processes that share ``_build/`` build
    it once."""
    target = library_path(flags, kind)
    if not target.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        with open(BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not target.exists():
                # no Stall may land inside the g++ build (guard.watchdog)
                with shielded():
                    _build(target, flags)
    return target


def _load_pinned(path: str) -> ctypes.CDLL:
    """The pinned library, loaded and bound as it is; raises naming ``path``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{PIN_ENV}={path}: no such library file")
    try:
        return _bind(ctypes.CDLL(path))
    except (OSError, AttributeError) as exc:
        raise RuntimeError(f"{PIN_ENV}={path}: cannot load the pinned library: {exc}") from exc


def library() -> ctypes.CDLL:
    """The loaded native library: the pinned file (``PIN_ENV``), else the
    library of the sources, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            pinned = os.environ.get(PIN_ENV)
            _lib = _load_pinned(pinned) if pinned else _bind(ctypes.CDLL(str(ensure_built())))
        return _lib


def loaded_path() -> Optional[str]:
    """The file of the loaded library, or None before the first load."""
    return None if _lib is None else _lib._name


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, c_long, c_int, c_char_p = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p
    signatures = {
        "scx_stream_open": (p, [c_char_p, c_int, c_int, c_char_p, c_int]),
        "scx_stream_next": (c_long, [p, c_long]),
        "scx_stream_error": (c_char_p, [p]),
        "scx_stream_close": (None, [p]),
        "scx_arena_nbytes": (c_long, [c_long]),
        "scx_batch_fill_arena": (c_long, [p, p, c_long]),
        "scx_decode_bam": (p, [c_char_p, c_int, c_char_p, c_int]),
        "scx_free": (None, [p]),
        "scx_n_records": (c_long, [p]),
        "scx_col_i32": (ctypes.POINTER(ctypes.c_int32), [p, c_char_p]),
        "scx_col_i8": (ctypes.POINTER(ctypes.c_int8), [p, c_char_p]),
        "scx_col_u16": (ctypes.POINTER(ctypes.c_uint16), [p, c_char_p]),
        "scx_col_u32": (ctypes.POINTER(ctypes.c_uint32), [p, c_char_p]),
        "scx_vocab_size": (c_long, [p, c_char_p]),
        "scx_vocab_bytes": (ctypes.POINTER(ctypes.c_char), [p, c_char_p, ctypes.POINTER(c_long)]),
        "scx_vocab_offsets": (ctypes.POINTER(ctypes.c_int64), [p, c_char_p]),
        "scx_tagsort": (c_long, [c_char_p, c_char_p, c_char_p, c_char_p, c_char_p, c_long,
                                 c_int, c_char_p, c_int]),
        "scx_tagsort_pipe_open": (p, [c_char_p, c_char_p, c_char_p, c_char_p, c_long,
                                      c_char_p, c_int, c_char_p, c_char_p, c_int]),
        "scx_tagsort_pipe_fd": (c_int, [p]),
        "scx_tagsort_pipe_finish": (c_long, [p]),
        "scx_tagsort_pipe_stats": (None, [p, ctypes.POINTER(ctypes.c_double)]),
        "scx_tagsort_pipe_error": (c_char_p, [p]),
        "scx_tagsort_pipe_free": (None, [p, c_int]),
        "scx_format_csv_block": (c_long, [c_char_p, p, c_long, p, ctypes.c_int32, p,
                                          ctypes.c_int32, p, p, ctypes.c_int32, p, c_long]),
        "scx_fqm": (c_long, [c_char_p, p, c_int, p, c_int, c_int, c_char_p, c_int, c_char_p, c_int]),
        "scx_sfq_open": (p, [c_char_p, c_char_p, p, c_int, p, c_int, c_char_p, c_char_p, c_int]),
        "scx_sfq_next": (c_long, [p, c_long]),
        "scx_sfq_buf": (ctypes.POINTER(ctypes.c_char), [p, c_char_p]),
        "scx_sfq_len": (c_int, [p, c_char_p]),
        "scx_sfq_write": (c_long, [p, c_long, p]),
        "scx_sfq_close": (c_int, [p]),
        "scx_sfq_error": (c_char_p, [p]),
        "scx_sfq_free": (None, [p]),
        "scx_fqp_open": (p, [c_char_p, c_char_p, c_char_p, c_char_p, c_int, c_int, c_char_p,
                             p, c_int, p, c_int, p, c_int, c_int, c_char_p, c_int]),
        "scx_fqp_next": (c_long, [p, c_long]),
        "scx_fqp_buf": (ctypes.POINTER(ctypes.c_char), [p, c_char_p]),
        "scx_fqp_len": (c_int, [p, c_char_p]),
        "scx_fqp_write": (c_long, [p, c_long, p, p]),
        "scx_fqp_stats": (None, [p, ctypes.POINTER(c_long)]),
        "scx_fqp_close": (c_int, [p]),
        "scx_fqp_error": (c_char_p, [p]),
        "scx_fqp_free": (None, [p]),
        "scx_pool_threads": (c_int, []),
        "scx_attach_open": (p, [c_char_p, c_char_p, c_char_p, c_char_p, p, c_int, p, c_int,
                                p, c_int, c_char_p, c_int]),
        "scx_attach_next": (c_long, [p, c_long]),
        "scx_attach_buf": (ctypes.POINTER(ctypes.c_char), [p, c_char_p]),
        "scx_attach_len": (c_int, [p, c_char_p]),
        "scx_attach_write": (c_long, [p, c_long, p, p]),
        "scx_attach_close": (c_int, [p]),
        "scx_attach_error": (c_char_p, [p]),
        "scx_attach_free": (None, [p]),
        "scx_synth_bam": (c_long, [c_char_p, c_long, c_long, c_int, c_int, c_int, c_int,
                                   ctypes.c_ulonglong, c_int, c_char_p, c_int]),
    }
    for name, (restype, argtypes) in signatures.items():
        function = getattr(lib, name)
        function.restype = restype
        function.argtypes = argtypes
    return lib


def default_threads() -> int:
    """The decoder's worker threads: ``SCTOOLS_TPU_THREADS`` when it holds
    1..1024 (the window the C++ side reads), else the CPU count, at most 16."""
    env = os.environ.get("SCTOOLS_TPU_THREADS")
    if env:
        try:
            value = int(env)
        except ValueError:
            value = 0
        if 0 < value <= 1024:
            return value
    return min(os.cpu_count() or 1, 16)


def _copy_array(pointer, n, dtype):
    return np.ctypeslib.as_array(pointer, shape=(n,)).astype(dtype, copy=True)


def _vocab(lib, handle, name: bytes) -> List[str]:
    """A batch's vocabulary of a coded column as Python strings.

    The names (which hold no NUL: BAM strings end at one) are laid out with
    a NUL between each two in numpy and split in one call, not sliced one
    by one: a query-name vocabulary holds about a string a record, and on
    the ingest ring's thread every Python step holds the GIL against the
    consumer's.
    """
    size = lib.scx_vocab_size(handle, name)
    if size <= 0:
        return []
    total = ctypes.c_long(0)
    data = lib.scx_vocab_bytes(handle, name, ctypes.byref(total))
    offsets = np.ctypeslib.as_array(lib.scx_vocab_offsets(handle, name), shape=(size + 1,))
    raw = np.frombuffer(ctypes.string_at(data, total.value), dtype=np.uint8)
    joined = np.zeros(total.value + size - 1, dtype=np.uint8)
    joined[np.arange(total.value) + np.repeat(np.arange(size), np.diff(offsets))] = raw
    return joined.tobytes().decode("ascii").split("\0")


def _frame_from_handle(lib, handle, want_qname: bool) -> ReadFrame:
    """Copy the handle's current batch out into a ReadFrame."""
    n = lib.scx_n_records(handle)

    def column(accessor, name, dtype):
        if n == 0:
            return np.zeros(0, dtype)
        return _copy_array(accessor(handle, name), n, dtype)

    def i32(name):
        return column(lib.scx_col_i32, name, np.int32)

    def i8(name):
        return column(lib.scx_col_i8, name, np.int8)

    def u16(name):
        return column(lib.scx_col_u16, name, np.uint16)

    def u32(name):
        return column(lib.scx_col_u32, name, np.uint32)

    def vocab(name):
        return _vocab(lib, handle, name) if n else []

    return ReadFrame(
        cell=i32(b"cell"), umi=i32(b"umi"), gene=i32(b"gene"), qname=i32(b"qname"),
        cell_names=vocab(b"cell"), umi_names=vocab(b"umi"), gene_names=vocab(b"gene"),
        qname_names=(vocab(b"qname") if want_qname else [""]) if n else [],
        ref=i32(b"ref"), pos=i32(b"pos"), strand=i8(b"strand"),
        unmapped=i8(b"unmapped").astype(bool), duplicate=i8(b"duplicate").astype(bool),
        spliced=i8(b"spliced").astype(bool), xf=i8(b"xf"), nh=i32(b"nh"),
        perfect_umi=i8(b"perfect_umi"), perfect_cb=i8(b"perfect_cb"),
        umi_qual=u16(b"umi_qual"), cb_qual=u16(b"cb_qual"),
        genomic_qual=u32(b"genomic_qual"), genomic_total=u32(b"genomic_total"),
    )


def _errbuf():
    return ctypes.create_string_buffer(512)


def synth_bam_native(
    path: str,
    n_cells: int,
    molecules_per_cell: int = 8,
    reads_per_molecule: int = 4,
    n_genes: int = 4096,
    seq_len: int = 98,
    seed: int = 42,
    compress_level: int = 1,
    cell_offset: int = 0,
) -> int:
    """Write a cell-sorted, fully tagged synthetic BAM; returns the records
    written (``n_cells * molecules_per_cell * reads_per_molecule``).

    ``cell_offset`` shifts the barcode space, so that files written with
    disjoint cell ranges share no barcode. The records equal those of the
    JAX package's ``synth_bam_native`` for the same arguments; the BGZF
    bytes may differ (zlib here). Raises RuntimeError when the write fails.
    """
    lib = library()
    calls["synth_bam"] += 1
    errbuf = _errbuf()
    with obs.span("native:synth_bam") as sp:
        written = lib.scx_synth_bam(
            path.encode(), n_cells, cell_offset, molecules_per_cell, reads_per_molecule,
            n_genes, seq_len, seed, compress_level, errbuf, ctypes.sizeof(errbuf),
        )
        if written < 0:  # raised inside the span, so that it carries the error
            raise RuntimeError(f"synth bam failed: {_message(errbuf)}")
        sp.add(records=int(written))
    return written


def _message(buffer) -> str:
    return buffer.value.decode(errors="replace")


def _threads(n_threads: Optional[int]) -> int:
    return default_threads() if n_threads is None else n_threads


def frame_from_bam(path: str, n_threads: Optional[int] = None) -> ReadFrame:
    """Decode a whole BAM file into one ReadFrame (query names included),
    on ``n_threads`` decoder threads (None: ``default_threads()``).

    Raises RuntimeError when the file cannot be opened or is malformed.
    """
    lib = library()
    calls["frame_from_bam"] += 1
    errbuf = _errbuf()
    with obs.span("native:decode_bam") as sp:
        handle = lib.scx_decode_bam(
            path.encode(), _threads(n_threads), errbuf, ctypes.sizeof(errbuf))
        if not handle:
            raise RuntimeError(f"native BAM decode failed: {_message(errbuf)}")
        try:
            frame = _frame_from_handle(lib, handle, want_qname=True)
        finally:
            lib.scx_free(handle)
        sp.add(records=frame.n_records)
    return frame


def _decoded_batches(lib, stream, batch_records: int, want_qname: bool, what: str, span: str):
    """ReadFrames of up to ``batch_records`` records from an open stream
    handle, until its end, each decode a ``span``; the caller closes the
    handle."""
    while True:
        with obs.span(span) as sp:
            n = lib.scx_stream_next(stream, batch_records)
            if n < 0:
                raise RuntimeError(
                    f"{what} failed: {lib.scx_stream_error(stream).decode(errors='replace')}")
            if n == 0:
                sp.add(eof=1)  # the terminating poll, not a batch
                return
            sp.add(records=int(n))
            frame = _frame_from_handle(lib, stream, want_qname)
        yield frame


def stream_frames(path: str, batch_records: int, n_threads: Optional[int] = None,
                  want_qname: bool = False) -> Iterator[ReadFrame]:
    """Yield ReadFrames of <= batch_records alignments in file order, decoded
    on ``n_threads`` threads (None: ``default_threads()``).

    Bounded host memory: the native stream holds the current batch plus one
    compressed chunk. With ``want_qname=False`` the qname column is all
    zeros and its vocabulary is ``[""]``, skipping the near-one-entry-per-
    record dictionary that metrics never read. Raises RuntimeError when the
    file cannot be opened or is malformed.
    """
    lib = library()
    calls["stream_frames"] += 1
    errbuf = _errbuf()
    handle = lib.scx_stream_open(
        path.encode(), _threads(n_threads), int(want_qname), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"native BAM stream open failed: {_message(errbuf)}")
    try:
        yield from _decoded_batches(
            lib, handle, batch_records, want_qname, "native BAM stream", "native:stream_batch")
    finally:
        lib.scx_stream_close(handle)


def arena_nbytes(capacity: int) -> int:
    """The byte size of a packed column arena for ``capacity`` records, by
    the C++ layout (``scx_arena_nbytes``); ``ingest.arena.arena_nbytes``
    computes the same from ``ARENA_SPEC``. Raises ValueError unless the
    capacity is a positive multiple of 64."""
    n = library().scx_arena_nbytes(capacity)
    if n < 0:
        raise ValueError(f"invalid arena capacity {capacity} (a positive multiple of 64)")
    return int(n)


class NativeBatchStream:
    """A streaming BAM decode handle for the ingest ring.

    ``next()`` decodes up to ``max_records`` alignments into the handle's
    batch, ``fill_arena()`` writes that batch's columns into a caller-owned
    contiguous buffer (``ingest.arena.ColumnArena`` views it with
    ``np.frombuffer``: no per-column copies), and ``vocab()`` returns the
    batch's sorted vocabulary of a coded column. Raises RuntimeError when
    the file cannot be opened or is malformed. ``close()`` releases the
    handle; the stream is also a context manager. ``n_threads``: the
    decoder's threads (None: ``default_threads()``).
    """

    def __init__(self, path: str, n_threads: Optional[int] = None, want_qname: bool = False):
        lib = library()
        errbuf = _errbuf()
        handle = lib.scx_stream_open(
            path.encode(), _threads(n_threads), int(want_qname), errbuf, ctypes.sizeof(errbuf))
        if not handle:
            raise RuntimeError(f"native BAM stream open failed: {_message(errbuf)}")
        calls["batch_stream"] += 1
        self._lib = lib
        self._handle = handle

    def next(self, max_records: int) -> int:
        """Decode the next batch; returns its record count (0 at the end)."""
        n = self._lib.scx_stream_next(self._handle, max_records)
        if n < 0:
            raise RuntimeError(
                "native BAM stream failed: "
                f"{self._lib.scx_stream_error(self._handle).decode(errors='replace')}")
        return int(n)

    def fill_arena(self, arena: np.ndarray, capacity: int) -> int:
        """Write the current batch's columns into ``arena`` (a C-contiguous
        uint8 buffer of ``arena_nbytes(capacity)`` bytes); returns the record
        count. Rows [n:capacity) of each section are left as they were."""
        if arena.dtype != np.uint8 or not arena.flags["C_CONTIGUOUS"]:
            raise ValueError("arena must be a C-contiguous uint8 buffer")
        if arena.nbytes < arena_nbytes(capacity):
            raise ValueError(f"arena of {arena.nbytes} bytes is too small for capacity {capacity}")
        n = self._lib.scx_batch_fill_arena(self._handle, arena.ctypes.data, capacity)
        if n < 0:
            raise RuntimeError(f"arena fill failed: capacity {capacity} cannot hold the batch")
        return int(n)

    def vocab(self, name: str) -> List[str]:
        """The current batch's sorted vocabulary of a coded column."""
        return _vocab(self._lib, self._handle, name.encode())

    def close(self) -> None:
        if self._handle is not None:
            self._lib.scx_stream_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeBatchStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _tag_bytes(tag_keys: Sequence[str]) -> List[bytes]:
    keys = list(tag_keys)
    if len(keys) != 3 or any(len(key) != 2 for key in keys):
        raise RuntimeError("native tagsort requires exactly three 2-char tags")
    return [key.encode() for key in keys]


def tagsort(
    input_bam: str,
    output_bam: str,
    tag_keys: Sequence[str],
    batch_records: int = 500_000,
    compress_level: int = 6,
) -> int:
    """Sort ``input_bam`` by three tags then query name into a BGZF file at
    ``compress_level``; returns the records written.

    Memory is bounded by ``batch_records`` records (at least 1,000) plus
    the compression buffers. Sorted partials go beside the output, as
    ``<output_bam>.tagsort_partial_N``, and are removed on success and on
    failure; a failure removes the output too and raises RuntimeError.
    """
    keys = _tag_bytes(tag_keys)
    lib = library()
    calls["tagsort"] += 1
    errbuf = _errbuf()
    with obs.span("native:tagsort") as sp:
        n = lib.scx_tagsort(
            input_bam.encode(), output_bam.encode(), *keys, batch_records, compress_level,
            errbuf, ctypes.sizeof(errbuf))
        if n < 0:  # raise inside the span so it carries the error
            raise RuntimeError(f"native tagsort failed: {_message(errbuf)}")
        sp.add(records=int(n))
    return n


def tagsort_stream_frames(
    input_bam: str,
    tag_keys: Sequence[str],
    batch_records: int = 1 << 20,
    sort_batch_records: int = 500_000,
    bam_output: Optional[str] = None,
    bam_compress_level: int = 1,
    scratch_prefix: Optional[str] = None,
    n_threads: Optional[int] = None,
    want_qname: bool = False,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[ReadFrame]:
    """Yield sorted ReadFrames streamed straight out of the tag sort's merge.

    A worker thread runs the out-of-core sort (partials at
    ``<scratch_prefix>_<pid>_N``; by default ``scratch_prefix`` is
    ``<bam_output>.tagsort_partial``, or without a ``bam_output`` the input's
    name with that suffix in the temp directory, never beside the input)
    and streams the merged records as plain BAM through a pipe, which the
    column decoder reads on ``n_threads`` threads (None:
    ``default_threads()``). With ``bam_output`` the same merge pass tees
    the sorted BAM to that file at BGZF level ``bam_compress_level``.
    ``want_qname`` fills the frames' query names. Raises RuntimeError on a
    sort or decode failure. A failure, or a generator closed before its
    end, closes the pipe, which ends the worker, and leaves no partials and
    no ``bam_output``. At the end of the stream the sort's wall seconds by
    phase (``read``, ``sort``, ``partials``, ``merge``, on its own thread)
    and the number of partials it wrote (``partial_files``) go into
    ``stats`` when it is given.
    """
    keys = _tag_bytes(tag_keys)
    if scratch_prefix is None:
        base = bam_output or os.path.join(tempfile.gettempdir(), os.path.basename(input_bam))
        scratch_prefix = base + ".tagsort_partial"
    lib = library()
    calls["tagsort_stream_frames"] += 1
    errbuf = _errbuf()
    handle = lib.scx_tagsort_pipe_open(
        input_bam.encode(), *keys, sort_batch_records, (bam_output or "").encode(),
        bam_compress_level, scratch_prefix.encode(), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"tagsort pipe open failed: {_message(errbuf)}")
    stream = None
    complete = False
    try:
        read_fd = lib.scx_tagsort_pipe_fd(handle)
        stream = lib.scx_stream_open(
            f"/proc/self/fd/{read_fd}".encode(), _threads(n_threads), int(want_qname),
            errbuf, ctypes.sizeof(errbuf))
        if not stream:
            raise RuntimeError(f"tagsort stream open failed: {_message(errbuf)}")
        total = 0
        for frame in _decoded_batches(
                lib, stream, batch_records, want_qname, "tagsort stream", "native:tagsort_stream_batch"):
            total += frame.n_records
            yield frame
        # close OUR read descriptors before joining the worker, so a
        # failed or blocked writer cannot deadlock the join
        lib.scx_stream_close(stream)
        stream = None
        merged = lib.scx_tagsort_pipe_finish(handle)
        if merged < 0:
            raise RuntimeError(
                f"tagsort merge failed: {lib.scx_tagsort_pipe_error(handle).decode(errors='replace')}")
        if merged != total:
            raise RuntimeError(f"tagsort stream truncated: decoded {total} of {merged} records")
        if stats is not None:
            values = (ctypes.c_double * 5)()
            lib.scx_tagsort_pipe_stats(handle, values)
            stats.update(zip(("read", "sort", "partials", "merge"), values[:4]))
            stats["partial_files"] = int(values[4])
        complete = True
    finally:
        if stream is not None:
            lib.scx_stream_close(stream)
        lib.scx_tagsort_pipe_free(handle, int(complete))


def pool_threads() -> int:
    """The threads of the FASTQ loops' BGZF pools and of FastqMetrics' scan:
    ``default_threads()``'s rule, as the C++ side reads it."""
    return library().scx_pool_threads()


def format_csv_block(index: Sequence[str], columns: Sequence[np.ndarray]) -> bytes:
    """One block of metric rows as CSV bytes: ``index[i],col0[i],col1[i]...``
    and a newline per row.

    ``columns`` are equal-length 1-D arrays in header order; a floating
    column renders as float64, any other as int64, each value exactly as
    Python's ``str()`` renders it (shortest round-trip floats, ``nan``,
    ``inf``, ``1e-05``, a trailing ``.0`` on integral floats). Callers that
    want the ``str()`` of another dtype cast first, as
    ``MetricCSVWriter.write_block`` does.
    """
    n = len(index)
    if n == 0:
        return b""
    encoded = [str(name).encode() for name in index]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    blob = b"".join(encoded)
    columns = [np.asarray(column) for column in columns]
    is_float = np.array([np.issubdtype(c.dtype, np.floating) for c in columns], dtype=np.int8)
    col_src = np.zeros(len(columns), np.int32)
    int_cols: List[np.ndarray] = []
    float_cols: List[np.ndarray] = []
    for i, column in enumerate(columns):
        if column.shape != (n,):
            # a mismatch would read out of bounds in C
            raise ValueError(f"column {i} has shape {column.shape}, index has {n} rows")
        group = float_cols if is_float[i] else int_cols
        col_src[i] = len(group)
        group.append(column)
    ints = np.ascontiguousarray(np.column_stack(int_cols) if int_cols else np.zeros((n, 0)), np.int64)
    floats = np.ascontiguousarray(
        np.column_stack(float_cols) if float_cols else np.zeros((n, 0)), np.float64)
    capacity = len(blob) + n * (33 * len(columns) + 1) + 64
    out = ctypes.create_string_buffer(capacity)
    lib = library()
    calls["format_csv_block"] += 1
    with obs.span("native:csv_format", records=n) as sp:
        written = lib.scx_format_csv_block(
            blob, offsets.ctypes.data, n, ints.ctypes.data, ints.shape[1], floats.ctypes.data,
            floats.shape[1], is_float.ctypes.data, col_src.ctypes.data, len(columns), out,
            capacity)
        if written < 0:  # raise inside the span so it carries the error
            raise RuntimeError("csv block formatting overflowed its buffer")
        sp.add(bytes=int(written))
    return ctypes.string_at(out, written)


def _spans(spans) -> Tuple[np.ndarray, int]:
    """``[start, end)`` pairs as the flat int32 array the C side reads."""
    flat = np.array([bound for span in spans or [] for bound in span], dtype=np.int32)
    return flat, len(flat) // 2


def _pointer(array: Optional[np.ndarray]) -> Optional[int]:
    return None if array is None else array.ctypes.data


def _barcodes(pointer, n: int, width: int) -> np.ndarray:
    """A handle's fixed-width barcode buffer as an ``[n, width]`` uint8 view;
    valid until the handle's next batch."""
    return np.ctypeslib.as_array(ctypes.cast(pointer, ctypes.POINTER(ctypes.c_uint8)), shape=(n, width))


def _correct(corrector, raw: np.ndarray, seconds: Dict[str, float]) -> Tuple[np.ndarray, np.ndarray]:
    """Whitelist correction of one fixed-width barcode block: the corrected
    barcodes as a fixed-width block and the uint8 mask of the rows that
    corrected, for the C side's write.

    A barcode's length is the index of its first NUL byte (the C side pads
    a short read's barcode with NULs), so a short one never corrects.
    """
    start = time.perf_counter()
    nul = raw == 0
    lengths = np.where(nul.any(axis=1), nul.argmax(axis=1), raw.shape[1])
    indices = corrector.submit_block(raw, lengths).indices()
    hit = indices >= 0
    block = np.zeros_like(raw)
    block[hit] = corrector.rows[indices[hit]]
    seconds["correct"] += time.perf_counter() - start
    return block, hit.astype(np.uint8)


def _check_length(corrector, cb_len: int) -> None:
    if corrector is not None and cb_len != corrector.barcode_length:
        raise RuntimeError(
            f"whitelist barcode length {corrector.barcode_length} does "
            f"not match the cell barcode span length {cb_len}"
        )


def _remove(paths: Sequence[str]) -> None:
    for path in paths:
        try:
            os.remove(path)
        except OSError:
            pass


def shard_paths(prefix: str, n_shards: int, output_format: str = "BAM") -> List[str]:
    """The shard files ``fastqprocess`` writes: ``<prefix>_<i>.bam``, or per
    shard ``<prefix>_R1_<i>.fastq.gz`` then ``<prefix>_R2_<i>.fastq.gz``."""
    if output_format.upper() == "FASTQ":
        return [f"{prefix}_{r}_{i}.fastq.gz" for i in range(n_shards) for r in ("R1", "R2")]
    return [f"{prefix}_{i}.bam" for i in range(n_shards)]


def fastqprocess(
    r1_files: Sequence[str],
    r2_files: Sequence[str],
    output_prefix: str,
    cb_spans,
    umi_spans,
    sample_spans,
    i1_files: Optional[Sequence[str]],
    corrector,
    n_shards: int,
    output_format: str,
    sample_id: str,
    batch_size: int,
    seconds: Dict[str, float],
) -> Dict[str, int]:
    """FASTQ triplets -> ``n_shards`` disjoint-barcode shards (``shard_paths``).

    ``corrector`` is a ``WhitelistCorrector`` or None. Returns the counters
    {total_reads, correct, corrected, uncorrectable}; prints the progress
    line every 10M reads and, with a whitelist, the reference's summary to
    stderr. Adds the seconds of reading (``read``), correction (``correct``)
    and writing (``write``) into ``seconds``. On any failure the shards of
    this run are removed.
    """
    fmt = {"BAM": 0, "FASTQ": 1}.get(output_format.upper())
    if fmt is None:
        raise ValueError("output_format must be BAM or FASTQ")
    cb, n_cb = _spans(cb_spans)
    umi, n_umi = _spans(umi_spans)
    sample, n_sample = _spans(sample_spans)
    lib = library()
    calls["fastqprocess"] += 1
    errbuf = _errbuf()
    handle = lib.scx_fqp_open(
        "\n".join(r1_files).encode(), "\n".join(i1_files or []).encode(),
        "\n".join(r2_files).encode(), output_prefix.encode(), n_shards, fmt, sample_id.encode(),
        cb.ctypes.data, n_cb, umi.ctypes.data, n_umi, sample.ctypes.data, n_sample,
        COMPRESS_LEVEL, errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"fastqprocess open failed: {_message(errbuf)}")
    complete = False
    try:
        cb_len = lib.scx_fqp_len(handle, b"cb")
        _check_length(corrector, cb_len)
        total = 0
        while True:
            start = time.perf_counter()
            n = lib.scx_fqp_next(handle, batch_size)
            seconds["read"] += time.perf_counter() - start
            if n < 0:
                raise RuntimeError(f"fastqprocess read failed: {lib.scx_fqp_error(handle).decode()}")
            if n == 0:
                break
            block = mask = None
            if corrector is not None and cb_len > 0:
                block, mask = _correct(corrector, _barcodes(lib.scx_fqp_buf(handle, b"cr"), n, cb_len),
                                       seconds)
            start = time.perf_counter()
            if lib.scx_fqp_write(handle, n, _pointer(block), _pointer(mask)) < 0:
                raise RuntimeError(f"fastqprocess write failed: {lib.scx_fqp_error(handle).decode()}")
            seconds["write"] += time.perf_counter() - start
            for count in range(total // PROGRESS_EVERY + 1, (total + n) // PROGRESS_EVERY + 1):
                print(f"[fastqprocess] {count * PROGRESS_EVERY} reads processed", file=sys.stderr)
            total += n
        start = time.perf_counter()
        if lib.scx_fqp_close(handle) != 0:
            raise RuntimeError("fastqprocess close failed")
        seconds["write"] += time.perf_counter() - start
        values = (ctypes.c_long * 4)()
        lib.scx_fqp_stats(handle, values)
        complete = True
    finally:
        lib.scx_fqp_free(handle)
        if not complete:
            # never leave partial shards that could read as complete; only
            # the files this run creates (a glob could take others)
            _remove(shard_paths(output_prefix, n_shards, output_format))
    return dict(zip(("total_reads", "correct", "corrected", "uncorrectable"), values))


def attach(
    r1: str,
    u2: str,
    output_bam: str,
    cb_spans,
    umi_spans,
    sample_spans,
    i1: Optional[str],
    corrector,
    batch_size: int,
) -> Tuple[int, int, int, int]:
    """Tag the records of the BGZF BAM ``u2`` with the barcodes of ``r1``
    (sample spans from ``i1``) into ``output_bam``.

    The run stops when either input runs out (zip semantics). ``corrector``
    is a ``WhitelistCorrector`` or None. Returns (records written, correct,
    corrected, uncorrectable), the last three counted over the written
    records; prints the progress line every 10M reads to stderr. On any
    failure the output is removed.
    """
    cb, n_cb = _spans(cb_spans)
    umi, n_umi = _spans(umi_spans)
    sample, n_sample = _spans(sample_spans)
    lib = library()
    calls["attach"] += 1
    errbuf = _errbuf()
    handle = lib.scx_attach_open(
        r1.encode(), (i1 or "").encode(), u2.encode(), output_bam.encode(), cb.ctypes.data, n_cb,
        umi.ctypes.data, n_umi, sample.ctypes.data, n_sample, errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"attach open failed: {_message(errbuf)}")
    written = correct = corrected = 0
    next_progress = PROGRESS_EVERY
    complete = False
    try:
        cb_len = lib.scx_attach_len(handle, b"cb")
        _check_length(corrector, cb_len)
        seconds = {"correct": 0.0}
        while True:
            n = lib.scx_attach_next(handle, batch_size)
            if n < 0:
                raise RuntimeError(f"attach read failed: {lib.scx_attach_error(handle).decode()}")
            if n == 0:
                break
            block = mask = None
            if corrector is not None and cb_len > 0:
                raw = _barcodes(lib.scx_attach_buf(handle, b"cr"), n, cb_len)
                block, mask = _correct(corrector, raw, seconds)
            done = lib.scx_attach_write(handle, n, _pointer(block), _pointer(mask))
            if done < 0:
                raise RuntimeError(f"attach write failed: {lib.scx_attach_error(handle).decode()}")
            if mask is not None:
                # only the records written: the last batch stops short when
                # u2 runs out first, and the summary counts what was written
                hit = mask[:done].astype(bool)
                same = int((block[:done][hit] == raw[:done][hit]).all(axis=1).sum())
                correct += same
                corrected += int(hit.sum()) - same
            written += done
            if written >= next_progress:
                print(f"[attach] {written} reads processed", file=sys.stderr)
                next_progress += PROGRESS_EVERY
            if done < n:
                break  # u2 ran out before the fastq (zip semantics)
        if lib.scx_attach_close(handle) != 0:
            raise RuntimeError("attach close failed")
        complete = True
    finally:
        lib.scx_attach_free(handle)
        if not complete:
            _remove([output_bam])  # never leave an output that could read as complete
    uncorrectable = written - correct - corrected if corrector is not None else 0
    return written, correct, corrected, uncorrectable


def sample_fastq(
    r1_files: Sequence[str],
    r2_files: Sequence[str],
    corrector,
    cb_spans,
    umi_spans,
    output_prefix: str,
    batch_size: int,
    seconds: Dict[str, float],
) -> Tuple[int, int]:
    """Write ``<output_prefix>.R1`` / ``.R2`` with the read pairs whose cell
    barcode corrects to ``corrector``'s whitelist; returns (kept, total).

    R1 and R2 are each the concatenation of their files, zipped record by
    record: a count mismatch is a ``ValueError``. Adds the seconds of
    reading (``read``), correction (``correct``) and writing (``write``)
    into ``seconds``. On any failure both outputs are removed.
    """
    cb, n_cb = _spans(cb_spans)
    umi, n_umi = _spans(umi_spans)
    lib = library()
    calls["sample_fastq"] += 1
    errbuf = _errbuf()
    handle = lib.scx_sfq_open(
        "\n".join(r1_files).encode(), "\n".join(r2_files).encode(), cb.ctypes.data, n_cb,
        umi.ctypes.data, n_umi, output_prefix.encode(), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"samplefastq open failed: {_message(errbuf)}")
    kept = total = 0
    complete = False
    try:
        cb_len = lib.scx_sfq_len(handle, b"cr")
        _check_length(corrector, cb_len)
        while True:
            start = time.perf_counter()
            n = lib.scx_sfq_next(handle, batch_size)
            seconds["read"] += time.perf_counter() - start
            if n == -2:  # the strict zip: R1 and R2 ended apart
                raise ValueError(lib.scx_sfq_error(handle).decode())
            if n < 0:
                raise RuntimeError(f"samplefastq read failed: {lib.scx_sfq_error(handle).decode()}")
            if n == 0:
                break
            total += n
            _, keep = _correct(corrector, _barcodes(lib.scx_sfq_buf(handle, b"cr"), n, cb_len), seconds)
            start = time.perf_counter()
            done = lib.scx_sfq_write(handle, n, keep.ctypes.data)
            if done < 0:
                raise RuntimeError(f"samplefastq write failed: {lib.scx_sfq_error(handle).decode()}")
            seconds["write"] += time.perf_counter() - start
            kept += done
        start = time.perf_counter()
        if lib.scx_sfq_close(handle) != 0:
            raise RuntimeError("samplefastq close failed")
        seconds["write"] += time.perf_counter() - start
        complete = True
    finally:
        lib.scx_sfq_free(handle)
        if not complete:
            _remove([output_prefix + ".R1", output_prefix + ".R2"])
    return kept, total


def fastq_metrics(fastq_files: Sequence[str], cb_spans, umi_spans, min_length: int,
                  output_prefix: str, n_threads: Optional[int] = None) -> int:
    """FastqMetrics' scan of the R1 shards into its four files, one shard a
    thread on at most ``n_threads`` threads (None: ``default_threads()``);
    returns the reads scanned. A read shorter than ``min_length`` is a
    ``ValueError``, an unreadable shard a ``RuntimeError``."""
    cb, n_cb = _spans(cb_spans)
    umi, n_umi = _spans(umi_spans)
    lib = library()
    calls["fastq_metrics"] += 1
    errbuf = _errbuf()
    n = lib.scx_fqm("\n".join(fastq_files).encode(), cb.ctypes.data, n_cb, umi.ctypes.data, n_umi,
                    min_length, output_prefix.encode(), _threads(n_threads), errbuf, ctypes.sizeof(errbuf))
    if n == -2:  # a read shorter than the read structure
        raise ValueError(_message(errbuf))
    if n < 0:
        raise RuntimeError(f"fastq metrics failed: {_message(errbuf)}")
    return n
