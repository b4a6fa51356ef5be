"""The port's native host layer: a streaming BAM decoder and an out-of-core
tag sort in C++, bound with ``ctypes``.

The port's copy of the BAM half of the JAX package's native layer
(``bamdecode.cpp``, ``tagsort.cpp`` and the parts of ``native_io.h`` they
use), over zlib where that copy uses libdeflate. It is the route of every
BAM command, as in the JAX package:

- ``stream_frames`` yields ``ReadFrame``s of a BGZF (or plain ``"BAM\\1"``)
  BAM, decoded on a thread pool (``io.packed.iter_frames_from_bam``);
- ``frame_from_bam`` decodes a whole file into one frame
  (``io.packed.frame_from_bam``);
- ``tagsort`` sorts a BAM by three tags and the query name into a BGZF
  file (``tagsort.tag_sort_bam_out_of_core``);
- ``tagsort_stream_frames`` streams the sort's merge through a pipe into
  the decoder, and may tee the sorted BAM to a file in the same pass (the
  fused ``TagSortBam --cell-metrics-output``).

The library is compiled with ``g++`` at first use, never at import, into
``_build/`` beside the package (a directory git ignores), under a name that
carries the hash of the sources and the flags. The compiler writes to a
temporary name that ``os.replace`` publishes, under an ``fcntl`` lock, so
that processes sharing the directory build once. A failed build raises
with the compiler's output. The flags name no ``-march``: a library built
on one host runs on any x86-64 host.

``SCTOOLS_TPU_THREADS`` (1..1024) sets the worker threads of the decoder
and of the sort's writer overlap, as in the JAX package; the default is
the CPU count, at most 16.

``calls`` counts, per function above, the calls that reached the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..io.packed import ReadFrame

_SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SOURCE_DIR.parent / "_build"
SOURCES = ("bamdecode.cpp", "tagsort.cpp")
HEADERS = ("native_io.h",)
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-Wall", "-Wextra"]
LINK_FLAGS = ["-lz", "-lpthread"]

calls: Dict[str, int] = {
    "stream_frames": 0, "frame_from_bam": 0, "tagsort": 0, "tagsort_stream_frames": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def library_path() -> Path:
    """Where the library of these sources and flags is built."""
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode() + b"\0" + (_SOURCE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libsctools_native-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH: it builds the port's native layer")
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    result = subprocess.run(
        [compiler, *CXX_FLAGS, *(str(_SOURCE_DIR / name) for name in SOURCES),
         *LINK_FLAGS, "-o", str(partial)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if result.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"building the native layer failed:\n{result.stdout}")
    os.replace(partial, target)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded native library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                BUILD_DIR.mkdir(exist_ok=True)
                with open(BUILD_DIR / "native.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                    if not target.exists():
                        _build(target)
            _lib = _bind(ctypes.CDLL(str(target)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, c_long, c_int, c_char_p = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p
    signatures = {
        "scx_stream_open": (p, [c_char_p, c_int, c_int, c_char_p, c_int]),
        "scx_stream_next": (c_long, [p, c_long]),
        "scx_stream_error": (c_char_p, [p]),
        "scx_stream_close": (None, [p]),
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
    size = lib.scx_vocab_size(handle, name)
    total = ctypes.c_long(0)
    data = lib.scx_vocab_bytes(handle, name, ctypes.byref(total))
    offsets = lib.scx_vocab_offsets(handle, name)
    raw = ctypes.string_at(data, total.value) if total.value else b""
    return [raw[offsets[i]:offsets[i + 1]].decode("ascii") for i in range(size)]


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


def _message(buffer) -> str:
    return buffer.value.decode(errors="replace")


def frame_from_bam(path: str) -> ReadFrame:
    """Decode a whole BAM file into one ReadFrame (query names included).

    Raises RuntimeError when the file cannot be opened or is malformed.
    """
    lib = library()
    calls["frame_from_bam"] += 1
    errbuf = _errbuf()
    handle = lib.scx_decode_bam(
        path.encode(), default_threads(), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"native BAM decode failed: {_message(errbuf)}")
    try:
        return _frame_from_handle(lib, handle, want_qname=True)
    finally:
        lib.scx_free(handle)


def _decoded_batches(lib, stream, batch_records: int, want_qname: bool, what: str):
    """ReadFrames of up to ``batch_records`` records from an open stream
    handle, until its end; the caller closes the handle."""
    while True:
        n = lib.scx_stream_next(stream, batch_records)
        if n < 0:
            raise RuntimeError(
                f"{what} failed: {lib.scx_stream_error(stream).decode(errors='replace')}")
        if n == 0:
            return
        yield _frame_from_handle(lib, stream, want_qname)


def stream_frames(path: str, batch_records: int, want_qname: bool = False) -> Iterator[ReadFrame]:
    """Yield ReadFrames of <= batch_records alignments in file order.

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
        path.encode(), default_threads(), int(want_qname), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"native BAM stream open failed: {_message(errbuf)}")
    try:
        yield from _decoded_batches(lib, handle, batch_records, want_qname, "native BAM stream")
    finally:
        lib.scx_stream_close(handle)


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
    n = lib.scx_tagsort(
        input_bam.encode(), output_bam.encode(), *keys, batch_records, compress_level,
        errbuf, ctypes.sizeof(errbuf))
    if n < 0:
        raise RuntimeError(f"native tagsort failed: {_message(errbuf)}")
    return n


TEE_LEVEL = 1  # the fused pass's sorted BAM, at the JAX package's level


def tagsort_stream_frames(
    input_bam: str,
    tag_keys: Sequence[str],
    scratch_prefix: str,
    stats: Dict[str, float],
    batch_records: int = 1 << 20,
    sort_batch_records: int = 500_000,
    bam_output: Optional[str] = None,
) -> Iterator[ReadFrame]:
    """Yield sorted ReadFrames, without query names, streamed straight out
    of the tag sort's merge.

    A worker thread runs the out-of-core sort (partials at
    ``<scratch_prefix>_<pid>_N``) and streams the merged records as plain
    BAM through a pipe, which the column decoder reads. With
    ``bam_output`` the same merge pass tees the sorted BAM to that file at
    BGZF level ``TEE_LEVEL``. Raises RuntimeError on a sort or decode
    failure. A failure, or a generator closed before its end, closes the
    pipe, which ends the worker, and leaves no partials and no
    ``bam_output``. At the end of the stream the sort's wall seconds by
    phase (``read``, ``sort``, ``partials``, ``merge``, on its own thread)
    and the number of partials it wrote (``partial_files``) go into
    ``stats``.
    """
    keys = _tag_bytes(tag_keys)
    lib = library()
    calls["tagsort_stream_frames"] += 1
    errbuf = _errbuf()
    handle = lib.scx_tagsort_pipe_open(
        input_bam.encode(), *keys, sort_batch_records, (bam_output or "").encode(),
        TEE_LEVEL, scratch_prefix.encode(), errbuf, ctypes.sizeof(errbuf))
    if not handle:
        raise RuntimeError(f"tagsort pipe open failed: {_message(errbuf)}")
    stream = None
    complete = False
    try:
        read_fd = lib.scx_tagsort_pipe_fd(handle)
        stream = lib.scx_stream_open(
            f"/proc/self/fd/{read_fd}".encode(), default_threads(), 0,
            errbuf, ctypes.sizeof(errbuf))
        if not stream:
            raise RuntimeError(f"tagsort stream open failed: {_message(errbuf)}")
        total = 0
        for frame in _decoded_batches(lib, stream, batch_records, False, "tagsort stream"):
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
        values = (ctypes.c_double * 5)()
        lib.scx_tagsort_pipe_stats(handle, values)
        stats.update(zip(("read", "sort", "partials", "merge"), values[:4]))
        stats["partial_files"] = int(values[4])
        complete = True
    finally:
        if stream is not None:
            lib.scx_stream_close(stream)
        lib.scx_tagsort_pipe_free(handle, int(complete))
