"""Line iteration over (possibly compressed) sequence files.

Capability match for the reference reader contract (src/sctools/reader.py:
37-204): compression detected from magic bytes rather than extensions,
seamless multi-file iteration, str lines for ``mode='r'`` and bytes for
``mode='rb'``, optional header-comment skipping, index-based record
subsetting, and lockstep zipping of multiple readers. Built as a small
dispatch table over content signatures plus plain generators.

The port's own copy of ``sctools_tpu.reader``.
"""

from __future__ import annotations

import bz2
import gzip
import os
from typing import Callable, Generator, Iterable, List, Sequence, Set, Union

# content signature -> opener. Longest signatures first so prefixes cannot
# shadow each other.
_SIGNATURES: Sequence[tuple] = (
    (b"BZh", bz2.open),
    (b"\x1f\x8b", gzip.open),
)


def infer_open(file_: str, mode: str) -> Callable:
    """Opener for ``file_`` with compression inferred from magic bytes."""
    with open(file_, "rb") as probe:
        head = probe.read(max(len(sig) for sig, _ in _SIGNATURES))
    for signature, opener in _SIGNATURES:
        if head.startswith(signature):
            text_mode = "rt" if mode == "r" else mode
            return lambda path: opener(path, mode=text_mode)
    return lambda path: open(path, mode=mode)


def _normalize_files(files: Union[str, Iterable]) -> List[str]:
    if isinstance(files, str):
        return [files]
    if isinstance(files, Iterable):
        out = list(files)
        if not all(isinstance(f, str) for f in out):
            raise TypeError("All passed files must be type str")
        return out
    raise TypeError("Files must be a string filename or a list of such names.")


class Reader:
    """Iterate one or more files as a single line stream.

    ``mode='r'`` yields str, ``'rb'`` bytes; leading lines starting with
    ``header_comment_char`` are skipped per file.
    """

    def __init__(self, files="-", mode="r", header_comment_char=None):
        self._files = _normalize_files(files)
        if mode not in ("r", "rb"):
            raise ValueError("Mode must be one of 'r', 'rb'")
        self._mode = mode
        if header_comment_char is not None and mode == "rb":
            header_comment_char = header_comment_char.encode()
        self._header_comment_char = header_comment_char

    @property
    def filenames(self) -> List[str]:
        return self._files

    @property
    def size(self) -> int:
        """Collective on-disk size of all files in bytes."""
        return sum(os.stat(f).st_size for f in self._files)

    def __len__(self) -> int:
        """Number of records; consumes the files to count them."""
        return sum(1 for _ in self)

    def _iter_one(self, path: str):
        handle = infer_open(path, self._mode)(path)
        try:
            lines = iter(handle)
            comment = self._header_comment_char
            if comment is not None:
                for line in lines:
                    if not line.startswith(comment):
                        yield line
                        break
            yield from lines
        finally:
            handle.close()

    def __iter__(self):
        for path in self._files:
            yield from self._iter_one(path)

    def select_record_indices(self, indices: Set) -> Generator:
        """Yield only records whose ordinal index is in ``indices``."""
        remaining = set(indices)
        for ordinal, record in enumerate(self):
            if ordinal in remaining:
                yield record
                remaining.discard(ordinal)
                if not remaining:
                    return


def zip_readers(*readers, indices=None) -> Generator:
    """Iterate multiple readers in lockstep, optionally subset to indices."""
    if indices:
        yield from zip(*(r.select_record_indices(indices) for r in readers))
    else:
        yield from zip(*readers)
