"""Atomic artifact commit: tmp-file + rename, and content hashing.

The port's copy of ``sctools_tpu.sched.commit``; the metric CSV writer
names its temp file with :func:`inflight_path` too.

A task killed at ANY instant must never leave a partial artifact that a
downstream merge could swallow. The contract: writers produce into a
process-unique ``*.inflight.<pid>`` sibling and ``os.replace`` onto the
final path only when complete. Readers (the merge, the journal validator)
only ever glob final names, so an in-flight or abandoned temp file is
invisible to them; a crash leaves debris, never a lie.
"""

from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager
from typing import Iterator, Optional


def inflight_path(final_path: str) -> str:
    """The process-unique temp sibling for ``final_path``."""
    return f"{final_path}.inflight.{os.getpid()}"


@contextmanager
def atomic_output(final_path: str) -> Iterator[str]:
    """Yield a temp path; atomically publish it as ``final_path`` on exit.

    On exception the temp file is removed and nothing is published.
    ``os.replace`` overwrites an existing final file — re-running a task
    after a crash-after-rename is therefore idempotent.
    """
    tmp = inflight_path(final_path)
    try:
        yield tmp
        os.replace(tmp, final_path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def content_signature(path: str) -> str:
    """rsync-style ``size:mtime_ns`` content-generation signature.

    The ONE definition of the input signature task ids bind to: the task
    list (``parallel.launch.make_cell_metric_tasks``) stamps it into
    payloads and ``sched retry-quarantined`` re-verifies it before
    resurrecting a quarantined task — both sides must always agree on
    the format, or requeue refusals become format-mismatch noise.
    """
    stat = os.stat(path)
    return f"{stat.st_size}:{stat.st_mtime_ns}"


def sha256_file(path: str, chunk: int = 1 << 20) -> Optional[str]:
    """Hex content hash of ``path`` (None when unreadable)."""
    digest = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk)
                if not block:
                    break
                digest.update(block)
    except OSError:
        return None
    return digest.hexdigest()
