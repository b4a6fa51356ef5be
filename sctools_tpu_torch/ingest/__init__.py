"""The host <-> device seam of the port, and the ingest ring before it.

``upload`` is the twin of ``sctools_tpu.ingest.upload``
(ingest/__init__.py:74-130), and ``pull``, ``Pulled`` and the
``WritebackRing`` (``.wire``) are the twins of ``sctools_tpu.ingest.wire``.
Each crossing names its ``site`` and writes the bytes it moves into the
transfer ledger (``obs.xprof.record_transfer``, a no-op while recording is
off), under the JAX package's site names where the port has the site, and
runs under the guard's transient ladder (``guard.retrying``): an upload on
the ``upload`` leg's deadline, a pull's wait on the ``pull`` leg's (or the
``compute`` leg's when only that one is set). An upload copies a host
array from pinned memory with ``non_blocking=True``; a pull copies a
device tensor into pinned host memory the same way and records a CUDA
event, so the host waits for that one result only when it reads it. On
the CPU both are plain tensor views: nothing is copied or awaited.

``ring_frames`` (``.ring``) decodes BAM batches on a prefetch thread into
recycled packed column arenas (``.arena``); ``.framedebug`` is its stale-read
witness. ``SCTOOLS_TPU_PREFETCH_DEPTH`` (1..64, default 2) sets the queue's
depth and, through ``ring_slots``, the slot count (depth + 3). The ring's
consumer side pulls each frame under the ``decode`` leg's deadline.
``NativeDecodeError`` is the guard's (``guard.errors``): a ``PoisonData``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import guard
from ..guard.errors import NativeDecodeError
from ..obs import xprof
from ..utils.prefetch import prefetch_depth
from .ring import DECODE_PARTS, ring_frames, ring_slots
from .wire import Pulled, WritebackRing, pull, wire_overlap_enabled

__all__ = [
    "DECODE_PARTS",
    "NativeDecodeError",
    "Pulled",
    "WritebackRing",
    "prefetch_depth",
    "pull",
    "ring_frames",
    "ring_slots",
    "upload",
    "wire_overlap_enabled",
]


def upload(array: np.ndarray, device: torch.device, site: str) -> torch.Tensor:
    """``array`` as a tensor on ``device`` (asynchronous on CUDA), its
    bytes ledgered under ``site``.

    The pinned staging copy comes from PyTorch's caching host allocator,
    which keeps the block alive until the copy that reads it has run, so
    the caller may drop or reuse ``array`` at once. The copy is the
    retried unit of the guard's transient ladder: a transient re-stages
    the same host array.
    """
    host = torch.from_numpy(np.ascontiguousarray(array))

    def _put() -> torch.Tensor:
        if device.type == "cpu":
            return host
        return host.pin_memory().to(device, non_blocking=True)

    staged = guard.retrying(_put, site=site, leg="upload")
    xprof.record_transfer("h2d", host.nbytes, site=site)
    return staged
