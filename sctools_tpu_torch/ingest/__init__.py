"""The host <-> device seam of the port, and the ingest ring before it.

``upload`` and ``pull`` are the twins of ``sctools_tpu.ingest.upload``
(ingest/__init__.py:74-130) and ``sctools_tpu.ingest.wire.pull``
(ingest/wire.py:81), without the JAX package's transfer ledger and retry
ladder. An upload copies a host array from pinned memory with
``non_blocking=True``; a pull copies a device tensor into pinned host memory
the same way and records a CUDA event, so the host waits for that one result
only when it reads it, not for the whole device. On the CPU both are plain
tensor views: nothing is copied or awaited.

``ring_frames`` (``.ring``) decodes BAM batches on a prefetch thread into
recycled packed column arenas (``.arena``); ``.framedebug`` is its stale-read
witness. ``SCTOOLS_TPU_PREFETCH_DEPTH`` (1..64, default 2) sets the queue's
depth and, through ``ring_slots``, the slot count (depth + 3).

The JAX package's ``WritebackRing`` (ingest/wire.py) is not ported as a
module: its asynchronous device-to-host copy is ``pull``'s pinned block and
CUDA event, and its slot states fed the JAX flight recorder, which the port
does not carry.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.prefetch import prefetch_depth
from .ring import NativeDecodeError, ring_frames, ring_slots

__all__ = [
    "NativeDecodeError",
    "Pulled",
    "prefetch_depth",
    "pull",
    "ring_frames",
    "ring_slots",
    "upload",
]


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device`` (asynchronous on CUDA).

    The pinned staging copy comes from PyTorch's caching host allocator,
    which keeps the block alive until the copy that reads it has run, so
    the caller may drop or reuse ``array`` at once.
    """
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class Pulled:
    """A device result on its way to the host; ``numpy()`` waits for it."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self._host = host
        self._event = event

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def pull(tensor: torch.Tensor) -> Pulled:
    """Start the copy of ``tensor`` to the host, on the current stream of
    the tensor's device (which need not be the current device: a mesh
    shard's results live on its own card), and record the event there."""
    if tensor.device.type == "cpu":
        return Pulled(tensor, None)
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    with torch.cuda.device(tensor.device):
        host.copy_(tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return Pulled(host, event)
