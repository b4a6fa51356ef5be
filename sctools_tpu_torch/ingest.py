"""The host <-> device seam of the port.

The twin of ``sctools_tpu.ingest.upload`` (ingest/__init__.py:74-130) and
``sctools_tpu.ingest.wire.pull`` (ingest/wire.py:81), without the JAX
package's transfer ledger and retry ladder. An upload copies a host array
from pinned memory with ``non_blocking=True``; a pull copies a device tensor
into pinned host memory the same way and records a CUDA event, so the host
waits for that one result only when it reads it, not for the whole device.

On the CPU both are plain tensor views: nothing is copied or awaited.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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
    """Start the copy of ``tensor`` to the host, on the current stream."""
    if tensor.device.type == "cpu":
        return Pulled(tensor, None)
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Pulled(host, event)
