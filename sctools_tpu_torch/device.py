"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means ``cuda``. A ``cuda``
request on a machine without a usable GPU raises: the port never falls back
to the CPU on its own. The CPU runs only when the caller asks for it with
``device="cpu"``, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` to run on: ``cuda`` by default, never a fallback."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU"
        )
    return resolved
