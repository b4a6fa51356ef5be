"""Sharded molecule counting over a device mesh.

The port of ``sctools_tpu.parallel.count`` (parallel/count.py:31-65) and of
the count accumulator's mesh route (``_add_batch_sharded``,
sctools_tpu/count.py:159-230). Records partition by cell hash, each device
counts its shard with ``ops.counting.count_molecules``, and the host
concatenates the disjoint molecules: query groups stay whole because every
alignment of one query carries the same CB. A carried ``_orig`` column maps
each shard's ``first_index`` back to the record's position in the batch, so
the cross-batch dedup and the first-observation row order are the
single-device ones.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import ingest
from ..count import RESULT_COLUMNS, UPLOAD_COLUMNS, device_count_columns
from ..ops.counting import count_molecules
from .mesh import DEFAULT_AXIS, Mesh
from .metrics import _check_shard_count
from .shard import partition_columns


def sharded_count_molecules(
    stacked_cols: Dict[str, np.ndarray], mesh: Mesh, axis_name: str = DEFAULT_AXIS
) -> Dict[str, List[torch.Tensor]]:
    """Per-shard unique molecules over cell-sharded records.

    ``stacked_cols``: [n_shards, S] host columns in the count's schema
    (``count.device_count_columns``), partitioned so a cell never spans
    shards. Each shard uploads one ``[8, S]`` int32 block to its device.
    Returns the kernel's outputs per shard; ``is_molecule`` rows are
    disjoint across shards, so a matrix is their concatenation.
    """
    n_shards, shard_size = stacked_cols["qname"].shape
    _check_shard_count(n_shards, mesh, axis_name)
    results = []
    for s, device in enumerate(mesh.devices):
        block = np.stack([stacked_cols[name][s].astype(np.int32, copy=False) for name in UPLOAD_COLUMNS])
        staged = ingest.upload(block, device)
        results.append(count_molecules(dict(zip(UPLOAD_COLUMNS, staged)), num_segments=shard_size))
    return {name: [result[name] for result in results] for name in results[0]}


class ShardedPull:
    """One batch's molecules on their way from every shard; ``numpy()``
    waits for them and returns the single-device ``[5, m]`` block of
    ``count.RESULT_COLUMNS`` (molecules only, ``first_index`` in batch
    positions)."""

    def __init__(self, pulls, orig: np.ndarray):
        self._pulls = pulls
        self._orig = orig

    def numpy(self) -> np.ndarray:
        parts = []
        for pulled, orig in zip(self._pulls, self._orig):
            result = pulled.numpy()
            part = result[:, result[0] != 0]
            part[4] = orig[part[4]]
            parts.append(part)
        return np.concatenate(parts, axis=1)


def pack_sharded_count(frame, n_shards: int):
    """One batch's count columns partitioned by cell over ``n_shards`` (no
    batch padding: each shard pads to its own bucket), with the batch
    position of every record; returns ``(stacked, orig)``."""
    cols = device_count_columns(frame, pad_to=0)
    cols["_orig"] = np.arange(len(cols["valid"]), dtype=np.int32)
    stacked = partition_columns(cols, n_shards, key="cell")
    return stacked, stacked.pop("_orig")


def dispatch_sharded_count(stacked: Dict[str, np.ndarray], orig: np.ndarray, mesh: Mesh) -> ShardedPull:
    """Queue the count of packed shards: counted on every shard, each
    shard's five results pulled as one block."""
    out = sharded_count_molecules(stacked, mesh)
    pulls = [
        ingest.pull(torch.stack([out[name][s].to(torch.int32) for name in RESULT_COLUMNS]))
        for s in range(mesh.size)
    ]
    return ShardedPull(pulls, orig)
