"""Host-side record partitioning by entity hash.

The port of ``sctools_tpu.parallel.shard`` (parallel/shard.py:21-75), host
numpy code copied as it is. A cell barcode never spans chunks, as in the
reference's barcode binning: records are partitioned by
``entity_code % n_shards`` into stacked ``[n_shards, shard_size]`` columns,
one row per mesh device. ``shard_size`` is the power-of-two bucket of the
largest shard and the pads are ``PAD_FILLS`` (the u8 fill clamped to its
dtype), so every shard's padded columns are JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..io.packed import PAD_FILLS
from ..ops.segments import bucket_size


def shard_assignment(codes: np.ndarray, n_shards: int) -> np.ndarray:
    """Destination shard per record: round-robin over entity codes, so
    lexicographically adjacent entities spread across shards."""
    return np.asarray(codes, dtype=np.int64) % n_shards


def partition_columns(
    cols: Dict[str, np.ndarray],
    n_shards: int,
    key: str = "cell",
    shard_size: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Partition a columnar batch into ``[n_shards, shard_size]`` stacked columns.

    ``cols`` must hold equal-length 1-D arrays including a boolean ``valid``
    mask. Only valid records are distributed, in record order; each shard is
    padded to a common power-of-two ``shard_size`` (``bucket_size``) with
    ``valid=False`` rows.
    """
    valid = np.asarray(cols["valid"], dtype=bool)
    dest = shard_assignment(cols[key], n_shards)
    dest = np.where(valid, dest, -1)

    per_shard_indices = [np.nonzero(dest == s)[0] for s in range(n_shards)]
    max_count = max((len(ix) for ix in per_shard_indices), default=0)
    if shard_size is None:
        shard_size = bucket_size(max_count)
    elif max_count > shard_size:
        raise ValueError(f"shard_size={shard_size} too small: largest shard holds {max_count}")

    out: Dict[str, np.ndarray] = {}
    for name, col in cols.items():
        if name == "valid":
            continue
        col = np.asarray(col)
        fill = PAD_FILLS.get(name, False if col.dtype == bool else 0)
        if np.issubdtype(col.dtype, np.integer):
            # a sort-last fill (int32 max) clamps to the column's dtype:
            # the u8 m_ref pads with 0xFF, exactly the single-device fill
            fill = min(int(fill), int(np.iinfo(col.dtype).max))
        stacked = np.full((n_shards, shard_size), fill, dtype=col.dtype)
        for s, ix in enumerate(per_shard_indices):
            stacked[s, : len(ix)] = col[ix]
        out[name] = stacked
    out["valid"] = np.zeros((n_shards, shard_size), dtype=bool)
    for s, ix in enumerate(per_shard_indices):
        out["valid"][s, : len(ix)] = True
    return out
