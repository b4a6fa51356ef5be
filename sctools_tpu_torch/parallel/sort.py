"""Cross-device sample sort: a globally sorted order over the mesh.

The port of ``sctools_tpu.parallel.sort`` (parallel/sort.py:50-350), the
classic regular-sampling sample sort:

1. each shard sorts its slice locally (lexicographic, padding last);
2. each shard contributes n_shards-1 evenly spaced samples; an all_gather
   and a sort of the pooled samples give n_shards-1 pivots, the same on
   every shard;
3. every record routes to shard ``count(pivots < key)`` through the
   capacity-bounded exchange of the metrics rekey (``reshard_by_key``);
4. each shard re-sorts what it received.

Flattening the shards in mesh order then gives the global sort. Routing
extends every key with a tiebreaker, the record's position in locally
sorted shard-major order (shard * S + index), so a heavy run of one key
splits across shards and the capacity stays near S / n_shards for any key
distribution. ``required_sort_capacity`` mirrors the device's pivots on the
host (same sample and pivot positions) for a tight capacity; an undersized
one raises ``ValueError`` before the step, and dropped records raise
``RuntimeError`` after it.

That mirror reads every shard's keys, so on a mesh that spans processes the
input is stacked host columns that every process holds whole; each process
sorts its own shards and returns them (the others' entries are None). A
global batch (``launch.host_local_to_global``) that is not fully
addressable raises ``RuntimeError`` before any collective, on every
process, as ``np.asarray`` of such a ``jax.Array`` does in JAX's
``required_sort_capacity``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import segments as seg
from . import collective
from .mesh import DEFAULT_AXIS, Mesh
from .metrics import (
    Sharded,
    _by_name,
    _check_shard_count,
    _dropped_count,
    _first_group,
    place,
    reshard_by_key,
)

_I32_MAX = np.iinfo(np.int32).max


def _masked_keys(cols, key_names) -> List[torch.Tensor]:
    valid = cols["valid"].to(torch.bool)
    return [torch.where(valid, cols[name].to(torch.int32), _I32_MAX) for name in key_names]


def _sample_positions(local_size: int, n_shards: int) -> np.ndarray:
    """Evenly spaced sample indices into a locally sorted slice (host and
    device agree on these by construction)."""
    k = n_shards - 1
    return ((np.arange(1, k + 1) * local_size) // n_shards).astype(np.int32)


def _pivot_positions(pool_size: int, n_shards: int) -> np.ndarray:
    return ((np.arange(1, n_shards) * pool_size) // n_shards).astype(np.int32)


def _positions_on(device, size: int, n_shards: int) -> torch.Tensor:
    """``_sample_positions`` / ``_pivot_positions`` made on the device, so
    that no host array is copied up inside the step."""
    return (torch.arange(1, n_shards, dtype=torch.int64, device=device) * size) // n_shards


def _dest_from_pivots(keys, pivot_cols) -> torch.Tensor:
    """count(pivot < key) per record, lexicographic over the key columns."""
    less = None
    equal_so_far = None
    for key, pivot in zip(keys, pivot_cols):
        k = key[:, None]
        p = pivot[None, :]
        this_less = p < k
        if less is None:
            less, equal_so_far = this_less, p == k
        else:
            less = less | (equal_so_far & this_less)
            equal_so_far = equal_so_far & (p == k)
    return torch.sum(less.to(torch.int32), dim=1, dtype=torch.int32)


def required_sort_capacity(stacked_cols: Dict[str, np.ndarray], key_names: List[str], n_shards: int) -> int:
    """Max (src, dst) bucket size of the sample-sort exchange: the device's
    pivot computation mirrored on the host (same sample and pivot
    positions), so the exchange can run with a tight capacity."""
    if not 1 <= len(key_names) <= 2:
        raise ValueError(f"distributed sort supports 1-2 key columns, got {len(key_names)}")
    local_size = np.asarray(stacked_cols[key_names[0]]).shape[1]
    n_rows = np.asarray(stacked_cols[key_names[0]]).shape[0]
    if n_rows * local_size >= 1 << 31:
        # the device tiebreaker (shard * S + index) is int32
        raise ValueError(
            f"total records {n_rows * local_size} overflow the int32 "
            "routing tiebreaker; use smaller per-batch shards"
        )
    valid = np.asarray(stacked_cols["valid"], dtype=bool)
    keys = [np.where(valid, np.asarray(stacked_cols[n], dtype=np.int64), _I32_MAX) for n in key_names]
    # pack lexicographic pairs into one comparable int64 (host only);
    # biasing each int32 key to unsigned keeps negative values ordered the
    # way the device's signed comparisons order them
    bias = np.int64(1) << 31
    packed = (keys[0] + bias) << 32
    if len(keys) > 1:
        packed = packed | (keys[1] + bias)
    # one stable sort per shard serves both the sample positions and the
    # valid-row bucket counting below
    order = np.argsort(packed, axis=1, kind="stable")
    packed_sorted = np.take_along_axis(packed, order, axis=1)
    # the device's routing tiebreaker: equal packed keys occupy the same
    # index range under any sort, so the bucket counts match the device's
    tie = (
        np.arange(n_shards, dtype=np.int64)[:, None] * local_size
        + np.arange(local_size, dtype=np.int64)[None, :]
    )
    sample_at = _sample_positions(local_size, n_shards)
    samples = packed_sorted[:, sample_at]
    sample_ties = tie[:, sample_at]
    pool_order = np.lexsort((sample_ties.reshape(-1), samples.reshape(-1)))
    pool = samples.reshape(-1)[pool_order]
    pool_tie = sample_ties.reshape(-1)[pool_order]
    pivot_at = _pivot_positions(pool.size, n_shards)
    pivots = pool[pivot_at]
    pivot_ties = pool_tie[pivot_at]
    most = 0
    for s in range(n_shards):
        mask = valid[s][order[s]]
        row = packed_sorted[s][mask]
        row_tie = tie[s][mask]
        # the device rule exactly: count(pivot < (key, tie)) lexicographic
        less = (pivots[None, :] < row[:, None]) | (
            (pivots[None, :] == row[:, None]) & (pivot_ties[None, :] < row_tie[:, None])
        )
        dest = less.sum(axis=1)
        if dest.size:
            most = max(most, int(np.bincount(dest, minlength=n_shards).max()))
    return most


def _sample_sort(shards, key_names, mesh: Mesh, axis_name, n_shards: int, capacity: int):
    """Steps 1-4 over the placed shards; returns (shards, n_dropped)."""
    local_size = next(local for local in shards if local is not None)[key_names[0]].shape[0]
    index = collective.axis_index(mesh, axis_name)

    def each(fn, values):  # another process's shard stays None
        return [fn(value) if value is not None else None for value in values]

    def local_sort(local):  # the payload rides the permutation once
        perm = seg.sort_permutation(_masked_keys(local, key_names))
        return {k: v[perm] for k, v in local.items()}

    # 1. local sort
    shards = each(local_sort, shards)
    route_keys = []
    for position, local in zip(index, shards):
        if local is None:
            route_keys.append(None)
            continue
        device = local[key_names[0]].device
        # routing tiebreaker: global position in locally sorted shard-major
        # order, unique per record
        tie = position * local_size + torch.arange(local_size, dtype=torch.int32, device=device)
        route_keys.append(_masked_keys(local, key_names) + [tie])

    # 2. pooled samples -> the same pivots on every shard
    pools = [
        each(lambda p: p.reshape(-1), collective.all_gather(
            each(lambda keys: keys[j][_positions_on(keys[j].device, local_size, n_shards)], route_keys),
            mesh, axis_name))
        for j in range(len(key_names) + 1)
    ]
    routed = []
    for s, local in enumerate(shards):
        if local is None:
            routed.append(None)
            continue
        pool = [column[s] for column in pools]
        perm = seg.sort_permutation(pool)
        at = _positions_on(pool[0].device, pool[0].shape[0], n_shards)
        pivots = [column[perm][at] for column in pool]
        # 3. the exchange by pivot bucket
        routed.append(dict(local, _dest=_dest_from_pivots(route_keys[s], pivots)))
    exchanged, dropped = reshard_by_key(routed, "_dest", mesh, axis_name, capacity=capacity, drop_key=True)

    # 4. local re-sort of the received records
    return each(local_sort, exchanged), dropped


def distributed_sort(
    stacked_cols: Dict[str, np.ndarray],
    key_names: List[str],
    mesh: Mesh,
    axis_name=DEFAULT_AXIS,
    capacity: Optional[int] = None,
) -> Sharded:
    """Sort sharded host columns globally by 1-2 int32 key columns.

    ``stacked_cols``: [n_shards, S] columns including ``valid``. Returns a
    sharded result of [n_shards * capacity] columns per shard: each shard
    locally sorted, shards ascending in mesh order, so the valid rows
    flattened in shard order are the global sort. Raises when an undersized
    ``capacity`` would drop records (the tight default comes from
    ``required_sort_capacity``).
    """
    if not 1 <= len(key_names) <= 2:
        raise ValueError(f"distributed sort supports 1-2 key columns, got {len(key_names)}")
    n_shards, _ = stacked_cols[key_names[0]].shape
    _check_shard_count(n_shards, mesh, axis_name)
    required = required_sort_capacity(stacked_cols, key_names, n_shards)
    if capacity is None:
        # bucketed, so batches of similar skew share one shape
        capacity = seg.bucket_size(max(required, 1), minimum=8)
    elif capacity < required:
        raise ValueError(f"sort capacity={capacity} too small: a (src,dst) bucket holds {required} records")
    shards = place(stacked_cols, mesh, axis_name)
    out, dropped = _sample_sort(shards, list(key_names), mesh, axis_name, n_shards, capacity)
    rows = _first_group(mesh, axis_name)
    n_dropped = _dropped_count(dropped, rows, mesh)
    if n_dropped:
        raise RuntimeError(
            f"distributed sort dropped {n_dropped} records: raise "
            "capacity (the tiebreaker balances key skew, so this "
            "indicates a sampling-slack shortfall; "
            "required_sort_capacity gives the tight bound)"
        )
    return _by_name([out[i] for i in rows])
