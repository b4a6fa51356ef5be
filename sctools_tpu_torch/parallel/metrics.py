"""Sharded metric computation over a device mesh, with all_to_all rekeying.

The port of ``sctools_tpu.parallel.metrics`` (parallel/metrics.py:41-428).
Records arrive sharded by *cell* hash (a cell never spans shards), so cell
metrics are exact per shard and merging is a concatenation of disjoint rows;
gene metrics need gene-disjoint shards, so the step *reshards* the batch by
gene hash with one ``all_to_all`` per column dtype, after which gene metrics
are exact per shard too.

Where JAX runs one ``shard_map`` program, the port runs the host loop of
that program: each shard's work (``metrics.device.compute_entity_metrics``,
the reshard's sort and scatter) is queued on its own device, shard after
shard in mesh order, and the exchange is ``collective.all_to_all``. Nothing
here waits on a device (no ``.item()``, no ``torch.nonzero``, no boolean-mask
indexing); the one host read is the drop counter, after the step, as in JAX.

A sharded value is a list in flat mesh order (``collective``); a sharded
result is a dict of such lists, one tensor per shard, which
``stack_to_host`` pulls into JAX's stacked ``[n_shards, ...]`` arrays.

On a mesh that spans processes (``parallel.global_mesh``) the input is a
global batch (``GlobalColumn``s from ``launch.host_local_to_global``, JAX's
global ``jax.Array``) or stacked host columns that every process holds
whole; each process places, computes and returns its own shards only (the
others' entries are None: JAX's ``addressable_shards``), and
``addressable_to_host`` pulls them. What every process must agree on is
allgathered over the control group: the reshard's capacity, the max of
each process's requirement over its shards, and the drop count, so that
every process raises together or none does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ingest
from ..metrics.device import compact_results_wire, compute_entity_metrics
from ..ops import segments as seg
from . import collective, distributed
from .mesh import DEFAULT_AXIS, Mesh

Sharded = Dict[str, List[Optional[torch.Tensor]]]


class GlobalColumn:
    """One column of a global batch, ``[n_shards, ...]`` over a mesh that
    may span processes (JAX's global ``jax.Array``): ``shards[i]`` is flat
    shard *i*'s row on its device where this process owns it, else None;
    ``host`` keeps this process's rows as they were given, in
    ``mesh.local_shards`` order."""

    def __init__(self, shards: List[Optional[torch.Tensor]], host: np.ndarray, mesh: Mesh):
        self.shards = shards
        self.host = host
        self.shape = (mesh.size,) + tuple(host.shape[1:])
        self.is_fully_addressable = mesh.is_fully_addressable

    def __array__(self, dtype=None, copy=None):
        """The stacked rows, where this process holds them all; else JAX's
        ``RuntimeError`` for a ``jax.Array`` over other processes' devices."""
        if not self.is_fully_addressable:
            raise RuntimeError(
                "Fetching value for a global batch that spans non-addressable (non process local) "
                "shards is not possible: use parallel.process_allgather, or its local rows (.host)"
            )
        return self.host if dtype is None else self.host.astype(dtype)


def _is_global(stacked_cols) -> bool:
    return isinstance(next(iter(stacked_cols.values())), GlobalColumn)


def place(stacked_cols, mesh: Mesh, axis_name=DEFAULT_AXIS) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Stacked ``[n_shards, ...]`` host columns -> one dict of tensors per
    local mesh shard, row ``axis_index`` on the shard's device (JAX's
    ``PartitionSpec(axis_name)`` placement: replicated along other axes),
    None for a shard another process owns. A global batch is placed already."""
    if _is_global(stacked_cols):
        return [
            {name: col.shards[i] for name, col in stacked_cols.items()} if i in mesh.local_shards else None
            for i in range(mesh.size)
        ]
    index = collective.axis_index(mesh, axis_name)
    return [
        {name: ingest.upload(np.asarray(col)[index[i]], mesh.devices[i]) for name, col in stacked_cols.items()}
        if i in mesh.local_shards else None
        for i in range(mesh.size)
    ]


def _first_group(mesh: Mesh, axis_name) -> List[int]:
    """The shards of one group, in axis order: one per stacked row."""
    return mesh.groups(axis_name)[0]


def _by_name(shards: Sequence[Optional[Dict[str, torch.Tensor]]]) -> Sharded:
    names = next(shard for shard in shards if shard is not None)
    return {name: [shard[name] if shard is not None else None for shard in shards] for name in names}


def stack_to_host(result: Sharded) -> Dict[str, np.ndarray]:
    """A sharded result pulled into stacked ``[n_shards, ...]`` arrays, all
    shards' pulls queued before the first is read. Every shard must be this
    process's (``addressable_to_host`` pulls a global result's)."""
    if any(t is None for tensors in result.values() for t in tensors):
        raise ValueError("the result spans other processes' shards: pull it with addressable_to_host")
    pulls = {name: [ingest.pull(t) for t in tensors] for name, tensors in result.items()}
    return {name: np.stack([p.numpy() for p in pulled]) for name, pulled in pulls.items()}


def addressable_to_host(result: Sharded) -> Dict[int, Dict[str, np.ndarray]]:
    """This process's shards of a sharded result, by row: JAX's
    ``addressable_shards``, pulled to the host."""
    rows = [row for row, tensor in enumerate(next(iter(result.values()))) if tensor is not None]
    pulls = {row: {name: ingest.pull(tensors[row]) for name, tensors in result.items()} for row in rows}
    return {row: {name: p.numpy() for name, p in pulled.items()} for row, pulled in pulls.items()}


def reshard_by_key(
    shards: Sequence[Dict[str, torch.Tensor]],
    key: str,
    mesh: Mesh,
    axis_name=DEFAULT_AXIS,
    capacity: Optional[int] = None,
    drop_key: bool = False,
) -> Tuple[List[Dict[str, torch.Tensor]], List[torch.Tensor]]:
    """Move every record to shard ``code % n_shards`` via all_to_all.

    ``shards`` are the per-shard local [S] columns, one dict per mesh shard
    (None for a shard another process owns).
    Each source packs its records into an [n_shards, capacity] send buffer
    (row = destination), the buffers are exchanged over ``axis_name``, and
    the received [n_shards, capacity] block (row = source) flattens into the
    new local batch of ``n_shards * capacity`` records, ``valid`` marking the
    real ones. Columns of one dtype ride one stacked exchange.

    ``capacity`` is the per-(src, dst) bucket (default: S, always enough).
    Returns ``(shards, n_dropped)``: records beyond an undersized capacity
    are dropped, and ``n_dropped`` (one int32 device scalar per shard)
    counts them for the caller to check after the step. ``drop_key``
    leaves the routing column out of the exchange.

    The send buffers are fresh tensors with one extra row that takes every
    record that does not travel (padding, overflow): the scatter never
    writes a buffer it reads, on distinct or repeated devices.
    """
    n_shards = mesh.axis_size(axis_name)
    first = next(local for local in shards if local is not None)
    local_size = first[key].shape[0]
    if capacity is None:
        capacity = local_size
    names = [n for n in first if not (drop_key and n == key)]
    sends: List[Optional[Dict[str, torch.Tensor]]] = []
    dropped: List[Optional[torch.Tensor]] = []
    for local in shards:
        if local is None:
            sends.append(None)
            dropped.append(None)
            continue
        device = local[key].device
        valid = local["valid"].to(torch.bool)
        dest = torch.where(valid, local[key].to(torch.int32) % n_shards, n_shards)
        # order records by destination; position within the destination run
        order = seg.sort_permutation([dest])
        sorted_dest = dest[order]
        starts = seg.run_starts([sorted_dest])
        iota = torch.arange(local_size, dtype=torch.int32, device=device)
        first = torch.cummax(torch.where(starts, iota, 0), 0).values
        col_in_bucket = iota - first
        travels = sorted_dest < n_shards
        ok = travels & (col_in_bucket < capacity)
        dropped.append(torch.sum((travels & ~ok).to(torch.int32), dtype=torch.int32))
        row = torch.where(ok, sorted_dest, n_shards).to(torch.int64)
        col = torch.where(ok, col_in_bucket, 0).to(torch.int64)
        buffers = {}
        for name in names:
            scol = local[name][order]
            if name == "valid":
                scol = scol.to(torch.bool) & ok
            base = torch.zeros((n_shards + 1, capacity), dtype=scol.dtype, device=device)
            base[row, col] = scol
            buffers[name] = base[:n_shards]
        sends.append(buffers)

    out: List[Optional[Dict[str, torch.Tensor]]] = [{} if send is not None else None for send in sends]
    by_dtype: Dict[torch.dtype, list] = {}
    mine = next(send for send in sends if send is not None)
    for name in names:
        by_dtype.setdefault(mine[name].dtype, []).append(name)
    for group in by_dtype.values():
        stacked = [torch.stack([send[n] for n in group]) if send is not None else None
                   for send in sends]  # [C, n_shards, cap]
        received = collective.all_to_all(stacked, mesh, axis_name, split_axis=1, concat_axis=1, tiled=True)
        for shard, block in zip(out, received):
            for i, name in enumerate(group if shard is not None else ()):
                shard[name] = block[i].reshape(n_shards * capacity)
    # the caller's column order, whatever the dtype grouping
    out = [{name: shard[name] for name in names} if shard is not None else None for shard in out]
    return out, dropped


def required_reshard_capacity(stacked_cols: Dict[str, np.ndarray], key: str, n_shards: int) -> int:
    """Max records any (src shard, dst shard) pair exchanges when rekeying:
    computed on the host before the step, so the exchange can use a tight
    capacity instead of the full shard size."""
    codes = np.asarray(stacked_cols[key])
    valid = np.asarray(stacked_cols["valid"], dtype=bool)
    most = 0
    for s in range(codes.shape[0]):
        dst = codes[s][valid[s]].astype(np.int64) % n_shards
        if dst.size:
            most = max(most, int(np.bincount(dst, minlength=n_shards).max()))
    return most


def _check_shard_count(n_shards: int, mesh: Mesh, axis_name) -> None:
    """A stacked batch must carry exactly one shard per device of the mesh
    axes, or records would vanish from the metrics with no error."""
    axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    mesh_size = mesh.axis_size(axis_name)
    if n_shards != mesh_size:
        raise ValueError(
            f"batch has {n_shards} shards but mesh axes {axes!r} hold "
            f"{mesh_size} devices; repartition with n_shards={mesh_size}"
        )


def run_sharded_metrics(
    shards: Sequence[Dict[str, torch.Tensor]],
    shard_size: int,
    kind: str,
    compact=None,
    **engine_flags,
):
    """The engine on each placed shard (``num_segments=shard_size``), queued
    shard after shard (None, another process's shard, stays None); with
    ``compact=(int_names, float_names, k)`` each result is compacted on its
    device into the fused column-major ``[ints + floats, k]`` int32 block.
    Returns the per-shard result dicts, or ``(blocks, n_entities)`` lists
    with ``compact``."""
    results = [
        compute_entity_metrics(local, num_segments=shard_size, kind=kind, **engine_flags)
        if local is not None else None
        for local in shards
    ]
    if compact is None:
        return results
    int_names, float_names, k = compact
    blocks = [compact_results_wire(result, int_names, float_names, k) if result is not None else None
              for result in results]
    return blocks, [result["n_entities"] if result is not None else None for result in results]


def sharded_entity_metrics(
    stacked_cols: Dict[str, np.ndarray],
    mesh: Mesh,
    kind: str,
    axis_name=DEFAULT_AXIS,
    compact=None,
    **engine_flags,
):
    """Per-shard metrics over entity-sharded records ([n_shards, S] host
    columns, partitioned by ``kind`` with ``shard.partition_columns``).

    Each device computes the full metric set for its local entities; the
    rows of different shards are disjoint by construction. ``engine_flags``
    pass through to ``compute_entity_metrics`` (presorted / prepacked /
    wide_genomic / small_ref / with_cb). Returns a sharded result dict, or
    with ``compact=(int_names, float_names, k)`` the per-shard
    ``([C, k] blocks, n_entities)`` lists.
    """
    first = next(iter(stacked_cols.values()))
    n_shards = first.shape[0]
    # the widest per-record dimension; scalar-ish columns (n_valid [n, 1])
    # must not win this max
    shard_size = max(v.shape[1] for v in stacked_cols.values())
    _check_shard_count(n_shards, mesh, axis_name)
    shards = place(stacked_cols, mesh, axis_name)
    out = run_sharded_metrics(shards, shard_size, kind, compact, **engine_flags)
    return out if compact is not None else _by_name(out)


def distributed_metrics_step(
    stacked_cols: Dict[str, np.ndarray],
    mesh: Mesh,
    axis_name=DEFAULT_AXIS,
    capacity: Optional[int] = None,
) -> Tuple[Sharded, Sharded]:
    """Cell AND gene metrics in one step over cell-sharded records.

    Cell metrics run in place on each shard; the batch is then resharded by
    gene hash (``reshard_by_key``) and gene metrics run on the gene-disjoint
    layout. ``axis_name`` may be a tuple of axes (a hybrid mesh): the rekey
    then spans them jointly.

    ``capacity`` (the per-(src, dst) reshard bucket) defaults to the tight
    bucketed requirement of the input; an explicit one below the
    requirement raises ``ValueError`` before any device work, and records
    dropped in the exchange raise ``RuntimeError`` after it.

    On a mesh that spans processes, a global batch's requirement is each
    process's over its own rows, allgathered to their max, and the drop
    count each process's, allgathered to their sum: every process builds
    the same capacity, and every one raises, or none does.
    """
    n_shards, shard_size = stacked_cols["cell"].shape
    _check_shard_count(n_shards, mesh, axis_name)
    if _is_global(stacked_cols):
        local = {name: stacked_cols[name].host for name in ("gene", "valid")}
        required = required_reshard_capacity(local, "gene", n_shards)
        if not mesh.is_fully_addressable:
            required = int(distributed.process_allgather(np.asarray([required]), tiled=True).max())
    else:
        required = required_reshard_capacity(stacked_cols, "gene", n_shards)
    if capacity is None:
        cap = seg.bucket_size(max(required, 1), minimum=8)
    elif capacity < required:
        raise ValueError(
            f"reshard capacity={capacity} too small: a (src,dst) shard "
            f"pair exchanges up to {required} records"
        )
    else:
        cap = capacity
    shards = place(stacked_cols, mesh, axis_name)
    cell_out = run_sharded_metrics(shards, shard_size, "cell")
    regene, dropped = reshard_by_key(shards, "gene", mesh, axis_name, capacity=cap)
    gene_out = run_sharded_metrics(regene, n_shards * cap, "gene")
    rows = _first_group(mesh, axis_name)
    n_dropped = _dropped_count(dropped, rows, mesh)
    if n_dropped:
        raise RuntimeError(
            f"reshard capacity={cap} too small: {n_dropped} records "
            "were dropped in the all_to_all rekey; rerun with a larger "
            "capacity (see required_reshard_capacity)"
        )
    return _by_name([cell_out[i] for i in rows]), _by_name([gene_out[i] for i in rows])


def _dropped_count(dropped, rows, mesh: Mesh) -> int:
    """The records dropped by the rows' shards, summed over every process
    of a mesh that spans processes."""
    pulls = [ingest.pull(dropped[i]) for i in rows if dropped[i] is not None]
    count = sum(int(p.numpy()) for p in pulls)
    if not mesh.is_fully_addressable:
        count = int(distributed.process_allgather(np.asarray([count], dtype=np.int64), tiled=True).sum())
    return count


def hybrid_metrics_step(
    stacked_cols: Dict[str, np.ndarray],
    mesh: Mesh,
    capacity: Optional[int] = None,
) -> Tuple[Sharded, Sharded]:
    """The distributed step on a 2-D (dcn, ici) mesh (``make_hybrid_mesh``):
    cells shard over the flattened device grid and the gene rekey spans
    both axes. Input: [n_slices * per_slice, S] cell-partitioned columns."""
    return distributed_metrics_step(stacked_cols, mesh, axis_name=tuple(mesh.axis_names), capacity=capacity)


def collect_sharded_rows(result) -> Dict[int, Dict[str, float]]:
    """Flatten a sharded result (per-shard tensor lists, or JAX's stacked
    host arrays) into {entity_code: {metric: value}}. Codes are disjoint
    across shards, so no merging arithmetic is needed."""
    if any(isinstance(v, list) for v in result.values()):
        result = stack_to_host(result)
    rows: Dict[int, Dict[str, float]] = {}
    n_shards = result["n_entities"].shape[0]
    skip = {"entity_code", "segment_valid", "n_entities"}
    for s in range(n_shards):
        n_entities = int(result["n_entities"][s])
        for r in range(n_entities):
            code = int(result["entity_code"][s][r])
            rows[code] = {k: result[k][s][r] for k in result if k not in skip}
    return rows
