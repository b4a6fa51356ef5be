"""Mesh-sharded metric gatherers: ``CalculateCellMetrics --devices N`` and friends.

The port of ``sctools_tpu.parallel.gatherer`` (parallel/gatherer.py:38-243).
The streaming loop is the single-device gatherer's (entity-boundary cuts,
the carried tail, the ingest ring, ``_PIPELINE_DEPTH`` batches in flight);
only the dispatch/finalize pair changes. Each batch is partitioned by entity
hash over the mesh (``shard.partition_columns``), each shard runs the
engine on its own device at the shard's padded size and compacts its rows
there, and the disjoint rows of all shards are concatenated and ordered by
entity code: the entity vocabulary's order, the single-device row order.
The CSV equals the single-device CSV byte for byte, because the engine's
per-entity results do not depend on where an entity lands in a batch, the
partition never splits an entity, and both paths make the same schema
decision (``MetricGatherer._prepare_batch``).

Each batch's dispatch is the ``gatherer.batch`` fault site
(``sched.faults``), as in JAX: a crash there is a worker dying mid-chunk,
with earlier batches already in the writer's temp file. Not ported: JAX's
heartbeats, dispatch records and the guard ladder (a failed batch fails
the command, and the writer discards its temp file).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import ingest
from ..io.packed import KEY_HI_SHIFT
from ..metrics.gatherer import (
    GatherCellMetrics,
    GatherGeneMetrics,
    _pack_wire,
    prepacked_gate,
    wire_result_names,
)
from ..ops.segments import entity_bucket
from ..sched import faults
from .metrics import run_sharded_metrics
from .shard import partition_columns


class _ShardedMixin:
    """Overrides the dispatch/finalize pair with the mesh-sharded pass; the
    inherited streaming loop treats the tuple returned here as opaque."""

    def __init__(self, *args, mesh=None, **kwargs):
        if mesh is None:
            raise ValueError("sharded gatherers require a mesh")
        # the single-device field names the mesh's first device; every
        # shard's work goes to its own
        kwargs["device"] = mesh.devices[0]
        super().__init__(*args, **kwargs)
        self._mesh = mesh
        self._n_shards = mesh.size

    def _dispatch_device_batch(self, frame, pad_to: int, presorted: bool = True):
        faults.fire("gatherer.batch", name=str(self._bam_file))
        start_time = time.perf_counter()
        # the same schema decision as the single-device path: byte-identical
        # CSVs need both to derive the per-record quality floats alike. The
        # run-keyed wire is a transport choice and does not apply here
        prepacked = presorted and prepacked_gate(frame, self.entity_kind)
        cols, static_flags = self._prepare_batch(frame, prepacked)
        if prepacked:
            # partition by the outer entity code recovered from the packed
            # key; the per-shard valid prefix count replaces the mask
            n = len(cols["flags"])
            valid = np.arange(n) < cols.pop("n_valid")[0]
            outer = (cols["key_hi"] >> KEY_HI_SHIFT).astype(np.int32)
            cols["valid"] = valid
            cols["_outer"] = outer
            stacked = partition_columns(cols, self._n_shards, key="_outer")
            del stacked["_outer"]
            stacked["n_valid"] = stacked.pop("valid").sum(axis=1).astype(np.int32)[:, None]
            engine_flags = dict(presorted=True, prepacked=True, **static_flags)
            outer_codes = outer[valid]
            # one int32 wire block a shard, as the single-device path ships
            per_shard = [
                {"wire": _pack_wire({k: v[s] for k, v in stacked.items()}, static_flags)}
                for s in range(self._n_shards)
            ]
        else:
            # plain named columns; the partition keeps record order, so each
            # shard's groups stay ascending and presorted passes through
            stacked = partition_columns(cols, self._n_shards, key=self.entity_kind)
            engine_flags = dict(presorted=presorted)
            outer_codes = np.asarray(cols[self.entity_kind])[np.asarray(cols["valid"], dtype=bool)]
            per_shard = [{k: v[s] for k, v in stacked.items()} for s in range(self._n_shards)]
        shard_size = max(v.shape[1] for v in stacked.values())
        # per-shard entity counts are host-knowable (distinct codes routed
        # to each shard), so each shard compacts its rows on its device into
        # the block the single-device path pulls, sized by the entity bucket
        unique_codes = np.unique(outer_codes)
        counts = np.bincount(unique_codes % self._n_shards, minlength=self._n_shards)
        k = entity_bucket(int(counts.max(initial=1)), shard_size)
        int_names, float_names = wire_result_names(self.columns)
        self.seconds["pack"] += time.perf_counter() - start_time
        start_time = time.perf_counter()
        staged = [
            {name: ingest.upload(array, device) for name, array in shard.items()}
            for shard, device in zip(per_shard, self._mesh.devices)
        ]
        blocks, n_entities = run_sharded_metrics(
            staged, shard_size, self.entity_kind, compact=(int_names, float_names, k), **engine_flags
        )
        # one pull a shard: its block with its entity count appended
        pulls = [
            ingest.pull(_with_count(block, count)) for block, count in zip(blocks, n_entities)
        ]
        self.batches.append(dict(
            records=frame.n_records, padded=self._n_shards * shard_size, presorted=presorted,
            prepacked=prepacked, run_keyed=False, entities=int(unique_codes.size),
            shards=self._n_shards, events=None,
            h2d_bytes=sum(a.nbytes for shard in per_shard for a in shard.values()),
        ))
        self.seconds["dispatch"] += time.perf_counter() - start_time
        return self._entity_names(frame), pulls, len(int_names) + len(float_names), k, int_names, float_names

    def _finalize_device_batch(self, entity_names, pulls, n_columns: int, k: int, int_names,
                               float_names, out) -> None:
        start = time.perf_counter()
        views = [pulled.numpy() for pulled in pulls]  # waits for this batch's pulls only
        self.seconds["wait"] += time.perf_counter() - start
        start = time.perf_counter()
        # entity vocabulary order == ascending codes == the single-device
        # row order; shards are disjoint, so this sort is the whole merge.
        # Column-major throughout: the concat is along the entity axis
        cols = np.concatenate(
            [view[:-1].reshape(n_columns, k)[:, : int(view[-1])] for view in views], axis=1
        )
        cols = cols[:, np.argsort(cols[0])]
        ints = cols[: len(int_names)]
        floats = cols[len(int_names):].view(np.float32)
        self._write_device_rows(entity_names, cols.shape[1], int_names, float_names, ints, floats, out)
        self.seconds["csv"] += time.perf_counter() - start


def _with_count(block: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """A shard's ``[C, k]`` result block flattened, its entity count last:
    one tensor, one pull."""
    return torch.cat([block.reshape(-1), count.reshape(1).to(block.dtype)])


class ShardedCellMetrics(_ShardedMixin, GatherCellMetrics):
    """GatherCellMetrics over a device mesh (cells never span shards)."""


class ShardedGeneMetrics(_ShardedMixin, GatherGeneMetrics):
    """GatherGeneMetrics over a device mesh (genes never span shards)."""


def sharded_gatherer_cls(kind: str):
    return ShardedCellMetrics if kind == "cell" else ShardedGeneMetrics
