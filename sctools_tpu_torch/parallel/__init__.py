"""The device mesh: sharding, collectives and the sharded pipelines.

The port of ``sctools_tpu.parallel``. An entity (cell or gene) never spans
shards: records partition by entity-code hash (``shard``), each shard's
metric or count pass runs on its own device (``metrics``, ``count``,
``gatherer``), and re-keying between entity axes is an ``all_to_all`` over
the mesh (``collective``). The mesh is one process over a list of
``torch.device``s (``mesh``), as ``--devices N`` is one process over N
devices in the JAX package, or several processes joined into one global
mesh (``launch.initialize_distributed``, ``global_mesh``; the group and its
transport in ``distributed``), whose collectives cross the process
boundary. ``launch`` also holds the chunk queue: worker processes pull
SplitBam chunks from the fault-tolerant scheduler (``sched``) and merge
the parts.
"""

from . import collective, distributed
from .count import sharded_count_molecules
from .gatherer import ShardedCellMetrics, ShardedGeneMetrics, sharded_gatherer_cls
from .distributed import process_allgather, process_count, process_index
from .launch import (
    default_journal_dir,
    host_local_to_global,
    initialize_distributed,
    local_mesh,
    make_cell_metric_tasks,
    merge_sorted_csv_parts,
    process_chunks,
    run_cell_metrics_task,
    run_process_cell_metrics,
    sync_processes,
)
from .mesh import Mesh, collective_preflight, global_mesh, make_hybrid_mesh, make_mesh, mesh_fingerprint
from .metrics import (
    GlobalColumn,
    addressable_to_host,
    collect_sharded_rows,
    distributed_metrics_step,
    hybrid_metrics_step,
    required_reshard_capacity,
    reshard_by_key,
    sharded_entity_metrics,
    stack_to_host,
)
from .shard import partition_columns, shard_assignment
from .sort import distributed_sort, required_sort_capacity

__all__ = [
    "GlobalColumn",
    "Mesh",
    "ShardedCellMetrics",
    "ShardedGeneMetrics",
    "addressable_to_host",
    "collect_sharded_rows",
    "collective",
    "collective_preflight",
    "default_journal_dir",
    "distributed",
    "distributed_metrics_step",
    "distributed_sort",
    "global_mesh",
    "host_local_to_global",
    "hybrid_metrics_step",
    "initialize_distributed",
    "local_mesh",
    "make_cell_metric_tasks",
    "make_hybrid_mesh",
    "make_mesh",
    "merge_sorted_csv_parts",
    "mesh_fingerprint",
    "partition_columns",
    "process_allgather",
    "process_chunks",
    "process_count",
    "process_index",
    "required_reshard_capacity",
    "required_sort_capacity",
    "reshard_by_key",
    "run_cell_metrics_task",
    "run_process_cell_metrics",
    "shard_assignment",
    "sharded_count_molecules",
    "sharded_entity_metrics",
    "sharded_gatherer_cls",
    "stack_to_host",
    "sync_processes",
]
