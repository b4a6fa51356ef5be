"""The device mesh: sharding, collectives and the sharded pipelines.

The port of ``sctools_tpu.parallel``. An entity (cell or gene) never spans
shards: records partition by entity-code hash (``shard``), each shard's
metric or count pass runs on its own device (``metrics``, ``count``,
``gatherer``), and re-keying between entity axes is an ``all_to_all`` over
the mesh (``collective``). The mesh is one process over a list of
``torch.device``s (``mesh``), as ``--devices N`` is one process over N
devices in the JAX package. ``launch`` is the chunk queue: worker
processes pull SplitBam chunks from the fault-tolerant scheduler
(``sched``) and merge the parts. The processes joined into one mesh
(``jax.distributed`` in JAX's ``launch.py``) are not ported here.
"""

from . import collective
from .count import sharded_count_molecules
from .gatherer import ShardedCellMetrics, ShardedGeneMetrics, sharded_gatherer_cls
from .launch import (
    default_journal_dir,
    local_mesh,
    make_cell_metric_tasks,
    merge_sorted_csv_parts,
    run_cell_metrics_task,
    run_process_cell_metrics,
)
from .mesh import Mesh, collective_preflight, make_hybrid_mesh, make_mesh, mesh_fingerprint
from .metrics import (
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
    "Mesh",
    "ShardedCellMetrics",
    "ShardedGeneMetrics",
    "collect_sharded_rows",
    "collective",
    "collective_preflight",
    "default_journal_dir",
    "distributed_metrics_step",
    "distributed_sort",
    "hybrid_metrics_step",
    "local_mesh",
    "make_cell_metric_tasks",
    "make_hybrid_mesh",
    "make_mesh",
    "merge_sorted_csv_parts",
    "mesh_fingerprint",
    "partition_columns",
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
]
