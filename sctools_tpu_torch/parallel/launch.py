"""Multi-process launch: processes joined into one mesh, and the chunk queue.

The port of ``sctools_tpu.parallel.launch`` (parallel/launch.py:1-502). The
cross-VM story has two halves.

1. **The chunk queue.** The reference's scatter-gather (SplitBam cuts a BAM
   into cell-disjoint chunks, each chunk's metrics run in their own
   process, a merge joins the parts; reference
   src/sctools/metrics/README.md:19-28) becomes one journaled queue: every
   worker process pulls chunks from it (``sched.WorkQueue``), computes their
   metrics with ``ShardedCellMetrics`` on its own devices, and publishes one
   part a chunk, canonically named by the chunk's global index. A dead or
   straggling peer's chunks are stolen after its lease TTL, failing chunks
   retry with backoff and are then quarantined, and a re-launch resumes from
   the journal. ``merge_sorted_csv_parts`` joins the parts into the CSV of
   a one-shot run, byte for byte, after checking that the part sequence has
   no gap or duplicate and equals the journal's committed set
   (``sched.parts``).
2. **The global mesh.** ``initialize_distributed`` joins the processes into
   one ``torch.distributed`` group (``parallel.distributed``: gloo for
   control, NCCL or gloo for device tensors); ``global_mesh`` lays N
   processes x D local devices out process-major (process p owns global
   shards [p*D, (p+1)*D)); ``host_local_to_global`` feeds each process's
   shards into one global batch; and ``distributed_metrics_step``'s gene
   rekey then crosses the process boundary with no change to the step.
   ``sync_processes`` is the barrier between the halves (before the rank-0
   merge).

Each entry point here takes ``device``: ``cuda`` (every card of this process)
unless the caller asks for ``cpu`` (one CPU shard, as JAX's
``jax.local_devices()`` is under ``JAX_PLATFORMS=cpu``). Worker processes
must pass it: no environment variable selects the port's device.

A worker points the guard's poison-record sidecars at
``<journal>/quarantine`` (``guard.quarantine.set_quarantine_dir``), where
``sched status`` and ``obs audit`` read them, as JAX's does (:268 on).
Differs from JAX on purpose: a task whose device dispatch was degraded by
JAX's guard ladder reruns there on the CPU backend (launch.py:211-226);
the port's guard has no rungs, so a failing task retries and is then
quarantined. The ``distributed:chunk_metrics``, ``distributed:chunk_queue``
and ``distributed:merge_parts`` spans and the ``chunks_processed`` counter
are JAX's, as are the SIGTERM flight recorder a worker installs and the
merge's audit record (``audit-merge.jsonl``). ``process_chunks`` is the
static round-robin share of the chunks, for callers that need a fixed
partition and no shared journal.
"""

from __future__ import annotations

import gzip
import heapq
import os
import zlib
from contextlib import ExitStack
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ingest, obs
from ..guard import quarantine
from ..obs import audit
from ..device import DeviceLike, resolve
from ..sched import QuarantinedTasksError, WorkQueue, atomic_output, faults, make_task
from ..sched.commit import content_signature
from ..sched.parts import validated_parts
from . import distributed
from .gatherer import ShardedCellMetrics
from .mesh import DEFAULT_AXIS, Mesh, make_mesh, mesh_fingerprint
from .metrics import GlobalColumn

# JAX's launch.initialize_distributed and launch.global_mesh
from .distributed import initialize as initialize_distributed  # noqa: E402,F401
from .mesh import global_mesh  # noqa: E402,F401


def host_local_to_global(
    stacked_local: Dict[str, np.ndarray], mesh: Mesh, axis_name=DEFAULT_AXIS
) -> Dict[str, GlobalColumn]:
    """This process's ``[D, S]`` host columns -> one global ``[n_shards, S]``
    batch (JAX's ``multihost_utils.host_local_array_to_global_array``).

    Every process calls it with ITS rows, one a local shard of ``mesh`` in
    ``mesh.local_shards`` order (process-major on ``global_mesh``); each is
    uploaded to its shard's device, and the other processes' shards stay
    absent. ``axis_name`` must span the whole mesh. The batch feeds
    ``distributed_metrics_step`` / ``hybrid_metrics_step`` unchanged.
    """
    if mesh.axis_size(axis_name) != mesh.size:
        raise ValueError(f"axis {axis_name!r} holds {mesh.axis_size(axis_name)} of the mesh's {mesh.size} "
                         "devices: a global batch shards over all of them")
    out = {}
    for name, col in stacked_local.items():
        col = np.asarray(col)
        if col.shape[0] != len(mesh.local_shards):
            raise ValueError(f"{name}: {col.shape[0]} local rows for this process's "
                             f"{len(mesh.local_shards)} shards")
        shards = [None] * mesh.size
        for row, shard in enumerate(mesh.local_shards):
            shards[shard] = ingest.upload(col[row], mesh.devices[shard], site="parallel.upload")
        out[name] = GlobalColumn(shards, col, mesh)
    return out


def sync_processes(name: str) -> None:
    """Barrier across every process (e.g. before the rank-0 merge): JAX's
    ``sync_global_devices``, which allgathers the CRC-32 of ``name`` and
    raises on every process when the names differ."""
    mine = np.uint32(zlib.crc32(name.encode()))
    everyone = distributed.process_allgather(np.asarray([mine]), tiled=True)
    if not np.all(everyone == mine):
        raise AssertionError(f"sync_global_devices name mismatch ('{name}'). Expected: {everyone}; got: {mine}.")


def local_mesh(device: DeviceLike = None, axis_name: str = DEFAULT_AXIS) -> Mesh:
    """A mesh over this process's own devices, for chunk-local compute:
    every card on ``cuda``, one shard on ``cpu`` (``make_mesh(device="cpu")``
    would give one a core, and announce another mesh than JAX's worker)."""
    if resolve(device).type == "cpu":
        return Mesh([torch.device("cpu")], (axis_name,))
    return make_mesh(axis_name=axis_name)


def process_chunks(chunks: Sequence[str], num_processes: int, process_id: int) -> List[tuple]:
    """The static round-robin share of the chunk files as (global_index, path),
    over the chunks in sorted order (like the reference's barcode -> bin
    round-robin, src/sctools/bam.py:442-448). The metrics workers pull from
    the work queue instead (``run_process_cell_metrics``)."""
    return [(index, chunk) for index, chunk in enumerate(sorted(chunks)) if index % num_processes == process_id]


def default_journal_dir(part_stem: str) -> str:
    """The shared journal directory for a run writing ``part_stem`` parts.

    Derived from the *directory* of the stem (shared storage), not the
    per-process stem itself, so every worker of a run resolves the same
    journal without extra plumbing.
    """
    return os.path.join(
        os.path.dirname(os.path.abspath(part_stem)), "sched-journal"
    )


def make_cell_metric_tasks(
    chunks: Sequence[str],
    out_dir: str,
    mitochondrial_gene_ids: frozenset = frozenset(),
) -> List:
    """The chunk-metrics task list (content-hashed ids, shared by workers).

    Payloads are self-contained (chunk path, the chunk's content signature,
    global part index, output directory, mito gene set), so ``python -m
    sctools_tpu_torch.sched resume`` can re-run any task in a fresh
    process, and they are the JAX package's: the same chunks and out dir
    give the same task ids under either package. The signature binds a
    task to its chunk's content generation, so re-splitting into
    same-named files yields new ids, and retry-quarantined verifies it.
    """
    return [
        make_task(
            "cell_metrics",
            f"chunk{index:04d}",
            {
                "chunk": os.path.abspath(chunk),
                "chunk_sig": content_signature(chunk),
                "index": index,
                "out_dir": os.path.abspath(out_dir),
                "mito": sorted(mitochondrial_gene_ids),
            },
        )
        for index, chunk in enumerate(sorted(chunks))
    ]


def run_cell_metrics_task(task, mesh: Optional[Mesh] = None, device: DeviceLike = None) -> str:
    """Execute ONE chunk-metrics task; returns the committed part path.

    The runner behind both run_process_cell_metrics's queue loop and the CLI
    ``resume`` command (``sched.runners``). The part path is canonical:
    derived from the payload alone (``out_dir`` + global chunk index),
    never from the worker, so a task stolen from a live straggler that
    finishes anyway re-publishes the byte-identical file onto the same
    path. Publication is atomic through the CSV writer, so a crash at any
    instant leaves no partial part. ``mesh`` defaults to ``local_mesh``
    of ``device``.
    """
    payload = task.payload
    index = int(payload["index"])
    chunk = payload["chunk"]
    part = os.path.join(payload["out_dir"], "metrics") + f".part{index:04d}"
    if faults.should_corrupt("task.input", name=task.name):
        # poison-task injection: process a garbled copy of the chunk so
        # the decode fails deterministically on every attempt
        poisoned = f"{part}.poison.bam"
        with open(chunk, "rb") as f:
            data = f.read()
        with open(poisoned, "wb") as f:
            f.write(faults.mangle(data))
        chunk = poisoned
    with obs.span("distributed:chunk_metrics", chunk=index):
        ShardedCellMetrics(
            chunk, part, set(payload.get("mito", ())),
            mesh=mesh if mesh is not None else local_mesh(device),
        ).extract_metrics()
    obs.count("chunks_processed")
    return part + ".csv.gz"


def run_process_cell_metrics(
    chunks: Sequence[str],
    part_stem: str,
    num_processes: int,
    process_id: int,
    mitochondrial_gene_ids: frozenset = frozenset(),
    mesh: Optional[Mesh] = None,
    journal_dir: Optional[str] = None,
    lease_ttl: float = 30.0,
    max_attempts: int = 3,
    backoff_base: float = 0.25,
    device: DeviceLike = None,
) -> List[str]:
    """Work the shared chunk queue into per-chunk CSV parts.

    Every worker pulls from the queue under ``journal_dir`` (default: a
    shared ``sched-journal/`` next to the parts), so a dead or straggling
    peer's chunks are stolen after its lease TTL, transient failures retry
    with backoff, and a re-launch skips committed parts.
    ``num_processes``/``process_id`` only name this worker.

    ``mesh`` defaults to ``local_mesh(device)``. Returns the part paths
    THIS worker committed. Parts are canonically named
    ``<dir(part_stem)>/metrics.partNNNN.csv.gz`` by global chunk index.
    Raises :class:`sched.QuarantinedTasksError` after the queue drains if
    poison chunks were quarantined (the rest of the run still completes
    and commits first).
    """
    mesh = mesh if mesh is not None else local_mesh(device)
    tasks = make_cell_metric_tasks(
        chunks,
        os.path.dirname(os.path.abspath(part_stem)),
        mitochondrial_gene_ids,
    )
    resolved_journal = journal_dir or default_journal_dir(part_stem)
    queue = WorkQueue(
        resolved_journal,
        worker_id=f"proc{process_id}-of-{num_processes}-{os.getpid()}",
        lease_ttl=lease_ttl,
        max_attempts=max_attempts,
        backoff_base=backoff_base,
        # the journal knows which mesh each worker serves; `sched status`
        # groups workers by it
        mesh=mesh_fingerprint(mesh),
    )
    # the guard's poison-record sidecars land next to the journal, where
    # `sched status` and `obs audit` look for them
    quarantine.set_quarantine_dir(os.path.join(resolved_journal, "quarantine"))
    # preemption insurance: persist the span ring + open-span stack to
    # flight.<worker>.jsonl on SIGTERM so a killed worker's postmortem
    # survives for `obs timeline` (no-op unless a trace dir is configured;
    # env-activated processes already installed it at import)
    obs.install_flight_recorder()
    with queue:
        queue.register(tasks)
        with obs.span("distributed:chunk_queue", chunks=len(tasks), process=process_id):
            summary = queue.run(
                lambda task: run_cell_metrics_task(task, mesh=mesh),
                only_ids=[t.id for t in tasks],
            )
    if summary.quarantined:
        raise QuarantinedTasksError(summary.quarantined)
    return summary.committed


def merge_sorted_csv_parts(
    part_pattern: str,
    output_path: str,
    compress: bool = True,
    journal_dir: Optional[str] = None,
    expected_parts: Optional[int] = None,
) -> int:
    """Join per-process CSV parts into the single-run CSV (rank-0 step).

    Text-level: rows are merged by their index field. Entity rows are
    disjoint across parts (the SplitBam invariant) and the single-process
    row order is sorted entity name order, so a k-way merge of the
    unmodified text rows reproduces the single-process file byte for byte.
    Returns the number of entity rows written.

    Validation before any byte is merged (``validated_parts``): the
    ``.partNNNN`` sequence must be gap-free and duplicate-free (and
    exactly ``0..expected_parts-1`` when the caller passes its chunk
    count: the only check that catches committed leftovers of an earlier,
    larger run in a reused directory), and with ``journal_dir`` the
    globbed set must equal the journal's committed set, hash-verified. The
    merged CSV itself publishes atomically, and its rows in and out are
    appended to ``<journal_dir>/audit-merge.jsonl`` (``audit.record_merge``).
    """
    paths = validated_parts(part_pattern, journal_dir, expected_parts)
    # each part is already in sorted entity-name order, so the join is a
    # k-way streaming merge in memory of the order of the parts' count
    n_rows = 0
    # merge accounting: count rows on the way IN per part, so the sidecar
    # entry can assert rows_in == rows_out — a text merge never folds, so
    # any skew is a real loss the audit must flag
    rows_per_part = [0] * len(paths)

    def _counted(f, part_index: int):
        for line in f:
            if line.strip():
                rows_per_part[part_index] += 1
                yield line

    merge_span = obs.span("distributed:merge_parts", parts=len(paths))
    with merge_span, atomic_output(output_path) as tmp_path, ExitStack() as stack:
        header: Optional[str] = None
        streams = []
        for part_index, path in enumerate(paths):
            f = stack.enter_context(gzip.open(path, "rt"))
            part_header = f.readline()
            if header is None:
                header = part_header
            elif part_header != header:
                raise ValueError(f"part {path} header differs")
            streams.append(_counted(f, part_index))
        opener = gzip.open if compress else open
        out = stack.enter_context(opener(tmp_path, "wt"))
        out.write(header)
        for line in heapq.merge(*streams, key=lambda line: line.split(",", 1)[0]):
            out.write(line)
            n_rows += 1
        merge_span.add(records=n_rows)
    audit.record_merge(
        journal_dir, "merge_sorted_csv_parts", output_path,
        len(paths), sum(rows_per_part), n_rows,
    )
    return n_rows
