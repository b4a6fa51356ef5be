"""Cross-tenant packing into the padded record buckets.

The port of ``sctools_tpu.serve.packer``, the occupancy half of the serving
plane. Solo, every small job pads its records up to its own bucket (the
``RECORD_BUCKET_MIN`` floor), so a worker fed small requests runs the device
at a few percent occupancy. The packer concatenates chunks from *different
tenants* into super-frames before they reach the gatherer's streaming loop,
so two 1.5k-record jobs share one 4096 bucket instead of padding two: the
same engine, the same shapes, better fill.

Three pieces:

- :func:`plan_packs` — greedy first-fit-decreasing bin packing over
  file-size record estimates; the objective is total padded records
  (the sum of ``bucket_size(pack)``), at one streaming dispatch per pack.
- :class:`PackedCellMetrics` — a :class:`GatherCellMetrics` whose frame
  source reads every member job's BAM in turn, claiming each job's entity
  names into a membership map as it goes, and hands the pack on in
  bucket-capacity super-frames in ascending entity order.
- ``_RouterWriter`` — the writer seam (``MetricGatherer._make_writer``):
  result rows route back to per-job CSVs by entity membership, so a packed
  run publishes the artifacts of solo runs byte for byte (per-entity
  metrics do not depend on batch neighbours: the engine's segment
  reductions never mix entities).

The JAX packer hands member frames on in arrival order. Cells spread over
the members by hash (SplitBam -t CB) leave each member ascending but their
concatenation only grouped, and a grouped batch takes the engine's
device-sorted path, whose 3-key sort reorders an entity's records and so
the f32 sums of its quality moments: the JAX serve smoke orders its barcode
prefixes to stay clear of that. The port merges the pack by entity
instead (a stable sort on the cell code of the whole pack, which a pack's
one-bucket plan keeps to about one batch in memory): each entity keeps its
records in file order, every batch is presorted as the member's solo run
is, and a packed artifact equals the solo one byte for byte.

Packing is safe only when member jobs cannot share an entity: a barcode in
two jobs would merge into one row. The frame source checks membership as it
claims names and raises :class:`PackEntityCollision`; :func:`run_packed`
then falls back to solo runs, slower and never wrong. The same holds for
header skew: member BAMs must agree on reference names (the wire's ref
column is header-coded).

Each execution's id is stamped into the obs context (:func:`trace_task`),
so its pulse heartbeats carry it and the audit ledger (``obs.audit``)
counts its stages under it, as in JAX: each executed segment's ``ledger``
is ``audit.take(exec_id)`` (records ingested, decoded and computed, rows
computed and emitted), and an aborted packed attempt's partial ledger is
discarded before the solo reruns. The member streams feed the pack's
outer ring, which alone counts ``records.ingested`` (``audited=False`` on
the inner rings).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ingest, obs
from ..device import DeviceLike
from ..obs import audit
from ..io.packed import concat_frames, copy_frame, slice_frame, take_frame
from ..io.sam import AlignmentReader
from ..metrics.gatherer import DEFAULT_BATCH_RECORDS, GatherCellMetrics
from ..metrics.writer import MetricCSVWriter
from ..ops.segments import bucket_size
from .api import ServeJob

#: rough compressed bytes per alignment record, for the planner's record
#: estimate; only the packing heuristic depends on it, never correctness
EST_RECORD_BYTES = 48


class PackEntityCollision(RuntimeError):
    """Two jobs in one pack claim the same entity (or skewed headers)."""


def artifact_path(output_stem: str, compress: bool = True) -> str:
    """The CSV path a job's writer will publish (no writer constructed)."""
    suffix = ".csv.gz" if compress else ".csv"
    if output_stem.endswith(suffix):
        return output_stem
    return output_stem + suffix


@dataclass(frozen=True)
class PackPlan:
    """One packed dispatch group: jobs that share padded buckets."""

    jobs: Tuple[ServeJob, ...]
    estimated_records: int


def pack_exec_id(tids: Sequence[str]) -> str:
    """Deterministic 16-hex execution id for a multi-member packed run
    (the JAX package's id for the same members)."""
    blob = "pack:" + ",".join(sorted(tids))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


@dataclass
class PackTrace:
    """What :func:`run_packed` actually executed.

    The engine constructs one per pack with the member task ids (aligned
    with the job list) and journals the filled-in trace on each member's
    ``committed`` event. ``executed`` holds one segment per device run:

    - a packed run: one segment with ``exec_id`` = :func:`pack_exec_id`,
      all member tids, and the per-member streamed record counts;
    - a collision-aborted packed attempt: the same, plus ``aborted`` (its
      rows are unknown at the abort);
    - a solo run (single-job pack or collision degrade): ``exec_id`` is
      the member's own task id.
    """

    tids: List[str]
    bucket: int = 0
    executed: List[Dict[str, Any]] = field(default_factory=list)

    def exec_id(self) -> str:
        return pack_exec_id(self.tids)

    def degrade_reason(self) -> Optional[str]:
        for segment in self.executed:
            if segment.get("degraded"):
                return str(segment["degraded"])
        return None


@contextlib.contextmanager
def trace_task(exec_id: Optional[str]):
    """Stamp ``exec_id`` as the obs context's task id for the block: the
    heartbeats of the run inherit it in their ring's task field, which is
    what slo matches a commit's ``pack_execs`` against."""
    if exec_id is None:
        yield
        return
    prior = obs.get_context().get("task_id")
    obs.set_context(task_id=exec_id)
    try:
        yield
    finally:
        obs.set_context(task_id=prior)


def estimate_records(bam: str) -> int:
    """File-size record estimate (planning only; streaming never trusts it)."""
    try:
        size = os.path.getsize(bam)
    except OSError:
        size = 0
    return max(1, size // EST_RECORD_BYTES)


def plan_packs(
    jobs: Sequence[ServeJob], batch_records: int = DEFAULT_BATCH_RECORDS
) -> List[PackPlan]:
    """Greedy occupancy packing: first-fit-decreasing into one-dispatch bins.

    Capacity is ``bucket_size(batch_records)``: a pack must fit one
    streaming dispatch, so its records land in one padded bucket run.
    Jobs inside a pack keep a deterministic (tenant, bam) order so the
    packed record stream is reproducible run to run.
    """
    capacity = bucket_size(batch_records)
    estimates = {id(job): estimate_records(job.bam) for job in jobs}
    order = sorted(jobs, key=lambda j: (-estimates[id(j)], j.tenant, j.bam))
    bins: List[List[ServeJob]] = []
    totals: List[int] = []
    for job in order:
        est = min(estimates[id(job)], capacity)
        for i, total in enumerate(totals):
            if total + est <= capacity:
                bins[i].append(job)
                totals[i] += est
                break
        else:
            bins.append([job])
            totals.append(est)
    plans = []
    for members, total in zip(bins, totals):
        members = sorted(members, key=lambda j: (j.tenant, j.bam))
        plans.append(PackPlan(jobs=tuple(members), estimated_records=total))
    plans.sort(key=lambda p: (p.jobs[0].tenant, p.jobs[0].bam))
    return plans


class _RouterWriter:
    """Writer seam: split result blocks back out to per-job CSVs.

    Duck-types the slice of :class:`MetricCSVWriter` the gatherer's device
    path uses (``write_header`` / ``write_block`` / ``close`` /
    ``discard``), fanning each call out by entity membership. Every per-job
    writer keeps the atomic inflight-then-publish commit, so a pack killed
    mid-run publishes nothing for any member.
    """

    def __init__(
        self,
        jobs: Sequence[ServeJob],
        membership: Dict[str, int],
        compress: bool,
    ):
        self._writers = [MetricCSVWriter(job.out, compress) for job in jobs]
        self._membership = membership
        #: per-member routed row counts
        self.rows_routed: List[int] = [0] * len(self._writers)

    @property
    def rows_written(self) -> int:
        return sum(writer.rows_written for writer in self._writers)

    def write_header(self, record) -> None:
        for writer in self._writers:
            writer.write_header(record)

    def write_block(self, index, columns) -> None:
        names = [str(name) for name in index]
        owners = np.empty(len(names), dtype=np.int64)
        for i, name in enumerate(names):
            owner = self._membership.get(name)
            if owner is None:
                raise PackEntityCollision(
                    f"result entity {name!r} claimed by no pack member"
                )
            owners[i] = owner
        arrays = [np.asarray(column) for column in columns]
        names_arr = np.asarray(names, dtype=object)
        for j in range(len(self._writers)):
            mask = owners == j
            if mask.any():
                self.rows_routed[j] += int(mask.sum())
                self._writers[j].write_block(
                    names_arr[mask], [column[mask] for column in arrays]
                )

    def close(self) -> None:
        for writer in self._writers:
            writer.close()

    def discard(self) -> None:
        for writer in self._writers:
            writer.discard()


class PackedCellMetrics(GatherCellMetrics):
    """Cell metrics over a pack: many jobs, one streaming device run.

    The frame source reads each member BAM through the ingest ring in
    (tenant, bam) order, copies every frame off its recycled arena slot and
    claims its entity names for the owning job; it then merges the pack by
    entity (the module docstring says why) and yields it in bucket-capacity
    super-frames: that accumulation turns N underfull buckets into one full
    one. Output routes back to per-job CSVs through ``_RouterWriter``.
    """

    def __init__(
        self,
        jobs: Sequence[ServeJob],
        compress: bool = True,
        batch_records: int = DEFAULT_BATCH_RECORDS,
        device: DeviceLike = None,
        graphs=None,
    ):
        if not jobs:
            raise ValueError("a pack needs at least one job")
        self._jobs = list(jobs)
        self._membership: Dict[str, int] = {}
        #: per-member streamed record counts
        self._owner_rows: List[int] = [0] * len(self._jobs)
        self._router: Optional[_RouterWriter] = None  # built in _make_writer
        # the largest member donates the header for the wire-schema probe;
        # the frame source separately refuses packs with skewed headers
        primary = max(self._jobs, key=lambda j: estimate_records(j.bam))
        super().__init__(
            primary.bam,
            primary.out,
            batch_records=batch_records,
            frame_source=self._pack_frames,
            device=device,
            compress=compress,
            graphs=graphs,
        )

    @property
    def artifacts(self) -> List[str]:
        """Per-job published CSV paths, aligned with the job list."""
        return [artifact_path(job.out, self._compress) for job in self._jobs]

    @property
    def owner_rows(self) -> List[int]:
        """Records streamed per member, aligned with the job list."""
        return list(self._owner_rows)

    @property
    def owner_emitted(self) -> List[int]:
        """CSV rows routed to each member's writer."""
        if self._router is None:
            return [0] * len(self._jobs)
        return list(self._router.rows_routed)

    @property
    def owner_claimed(self) -> List[int]:
        """Entities each member claimed while streaming: every claimed
        entity must come back as exactly one routed row."""
        counts = [0] * len(self._jobs)
        for owner in self._membership.values():
            counts[owner] += 1
        return counts

    def _make_writer(self) -> _RouterWriter:
        self._router = _RouterWriter(
            self._jobs, self._membership, self._compress
        )
        return self._router

    def _check_headers(self) -> None:
        references = None
        for job in self._jobs:
            with AlignmentReader(job.bam) as probe:
                names = tuple(probe.header.references)
            if references is None:
                references = names
            elif names != references:
                raise PackEntityCollision(
                    f"pack member {job.bam!r} has a different reference "
                    f"set than its peers; refusing to mix header codings"
                )

    def _claim(self, owner: int, names: Sequence[str]) -> None:
        membership = self._membership
        for name in names:
            rendered = "None" if name == "" else str(name)
            prior = membership.get(rendered)
            if prior is None:
                membership[rendered] = owner
            elif prior != owner:
                raise PackEntityCollision(
                    f"entity {rendered!r} appears in jobs for both "
                    f"{self._jobs[prior].tenant!r} and "
                    f"{self._jobs[owner].tenant!r}; packing would merge "
                    f"their rows"
                )

    def _pack_frames(self):
        if len(self._jobs) > 1:
            self._check_headers()
        pack = None
        for owner, job in enumerate(self._jobs):
            # audited=False: these member frames feed the pack's outer
            # ``source=`` ring, which ledgers the handoff — counting here
            # too would double every record on the conservation report
            frames = ingest.ring_frames(job.bam, self._batch_records, audited=False)
            try:
                for frame in frames:
                    # ring frames alias recycled arena slots; the pack keeps
                    # them past the ring's window, so copy first
                    frame = copy_frame(frame)
                    self._claim(owner, frame.cell_names)
                    self._owner_rows[owner] += frame.n_records
                    pack = frame if pack is None else concat_frames(pack, frame)
            finally:
                frames.close()
        if pack is None or not pack.n_records:
            return
        # an entity lives in one member, its records contiguous there: the
        # stable sort on the (string-ordered) cell code makes the pack
        # ascending and keeps each entity's records in file order
        pack = take_frame(pack, np.argsort(pack.cell, kind="stable"))
        capacity = bucket_size(self._batch_records)
        for start in range(0, pack.n_records, capacity):
            yield slice_frame(pack, start, start + capacity)


def run_packed(
    jobs: Sequence[ServeJob],
    compress: bool = True,
    batch_records: int = DEFAULT_BATCH_RECORDS,
    trace: Optional[PackTrace] = None,
    device: DeviceLike = None,
    graphs=None,
) -> Tuple[List[str], bool]:
    """Run one pack; returns (per-job artifact paths, actually_packed).

    On :class:`PackEntityCollision` (shared entities or skewed headers) the
    pack degrades to per-job solo runs: the same artifacts, without the
    shared buckets. Collisions surface while streaming, before any member
    publishes (atomic commit), so the fallback starts clean.

    When ``trace`` is given, its ``executed`` segments record what actually
    ran, a collision-aborted packed attempt included. ``device`` is
    ``cuda`` unless the caller asks for ``cpu``; ``graphs`` (a
    ``serve.graphs.GraphSet``) replays the engine's pass from CUDA graphs.
    """
    jobs = list(jobs)
    # tenants submit output stems from another host; the directory is the
    # worker's to make (a missing parent must not quarantine the job)
    for job in jobs:
        parent = os.path.dirname(artifact_path(job.out, compress))
        if parent:
            os.makedirs(parent, exist_ok=True)
    if trace is not None:
        trace.bucket = bucket_size(batch_records)
    degraded = None
    if len(jobs) > 1:
        gatherer = PackedCellMetrics(
            jobs, compress=compress, batch_records=batch_records,
            device=device, graphs=graphs,
        )
        exec_id = trace.exec_id() if trace is not None else None
        try:
            with trace_task(exec_id):
                gatherer.extract_metrics()
            if trace is not None:
                # the pack's conservation ledger rides the segment the
                # engine already journals verbatim: the execution-level
                # counts plus the per-member routed and claimed splits the
                # fleet report balances against
                trace.executed.append(
                    {
                        "exec_id": exec_id,
                        "tids": list(trace.tids),
                        "rows": gatherer.owner_rows,
                        "degraded": None,
                        "ledger": audit.take(exec_id),
                        "rows_routed": gatherer.owner_emitted,
                        "rows_claimed": gatherer.owner_claimed,
                    }
                )
            return gatherer.artifacts, True
        except PackEntityCollision:
            # degrade below; nothing was published
            degraded = "entity-collision"
            if exec_id is not None:
                # the aborted attempt's half-counted ledger must not bleed
                # into the solo reruns' balance
                audit.discard(exec_id)
            if trace is not None:
                trace.executed.append(
                    {
                        "exec_id": exec_id,
                        "tids": list(trace.tids),
                        "rows": None,
                        "degraded": degraded,
                        "aborted": True,
                    }
                )
    artifacts = []
    for i, job in enumerate(jobs):
        exec_id = trace.tids[i] if trace is not None else None
        solo = GatherCellMetrics(
            job.bam,
            job.out,
            batch_records=batch_records,
            device=device,
            compress=compress,
            graphs=graphs,
        )
        with trace_task(exec_id):
            solo.extract_metrics()
        artifacts.append(artifact_path(job.out, compress))
        if trace is not None:
            trace.executed.append(
                {
                    "exec_id": exec_id,
                    "tids": [trace.tids[i]],
                    "rows": None,
                    "degraded": degraded,
                    "ledger": audit.take(exec_id),
                }
            )
    return artifacts, False
