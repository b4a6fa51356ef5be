"""The port's serving plane (``sctools_tpu_torch.serve``) on the CPU, against
the JAX package.

Every case of ``test_serve.py`` runs here against the port, under the same
name, but for these, which have no counterpart:
``test_aot_cache_dir_keyed_by_hash_with_env_override`` (the port keeps no
executable cache on disk: a CUDA graph lives in the process that captured
it) and the two executable-store cases (JAX's xprof store; the port's
counterpart is the CUDA graph set, whose cases need the card and live in
``test_torch_cuda.py``). The three other manifest cases run on the port's
graph manifest (``serve/graph_manifest.json``), whose committed file must
equal what the port's AOT pass (``python -m sctools_tpu_torch.analysis
--emit-aot-manifest``) writes over the port; the port's ``dim_admissible``
(``analysis.shardcheck``'s) must give JAX's answers under both contracts. Workers run with ``device="cpu"``,
where no graph set is built and the engine runs eagerly.

Against the JAX package, on the same inputs made from a seed:
``submit_jobs`` gives JAX's task ids; ``plan_packs`` gives JAX's plans on
the same files; an ``AdmissionController`` fed the same seeded operation
sequence makes JAX's choices; ``run_packed`` gives JAX's artifacts (CSV
text equal but for the ``*_variance`` fields, rtol 1e-6 with no absolute
slack, as ``test_torch_metrics`` explains) and JAX's trace segments, for a
clean pack, a pack whose stream is grouped but not ascending, and a
collision; a port worker drains a journal JAX's ``submit_jobs`` wrote, and
its ``committed`` extras equal a JAX worker's on the same jobs (each
execution's audit ``ledger`` included, stage for stage); JAX's ``sched
status`` and the port's print the same serve lines for the same journal.

End to end: two worker processes on ``device="cpu"``, one SIGTERM'd inside
a pack (held there by an injected ``delay@task.claimed``); no job is lost,
the survivor steals the dead worker's leases, and every artifact equals
the job's solo run byte for byte.

Steering: two workers with the controller armed (``steer.force``) drain
sixteen small jobs of four tenants on the CPU under a pulse memory
session, after warming every rung of their ladders; their artifacts equal
the jobs' solo
runs byte for byte, their announcements carry the controllers'
snapshots, they journal applied and refused decisions, and on that run
directory
JAX's ``sched status`` steer line, ``obs efficiency --suggest --json``,
``obs delta``'s serve block and the exporter's steer gauges equal the
port's. Unarmed, every announcement is ``{"mode": "off"}``.
"""

from __future__ import annotations

import io
import json
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from helpers import make_record, write_bam
from sctools_tpu.sched import Journal as JaxJournal
from sctools_tpu.sched import cli as jax_sched_cli
from sctools_tpu.serve import api as jax_api
from sctools_tpu.serve import cli as jax_serve_cli
from sctools_tpu.serve import packer as jax_packer
from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics
from sctools_tpu_torch.metrics.writer import MetricCSVWriter
from sctools_tpu_torch.sched import COMMITTED, Journal
from sctools_tpu_torch.sched import cli as sched_cli
from sctools_tpu_torch.sched import faults, runners
from sctools_tpu_torch.sched.journal import TaskState, make_task
from sctools_tpu_torch.serve import graphs as port_graphs
from sctools_tpu_torch.serve.api import (
    DEFAULT_ADMISSION_DEPTH,
    SERVE_TASK_KIND,
    AdmissionController,
    ServeJob,
    group_open_jobs,
    serve_entry,
    warmup_step,
)
from sctools_tpu_torch.serve.cli import main as serve_cli_main
from sctools_tpu_torch.serve.cli import submit_jobs
from sctools_tpu_torch.serve.engine import ServeWorker, run_serve_task
from sctools_tpu_torch.serve.packer import (
    PackEntityCollision,
    PackTrace,
    artifact_path,
    estimate_records,
    pack_exec_id,
    plan_packs,
    run_packed,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANCE_RTOL = 1e-6  # for *_variance only (test_torch_metrics explains)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure("")
    yield
    faults.reset()


def _tenant_bam(path, prefix, n_cells=4):
    records = []
    for i in range(n_cells):
        cb = f"{prefix}{i:02d}" + "A" * 8
        for j, ub in enumerate(["AAAAAA", "CCCCCC"]):
            records.append(
                make_record(
                    name=f"{cb}.{ub}.{j}", cb=cb, cr=cb, cy="IIII",
                    ub=ub, ur=ub, uy="IIII", ge="G1", xf="CODING",
                    nh=1, pos=100 + i,
                )
            )
    write_bam(str(path), records)


def _random_bam(path, prefix, seed, n_cells=24):
    """A cell-sorted library of random barcodes behind ``prefix``: three
    molecules a cell, two genes, two reads a molecule."""
    rng = random.Random(seed)
    records = []
    for cb in sorted(
        prefix + "".join(rng.choice("ACGT") for _ in range(10))
        for _ in range(n_cells)
    ):
        for ub in sorted(
            "".join(rng.choice("ACGT") for _ in range(6)) for _ in range(3)
        ):
            ge = rng.choice(["G1", "G2"])
            for i in range(2):
                records.append(
                    make_record(
                        name=f"{cb}{ub}{i}", cb=cb, cr=cb, cy="IIII",
                        ub=ub, ur=ub, uy="IIII", ge=ge, xf="CODING",
                        nh=1, pos=rng.randrange(1000),
                    )
                )
    write_bam(str(path), records)


def _interleaved_bams(tmp_path, n_members=3, n_cells=700, seed=9):
    """Members that split one cell-sorted library by a hash of the cell, as
    SplitBam -t CB does: each member ascending, their cells interleaved.
    Qualities vary by read, so an entity's f32 quality sums depend on the
    order of its records."""
    rng = random.Random(seed)
    records = {i: [] for i in range(n_members)}
    for cb in sorted("".join(rng.choice("ACGT") for _ in range(12)) for _ in range(n_cells)):
        owner = rng.randrange(n_members)
        for ub in sorted("".join(rng.choice("ACGT") for _ in range(6)) for _ in range(3)):
            ge = rng.choice(["G1", "G2", "G3"])
            for i in range(rng.randint(1, 4)):
                records[owner].append(make_record(
                    name=f"{cb}{ub}{i}", cb=cb, cr=cb,
                    cy="".join(rng.choice("+5?I") for _ in range(12)), ub=ub, ur=ub,
                    uy="".join(rng.choice("+5?I") for _ in range(6)), ge=ge, xf="CODING", nh=1,
                    pos=rng.randrange(1000), quality=[rng.randrange(2, 41) for _ in range(26)],
                ))
    paths = []
    for owner, recs in records.items():
        paths.append(str(tmp_path / f"member{owner}.bam"))
        write_bam(paths[-1], recs)
    return paths


def _text(path) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def assert_text_match(port_text: str, jax_text: str) -> None:
    """CSV texts equal byte for byte, but for the *_variance fields, which
    match within VARIANCE_RTOL."""
    port_lines, jax_lines = port_text.split("\n"), jax_text.split("\n")
    assert port_lines[0] == jax_lines[0] and len(port_lines) == len(jax_lines)
    header = port_lines[0].split(",")
    variance = [i for i, column in enumerate(header) if column.endswith("_variance")]
    for port_line, jax_line in zip(port_lines[1:], jax_lines[1:]):
        if port_line == jax_line:
            continue
        a, b = port_line.split(","), jax_line.split(",")
        assert [f for i, f in enumerate(a) if i not in variance] == [
            f for i, f in enumerate(b) if i not in variance
        ], f"{port_line!r} != {jax_line!r}"
        np.testing.assert_allclose(
            [float(a[i]) for i in variance], [float(b[i]) for i in variance],
            rtol=VARIANCE_RTOL, atol=0, equal_nan=True, err_msg=port_line,
        )


# ----------------------------------------------------------- admission

def test_admission_depth_bound_and_release():
    admission = AdmissionController(max_depth=2)
    assert admission.admit("a") and admission.admit("a")
    assert admission.depth("a") == 2
    assert not admission.admit("a")  # bound holds
    admission.release("a")
    assert admission.admit("a")
    admission.release("a")
    admission.release("a")
    assert admission.depth("a") == 0
    assert admission.snapshot() == {"max_depth": 2, "in_flight": {}}


def test_admission_select_is_round_robin_fair():
    admission = AdmissionController(max_depth=1)
    queued = {"a": ["1", "2", "3"], "b": ["4"], "c": ["5"]}
    picked = []
    while True:
        tenant = admission.select(queued)
        if tenant is None:
            break
        assert admission.admit(tenant)
        picked.append(tenant)
    # one turn per tenant, however deep a's backlog is
    assert picked == ["a", "b", "c"]
    admission.release("b")
    assert admission.select(queued) == "b"


def test_admission_select_skips_blocked_and_empty_tenants():
    admission = AdmissionController(max_depth=1)
    assert admission.admit("a")
    assert admission.select({"a": ["1"], "b": []}) is None
    assert admission.select({}) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_controller_equals_jax(seed):
    """The same seeded sequence of admit/release/select calls makes the
    same choices and leaves the same snapshots in both packages."""
    rng = random.Random(seed)
    depth = rng.randint(1, 3)
    port, jax = AdmissionController(max_depth=depth), jax_api.AdmissionController(max_depth=depth)
    tenants = ["acme", "beta", "zenith", "t0"]
    for _ in range(300):
        op = rng.choice(["admit", "release", "select"])
        if op == "select":
            queued = {t: [str(i) for i in range(rng.randint(0, 2))] for t in rng.sample(tenants, rng.randint(0, 4))}
            assert port.select(queued) == jax.select(queued)
        else:
            tenant = rng.choice(tenants)
            assert getattr(port, op)(tenant) == getattr(jax, op)(tenant)
        assert port.snapshot() == jax.snapshot()
        assert [port.depth(t) for t in tenants] == [jax.depth(t) for t in tenants]


# ------------------------------------------------------------ grouping

def _serve_task(tenant, name):
    return make_task(
        SERVE_TASK_KIND, f"{tenant}/{name}",
        ServeJob(tenant, f"/in/{name}.bam", f"/out/{name}").payload(),
    )


def test_group_open_jobs_buckets_by_tenant_in_name_order():
    tasks = {t.id: t for t in [
        _serve_task("b", "j1"), _serve_task("a", "j2"),
        _serve_task("a", "j1"),
        make_task("touch", "not-serve", {"tenant": "a"}),
    ]}
    grouped = group_open_jobs(tasks, {}, now=0.0)
    assert sorted(grouped) == ["a", "b"]
    names = [tasks[tid].name for tid in grouped["a"]]
    assert names == ["a/j1", "a/j2"]  # stable per-tenant order
    assert len(grouped["b"]) == 1


def test_group_open_jobs_excludes_terminal_and_backoff_keeps_leased():
    rows = [
        ("committed", TaskState(state=COMMITTED), False),
        ("quarantined", TaskState(state="quarantined"), False),
        ("backoff", TaskState(state="failed", not_before=100.0), False),
        # a leased task MUST stay claimable: the lease broker (not the
        # journal) decides whether the lease is live or steal-able
        ("leased", TaskState(state="leased"), True),
        ("failed-ready", TaskState(state="failed", not_before=1.0), True),
        ("untouched", None, True),
    ]
    tasks, states, want = {}, {}, set()
    for name, state, claimable in rows:
        task = _serve_task("t", name)
        tasks[task.id] = task
        if state is not None:
            states[task.id] = state
        if claimable:
            want.add(task.id)
    grouped = group_open_jobs(tasks, states, now=50.0)
    assert set(grouped.get("t", [])) == want


def test_serve_job_payload_round_trip():
    job = ServeJob("acme", "/data/in.bam", "/data/out")
    assert ServeJob.from_payload(job.payload()) == job


def test_entry_markers_are_runtime_attributes():
    assert getattr(ServeWorker.serve_forever, "__scx_serve_entry__", False)
    assert getattr(ServeWorker.warmup, "__scx_warmup_step__", False)
    @serve_entry
    def handler():
        pass
    @warmup_step
    def warm():
        pass
    assert handler.__scx_serve_entry__ and warm.__scx_warmup_step__


# -------------------------------------------------------------- packer

def test_artifact_path_suffixes():
    assert artifact_path("/out/part", compress=True) == "/out/part.csv.gz"
    assert artifact_path("/out/part", compress=False) == "/out/part.csv"
    assert artifact_path("/out/part.csv", compress=False) == "/out/part.csv"


def test_estimate_records_from_size_and_missing(tmp_path):
    bam = tmp_path / "sized.bam"
    bam.write_bytes(b"\0" * (48 * 100))
    assert estimate_records(str(bam)) == 100
    assert estimate_records(str(tmp_path / "absent.bam")) == 1


def _sized_job(tmp_path, tenant, name, est_records):
    bam = tmp_path / f"{tenant}.{name}.bam"
    bam.write_bytes(b"\0" * (48 * est_records))
    return ServeJob(tenant, str(bam), str(tmp_path / f"{tenant}.{name}"))


def test_plan_packs_first_fit_decreasing(tmp_path):
    jobs = [
        _sized_job(tmp_path, "t0", "big", 3000),
        _sized_job(tmp_path, "t1", "mid", 2000),
        _sized_job(tmp_path, "t2", "small", 1000),
        _sized_job(tmp_path, "t3", "tiny", 500),
    ]
    plans = plan_packs(jobs, batch_records=4096)
    packs = [
        tuple(job.tenant for job in plan.jobs) for plan in plans
    ]
    # FFD into 4096-capacity bins: 3000+1000 and 2000+500
    assert sorted(packs) == [("t0", "t2"), ("t1", "t3")]
    for plan in plans:
        assert plan.estimated_records <= 4096
        assert list(plan.jobs) == sorted(
            plan.jobs, key=lambda j: (j.tenant, j.bam)
        )


def test_plan_packs_oversize_job_gets_own_capped_bin(tmp_path):
    jobs = [
        _sized_job(tmp_path, "t0", "huge", 9000),
        _sized_job(tmp_path, "t1", "small", 100),
    ]
    plans = plan_packs(jobs, batch_records=4096)
    # the estimate is clamped to capacity, so the small job still packs
    # with it: streaming splits the actual records across buckets
    assert len(plans) == 1 or all(
        plan.estimated_records <= 4096 for plan in plans
    )
    assert sum(len(plan.jobs) for plan in plans) == 2


def test_plan_packs_deterministic(tmp_path):
    jobs = [
        _sized_job(tmp_path, f"t{i}", "job", 700 + 13 * i) for i in range(6)
    ]
    first = plan_packs(jobs, batch_records=4096)
    second = plan_packs(list(reversed(jobs)), batch_records=4096)
    as_names = lambda plans: [  # noqa: E731
        tuple(job.tenant for job in plan.jobs) for plan in plans
    ]
    assert as_names(first) == as_names(second)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_packs_equals_jax(tmp_path, seed):
    """Seeded file sizes and capacities: both planners give the same packs
    of the same jobs, in the same order, with the same estimates."""
    rng = random.Random(seed)
    jobs = [
        _sized_job(tmp_path, f"t{rng.randrange(4)}", f"job{i}", rng.randrange(1, 6000))
        for i in range(rng.randint(1, 12))
    ]
    jax_jobs = [jax_api.ServeJob(job.tenant, job.bam, job.out) for job in jobs]
    for batch_records in (4096, 5000, 1 << 14):
        port = plan_packs(jobs, batch_records)
        jax = jax_packer.plan_packs(jax_jobs, batch_records)
        assert [
            ([(j.tenant, j.bam, j.out) for j in p.jobs], p.estimated_records) for p in port
        ] == [
            ([(j.tenant, j.bam, j.out) for j in p.jobs], p.estimated_records) for p in jax
        ]


def test_run_packed_degrades_to_solo_on_entity_collision(tmp_path):
    # both tenants share barcode prefix "AA": same entities, packing would
    # merge their rows; run_packed must fall back to solo runs
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "AA")
    jobs = [
        ServeJob("ta", str(bam_a), str(tmp_path / "out_a")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out_b")),
    ]
    artifacts, packed = run_packed(jobs, compress=False, batch_records=4096, device="cpu")
    assert not packed
    assert [os.path.basename(a) for a in artifacts] == [
        "out_a.csv", "out_b.csv",
    ]
    for artifact in artifacts:
        assert os.path.exists(artifact)
    # no inflight debris from the aborted packed attempt
    assert not [p for p in os.listdir(tmp_path) if "inflight" in p]


def test_run_packed_records_trace_segments(tmp_path):
    # a clean pack leaves ONE executed segment: the pack exec id, every
    # member, and the per-member row counts
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "CC")
    jobs = [
        ServeJob("ta", str(bam_a), str(tmp_path / "out_a")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out_b")),
    ]
    tids = ["a" * 16, "b" * 16]
    trace = PackTrace(tids=tids)
    _, packed = run_packed(
        jobs, compress=False, batch_records=4096, trace=trace, device="cpu"
    )
    assert packed
    assert trace.bucket == 4096
    (seg,) = trace.executed
    assert seg["exec_id"] == pack_exec_id(tids) == trace.exec_id()
    assert seg["tids"] == tids
    assert seg["degraded"] is None and not seg.get("aborted")
    # per-member decoded rows: 4 cells x 2 ubs x 1 read = 8 each
    assert seg["rows"] == [8, 8]
    assert trace.degrade_reason() is None
    # the execution's audit ledger: 16 records through every record stage,
    # 8 rows computed and out (4 cells each)
    assert seg["ledger"] == {"records.ingested": 16, "records.decoded": 16, "records.computed": 16,
                             "rows.computed": 8, "rows.emitted": 8}
    assert seg["rows_routed"] == seg["rows_claimed"] == [4, 4]


def test_run_packed_trace_records_collision_degrade(tmp_path):
    # the aborted packed attempt AND the solo re-runs all land in the
    # trace: the aborted segment carries the collision reason, the solo
    # segments carry the member task ids as their exec ids
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "AA")
    jobs = [
        ServeJob("ta", str(bam_a), str(tmp_path / "out_a")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out_b")),
    ]
    tids = ["a" * 16, "b" * 16]
    trace = PackTrace(tids=tids)
    _, packed = run_packed(
        jobs, compress=False, batch_records=4096, trace=trace, device="cpu"
    )
    assert not packed
    aborted = [s for s in trace.executed if s.get("aborted")]
    solos = [s for s in trace.executed if not s.get("aborted")]
    assert len(aborted) == 1
    assert aborted[0]["degraded"] == "entity-collision"
    assert [s["exec_id"] for s in solos] == tids
    assert trace.degrade_reason() == "entity-collision"


def test_run_packed_creates_missing_output_directories(tmp_path):
    # tenants submit output stems from another host: the worker must make
    # the parent directory instead of quarantining the job on the
    # inflight CSV's FileNotFoundError
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "CC")
    jobs = [
        ServeJob("ta", str(bam_a), str(tmp_path / "out" / "ta" / "part")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out" / "tb" / "part")),
    ]
    artifacts, _ = run_packed(jobs, compress=False, batch_records=4096, device="cpu")
    for artifact in artifacts:
        assert os.path.exists(artifact)


def test_router_rejects_an_unclaimed_entity(tmp_path):
    from sctools_tpu_torch.serve.packer import _RouterWriter

    router = _RouterWriter([ServeJob("t", "/in.bam", str(tmp_path / "o"))], {"AA": 0}, compress=False)
    router.write_header({"n_reads": None})
    with pytest.raises(PackEntityCollision, match="claimed by no pack member"):
        router.write_block(np.asarray(["CC"], dtype=object), [np.asarray([1])])
    router.discard()
    assert os.listdir(tmp_path) == []


# packs whose members are ascending in (tenant, bam) order stay presorted;
# "reversed" puts the larger barcodes first, so the packed stream is grouped
# by cell but not ascending and the batch takes the device-sorted path
_PACK_CASES = {
    "clean": (("ta", "AA", 11), ("tb", "CC", 12), ("tc", "GG", 13)),
    "reversed": (("ta", "TT", 21), ("tb", "GA", 22), ("tc", "AC", 23)),
    "collision": (("ta", "AA", 31), ("tb", "AA", 31)),
}


def _pack_inputs(tmp_path, case):
    jobs = []
    for tenant, prefix, seed in _PACK_CASES[case]:
        bam = tmp_path / f"{tenant}.bam"
        _random_bam(bam, prefix, seed)
        jobs.append((tenant, str(bam), str(tmp_path / "out" / tenant)))
    return jobs


@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_run_packed_equals_jax(tmp_path, case):
    """Artifacts as CSV text and trace segments (exec_id, tids, rows,
    degraded, bucket) equal JAX's run_packed on the same files; every
    packed artifact also equals its job's solo run on the port."""
    jobs = _pack_inputs(tmp_path, case)
    tids = [f"{i:016x}" for i in range(len(jobs))]
    port_trace, jax_trace = PackTrace(tids=list(tids)), jax_packer.PackTrace(tids=list(tids))
    port_art, port_packed = run_packed(
        [ServeJob(*job) for job in jobs], compress=False, batch_records=4096,
        trace=port_trace, device="cpu",
    )
    port_text = [_text(path) for path in port_art]
    jax_art, jax_packed = jax_packer.run_packed(
        [jax_api.ServeJob(*job) for job in jobs], compress=False, batch_records=4096, trace=jax_trace,
    )
    assert port_art == jax_art and port_packed == jax_packed == (case != "collision")
    for port, path in zip(port_text, jax_art):
        assert_text_match(port, _text(path))
    keys = ("exec_id", "tids", "rows", "degraded", "aborted")
    assert [{k: s.get(k) for k in keys} for s in port_trace.executed] == [
        {k: s.get(k) for k in keys} for s in jax_trace.executed
    ]
    assert port_trace.bucket == jax_trace.bucket == 4096
    for segment in jax_trace.executed:
        if "ledger" in segment:  # the audit ledger of each execution equals JAX's, stage for stage
            port_segment = next(s for s in port_trace.executed if s["exec_id"] == segment["exec_id"]
                                and not s.get("aborted"))
            assert port_segment["ledger"] == segment["ledger"] and segment["ledger"]
    for (tenant, bam, _), packed_text in zip(jobs, port_text):
        solo = tmp_path / f"solo_{tenant}"
        GatherCellMetrics(bam, str(solo), batch_records=4096, device="cpu", compress=False).extract_metrics()
        assert _text(f"{solo}.csv") == packed_text


def test_packed_artifacts_equal_solo_runs_when_members_interleave(tmp_path):
    """Members whose cells interleave (a hash split) pack into one stream
    that is grouped but not ascending; the packer merges it by entity, so
    every batch stays presorted and every artifact equals its member's solo
    run byte for byte, quality means and variances included."""
    bams = _interleaved_bams(tmp_path)
    jobs = [ServeJob(f"t{i}", bam, str(tmp_path / "out" / f"t{i}")) for i, bam in enumerate(bams)]
    trace = PackTrace(tids=[f"{i:016x}" for i in range(len(jobs))])
    artifacts, packed = run_packed(jobs, compress=False, batch_records=4096, trace=trace, device="cpu")
    assert packed and sum(trace.executed[0]["rows"]) > 4096  # more than one batch
    for job, artifact in zip(jobs, artifacts):
        solo = tmp_path / f"solo_{job.tenant}"
        GatherCellMetrics(job.bam, str(solo), batch_records=4096, device="cpu", compress=False).extract_metrics()
        assert _text(artifact) == _text(f"{solo}.csv")


# -------------------------------------------------------------- engine

def test_serve_forever_requires_warmup(tmp_path):
    with ServeWorker(str(tmp_path / "journal"), device="cpu") as worker:
        with pytest.raises(RuntimeError, match="warm"):
            worker.serve_forever(max_jobs=1)


def test_worker_drains_journal_and_commits(tmp_path):
    journal_dir = str(tmp_path / "journal")
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "CC")
    jobs = [
        ServeJob("ta", str(bam_a), str(tmp_path / "out_a")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out_b")),
    ]
    assert submit_jobs(journal_dir, jobs) == 2
    assert submit_jobs(journal_dir, jobs) == 0  # content-hashed: idempotent
    with ServeWorker(
        journal_dir, worker_id="unit", batch_records=4096,
        compress=False, lease_ttl=5.0, poll_interval=0.05, device="cpu",
    ) as worker:
        worker.warmup()
        committed = worker.serve_forever(drain=True, idle_timeout_s=30.0)
    assert committed == 2
    assert worker.first_result_s is not None and worker.packs_run >= 1
    journal = Journal(journal_dir, worker_id="check")
    try:
        tasks, states = journal.replay()
        meta = journal.worker_meta()
        events = journal.events()
    finally:
        journal.close()
    assert len(tasks) == 2
    assert all(st.state == COMMITTED for st in states.values())
    for st in states.values():
        assert st.part and os.path.exists(st.part) and st.sha256
    assert meta["unit"]["serve"]["max_depth"] == DEFAULT_ADMISSION_DEPTH
    # every commit carries the executed-segment trace extras, and the
    # engine announced each pack plan BEFORE dispatch
    commits = [e for e in events if e.get("event") == "committed"]
    assert len(commits) == 2
    for event in commits:
        assert event["pack_members"] and event["id"] in event["pack_members"]
        assert event["pack_bucket"] == 4096
        segs = event["pack_execs"]
        assert segs and all(s["exec_id"] for s in segs)
        assert event["pack"] in {s["exec_id"] for s in segs}
    plans = [
        e for e in events
        if e.get("event") == "worker" and e.get("pack_plan")
    ]
    assert plans, "no pack_plan announcement journaled before dispatch"
    planned = {p["pack_plan"]["exec_id"] for p in plans}
    assert {c["pack"] for c in commits} <= planned
    # the plan announcement must NOT clobber the serve admission snapshot
    # `sched status` reads (worker meta is last-wins)
    assert "serve" in meta["unit"]
    # no graph set on the CPU: the engine ran eagerly
    assert worker.graphs is None
    assert worker.graph_stats() == {"captures_warmup": 0, "captures_serving": 0, "replays": 0, "keys": 0}


def test_run_serve_task_solo_runner(tmp_path):
    bam = tmp_path / "solo.bam"
    _tenant_bam(bam, "GG")
    task = make_task(
        SERVE_TASK_KIND, "t/solo",
        ServeJob("t", str(bam), str(tmp_path / "solo_out")).payload(),
    )
    artifact = run_serve_task(task, device="cpu")
    assert artifact.endswith("solo_out.csv.gz") and os.path.exists(artifact)


def test_cuda_worker_without_gpu_raises_before_any_lease(tmp_path, monkeypatch):
    """The worker, its CLI and the solo runner default to cuda; without a
    GPU they raise before a lease is taken or a job is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    journal_dir = tmp_path / "journal"
    bam = tmp_path / "a.bam"
    _tenant_bam(bam, "AA")
    submit_jobs(str(journal_dir), [ServeJob("ta", str(bam), str(tmp_path / "out_a"))])
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        ServeWorker(str(journal_dir))
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        serve_cli_main(["worker", str(journal_dir), "--drain"], out=io.StringIO())
    tasks, states = Journal(str(journal_dir), worker_id="check").replay()
    assert [st.state for st in states.values()] == ["pending"]
    assert not list((journal_dir / "leases").glob("*.lock"))
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        run_serve_task(next(iter(tasks.values())))
    assert not (tmp_path / "out_a.csv.gz").exists()


def test_graph_set_is_cuda_only_and_keys_by_static_signature():
    with pytest.raises(ValueError, match="cuda"):
        port_graphs.GraphSet("cpu")
    cols = {"wire": torch.zeros(10, dtype=torch.int32)}
    key = port_graphs.graph_key(cols, dict(num_segments=4096, kind="cell", presorted=True, prepacked=True))
    # defaults fill in, so an explicit default names the same graph
    assert key == port_graphs.graph_key(
        cols, dict(num_segments=4096, kind="cell", presorted=True, prepacked=True, num_runs=0, with_cb=True)
    )
    assert key != port_graphs.graph_key(cols, dict(num_segments=4096, kind="cell", presorted=True, prepacked=True,
                                                  num_runs=2048))
    assert key != port_graphs.graph_key({"wire": torch.zeros(12, dtype=torch.int32)},
                                        dict(num_segments=4096, kind="cell", presorted=True, prepacked=True))
    with pytest.raises(TypeError, match="static argument"):
        port_graphs.graph_key(cols, dict(num_segments=4096, bogus=1))


def test_writer_without_compression_commits_plain_csv(tmp_path):
    stem = str(tmp_path / "plain")
    writer = MetricCSVWriter(stem, compress=False)
    assert writer.filename == stem + ".csv"
    writer.write_header({"a": None, "_private": None, "b": None})
    writer.write("c1", {"a": 1, "b": 2.5})
    writer.write_block(np.asarray(["c2", "c3"], dtype=object), [np.asarray([3, 4]), np.asarray([0.5, 1.0])])
    assert not os.path.exists(writer.filename)  # nothing published before close
    writer.close()
    assert _text(stem + ".csv") == ",a,b\nc1,1,2.5\nc2,3,0.5\nc3,4,1.0\n"
    assert writer.rows_written == 3
    assert os.listdir(tmp_path) == ["plain.csv"]


def test_gatherer_counts_and_plain_output_equal_compressed(tmp_path):
    bam = tmp_path / "in.bam"
    _random_bam(bam, "AC", 5)
    plain = GatherCellMetrics(str(bam), str(tmp_path / "p"), batch_records=4096, device="cpu", compress=False)
    plain.extract_metrics()
    packed = GatherCellMetrics(str(bam), str(tmp_path / "g"), batch_records=4096, device="cpu")
    packed.extract_metrics()
    import gzip

    with gzip.open(tmp_path / "g.csv.gz", "rt") as f:
        assert f.read() == _text(tmp_path / "p.csv")
    assert plain.records_streamed == packed.records_streamed == 24 * 3 * 2
    assert plain.rows_emitted == packed.rows_emitted == 24


def test_runner_registry_resolves_the_serve_runner():
    assert runners.resolve(SERVE_TASK_KIND) is run_serve_task


def test_sched_resume_drains_a_serve_journal_on_cpu(tmp_path):
    journal_dir = str(tmp_path / "journal")
    bam_a, bam_b = tmp_path / "a.bam", tmp_path / "b.bam"
    _tenant_bam(bam_a, "AA")
    _tenant_bam(bam_b, "CC")
    submit_jobs(journal_dir, [
        ServeJob("ta", str(bam_a), str(tmp_path / "out_a")),
        ServeJob("tb", str(bam_b), str(tmp_path / "out_b")),
    ])
    out = io.StringIO()
    assert sched_cli.main(["resume", journal_dir, "--lease-ttl", "5"], out=out, device="cpu") == 0
    assert "2 committed here" in out.getvalue()
    assert (tmp_path / "out_a.csv.gz").exists() and (tmp_path / "out_b.csv.gz").exists()


# ----------------------------------------------------------------- CLI

def test_serve_cli_submit(tmp_path, capsys):
    journal_dir = str(tmp_path / "journal")
    rc = serve_cli_main(
        ["submit", journal_dir, "--job", "acme", "/in.bam", "/out"]
    )
    assert rc == 0
    assert "registered 1 new job(s)" in capsys.readouterr().out
    assert serve_cli_main(["submit", journal_dir]) == 2


def test_submit_jobs_task_ids_equal_jax(tmp_path):
    rng = random.Random(7)
    triples = [
        (f"t{rng.randrange(3)}", f"/in/{rng.randrange(10**6)}.bam", f"/out/{i}/{rng.randrange(10**6)}")
        for i in range(8)
    ]
    assert submit_jobs(str(tmp_path / "port"), [ServeJob(*t) for t in triples]) == 8
    assert jax_serve_cli.submit_jobs(str(tmp_path / "jax"), [jax_api.ServeJob(*t) for t in triples]) == 8
    port_tasks, _ = Journal(str(tmp_path / "port"), worker_id="check").replay()
    jax_tasks, _ = JaxJournal(str(tmp_path / "jax"), worker_id="check").replay()
    assert {tid: (t.kind, t.name, dict(t.payload, submitted=None)) for tid, t in port_tasks.items()} == {
        tid: (t.kind, t.name, dict(t.payload, submitted=None)) for tid, t in jax_tasks.items()
    }
    # either package's submit is a no-op on the other's journal
    assert jax_serve_cli.submit_jobs(str(tmp_path / "port"), [jax_api.ServeJob(*t) for t in triples]) == 0
    assert submit_jobs(str(tmp_path / "jax"), [ServeJob(*t) for t in triples]) == 0


def test_worker_cli_prints_its_summary(tmp_path):
    journal_dir = str(tmp_path / "journal")
    bam = tmp_path / "a.bam"
    _tenant_bam(bam, "AA")
    assert serve_cli_main(["submit", journal_dir, "--job", "ta", str(bam), str(tmp_path / "out_a")],
                          out=io.StringIO()) == 0
    out = io.StringIO()
    rc = serve_cli_main(
        ["worker", journal_dir, "--worker-id", "w0", "--calibration-bam", str(bam), "--batch-records", "4096",
         "--no-compress", "--drain", "--idle-timeout", "30", "--poll-interval", "0.05"],
        out=out, device="cpu",
    )
    assert rc == 0
    summary = json.loads(out.getvalue())
    assert summary == {
        "worker": "w0", "jobs_committed": 1, "first_result_s": summary["first_result_s"],
        "warmup_s": summary["warmup_s"], "packs_run": 1, "packs_degraded": 0, "profile": None,
        "graphs": {"captures_warmup": 0, "captures_serving": 0, "replays": 0, "keys": 0},
    }
    assert summary["first_result_s"] > 0
    assert (tmp_path / "out_a.csv").exists()


def test_sched_status_renders_serve_view(tmp_path, capsys):
    journal_dir = str(tmp_path / "journal")
    jobs = [
        ServeJob("acme", "/in/a.bam", "/out/a"),
        ServeJob("acme", "/in/b.bam", "/out/b"),
        ServeJob("zenith", "/in/z.bam", "/out/z"),
    ]
    submit_jobs(journal_dir, jobs)
    journal = Journal(journal_dir, worker_id="w0")
    try:
        tasks, _ = journal.replay()
        by_name = {tasks[tid].name: tid for tid in tasks}
        journal.record(by_name["acme/a"], "leased", attempt=1)
        journal.record(by_name["acme/b"], "leased", attempt=1)
        journal.record(by_name["acme/b"], "committed", attempt=1)
        journal.announce_worker(
            {
                "serve": {"max_depth": 4, "in_flight": {"acme": 1}},
                "warm": True,
            }
        )
    finally:
        journal.close()
    assert sched_cli.main(["status", journal_dir]) == 1  # open work
    out = capsys.readouterr().out
    assert "serve tenant acme: queued=0 running=1 committed=1" in out
    assert "serve tenant zenith: queued=1 running=0 committed=0" in out
    assert "serve admission w0: depth=1 (max 4/tenant) acme=1 [warm]" in out


def _serve_lines(main, journal_dir):
    out = io.StringIO()
    code = main(["status", journal_dir], out=out)
    return code, [line for line in out.getvalue().splitlines() if line.startswith("serve ")]


# ------------------------------------------------- worker parity with JAX

@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    """The same three jobs (two tenants, one pack of two plus a solo job
    by admission order) drained by a JAX worker from a journal JAX's
    submit_jobs wrote, then by a port worker from another journal JAX's
    submit_jobs wrote; the artifacts of each run are kept."""
    from sctools_tpu.obs import xprof
    from sctools_tpu.serve.engine import ServeWorker as JaxServeWorker

    base = tmp_path_factory.mktemp("serve_workers")
    triples = []
    for tenant, prefix, seed in (("ta", "AA", 41), ("ta", "AG", 42), ("tb", "CC", 43)):
        bam = base / f"{tenant}.{prefix}.bam"
        _random_bam(bam, prefix, seed)
        triples.append((tenant, str(bam), str(base / "out" / f"{tenant}.{prefix}")))
    runs = {}
    for name in ("jax", "port"):
        journal_dir = str(base / f"journal_{name}")
        assert jax_serve_cli.submit_jobs(journal_dir, [jax_api.ServeJob(*t) for t in triples]) == 3
        opts = dict(worker_id=f"w-{name}", max_depth=1, batch_records=4096, compress=False, lease_ttl=10.0,
                    poll_interval=0.05)
        if name == "jax":
            old = os.environ.get("SCTOOLS_TPU_AOT_CACHE")
            os.environ["SCTOOLS_TPU_AOT_CACHE"] = str(base / "aot")
            try:
                with JaxServeWorker(journal_dir, **opts) as worker:
                    worker.warmup()
                    assert worker.serve_forever(drain=True, idle_timeout_s=60.0) == 3
            finally:
                xprof.disable_executable_store()
                if old is None:
                    os.environ.pop("SCTOOLS_TPU_AOT_CACHE", None)
                else:
                    os.environ["SCTOOLS_TPU_AOT_CACHE"] = old
        else:
            with ServeWorker(journal_dir, device="cpu", **opts) as worker:
                worker.warmup()
                assert worker.serve_forever(drain=True, idle_timeout_s=60.0) == 3
        artifacts = {t[2]: _text(t[2] + ".csv") for t in triples}
        runs[name] = (journal_dir, artifacts)
    return runs


_EXTRA_KEYS = ("pack", "pack_members", "pack_rows", "pack_degraded", "pack_bucket", "pack_execs", "audit")


def _commit_extras(journal_cls, journal_dir):
    journal = journal_cls(journal_dir, worker_id="check")
    try:
        events = [e for e in journal.events() if e.get("event") == "committed"]
    finally:
        journal.close()
    return {e["id"]: {k: e.get(k) for k in _EXTRA_KEYS} for e in events}


def test_port_worker_drains_jax_journal_with_jax_commit_extras(worker_runs):
    jax_extras = _commit_extras(JaxJournal, worker_runs["jax"][0])
    port_extras = _commit_extras(Journal, worker_runs["port"][0])
    assert len(port_extras) == 3 and set(port_extras) == set(jax_extras)
    assert any(len(extra["pack_members"]) > 1 for extra in port_extras.values())
    for tid, extra in jax_extras.items():
        # the pack executions' audit ledgers included, stage for stage
        assert port_extras[tid] == extra
    for path, text in worker_runs["port"][1].items():
        assert_text_match(text, worker_runs["jax"][1][path])
    # and JAX replays the port's journal to the same committed states
    port_states = JaxJournal(worker_runs["port"][0], worker_id="check").replay()[1]
    assert sorted(st.state for st in port_states.values()) == [COMMITTED] * 3


def test_sched_status_serve_lines_equal_jax(worker_runs, monkeypatch):
    now = time.time() + 5.0
    monkeypatch.setattr(sched_cli, "wall_clock", lambda: now)
    monkeypatch.setattr(jax_sched_cli, "wall_clock", lambda: now)
    for journal_dir in (worker_runs["port"][0], worker_runs["jax"][0]):
        port_code, port_lines = _serve_lines(sched_cli.main, journal_dir)
        jax_code, jax_lines = _serve_lines(jax_sched_cli.main, journal_dir)
        assert (port_code, port_lines) == (jax_code, jax_lines)
        assert port_code == 0
        assert any(line.startswith("serve rows: ") and line.endswith("— balanced") for line in port_lines)
        assert any(line.startswith("serve steer ") and line.endswith("mode=off") for line in port_lines)
    # a journal with open, leased and quarantined jobs
    journal_dir = str(worker_runs["port"][0]) + "_open"
    submit_jobs(journal_dir, [ServeJob("acme", f"/in/{i}.bam", f"/out/{i}") for i in range(3)]
                + [ServeJob("zenith", "/in/z.bam", "/out/z")])
    journal = Journal(journal_dir, worker_id="w0")
    tasks, _ = journal.replay()
    by_name = {tasks[tid].name: tid for tid in tasks}
    journal.record(by_name["acme/0"], "leased", attempt=1)
    journal.record(by_name["acme/1"], "quarantined", error="boom")
    journal.announce_worker({"serve": {"max_depth": 2, "in_flight": {"acme": 1}}, "warm": True,
                             "steer": {"mode": "off"}})
    journal.close()
    assert _serve_lines(sched_cli.main, journal_dir) == _serve_lines(jax_sched_cli.main, journal_dir)


# ------------------------------------------------- end to end, SIGTERM

WORKER = """
import sys
from sctools_tpu_torch.serve.cli import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


def _launch(journal_dir, worker_id, fault_spec, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SCTOOLS_TPU_FAULTS", None)
    if fault_spec:
        env["SCTOOLS_TPU_FAULTS"] = fault_spec
    return subprocess.Popen(
        [sys.executable, "-c", WORKER, "worker", journal_dir, "--worker-id", worker_id, "--batch-records", "4096",
         "--no-compress", "--lease-ttl", "1.0", "--poll-interval", "0.05", "--idle-timeout", "60", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )


def test_sigterm_mid_pack_loses_no_job(tmp_path):
    journal_dir = str(tmp_path / "journal")
    triples = []
    for tenant, prefix, seed in (("t0", "AA", 1), ("t0", "AC", 2), ("t1", "CA", 3), ("t1", "CC", 4)):
        bam = tmp_path / f"{tenant}.{prefix}.bam"
        _random_bam(bam, prefix, seed)
        triples.append((tenant, str(bam), str(tmp_path / "out" / f"{tenant}.{prefix}")))
    assert submit_jobs(journal_dir, [ServeJob(*t) for t in triples]) == 4
    # the victim leases one job a tenant and sleeps inside the pack
    victim = _launch(journal_dir, "wA", "delay@task.claimed:secs=60,times=1", "--max-depth", "1")
    procs = [victim]
    try:
        deadline = time.monotonic() + 60
        probe = Journal(journal_dir, worker_id="probe")
        while not any(st.state == "leased" for st in probe.replay()[1].values()):
            assert victim.poll() is None, victim.communicate()[0]
            assert time.monotonic() < deadline, "the victim never leased a job"
            time.sleep(0.05)
        survivor = _launch(journal_dir, "wB", "", "--drain")
        procs.append(survivor)
        victim.send_signal(signal.SIGTERM)
        assert victim.wait(timeout=30) == -signal.SIGTERM
        out, _ = survivor.communicate(timeout=120)
        assert survivor.returncode == 0, out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["worker"] == "wB" and summary["jobs_committed"] == 4
    tasks, states = probe.replay()
    events = probe.events()
    probe.close()
    assert sorted(st.state for st in states.values()) == [COMMITTED] * 4
    stolen = [e for e in events if e.get("event") == "leased" and e.get("stolen")]
    assert stolen and {e["worker"] for e in stolen} == {"wB"}
    assert not [p for p in os.listdir(tmp_path / "out") if "inflight" in p]
    for tenant, bam, stem in triples:
        solo = tmp_path / f"solo.{os.path.basename(stem)}"
        GatherCellMetrics(bam, str(solo), batch_records=4096, device="cpu", compress=False).extract_metrics()
        assert _text(stem + ".csv") == _text(f"{solo}.csv")


# ------------------------------------------------------------ manifest

from sctools_tpu.analysis.shardcheck import dim_admissible as jax_dim_admissible  # noqa: E402
from sctools_tpu.serve.manifest import load_manifest as jax_load_manifest  # noqa: E402
from sctools_tpu_torch.analysis import shardcheck as port_shardcheck  # noqa: E402
from sctools_tpu_torch.analysis.cli import main as port_analysis  # noqa: E402
from sctools_tpu_torch.serve import manifest as port_manifest  # noqa: E402
from sctools_tpu_torch.serve.manifest import (  # noqa: E402
    ManifestError,
    load_manifest,
    precompile_sites,
    validate_loaded_manifest,
)


def test_committed_manifest_loads_and_names_precompile_set():
    manifest = load_manifest()
    assert manifest["version"] == 1
    assert validate_loaded_manifest(manifest) == []
    sites = precompile_sites(manifest)
    assert sites and set(sites) <= set(manifest["sites"])
    assert all(manifest["sites"][name]["precompile"] for name in sites)


def test_load_manifest_rejects_missing_and_tampered(tmp_path):
    with pytest.raises(ManifestError, match="python -m sctools_tpu_torch.serve.manifest"):
        load_manifest(str(tmp_path / "missing.json"))
    manifest = load_manifest()
    manifest["contract_hash"] = "0" * 64
    tampered = tmp_path / "tampered.json"
    tampered.write_text(json.dumps(manifest))
    with pytest.raises(ManifestError, match="hash mismatch"):
        load_manifest(str(tampered))


def test_validate_loaded_manifest_problem_classes():
    assert validate_loaded_manifest({"version": 99}) == [
        "manifest version 99 != 1",
        "manifest missing embedded contract or hash",
    ]
    manifest = load_manifest()
    del manifest["sites"]
    assert validate_loaded_manifest(manifest) == [
        "manifest missing sites table"
    ]


def test_committed_manifest_equals_its_generator(tmp_path, capsys):
    with open(port_manifest.DEFAULT_MANIFEST_PATH, encoding="utf-8") as f:
        committed = f.read()
    fresh = tmp_path / "graph_manifest.json"
    package = os.path.dirname(os.path.dirname(port_manifest.DEFAULT_MANIFEST_PATH))
    assert port_analysis(["--emit-aot-manifest", str(fresh), package]) == 0
    assert committed == fresh.read_text()
    manifest = load_manifest()
    site = port_graphs.SITE
    assert site == "metrics.compute_entity_metrics"
    assert manifest["sites"][site]["serve_reachable"] and manifest["sites"][site]["precompile"]
    assert manifest["sites"][site]["static_argnames"] == [name for name, _ in port_graphs.STATIC_ARGS]
    assert manifest["contract"]["bucket_minimums"] == [8, 4096]
    # the layout of JAX's manifest, and the site's static arguments are JAX's
    jax = jax_load_manifest()
    assert set(manifest) == set(jax)
    assert manifest["sites"][site]["static_argnames"] == jax["sites"][site]["static_argnames"]
    assert validate_loaded_manifest(jax) == []  # JAX's hash, recomputed by the port


def _tested_dims():
    """Every dim up to 2^16, every wire length and power of two up to 2^22
    with its neighbours, and 40,000 seeded dims up to 2^22 (a full sweep to
    2^22 takes minutes in either package)."""
    dims = set(range(1 << 16))
    for padded in (1 << k for k in range(12, 21)):
        for record_bytes in range(12, 73):
            words = padded * record_bytes // 4
            for runs in [0] + [1 << k for k in range(12, 21)]:
                for dim in (1 + words + 2 * runs, 1 << (padded.bit_length() + 1)):
                    dims.update(d for d in (dim - 1, dim, dim + 1) if d <= 1 << 22)
    rng = np.random.default_rng(0)
    dims.update(int(d) for d in rng.integers(0, (1 << 22) + 1, size=40_000))
    return sorted(dims)


def test_dim_admissible_equals_jax_under_both_contracts():
    dims = _tested_dims()
    for contract in (load_manifest()["contract"], jax_load_manifest()["contract"]):
        port = [port_shardcheck.dim_admissible(d, contract) for d in dims]
        assert port == [jax_dim_admissible(d, contract) for d in dims]
        assert 1000 < sum(port) < len(dims)
    # and the two contracts admit the same dims
    ours, theirs = load_manifest()["contract"], jax_load_manifest()["contract"]
    assert [port_shardcheck.dim_admissible(d, ours) for d in dims] == [
        port_shardcheck.dim_admissible(d, theirs) for d in dims
    ]


def test_signature_violations_name_unbucketed_dims():
    contract = load_manifest()["contract"]
    good = port_xprof.signature(({"wire": torch.zeros(1 + 4096 * 12 // 4, dtype=torch.int32)},),
                                dict(num_segments=4096, prepacked=True))
    bad = port_xprof.signature(({"flags": torch.zeros(5000, dtype=torch.int32)},), dict(num_segments=5000))
    sites = {port_graphs.SITE: {"signatures": {good: 1}}}
    assert port_shardcheck.check_signatures(contract, sites) == []
    sites[port_graphs.SITE]["signatures"][bad] = 1
    problems = port_shardcheck.check_signatures(contract, sites)
    assert problems and all("5000" in problem for problem in problems)
    assert any("dim 5000" in problem for problem in problems)
    assert any("num_segments=5000" in problem for problem in problems)
    assert port_shardcheck.check_signatures(contract, {}) == []


def test_serve_cli_parses_manifest_and_steer_epoch_as_jax(monkeypatch):
    seen = {}

    def parsed(module):
        def capture(args, *_):
            seen[module] = (args.manifest, args.steer_epoch)
            return 0
        return capture

    monkeypatch.setattr(sys.modules["sctools_tpu_torch.serve.cli"], "_cmd_worker", parsed("port"))
    monkeypatch.setattr(jax_serve_cli, "_cmd_worker", parsed("jax"))
    for argv in (["worker", "j"], ["worker", "j", "--manifest", "m.json", "--steer-epoch", "0.25"]):
        serve_cli_main(argv, out=io.StringIO())
        jax_serve_cli.main(argv, out=io.StringIO())
        assert seen["port"] == seen["jax"]
    assert seen["port"] == ("m.json", 0.25)
    with pytest.raises(SystemExit):
        serve_cli_main(["worker", "j", "--steer-epoch", "soon"], out=io.StringIO())


def test_worker_refuses_a_tampered_manifest_before_any_lease(tmp_path):
    manifest = load_manifest()
    manifest["contract"]["pow2_min"] = 16
    path = tmp_path / "tampered.json"
    path.write_text(json.dumps(manifest))
    journal_dir = str(tmp_path / "journal")
    bam = tmp_path / "a.bam"
    _tenant_bam(bam, "AA")
    submit_jobs(journal_dir, [ServeJob("ta", str(bam), str(tmp_path / "out_a"))])
    with ServeWorker(journal_dir, manifest_path=str(path), device="cpu") as worker:
        with pytest.raises(ManifestError, match="hash mismatch"):
            worker.warmup()
    _, states = Journal(journal_dir, worker_id="check").replay()
    assert [st.state for st in states.values()] == ["pending"]


# ------------------------------------------------------------ steering

from sctools_tpu import steer as jax_steer  # noqa: E402
from sctools_tpu.obs import delta as jax_delta  # noqa: E402
from sctools_tpu.obs import serve as jax_obs_serve  # noqa: E402
from sctools_tpu.obs.__main__ import main as jax_obs_main  # noqa: E402
from sctools_tpu_torch import obs as port_obs  # noqa: E402
from sctools_tpu_torch import steer as port_steer  # noqa: E402
from sctools_tpu_torch.obs import delta as port_delta  # noqa: E402
from sctools_tpu_torch.obs import pulse as port_pulse  # noqa: E402
from sctools_tpu_torch.obs import serve as port_obs_serve  # noqa: E402
from sctools_tpu_torch.obs import xprof as port_xprof  # noqa: E402
from sctools_tpu_torch.obs.__main__ import main as port_obs_main  # noqa: E402
from sctools_tpu_torch.utils import prefetch as port_prefetch  # noqa: E402

COMMITS = {"w1": 8, "w0": 8}
_STEER_PREFIXES = tuple(a + b for a in "ACGT" for b in "ACGT")


@pytest.fixture(scope="module")
def armed_run(tmp_path_factory):
    """Sixteen jobs of four tenants drained by two armed workers in turn on
    the CPU, each warmed on every rung of its ladder, traced (obs and a
    pulse memory session) and its registry dumped: w1 at the 4096 floor
    (its thin traffic's downshifts are refused) drains two groups of four
    (one job a tenant), then w0 at 8192 (its downshift to the resident 4096
    applies) the other two.
    ``(run_dir, jobs, workers, beats)``."""
    base = tmp_path_factory.mktemp("steer_run")
    run_dir = base / "run"
    journal_dir = str(run_dir / "sched-journal")
    jobs = []
    for i, prefix in enumerate(_STEER_PREFIXES):
        bam = base / f"job{i:02d}.bam"
        _random_bam(bam, prefix, 100 + i, n_cells=40)
        jobs.append(ServeJob(f"t{i % 4}", str(bam), str(base / "out" / f"job{i:02d}")))
    calibration = base / "calibration.bam"
    _random_bam(calibration, "AA", 7, n_cells=200)
    assert submit_jobs(journal_dir, jobs) == len(jobs)
    port_obs.reset()
    port_pulse.reset()
    port_xprof.reset()
    port_obs.enable()
    try:
        workers = {}
        with port_steer.force(True), port_pulse.memory_session() as beats:
            for name, static, quota in (("w1", 4096, 8), ("w0", 8192, None)):
                with ServeWorker(journal_dir, worker_id=name, max_depth=1, batch_records=static, compress=False,
                                 lease_ttl=10.0, poll_interval=0.05, steer_epoch_s=0.0, device="cpu") as worker:
                    worker.warmup(calibration_bam=str(calibration))
                    assert worker.serve_forever(max_jobs=quota, drain=True, idle_timeout_s=60.0) == COMMITS[name]
                workers[name] = worker
        assert port_xprof.dump(str(run_dir / "xprof.w0.json"), worker="w0")
    finally:
        port_obs.disable()
        port_obs.reset()
        port_pulse.reset()
        port_xprof.reset()
        port_prefetch.set_depth_override(None)
    return run_dir, jobs, workers, list(beats)


def _journal_events(journal_dir):
    journal = Journal(journal_dir, worker_id="check")
    try:
        return journal.events()
    finally:
        journal.close()


def test_armed_drain_equals_solo_runs_and_journals_its_decisions(armed_run, tmp_path):
    run_dir, jobs, workers, beats = armed_run
    for i, job in enumerate(jobs):
        solo = tmp_path / f"solo{i}"
        GatherCellMetrics(job.bam, str(solo), batch_records=4096, device="cpu", compress=False).extract_metrics()
        with open(job.out + ".csv", "rb") as got, open(str(solo) + ".csv", "rb") as want:
            assert got.read() == want.read(), job.out
    ladders = {"w0": [4096, 8192, 16384], "w1": [4096, 8192]}
    for name, worker in workers.items():
        assert worker.controller.enabled and worker.controller.ladder() == ladders[name]
        assert worker.jobs_committed == COMMITS[name]
    assert any(b.get("task_id") == "warmup" for b in beats) and any(b.get("task_id") != "warmup" for b in beats)
    events = _journal_events(str(run_dir / "sched-journal"))
    announced = [e for e in events if e.get("event") == "worker"]
    assert {e["worker"] for e in announced} == {"w0", "w1"}
    assert all(e["steer"]["mode"] in ("steering", "static") for e in announced)
    assert all(e["steer"]["resident"] == ladders[e["worker"]] for e in announced)
    decisions = {name: [e["steer_decision"] for e in announced if e["worker"] == name and "steer_decision" in e]
                 for name in workers}
    # w1 at the floor: its thin traffic's downshift is refused, never applied
    assert "refused" in {d["verdict"] for d in decisions["w1"]}
    assert all(d["verdict"] != "applied" for d in decisions["w1"])
    # w0: the downshift onto its resident 4096 rung applies
    applied = [d for d in decisions["w0"] if d["verdict"] == "applied"]
    assert applied and all(d["proposal"] == {"knob": "bucket", "from": 8192, "to": 4096} for d in applied)
    # the packs ran at the buckets the controllers chose
    buckets = {e["worker"]: set() for e in events if e.get("event") == "committed"}
    for e in events:
        if e.get("event") == "committed":
            buckets[e["worker"]].add(e["pack_bucket"])
    assert buckets["w1"] == {4096} and 4096 in buckets["w0"]
    assert len(port_steer.load_decisions(str(run_dir))) == sum(map(len, decisions.values()))


def test_armed_run_reads_the_same_in_both_packages(armed_run, monkeypatch, capsys):
    run_dir = str(armed_run[0])
    journal_dir = str(armed_run[0] / "sched-journal")
    now = time.time() + 5.0
    monkeypatch.setattr(sched_cli, "wall_clock", lambda: now)
    monkeypatch.setattr(jax_sched_cli, "wall_clock", lambda: now)
    # sched status's steer line
    port_lines = _serve_lines(sched_cli.main, journal_dir)
    assert port_lines == _serve_lines(jax_sched_cli.main, journal_dir)
    steer_lines = [line for line in port_lines[1] if line.startswith("serve steer ")]
    assert [line.split(":")[0] for line in steer_lines] == ["serve steer w0", "serve steer w1"]
    assert all(" mode=steering bucket=" in line and "decisions=" in line for line in steer_lines)
    # obs efficiency --suggest --json: the registry's rows and the refusals'
    outs = {}
    for name, main in (("port", port_obs_main), ("jax", jax_obs_main)):
        capsys.readouterr()
        assert main(["efficiency", run_dir, "--suggest", "--json"]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert any(row["site"] == "steer:w1" for row in outs["port"]["suggestions"])
    # the delta's serve block (its steer entry included)
    port_serve = port_delta._distill_serve(run_dir)
    assert port_serve == jax_delta._distill_serve(run_dir)
    assert port_serve["steer"]["decisions"] == len(jax_steer.load_decisions(run_dir))
    # the exporter's steer gauges

    def gauges(module):
        body = module.PulseExporter(run_dir=run_dir).render()
        return [line for line in body.splitlines() if "sctools_tpu_steer_" in line]

    assert gauges(port_obs_serve) == gauges(jax_obs_serve)
    assert 'sctools_tpu_steer_applied_total{worker="w0"}' in "\n".join(gauges(port_obs_serve))
    assert 'sctools_tpu_steer_refused_total{worker="w1"}' in "\n".join(gauges(port_obs_serve))


def test_unarmed_announcements_are_off(tmp_path):
    journal_dir = str(tmp_path / "journal")
    bam = tmp_path / "a.bam"
    _tenant_bam(bam, "AA")
    submit_jobs(journal_dir, [ServeJob("ta", str(bam), str(tmp_path / "out_a"))])
    with port_steer.force(False):
        with ServeWorker(journal_dir, worker_id="w0", batch_records=4096, compress=False, lease_ttl=5.0,
                         poll_interval=0.05, steer_epoch_s=0.0, device="cpu") as worker:
            worker.warmup(calibration_bam=str(bam))
            assert worker.serve_forever(drain=True, idle_timeout_s=30.0) == 1
    assert worker.controller is port_steer.NOOP
    announced = [e for e in _journal_events(journal_dir) if e.get("event") == "worker"]
    assert announced and all(e["steer"] == {"mode": "off"} for e in announced)
    assert not any("steer_decision" in e for e in announced)
