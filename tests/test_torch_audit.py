"""The port's flight recorder and record-conservation ledger against JAX's.

``sctools_tpu_torch.obs.audit`` is the port's copy of ``sctools_tpu.obs.audit``
(the per-task ledger, its algebra, the run fold, the explains and the
exporter's gauges), and ``obs.flight_dump`` / ``install_flight_recorder``
its copy of JAX's flight recorder.

**Mirrored cases.** Every case of ``tests/test_audit.py`` runs here against
the port: the file is read, every ``sctools_tpu`` import in it is pointed at
``sctools_tpu_torch``, the collective gene merge is given a one-device CPU
mesh (the port's default mesh is every CUDA device), and the rewritten
module is executed. No case is left out.

**JAX parity**, on the same seeded inputs through both packages:

- ``run_process_cell_metrics`` over three chunks of one small BAM (JAX on a
  one-device mesh, as the port's CPU worker runs): every task's committed
  ``audit`` extra, key for key; ``audit_run``, its report text and
  ``explain_run`` for one ``--job`` and one ``--barcode`` once the run
  directories and task ids are normalised; ``merge_sorted_csv_parts``'
  sidecar entry, ``ts`` aside;
- crossing: each package's ``audit_run`` reads the other's journal as
  EXACT, and both give the same report of one journal;
- CreateCountMatrix's ledger under a task context (one batch, and many
  small batches with carried tails);
- the merges' sidecar entries, ``ts`` aside: MergeCellMetrics,
  MergeGeneMetrics (with a gene named ``None``, which both drop as a
  fold), the collective cell and gene merges and ``collective_merge_parts``;
- a serve execution's ``ledger``, packed and after a collision's solo
  reruns.

**The flight recorder**: the ``ring_slots`` and ``pulse`` providers return
while their lock is held by the same thread; each package's fleet and
registry loaders read the other's flight record (the worker, the open
spans, ``from_flight``); and a crash-injected sched worker process leaves a
flight record whose reason, open spans, sections and registry are JAX's,
and whose stolen rerun audits EXACT under both packages.
"""

from __future__ import annotations

import gzip
import inspect
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from sctools_tpu import obs as jax_obs
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.obs import audit as jax_audit
from sctools_tpu.obs import fleet as jax_fleet
from sctools_tpu.obs import xprof as jax_xprof
from sctools_tpu_torch import obs as port_obs
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.obs import audit as port_audit
from sctools_tpu_torch.obs import fleet as port_fleet
from sctools_tpu_torch.obs import pulse as port_pulse
from sctools_tpu_torch.obs import xprof as port_xprof
from sctools_tpu_torch.obs.__main__ import main as port_cli

from helpers import write_bam
from test_metrics import random_tagged_records
from test_torch_count import SyntheticCountData, _gtf_with_repeats

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

# ------------------------------------------------------------ mirrored cases

_JAX_IMPORT = re.compile(r"\b(from|import)(\s+)sctools_tpu\b(?!_torch)")
_REWRITES = (
    # the port's default merge mesh is every CUDA device: give the CPU one
    ('CollectiveMergeGeneMetrics(files, str(tmp_path / "coll"))',
     'CollectiveMergeGeneMetrics(files, str(tmp_path / "coll"), mesh=_cpu_mesh())'),
)


def _cpu_mesh():
    from sctools_tpu_torch.parallel import make_mesh

    return make_mesh(1, device="cpu")


def _ported(name: str) -> types.ModuleType:
    """``tests/<name>.py`` executed against the port (module docstring)."""
    path = TESTS / f"{name}.py"
    source = _JAX_IMPORT.sub(r"\1\2sctools_tpu_torch", path.read_text())
    for old, new in _REWRITES:
        assert old in source, old
        source = source.replace(old, new)
    module = types.ModuleType(f"ported_{name}")
    module.__file__ = str(path)
    module._cpu_mesh = _cpu_mesh
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


_MIRRORED = {"test_audit": set()}
_MODULES = {name: _ported(name) for name in _MIRRORED}

# the ported module's autouse fixture, under its own name
_clean_ledger = _MODULES["test_audit"]._clean_ledger


def _mirrored_cases():
    cases = []
    for module_name, skipped in _MIRRORED.items():
        module = _MODULES[module_name]
        tests = [n for n, f in vars(module).items() if n.startswith("test_") and callable(f)]
        missing = skipped - set(tests)
        assert not missing, f"{module_name} no longer has {missing}"
        cases.extend(
            pytest.param(module_name, name, id=f"{module_name}::{name}")
            for name in tests if name not in skipped
        )
    return cases


@pytest.mark.parametrize("module_name,name", _mirrored_cases())
def test_mirrored_case(module_name, name, request):
    fn = getattr(_MODULES[module_name], name)
    fn(**{arg: request.getfixturevalue(arg) for arg in inspect.signature(fn).parameters})


def test_every_case_of_test_audit_is_mirrored():
    assert len(_mirrored_cases()) == 34
    for value in vars(_MODULES["test_audit"]).values():
        owner = getattr(value, "__name__", "") if isinstance(value, types.ModuleType) else ""
        assert not owner.startswith("sctools_tpu.") and owner != "sctools_tpu", owner


# ------------------------------------------------------- the chunk queue

def _chunks(tmp):
    chunks = []
    for seed in (1, 2, 3):
        part, header = random_tagged_records(seed=seed, n_records=150)
        chunks.append(write_bam(str(tmp / f"chunk{seed}.bam"),
                                list(sort_by_tags_and_queryname(part, ["CB", "UB", "GE"])), header))
    return chunks


@pytest.fixture(scope="module")
def queue_runs(tmp_path_factory):
    """The same three chunks worked by each package's chunk queue, then its
    parts merged with the journal's merge sidecar: ``{package: run_dir}``."""
    import jax
    from jax.sharding import Mesh

    from sctools_tpu.parallel import launch as jax_launch
    from sctools_tpu_torch.parallel import launch as port_launch

    tmp = tmp_path_factory.mktemp("audit_queue")
    chunks = _chunks(tmp)
    runs = {}
    for name, launch in (("port", port_launch), ("jax", jax_launch)):
        run_dir = tmp / f"{name}_run"
        kwargs = (dict(device="cpu") if name == "port"
                  else dict(mesh=Mesh(np.array(jax.devices()[:1]), ("shard",))))
        launch.run_process_cell_metrics(chunks, str(run_dir / "p"), 1, 0, **kwargs)
        launch.merge_sorted_csv_parts(
            str(run_dir / "metrics.part*.csv.gz"), str(run_dir / "merged.csv.gz"),
            journal_dir=str(run_dir / "sched-journal"), expected_parts=3,
        )
        runs[name] = str(run_dir)
    return runs


def _committed_audits(run_dir):
    from sctools_tpu_torch.sched import Journal

    journal = Journal(os.path.join(run_dir, "sched-journal"), worker_id="check")
    try:
        specs, _ = journal.replay()
        return {specs[e["id"]].name: e.get("audit") for e in journal.events()
                if e.get("event") == "committed"}
    finally:
        journal.close()


def _normalised(value, run_dir, ids):
    """``value`` with the run directory, the task ids (-> names) and every
    ``ts`` taken out, so two runs of one input compare."""
    text = json.dumps(value, sort_keys=True)
    text = text.replace(os.path.abspath(run_dir), "<run>")
    for tid, name in ids.items():
        text = text.replace(tid, f"<{name}>")
    return _drop_ts(json.loads(text))


def _drop_ts(value):
    if isinstance(value, dict):
        return {k: _drop_ts(v) for k, v in value.items() if k != "ts"}
    if isinstance(value, list):
        return [_drop_ts(v) for v in value]
    return value


def _task_ids(report):
    return {tid: task["name"] for tid, task in report["tasks"].items()}


def test_committed_audit_extras_equal_jax(queue_runs):
    port, jax = _committed_audits(queue_runs["port"]), _committed_audits(queue_runs["jax"])
    assert sorted(port) == ["chunk0000", "chunk0001", "chunk0002"]
    assert port == jax
    for ledger in port.values():
        assert set(ledger) == {"records.ingested", "records.decoded", "records.computed",
                               "rows.computed", "rows.emitted"}
        assert ledger["records.ingested"] == ledger["records.decoded"] == ledger["records.computed"] > 0
        assert ledger["rows.computed"] == ledger["rows.emitted"] > 0


def test_audit_run_report_and_explains_equal_jax(queue_runs):
    reports = {name: port_audit.audit_run(run) for name, run in queue_runs.items()}
    jax_report = jax_audit.audit_run(queue_runs["jax"])
    ids = {name: _task_ids(report) for name, report in reports.items()}
    assert (_normalised(reports["port"], queue_runs["port"], ids["port"])
            == _normalised(jax_report, queue_runs["jax"], ids["jax"]))
    fleet = reports["port"]["fleet"]
    assert fleet["exact"] and fleet["tasks_audited"] == 3 and fleet["records"]["decoded"] == 450
    text = {name: port_audit.render_audit_report(report).replace(os.path.abspath(queue_runs[name]), "<run>")
            for name, report in reports.items()}
    assert text["port"] == jax_audit.render_audit_report(jax_report).replace(
        os.path.abspath(queue_runs["jax"]), "<run>") == text["jax"]
    assert text["port"].endswith("RESULT: EXACT — 0 unexplained records")
    with gzip.open(os.path.join(queue_runs["port"], "metrics.part0001.csv.gz"), "rt") as f:
        barcode = f.read().splitlines()[1].split(",", 1)[0]
    for query in (dict(job="chunk0001"), dict(barcode=barcode)):
        port = port_audit.explain_run(queue_runs["port"], **query)
        jax = jax_audit.explain_run(queue_runs["jax"], **query)
        assert port["found"] and {m["kind"] for m in port["matches"]} >= (
            {"job"} if "job" in query else {"output-row", "merged-row"})
        lines = [(a.pop("line"), b.pop("line"), a["file"])
                 for a, b in zip(port["matches"], jax["matches"]) if a["kind"] == "output-row"]
        for port_line, jax_line, part in lines:
            _assert_rows_match(port_line, jax_line, part)
        assert (_normalised(port, queue_runs["port"], ids["port"])
                == _normalised(jax, queue_runs["jax"], ids["jax"]))
        rendered = port_audit.render_explain(port).replace(os.path.abspath(queue_runs["port"]), "<run>")
        for tid, name in ids["port"].items():
            rendered = rendered.replace(tid, name)
        expected = jax_audit.render_explain(jax).replace(os.path.abspath(queue_runs["jax"]), "<run>")
        for tid, name in ids["jax"].items():
            expected = expected.replace(tid, name)
        assert rendered == expected


def _assert_rows_match(port_line, jax_line, part):
    """Two packages' renderings of one CSV row (cut at 200 characters):
    every field equal but the ``*_variance`` ones, rtol 1e-6 with no
    absolute slack (``test_torch_metrics`` explains)."""
    with gzip.open(part, "rt") as f:
        names = f.readline().rstrip("\n").split(",")
    port_fields, jax_fields = port_line.split(","), jax_line.split(",")
    assert len(port_fields) > 2 and port_fields[0] == jax_fields[0]
    # the last field may be cut short where the 200 characters end
    for name, a, b in list(zip(names, port_fields, jax_fields))[1:-1]:
        if name.endswith("_variance"):
            assert float(a) == pytest.approx(float(b), rel=1e-6, abs=0), name
        else:
            assert a == b, name


def test_merge_sorted_csv_parts_sidecar_equals_jax(queue_runs):
    entries = {}
    for name, run in queue_runs.items():
        (entry,) = port_audit.load_merges(os.path.join(run, "sched-journal"))
        entries[name] = _normalised(entry, run, {})
    assert entries["port"] == entries["jax"]
    assert entries["port"]["op"] == "merge_sorted_csv_parts" and entries["port"]["parts"] == 3
    assert entries["port"]["rows_in"] == entries["port"]["rows_out"] > 0


def test_each_package_audits_the_others_journal_exact(queue_runs, capsys):
    from sctools_tpu.obs.__main__ import main as jax_cli

    for run in queue_runs.values():
        port, jax = port_audit.audit_run(run), jax_audit.audit_run(run)
        assert port == jax and port["fleet"]["exact"]
        for args in (["audit", run], ["explain", run, "--job", "chunk0002"]):
            assert port_cli(args) == 0
            port_out = capsys.readouterr().out
            assert jax_cli(args) == 0
            assert port_out == capsys.readouterr().out
        assert port_out.startswith("  task chunk0002 (id ")


# ------------------------------------------------------------- the count

@pytest.fixture(scope="module")
def count_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audit_count")
    data = SyntheticCountData()
    return dict(bam=write_bam(str(tmp / "count.bam"), data.records(), data.header), gtf=_gtf_with_repeats(tmp),
                tmp=tmp)


@pytest.mark.parametrize("extra", [[], ["--batch-records", "32"]])
def test_count_ledger_under_a_task_equals_jax(count_inputs, extra):
    args = ["-b", count_inputs["bam"], "-a", count_inputs["gtf"]] + extra
    tmp = count_inputs["tmp"]
    ledgers = {}
    for name, obs, audit, run in (
        ("port", port_obs, port_audit,
         lambda: port_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "p")], device="cpu")),
        ("jax", jax_obs, jax_audit,
         lambda: jax_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "j")])),
    ):
        audit.reset()
        obs.set_context(task="count", task_id="count-task")
        try:
            run()
        finally:
            obs.set_context(task=None, task_id=None)
        ledgers[name] = audit.take("count-task")
        audit.reset()
    assert ledgers["port"] == ledgers["jax"]
    ledger = ledgers["port"]
    assert ledger["records.ingested"] == ledger["records.decoded"] == ledger["records.computed"] > 0
    assert port_audit.balance(ledger)["unexplained"] == 0


# ------------------------------------------------------------ the merges

def _gene_part(path, names, seed):
    from sctools_tpu_torch.metrics.merge import MergeGeneMetrics

    rng = np.random.default_rng(seed)
    columns = MergeGeneMetrics.COUNT_COLUMNS_TO_SUM + MergeGeneMetrics.READ_WEIGHTED_COLUMNS
    with gzip.open(path, "wt") as f:
        f.write("," + ",".join(columns) + "\n")
        for name in names:
            counts = [str(int(v)) for v in rng.integers(1, 50, len(MergeGeneMetrics.COUNT_COLUMNS_TO_SUM))]
            moments = [repr(float(v)) for v in rng.random(len(MergeGeneMetrics.READ_WEIGHTED_COLUMNS))]
            f.write(",".join([name] + counts + moments) + "\n")
    return path


def _merge_case(case, tmp, queue_runs):
    """(port merger, jax merger) of one case, each writing its own output
    and its sidecar into its own journal directory."""
    from sctools_tpu.metrics import collective as jax_collective
    from sctools_tpu.metrics import merge as jax_merge
    from sctools_tpu_torch.metrics import collective as port_collective
    from sctools_tpu_torch.metrics import merge as port_merge

    cells = sorted(str(p) for p in Path(queue_runs["port"]).glob("metrics.part*.csv.gz"))
    genes = [_gene_part(str(tmp / f"g{i}.csv.gz"), names, seed) for i, (names, seed) in enumerate(
        [(["ACT", "TUB", "GAP"], 3), (["TUB", "MYC", "None"], 4), (["ACT", "MYC", "ZZZ"], 5)])]
    if case == "cell":
        return (port_merge.MergeCellMetrics(cells, str(tmp / "p"), journal_dir=str(tmp / "pj")),
                jax_merge.MergeCellMetrics(cells, str(tmp / "j"), journal_dir=str(tmp / "jj")))
    if case == "gene":
        return (port_merge.MergeGeneMetrics(genes, str(tmp / "p"), journal_dir=str(tmp / "pj")),
                jax_merge.MergeGeneMetrics(genes, str(tmp / "j"), journal_dir=str(tmp / "jj")))
    if case == "collective_cell":
        return (port_collective.CollectiveMergeCellMetrics(cells, str(tmp / "p"), mesh=_cpu_mesh(),
                                                           journal_dir=str(tmp / "pj")),
                jax_collective.CollectiveMergeCellMetrics(cells, str(tmp / "j"), journal_dir=str(tmp / "jj")))
    # JAX's collective gene merge refuses a gene named None (ROADMAP's
    # faults of the reference): the two parts without one
    genes = [genes[0], genes[2]]
    return (port_collective.CollectiveMergeGeneMetrics(genes, str(tmp / "p"), mesh=_cpu_mesh(),
                                                       journal_dir=str(tmp / "pj")),
            jax_collective.CollectiveMergeGeneMetrics(genes, str(tmp / "j"), journal_dir=str(tmp / "jj")))


@pytest.mark.parametrize("case", ["cell", "gene", "collective_cell", "collective_gene"])
def test_merge_sidecar_entries_equal_jax(case, tmp_path, queue_runs):
    port, jax = _merge_case(case, tmp_path, queue_runs)
    port.execute()
    jax.execute()
    (port_entry,) = port_audit.load_merges(str(tmp_path / "pj"))
    (jax_entry,) = jax_audit.load_merges(str(tmp_path / "jj"))
    assert port.audit == port_entry
    assert port_entry.pop("output") == str(tmp_path / "p.csv.gz")
    assert jax_entry.pop("output") == str(tmp_path / "j.csv.gz")
    port_entry.pop("ts")
    jax_entry.pop("ts")
    assert port_entry == jax_entry
    assert port_entry["rows_in"] == port_entry["rows_out"] + port_entry["merged:collision"]
    if case == "gene":
        # 9 rows in over 5 named genes: 3 folds and the None row
        assert (port_entry["rows_in"], port_entry["rows_out"], port_entry["merged:collision"]) == (9, 5, 4)


def test_collective_merge_parts_sidecar_equals_jax(tmp_path, queue_runs):
    from sctools_tpu.metrics.collective import collective_merge_parts as jax_merge_parts
    from sctools_tpu_torch.metrics.collective import collective_merge_parts as port_merge_parts

    pattern = os.path.join(queue_runs["port"], "metrics.part*.csv.gz")
    journal = os.path.join(queue_runs["port"], "sched-journal")
    n = port_merge_parts(pattern, str(tmp_path / "p.csv.gz"), mesh=_cpu_mesh())
    assert n == jax_merge_parts(pattern, str(tmp_path / "j.csv.gz"))
    assert port_merge_parts(pattern, str(tmp_path / "p.csv.gz"), mesh=_cpu_mesh(), journal_dir=journal) == n
    entry = port_audit.load_merges(journal)[-1]
    assert (entry["op"], entry["parts"], entry["rows_in"], entry["rows_out"], entry["merged:collision"]) == (
        "collective_merge_parts", 3, n, n, 0)
    assert port_audit.audit_run(queue_runs["port"])["fleet"]["exact"]


# ------------------------------------------------------------- serving

def _serve_bam(path, prefix, seed):
    """A cell-sorted library of random barcodes behind ``prefix``: three
    molecules a cell, two genes, two reads a molecule."""
    import random

    from helpers import make_record

    rng = random.Random(seed)
    records = []
    for cb in sorted(prefix + "".join(rng.choice("ACGT") for _ in range(10)) for _ in range(12)):
        for ub in sorted("".join(rng.choice("ACGT") for _ in range(6)) for _ in range(3)):
            ge = rng.choice(["G1", "G2"])
            for i in range(2):
                records.append(make_record(name=f"{cb}{ub}{i}", cb=cb, cr=cb, cy="IIII", ub=ub, ur=ub,
                                           uy="IIII", ge=ge, xf="CODING", nh=1, pos=rng.randrange(1000)))
    write_bam(str(path), records)
    return str(path)


@pytest.mark.parametrize("collide", [False, True])
def test_serve_execution_ledgers_equal_jax(tmp_path, collide):
    from sctools_tpu.serve import api as jax_api
    from sctools_tpu.serve import packer as jax_packer
    from sctools_tpu_torch.serve import packer as port_packer
    from sctools_tpu_torch.serve.api import ServeJob

    bams = [_serve_bam(tmp_path / "a.bam", "AA", 1), _serve_bam(tmp_path / "b.bam", "AA" if collide else "CC",
                                                                 1 if collide else 2)]
    jobs = [("ta", bams[0], str(tmp_path / "out" / "a")), ("tb", bams[1], str(tmp_path / "out" / "b"))]
    tids = ["a" * 16, "b" * 16]
    port_trace, jax_trace = port_packer.PackTrace(tids=list(tids)), jax_packer.PackTrace(tids=list(tids))
    port_packer.run_packed([ServeJob(*job) for job in jobs], compress=False, batch_records=4096,
                           trace=port_trace, device="cpu")
    jax_packer.run_packed([jax_api.ServeJob(*job) for job in jobs], compress=False, batch_records=4096,
                          trace=jax_trace)
    port_ledgers = [(s["exec_id"], s.get("ledger")) for s in port_trace.executed]
    assert port_ledgers == [(s["exec_id"], s.get("ledger")) for s in jax_trace.executed]
    done = [ledger for _, ledger in port_ledgers if ledger is not None]
    assert len(done) == (2 if collide else 1)
    for ledger in done:
        assert port_audit.balance(ledger)["unexplained"] == 0 and ledger["rows.emitted"] > 0
    assert port_audit.peek(port_trace.exec_id()) == {}


# ----------------------------------------------------- the flight recorder

def test_ring_slots_and_pulse_providers_return_while_their_lock_is_held():
    """The providers run inside a signal handler that may have interrupted
    a holder of their lock on the same thread: they must return (bounded
    wait, then a lockless snapshot), never deadlock the death path."""
    from sctools_tpu_torch.ingest import ring as ring_mod

    assert port_obs._flight_sections["ring_slots"] is ring_mod._ring_snapshot
    pulse_provider = port_obs.bounded_snapshot(port_pulse._lock, port_pulse._flight_section, {})
    for lock, provider in ((ring_mod._state_lock, ring_mod._ring_snapshot),
                           (port_pulse._lock, pulse_provider)):
        assert lock.acquire()
        try:
            result = provider()  # held by THIS thread: must still return
            assert result is not None
        finally:
            lock.release()
    assert set(pulse_provider()) == {"path", "seq", "capacity", "recent"}


def _flight_record(obs, xprof, path, site):
    """A flight record of worker ``wF`` dumped mid-span with one dispatch
    in the registry."""
    obs.reset()
    xprof.reset()
    worker = obs.get_context().get("worker")
    obs.set_context(worker="wF")
    obs.enable()
    try:
        xprof.record_dispatch(site, 3, 8)
        with obs.span("sched:task"):
            assert obs.flight_dump(reason="test", path=str(path)) == str(path)
    finally:
        obs.disable()
        obs.set_context(worker=worker)
        obs.reset()
        xprof.reset()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_flight_record(tmp_path, writer):
    obs, xprof = (port_obs, port_xprof) if writer == "port" else (jax_obs, jax_xprof)
    _flight_record(obs, xprof, tmp_path / "flight.wF.jsonl", "parallel.sharded_metrics")
    with open(tmp_path / "flight.wF.jsonl") as f:
        meta = json.loads(f.readline())
    assert meta["meta"] == "flight" and meta["open_spans"] == ["sched:task"]
    assert {"reason", "worker", "pid", "wall", "mono", "counters", "gauges", "xprof"} <= set(meta)
    for fleet, registries in ((port_fleet, port_xprof), (jax_fleet, jax_xprof)):
        analysis = fleet.analyze(fleet.discover(str(tmp_path)))
        (flight,) = analysis["flight_records"]
        assert (flight["worker"], flight["reason"], flight["open_spans"]) == ("wF", "test", ["sched:task"])
        (registry,) = registries.load_registries(str(tmp_path))
        assert registry["from_flight"] and registry["worker"] == "wF"
        assert registry["sites"]["parallel.sharded_metrics"]["dispatches"] == 1


WORKER = """
import glob, os, sys
from sctools_tpu_torch.parallel.launch import run_process_cell_metrics

chunks = sorted(glob.glob(os.path.join(sys.argv[1], "chunk*.bam")))
run_process_cell_metrics(chunks, os.path.join(sys.argv[1], "run", "p"), 1, 0, lease_ttl=1.0, device="cpu")
"""


def test_crashed_sched_worker_leaves_a_flight_record_and_its_rerun_audits_exact(tmp_path, monkeypatch):
    from sctools_tpu_torch.parallel import launch as port_launch

    chunks = _chunks(tmp_path)
    run_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCTOOLS_TPU_")}
    env.update(PYTHONPATH=str(REPO), SCTOOLS_TPU_TRACE=str(run_dir / "trace"), SCTOOLS_TPU_PULSE="1",
               SCTOOLS_TPU_TRACE_WORKER="wA", SCTOOLS_TPU_FAULTS="crash@gatherer.batch:match=chunk2.bam,times=1")
    done = subprocess.run([sys.executable, "-c", WORKER, str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=240)
    assert done.returncode == 86, done.stdout + done.stderr
    # the scheduler names the worker: its journal id, as in JAX
    (flight,) = (run_dir / "trace").glob("flight.*.jsonl")
    with open(flight) as f:
        meta = json.loads(f.readline())
    assert flight.name == f"flight.{meta['worker']}.jsonl" and meta["worker"].startswith("proc0-of-1-")
    assert meta["meta"] == "flight" and meta["reason"].startswith("crash@gatherer.batch:")
    assert "sched:task" in meta["open_spans"]
    assert meta["sections"]["pulse"]["path"].endswith(".ring") and meta["sections"]["pulse"]["seq"] >= 0
    (ring,) = meta["sections"]["ring_slots"]
    assert ring["phase"] in ("filling", "queued", "eof") and ring["slots"] >= 3
    assert meta["xprof"]["sites"]["parallel.sharded_metrics"]["dispatches"] >= 1
    for fleet in (port_fleet, jax_fleet):
        flights = fleet.analyze(fleet.discover(str(run_dir)))["flight_records"]
        assert [(f["worker"], f["reason"]) for f in flights] == [(meta["worker"], meta["reason"])]
    # the rerun steals the crashed task after its lease's TTL and commits it
    port_launch.run_process_cell_metrics(chunks, str(run_dir / "p"), 1, 0, lease_ttl=1.0, device="cpu")
    report = port_audit.audit_run(str(run_dir))
    assert report["fleet"]["exact"] and report["fleet"]["tasks_audited"] == 3
    assert report["fleet"]["records"]["decoded"] == 450 == report["fleet"]["records"]["computed"]
    stolen = [t for t in report["tasks"].values() if t["steals"]]
    assert len(stolen) == 1 and stolen[0]["attempts"] == 2
    assert jax_audit.audit_run(str(run_dir))["fleet"] == report["fleet"]
