"""scx-mesh on the port (``sctools_tpu_torch.analysis.meshcheck``, ``.meshwitness``) against JAX's.

- Parity: on JAX's SCX804 fixtures the port's pass gives JAX's (rule, line)
  set; SCX801-803 and SCX805 use ``shard_map`` / ``lax``, so each has a
  torch twin here (``meshwitness.mapped`` regions over the
  ``parallel.collective`` wrappers) whose findings equal its ``# <-
  SCXnnn`` marks and whose count per rule equals JAX's on its fixture.
  Every clean fixture and twin is silent. The port's own spellings (a loop
  over ``mesh.local_shards``, ``mesh.process``, ``get_rank``, a control
  group call) have cases of their own.
- Escapes work; the wrapper modules are the mechanism (the real tree and
  the smoke are clean under the gate: ``test_torch_analysis``'s
  ``test_cli_gate_is_clean_on_the_port_and_the_smoke`` runs this pass).
- Seeded faults in copies of the port's own code: a ``psum`` under ``if
  distributed.process_index() == 0`` in the step (SCX801), a ``.cpu()``
  between two collectives of the preflight and of the sample sort
  (SCX803), ``n_shards = 2`` in the reshard (SCX804).
- The witness: off is a true no-op; it records regions and de-duplicates;
  it flags an unscheduled collective and one outside a region, but not
  ``place()``'s ``axis_index``; dumps round-trip and each package reads the
  other's; ``obs efficiency`` reads the port's.
- Schedule parity: ``CalculateGeneMetrics --devices 2`` and the sample sort
  on the CPU give the same region labels (package prefix swapped) and
  per-region ``(name, axis)`` sequences in both packages, and the port's
  observed pairs lie inside its static schedule.
- The CLI: ``--mesh-only``, ``--json`` and ``--emit-collective-schedule``.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``).
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from sctools_tpu import parallel as jax_par
from sctools_tpu import platform as jax_platform
from sctools_tpu.analysis import meshcheck as jax_meshcheck
from sctools_tpu.analysis import meshwitness as jax_witness
from sctools_tpu_torch import parallel as port_par
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.analysis import build_collective_schedule, check_mesh, meshwitness
from sctools_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
MESH = REPO / "tests" / "fixtures_scxlint" / "meshcheck"
RULES = ["SCX801", "SCX802", "SCX803", "SCX804", "SCX805"]
WITNESS_VARS = (meshwitness.ENV_FLAG, meshwitness.ENV_SCHEDULE)


@pytest.fixture(autouse=True, scope="module")
def _no_parse_store():
    saved = os.environ.get("SCTOOLS_TPU_SCX_CACHE")
    os.environ["SCTOOLS_TPU_SCX_CACHE"] = "0"
    yield
    if saved is None:
        os.environ.pop("SCTOOLS_TPU_SCX_CACHE", None)
    else:
        os.environ["SCTOOLS_TPU_SCX_CACHE"] = saved


def rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def marked_lines(text: str, rule: str):
    return [n for n, line in enumerate(text.splitlines(), 1) if f"# <- {rule}" in line]


# -------------------------------------------------------- the torch twins

HEADER = '''import torch

from sctools_tpu_torch import ingest
from sctools_tpu_torch.analysis import meshwitness
from sctools_tpu_torch.parallel import collective, distributed

AXIS = "shard"
'''

TWINS = {
    "SCX801": (HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh):
    if distributed.process_index() == 0:
        shards = collective.psum(shards, mesh, AXIS)  # <- SCX801
    if shards[0].any():
        shards = collective.all_gather(shards, mesh, AXIS)  # <- SCX801
    return shards
''', HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh):
    total = collective.psum(shards, mesh, AXIS)
    scaled = [torch.where(t > 0, t * 2, t) for t in total]
    return collective.all_gather(scaled, mesh, AXIS)
'''),
    "SCX802": (HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh, combine):
    if combine == "sum":  # <- SCX802
        out = collective.psum(shards, mesh, AXIS)
    else:
        out = collective.all_gather(shards, mesh, AXIS)
    return out
''', HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh, combine):
    out = collective.psum(shards, mesh, AXIS)
    if combine == "scaled":
        out = [t * 2 for t in out]
    else:
        out = [t + 1 for t in out]
    return out
'''),
    "SCX803": (HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh):
    partial = collective.psum(shards, mesh, AXIS)
    probe = ingest.pull(partial[0], site="fix.probe")  # <- SCX803
    torch.cuda.synchronize()  # <- SCX803
    gathered = collective.all_gather(shards, mesh, AXIS)
    return gathered, partial, probe
''', HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh):
    partial = collective.psum(shards, mesh, AXIS)
    gathered = collective.all_gather(shards, mesh, AXIS)
    return gathered, partial


def drive(shards, mesh):
    gathered, partial = step(shards, mesh)
    host = ingest.pull(partial[0], site="fix.probe")
    torch.cuda.synchronize()
    return host.numpy(), gathered
'''),
    "SCX805": (HEADER + '''

@meshwitness.mapped("fix.local_totals", replicated=True)  # <- SCX805
def local_totals(shards, mesh):
    return [t.sum(0) for t in shards]
''', HEADER + '''

@meshwitness.mapped("fix.mesh_totals", replicated=True)
def mesh_totals(shards, mesh):
    return collective.psum([t.sum(0) for t in shards], mesh, AXIS)


@meshwitness.mapped("fix.local_rows", replicated=(False,))
def local_rows(shards, mesh):
    return [t * 2 for t in shards]
'''),
}


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("kind", ["bad", "clean"])
def test_scx804_matches_jax_on_its_fixtures(kind):
    path = str(MESH / f"scx804_{kind}.py")
    want = rule_lines(jax_meshcheck.check_mesh([path]))
    assert rule_lines(check_mesh([path])) == want
    assert bool(want) == (kind == "bad")


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires_on_its_marks_and_counts_as_jax(tmp_path, rule):
    bad = TWINS[rule][0]
    got = rule_lines(check_mesh([_write(tmp_path, f"{rule.lower()}_bad.py", bad)]))
    assert got == [(rule, line) for line in marked_lines(bad, rule)]
    jax_findings = jax_meshcheck.check_mesh([str(MESH / f"{rule.lower()}_bad.py")])
    assert len(got) == len([f for f in jax_findings if f.rule == rule])


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_clean_is_silent(tmp_path, rule):
    assert check_mesh([_write(tmp_path, f"{rule.lower()}_clean.py", TWINS[rule][1])]) == []


PORT_SCX801 = HEADER + '''

@meshwitness.mapped("fix.step")
def step(shards, mesh):
    for i in mesh.local_shards:
        shards = collective.all_gather(shards, mesh, AXIS)  # <- SCX801
    if mesh.process == 0:
        shards = collective.psum(shards, mesh, AXIS)  # <- SCX801
    if torch.distributed.get_rank() == 1:
        shards = collective.pmax(shards, mesh, AXIS)  # <- SCX801
    if bool(shards[0].any()):
        shards = collective.pmin(shards, mesh, AXIS)  # <- SCX801
    for i in range(mesh.size):
        shards = collective.pmean(shards, mesh, AXIS)
    return shards


def capacity(required, mesh):
    if distributed.process_index() == 0:
        required = distributed.process_allgather(required).max()  # <- SCX801
    return required
'''

PORT_SCX803 = HEADER + '''

def agree(mine, theirs):
    everyone = distributed.process_allgather(mine)
    checked = theirs.item()  # <- SCX803
    return distributed.process_allgather(everyone + checked)
'''


@pytest.mark.parametrize("text,rule", [(PORT_SCX801, "SCX801"), (PORT_SCX803, "SCX803")],
                         ids=["rank-and-data-sources", "control-group-calls"])
def test_the_ports_own_spellings(tmp_path, text, rule):
    got = rule_lines(check_mesh([_write(tmp_path, "port.py", text)]))
    assert got == [(rule, line) for line in marked_lines(text, rule)]


# ---------------------------------------------------------- the real tree

def test_inline_escape(tmp_path):
    src = ("def shard_for_mesh(cols, mesh):\n"
           "    n_shards = 8  # scx-lint: disable=SCX804 -- fixture rig pins the bench topology\n"
           "    return n_shards\n")
    assert check_mesh([_write(tmp_path, "suppressed_mesh.py", src)]) == []


def test_the_wrapper_modules_are_the_mechanism(tmp_path):
    text = TWINS["SCX802"][0]
    assert {f.rule for f in check_mesh([_write(tmp_path, "caller.py", text)])} == {"SCX802"}
    directory = tmp_path / "pkg" / "parallel"
    directory.mkdir(parents=True)
    for name in ("collective", "distributed"):
        (directory / f"{name}.py").write_text(text)
        assert check_mesh([str(directory / f"{name}.py")]) == []
    # a module merely named collective elsewhere (the collective merge) is a subject
    other = tmp_path / "pkg" / "metrics"
    other.mkdir(parents=True)
    (other / "collective.py").write_text(text)
    assert {f.rule for f in check_mesh([str(tmp_path / "pkg")])} == {"SCX802"}


def seeded_copy(tmp_path, name: str, old: str, new: str) -> str:
    text = (PORT / name).read_text()
    assert text.count(old) == 1, f"{name} changed: {old!r}"
    path = tmp_path / Path(name).name
    path.write_text(text.replace(old, new))
    return str(path)


@pytest.mark.parametrize("name,old,new,rule", [
    ("parallel/metrics.py", '    cell_out = run_sharded_metrics(shards, shard_size, "cell")\n',
     '    cell_out = run_sharded_metrics(shards, shard_size, "cell")\n'
     '    if distributed.process_index() == 0:\n'
     '        cell_out = collective.psum(cell_out, mesh, axis_name)\n', "SCX801"),
    ("parallel/mesh.py", "    gathered = collective.all_gather(rows, mesh, axis_name)\n",
     "    host_totals = [t.cpu() for t in totals if t is not None]\n"
     "    gathered = collective.all_gather(rows, mesh, axis_name)\n", "SCX803"),
    ("parallel/sort.py", "    shards = each(local_sort, shards)\n",
     "    shards = each(local_sort, shards)\n    sizes = each(lambda local: local['valid'].sum().cpu(), shards)\n",
     "SCX803"),
    ("parallel/metrics.py", "    n_shards = mesh.axis_size(axis_name)\n    first = next(",
     "    n_shards = 2\n    first = next(", "SCX804"),
], ids=["psum-under-process-index", "cpu-in-the-preflight", "cpu-in-the-sample-sort", "literal-shard-count"])
def test_faults_seeded_in_the_ports_code(tmp_path, name, old, new, rule):
    path = seeded_copy(tmp_path, name, old, new)
    assert {f.rule for f in check_mesh([path])} == {rule}


@pytest.fixture(scope="module")
def port_schedule():
    return build_collective_schedule([str(PORT)])


def test_collective_schedule_names_the_ports_regions(port_schedule):
    schedule = port_schedule
    pairs = {tuple(p) for p in schedule["collectives"]}
    assert {("all_to_all", "*"), ("all_gather", "*"), ("psum", "*"), ("axis_index", "*")} <= pairs
    assert not any(name in ("process_allgather", "all_gather_objects", "all_to_all_bytes") for name, _ in pairs)
    assert set(schedule["regions"]) == {
        "sctools_tpu_torch." + label for label in (
            "metrics.collective._build_gather.gather_rows",
            "metrics.collective._build_gather_psum.gather_and_reduce",
            "parallel.mesh.collective_preflight.preflight",
            "parallel.metrics._build_sharded_metrics.run",
            "parallel.metrics._build_distributed_step.step",
            "parallel.count._build_sharded_count.run",
            "parallel.sort._build_sample_sort.run")}
    assert "sctools_tpu_torch.parallel.metrics.reshard_by_key" in schedule["computations"]
    assert set(schedule["axis_universe"]) >= {"shard", "dcn"}


# -------------------------------------------------------------- the witness

@pytest.fixture
def armed(monkeypatch):
    for name in WITNESS_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(meshwitness.ENV_FLAG, "1")
    meshwitness.reset()
    yield monkeypatch
    meshwitness.reset()


def _sort_keys(n=2, per=96, seed=3):
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, 50, (n, per)).astype(np.int32),
            "k2": rng.integers(0, 9, (n, per)).astype(np.int32),
            "payload": np.arange(n * per, dtype=np.int32).reshape(n, per),
            "valid": np.ones((n, per), dtype=bool)}


def test_off_is_a_true_noop(monkeypatch):
    for name in WITNESS_VARS:
        monkeypatch.delenv(name, raising=False)
    meshwitness.reset()

    def touched(*args, **kwargs):
        raise AssertionError("the witness's state was touched while it is off")

    for name in ("record_collective", "region", "_region_stack", "in_region", "_ensure_dump_registered"):
        monkeypatch.setattr(meshwitness, name, touched)
    mesh = port_par.make_mesh(2, device="cpu")
    port_par.collective_preflight(mesh)
    port_par.stack_to_host(port_par.distributed_sort(_sort_keys(), ["k1", "k2"], mesh))
    monkeypatch.undo()
    snap = meshwitness.snapshot()
    assert snap["schedules"] == {} and snap["sequence"] == [] and snap["counts"] == {}


def test_witness_records_regions_and_dedupes(armed):
    for _ in range(2):
        with meshwitness.region("fix.step"):
            meshwitness.record_collective("psum", "shard", (4,), "int32", 16)
            meshwitness.record_collective("all_gather", ("dcn", "shard"), (4, 2), "int32", 32)
    snap = meshwitness.snapshot()
    assert snap["violations"] == []
    rows = snap["schedules"]["fix.step"]
    assert len(rows) == 1 and rows[0]["count"] == 2
    assert [e["name"] for e in rows[0]["entries"]] == ["psum", "all_gather"]
    assert rows[0]["entries"][1]["axis"] == "dcn+shard"
    assert snap["counts"] == {"psum": 2, "all_gather": 2} and snap["bytes"] == {"psum": 32, "all_gather": 64}
    # the sequence holds a distinct schedule once, not once per call
    assert [e["name"] for e in snap["sequence"]] == ["psum", "all_gather"]
    with meshwitness.region("fix.step"):
        meshwitness.record_collective("psum", "shard", (4,), "int32", 16)
    assert len(meshwitness.snapshot()["schedules"]["fix.step"]) == 2


def test_a_runs_batches_do_not_grow_the_sequence(armed):
    mesh = port_par.make_mesh(2, device="cpu")
    for _ in range(3):
        port_par.stack_to_host(port_par.distributed_sort(_sort_keys(), ["k1", "k2"], mesh))
    snap = meshwitness.snapshot()
    (row,) = snap["schedules"]["sctools_tpu_torch.parallel.sort._build_sample_sort.run"]
    assert row["count"] == 3 and len(snap["sequence"]) == len(row["entries"])
    assert snap["counts"]["axis_index"] == 3


def test_witness_flags_unscheduled_and_outside_region(armed, tmp_path):
    schedule = tmp_path / "schedule.json"
    schedule.write_text(json.dumps({"collectives": [["psum", "shard"]]}))
    armed.setenv(meshwitness.ENV_SCHEDULE, str(schedule))
    with meshwitness.region("fix.step"):
        meshwitness.record_collective("psum", "shard", (4,), "int32", 16)
        meshwitness.record_collective("ppermute", "shard", (4,), "int32", 16)
    assert [v["kind"] for v in meshwitness.violations()] == ["unscheduled-collective"]
    meshwitness.reset()
    armed.delenv(meshwitness.ENV_SCHEDULE)
    mesh = port_par.make_mesh(2, device="cpu")
    xs = [np.zeros(2, np.int32)] * 2
    import torch

    port_par.collective.psum([torch.from_numpy(x) for x in xs], mesh, "shard")
    assert [v["kind"] for v in meshwitness.violations()] == ["outside-region"]


def test_place_axis_index_is_a_host_helper_outside_regions(armed):
    """``place()`` calls ``collective.axis_index`` outside any region: host
    arithmetic on the mesh, so no entry and no outside-region violation.
    Inside a region (the sample sort's) it records, as JAX's does."""
    mesh = port_par.make_mesh(2, device="cpu")
    port_par.metrics.place(_sort_keys(), mesh)
    snap = meshwitness.snapshot()
    assert snap["violations"] == [] and snap["sequence"] == [] and snap["counts"] == {}
    with meshwitness.region("fix.step"):
        port_par.collective.axis_index(mesh, "shard")
    assert meshwitness.snapshot()["counts"] == {"axis_index": 1}


def test_witness_dump_roundtrip(armed, tmp_path):
    with meshwitness.region("fix.step"):
        meshwitness.record_collective("psum", "shard", (8,), "float32", 32)
    dest = tmp_path / "mesh.p0.json"
    assert meshwitness.dump(str(dest)) == str(dest)
    loaded = meshwitness.load_dumps(str(tmp_path))
    assert set(loaded) == {"p0"} and loaded["p0"]["counts"] == {"psum": 1} and loaded["p0"]["violations"] == []


@pytest.mark.parametrize("writer,reader", [(meshwitness, jax_witness), (jax_witness, meshwitness)],
                         ids=["port-dump-jax-reads", "jax-dump-port-reads"])
def test_each_package_reads_the_others_dump(armed, tmp_path, writer, reader):
    writer.reset()
    try:
        with writer.region("fix.step"):
            writer.record_collective("all_to_all", "shard", (2, 4), "int32", 32)
        writer.dump(str(tmp_path / "mesh.w1.json"))
    finally:
        writer.reset()
    loaded = reader.load_dumps(str(tmp_path))
    assert loaded["w1"]["schedules"]["fix.step"][0]["entries"][0]["name"] == "all_to_all"
    assert loaded["w1"]["counts"] == {"all_to_all": 1}


def test_obs_efficiency_reads_the_ports_dumps(armed, tmp_path):
    from sctools_tpu_torch.obs import xprof

    mesh = port_par.make_mesh(2, device="cpu")
    port_par.collective_preflight(mesh)
    meshwitness.dump(str(tmp_path / "mesh.p0.json"))
    section = xprof.efficiency_report(str(tmp_path))["collectives"]
    assert section["counts"] == {"psum": 1, "all_gather": 1, "all_to_all": 1}
    assert section["violations"] == 0 and set(section["workers"]) == {"p0"}


# ---------------------------------------------------------- schedule parity

def _sequences(snap, prefix):
    """Region label (prefix dropped) -> the distinct (name, axis) sequences."""
    out = {}
    for label, rows in snap["schedules"].items():
        assert label.startswith(prefix + "."), label
        out[label[len(prefix) + 1:]] = sorted({tuple((e["name"], e["axis"]) for e in row["entries"])
                                               for row in rows})
    return out


def _jax_armed_run(monkeypatch, fn):
    monkeypatch.setenv(jax_witness.ENV_FLAG, "1")
    jax_witness.reset()
    for builder in (jax_par.sort._build_sample_sort, jax_par.metrics._build_sharded_metrics):
        builder.cache_clear()
    jax.clear_caches()
    try:
        fn()
        return jax_witness.snapshot()
    finally:
        jax_witness.reset()


@pytest.fixture(scope="module")
def static_schedule(tmp_path_factory, port_schedule):
    path = tmp_path_factory.mktemp("schedule") / "schedule.json"
    path.write_text(json.dumps(port_schedule))
    return str(path)


def test_sample_sort_schedules_equal_jax(armed, static_schedule):
    armed.setenv(meshwitness.ENV_SCHEDULE, static_schedule)
    keys = _sort_keys(4, 64)
    port_par.stack_to_host(port_par.distributed_sort(keys, ["k1", "k2"], port_par.make_mesh(4, device="cpu")))
    port = meshwitness.snapshot()
    jax_mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("shard",))
    jax_snap = _jax_armed_run(armed, lambda: jax_par.distributed_sort(keys, ["k1", "k2"], jax_mesh))
    assert port["violations"] == [] and jax_snap["violations"] == []
    got, want = _sequences(port, "sctools_tpu_torch"), _sequences(jax_snap, "sctools_tpu")
    assert got == want and got["parallel.sort._build_sample_sort.run"]


def test_gene_metrics_on_two_devices_schedules_equal_jax(armed, static_schedule, tmp_path):
    from sctools_tpu.bam import sort_by_tags_and_queryname

    from helpers import write_bam
    from test_metrics import random_tagged_records

    records, header = random_tagged_records(seed=3)
    bam = write_bam(tmp_path / "gene.bam", list(sort_by_tags_and_queryname(records, ["GE", "CB", "UB"])), header)
    armed.setenv(meshwitness.ENV_SCHEDULE, static_schedule)
    assert port_platform.GenericPlatform.calculate_gene_metrics(
        ["-i", bam, "-o", str(tmp_path / "port"), "--devices", "2"], device="cpu") == 0
    port = meshwitness.snapshot()
    jax_snap = _jax_armed_run(armed, lambda: jax_platform.GenericPlatform.calculate_gene_metrics(
        ["-i", bam, "-o", str(tmp_path / "jax"), "--devices", "2"]))
    assert port["violations"] == [] and jax_snap["violations"] == []
    got, want = _sequences(port, "sctools_tpu_torch"), _sequences(jax_snap, "sctools_tpu")
    assert got == want and got


# ----------------------------------------------------------------- the CLI

def _bad_corpus(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "scx804_bad.py").write_text((MESH / "scx804_bad.py").read_text())
    for rule, (bad, _) in TWINS.items():
        (corpus / f"{rule.lower()}_bad.py").write_text(bad)
    return corpus


def test_cli_mesh_only(tmp_path, capsys):
    clean = tmp_path / "clean"
    clean.mkdir()
    for rule, (_, text) in TWINS.items():
        (clean / f"{rule.lower()}_clean.py").write_text(text)
    assert cli_main(["--mesh-only", str(clean)]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "passes: mesh;" in out
    assert cli_main(["--mesh-only", str(_bad_corpus(tmp_path))]) == 1
    out = capsys.readouterr().out
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == set(RULES)


def test_cli_json_covers_the_mesh_pass(tmp_path, capsys):
    assert cli_main(["--json", "--mesh-only", "--cost-only", str(_bad_corpus(tmp_path))]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == set(RULES)


def test_cli_emit_collective_schedule(tmp_path, capsys):
    dest = tmp_path / "schedule.json"
    assert cli_main(["--emit-collective-schedule", str(dest), str(PORT / "parallel")]) == 0
    assert "scx-mesh: wrote" in capsys.readouterr().out
    schedule = json.loads(dest.read_text())
    assert schedule["collectives"] and schedule["regions"]
    bad = tmp_path / "bad.json"
    assert cli_main(["--emit-collective-schedule", str(bad), str(_bad_corpus(tmp_path))]) == 0
    assert "corpus.fix.local_totals" in json.loads(bad.read_text())["regions"]
