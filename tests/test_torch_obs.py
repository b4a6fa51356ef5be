"""The port's observability layer against the JAX package's, on the CPU.

``sctools_tpu_torch.obs`` is the port's copy of the time half of
``sctools_tpu.obs``: spans, counters and the trace sink, pulse heartbeats
and rings, the HTTP exporter, slo stitching, RunProfiles and ``obs delta``.

**Mirrored cases.** The cases of ``tests/test_obs.py``, ``test_pulse.py``,
``test_delta.py`` and ``test_slo.py`` run here against the port: each file
is read, every ``sctools_tpu`` import in it (deferred ones and the child
scripts of its subprocess cases included) is pointed at
``sctools_tpu_torch``, and the rewritten module is executed, so the same
test bodies, parameters and fixtures drive the port's modules. Every case
runs but these, which test what the port leaves out:

- ``test_obs``: ``test_xla_trace_noop_without_configuration`` and
  ``test_install_jax_hooks_idempotent_and_records`` (JAX's profiler and
  compile hooks: the port has no jit).
- ``test_pulse``: ``test_summarize_overhead_ratios_takes_min``,
  ``test_check_result_platform_filtering``,
  ``test_check_result_bubble_and_pulse_gates`` and
  ``test_bench_pulse_overhead_asserts_off_mode`` (``bench.py``) and
  ``test_mesh_aware_platform_fingerprint_and_multichip_trajectory`` (a
  ``jax`` mesh; :func:`test_platform_fingerprint_is_the_ports` is its port
  case).
- ``test_delta``: ``test_trajectory_helpers_shared_with_bench``,
  ``test_regression_attribution_names_suspect`` and
  ``test_check_selftest_covers_attribution`` (``bench.py``).
- ``test_slo``: none.

**JAX parity cases**, on the same seeded inputs through both packages:
``render_metrics`` and ``render_summary``; rings that each package writes
and the other parses; a port profile that JAX's ``validate_profile``
accepts; ``attribute_delta`` and ``slo.stitch_run`` views; and
CalculateCellMetrics / CalculateGeneMetrics / CreateCountMatrix under
``obs.enable()`` and a pulse memory session in both packages (the port with
``device="cpu"``), and the fused TagSortBam ``--cell-metrics-output``,
CalculateCellMetrics ``--devices 2`` and ``run_process_cell_metrics`` over
three chunks (JAX on a one-device mesh, as the port's CPU worker runs): the
multiset of span names (JAX's ``jax:*`` compile hook spans left out), the
summed ``records`` per span name, the heartbeats' count, ``real_rows``,
``padded_rows`` and ``entities`` per stage, and every counter JAX counts
whose site the port has. Counters that differ between the packages, with
the reason: ``xprof_compiles`` and ``xprof_retraces`` (JAX's jit compiles;
the port's eager sites compile nothing) and the ``jax_event.*`` counters
(JAX's compile hooks, not ported); and
``prefetch_producer_blocked``, ``prefetch_consumer_wait_seconds`` and
``prefetch_abandoned_threads``, which count how the decode thread and the
consumer happened to meet and differ from run to run in either package.
The byte counters (``h2d_bytes``, ``d2h_bytes``, ``xprof_transfer_*``) and
the heartbeats' byte fields are compared where the packages move the same
bytes. The count's are left out: its upload is one int32 ``[8, n]`` block
and its pull one ``[5, n]`` block, where JAX moves its columns apart. On
``--devices 2`` each shard's pull carries its entity count as one int32
lane where JAX (x64 in the tests) pulls an int64, so the port's d2h bytes
are JAX's less 4 a shard a batch; so too on the chunk queue, whose workers
run the sharded gatherer on their one-device mesh.

**A subprocess case**: a traced serve worker on the CPU writes a complete,
schema-valid ``profile.<worker>.json`` and names it in its summary.
"""

from __future__ import annotations

import collections
import inspect
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from _pytest.mark.structures import ParameterSet

from sctools_tpu import obs as jax_obs
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.obs import delta as jax_delta
from sctools_tpu.obs import pulse as jax_pulse
from sctools_tpu.obs import slo as jax_slo
from sctools_tpu_torch import obs as port_obs
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.obs import delta as port_delta
from sctools_tpu_torch.obs import pulse as port_pulse
from sctools_tpu_torch.obs import slo as port_slo
from sctools_tpu_torch.obs import trajectory as port_trajectory
from sctools_tpu_torch.obs.__main__ import main as port_cli

from helpers import write_bam
from test_metrics import random_tagged_records
from test_torch_count import SyntheticCountData, _gtf_with_repeats

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
OBS = REPO / "sctools_tpu_torch" / "obs"

# ------------------------------------------------------------ mirrored cases

_JAX_IMPORT = re.compile(r"\b(from|import)(\s+)sctools_tpu\b(?!_torch)")


def _ported(name: str) -> types.ModuleType:
    """``tests/<name>.py`` executed with every ``sctools_tpu`` import
    pointed at ``sctools_tpu_torch``."""
    path = TESTS / f"{name}.py"
    source = _JAX_IMPORT.sub(r"\1\2sctools_tpu_torch", path.read_text())
    module = types.ModuleType(f"ported_{name}")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


_MIRRORED = {
    "test_obs": {
        "test_xla_trace_noop_without_configuration",
        "test_install_jax_hooks_idempotent_and_records",
    },
    "test_pulse": {
        "test_summarize_overhead_ratios_takes_min",
        "test_check_result_platform_filtering",
        "test_check_result_bubble_and_pulse_gates",
        "test_bench_pulse_overhead_asserts_off_mode",
        "test_mesh_aware_platform_fingerprint_and_multichip_trajectory",
    },
    "test_delta": {
        "test_trajectory_helpers_shared_with_bench",
        "test_regression_attribution_names_suspect",
        "test_check_selftest_covers_attribution",
    },
    "test_slo": set(),
}
_MODULES = {name: _ported(name) for name in _MIRRORED}

# the ported modules' fixtures, under their own names
recording = _MODULES["test_obs"].recording
pulse_dir = _MODULES["test_pulse"].pulse_dir


def _parametrizations(fn):
    """The keyword sets of ``fn``'s own ``parametrize`` marks (their
    cartesian product, in pytest's order)."""
    combos = [{}]
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names = mark.args[0]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        grown = []
        for value in mark.args[1]:
            value = value.values if isinstance(value, ParameterSet) else value
            values = value if len(names) > 1 else (value,)
            grown.extend({**combo, **dict(zip(names, values))} for combo in combos)
        combos = grown
    return combos


def _mirrored_cases():
    cases = []
    for module_name, skipped in _MIRRORED.items():
        module = _MODULES[module_name]
        tests = [n for n, f in vars(module).items() if n.startswith("test_") and callable(f)]
        missing = skipped - set(tests)
        assert not missing, f"{module_name} no longer has {missing}"
        for name in tests:
            if name in skipped:
                continue
            combos = _parametrizations(getattr(module, name))
            for index, kwargs in enumerate(combos):
                suffix = f"[{index}]" if len(combos) > 1 else ""
                cases.append(pytest.param(module_name, name, kwargs, id=f"{module_name}::{name}{suffix}"))
    return cases


@pytest.mark.parametrize("module_name,name,kwargs", _mirrored_cases())
def test_mirrored_case(module_name, name, kwargs, request):
    fn = getattr(_MODULES[module_name], name)
    call = {
        arg: kwargs[arg] if arg in kwargs else request.getfixturevalue(arg)
        for arg in inspect.signature(fn).parameters
    }
    fn(**call)


def test_mirrored_modules_reach_the_port_only():
    for module in _MODULES.values():
        for value in vars(module).values():
            owner = getattr(value, "__name__", "") if isinstance(value, types.ModuleType) else ""
            assert not owner.startswith("sctools_tpu.") and owner != "sctools_tpu", owner


def test_summarize_json_folds_counters_and_pulse(tmp_path, capsys, pulse_dir):
    trace = tmp_path / "trace.jsonl"
    trace.write_text(json.dumps({"name": "x", "dur": 1.0, "attrs": {"records": 5}}) + "\nnot json\n")
    (tmp_path / "metrics.prom").write_text(
        "# TYPE sctools_tpu_h2d_bytes_total counter\nsctools_tpu_h2d_bytes_total 123\n"
    )
    hb = port_pulse.heartbeat("count")
    hb.leg("compute", 1.0, 2.0)
    hb.add(real_rows=10, padded_rows=16, entities=3)
    hb.emit()
    assert port_cli(["summarize", str(trace), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["stages"][0]["name"] == "x" and payload["stages"][0]["records"] == 5
    assert payload["spans"] == 1 and payload["files"] == 1
    assert next(iter(payload["counters"].values()))["sctools_tpu_h2d_bytes_total"] == 123
    assert payload["compile_registry"] == {}
    (row,) = payload["pulse"].values()
    assert row["heartbeats"] == 1 and row["occupancy"] == 0.625


def test_platform_fingerprint_is_the_ports():
    fingerprint = port_trajectory.platform_fingerprint(device="cpu")
    assert fingerprint == {"backend": "torch-cpu", "device_kind": "cpu", "device_count": 1}
    from sctools_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, device="cpu")
    stamped = port_trajectory.platform_fingerprint(mesh=mesh, device="cpu")
    assert stamped["mesh"] == {"axes": list(mesh.axis_names), "sizes": [2]}


@pytest.mark.parametrize("command", ["audit", "explain"])
def test_unported_subcommands_exit_two_naming_the_roadmap_item(command, capsys):
    """``audit`` and ``explain`` are ported now: on a path that holds no
    journal (``explain`` without a selector too) each exits 2 with JAX's
    message."""
    from sctools_tpu.obs.__main__ import main as jax_cli

    assert port_cli([command, "anything"]) == 2 == jax_cli([command, "anything"])
    port_err, jax_err = capsys.readouterr().err.splitlines()
    assert port_err == jax_err and port_err.startswith(f"obs {command}: ")


@pytest.mark.parametrize("command,message", [
    ("timeline", "no trace/flight captures and no sched journal"),
    ("efficiency", "no xprof registries under"),
])
def test_ported_subcommands_exit_two_on_an_empty_run_dir(command, message, tmp_path, capsys):
    from sctools_tpu.obs.__main__ import main as jax_cli

    assert port_cli([command, str(tmp_path)]) == 2 == jax_cli([command, str(tmp_path)])
    port_err, jax_err = capsys.readouterr().err.splitlines()
    assert message in port_err and port_err == jax_err


def test_obs_modules_import_neither_torch_nor_numpy_at_load():
    import ast

    for path in sorted(OBS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("torch", "numpy"), f"{path.name} imports {name}"


def test_a_fresh_interpreter_loads_obs_without_torch():
    code = (
        "import sys\n"
        "import sctools_tpu_torch.obs, sctools_tpu_torch.obs.pulse, sctools_tpu_torch.obs.slo\n"
        "import sctools_tpu_torch.obs.delta, sctools_tpu_torch.obs.serve, sctools_tpu_torch.obs.__main__\n"
        "import sctools_tpu_torch.obs.audit\n"
        "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCTOOLS_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_vocabulary_and_layout_are_jaxs():
    assert port_pulse.STAGES == jax_pulse.STAGES
    assert port_pulse.WB_PHASES == jax_pulse.WB_PHASES
    assert port_pulse.LEGS == jax_pulse.LEGS
    assert port_pulse._RECORD.format == jax_pulse._RECORD.format
    assert (port_pulse.RECORD_SIZE, port_pulse.HEADER_SIZE) == (144, 4096)
    assert (port_pulse.RECORD_SIZE, port_pulse.HEADER_SIZE) == (jax_pulse.RECORD_SIZE, jax_pulse.HEADER_SIZE)
    assert port_delta.PROFILE_SCHEMA == jax_delta.PROFILE_SCHEMA
    assert port_delta.LEG_SCHEMA == jax_delta.LEG_SCHEMA
    assert port_delta.LEG_NAMES == jax_delta.LEG_NAMES
    assert (port_slo.SERVE_KIND, port_slo.WARMUP_EXEC) == (jax_slo.SERVE_KIND, jax_slo.WARMUP_EXEC)
    for name in ("ENV_FLAG", "ENV_CAPACITY"):
        assert getattr(port_pulse, name) == getattr(jax_pulse, name)
    assert (port_slo.ENV_FLAG, port_slo.ENV_TARGET) == (jax_slo.ENV_FLAG, jax_slo.ENV_TARGET)


def test_off_mode_hands_out_the_noop_singletons():
    assert not port_obs.enabled() and not port_pulse.enabled() and not port_slo.enabled()
    assert port_obs.span("a") is port_obs.span("b") is port_obs._NOOP
    assert port_pulse.heartbeat("count") is port_pulse.heartbeat("sort") is port_pulse.NOOP
    assert port_slo.probe() is port_slo.NOOP


# ----------------------------------------------------------- JAX parity cases

_RECORDS = [
    {"name": "decode", "ts": 0.0, "dur": 0.25, "thread": "p", "depth": 0,
     "attrs": {"records": 1000, "bytes": 4000}},
    {"name": "upload", "ts": 0.3, "dur": 0.125, "thread": "m", "depth": 0,
     "attrs": {"records": 1000, "prepacked": 1, "bytes": 94212}},
    {"name": "native:csv_format", "ts": 0.5, "dur": 0.0625, "thread": "m", "depth": 1,
     "attrs": {"records": 7, "bytes": 1674}},
    {"name": "writeback", "ts": 0.5, "dur": 0.5, "thread": "m", "depth": 0,
     "attrs": {"records": 1000, "entities": 7}, "error": "RuntimeError"},
]


def _fill(module):
    module.reset()
    module.enable()
    try:
        for record in _RECORDS:
            module._record_span(json.loads(json.dumps(record)))
        module.count("records_decoded", 1000)
        module.count("h2d_bytes", 94212)
        module.count("sched_backoff_seconds", 0.375)
        module.gauge("queue.depth", 3)
        return module.render_metrics()
    finally:
        module.disable()
        module.reset()


def test_render_metrics_and_summary_match_jax():
    port_text = _fill(port_obs)
    assert port_text == _fill(jax_obs)
    assert "sctools_tpu_records_decoded_total 1000" in port_text
    rows = port_obs.summarize_records(_RECORDS)
    assert rows == jax_obs.summarize_records(_RECORDS)
    assert port_obs.render_summary(rows) == jax_obs.render_summary(rows)


def _write_ring(pulse, ring_dir, seed):
    import random

    rng = random.Random(seed)
    saved = pulse._enabled, pulse._ring_dir
    pulse.reset()
    pulse._enabled, pulse._ring_dir = True, str(ring_dir)
    try:
        for batch in range(40):
            hb = pulse.heartbeat(rng.choice(sorted(pulse.STAGES)))
            t = batch * 0.5
            for i, leg in enumerate(pulse.LEGS):
                hb.leg(leg, t + 0.1 * i, t + 0.1 * i + rng.random() * 0.2)
            hb.add(real_rows=rng.randrange(1 << 20), padded_rows=1 << 20, entities=rng.randrange(5000),
                   bytes_h2d=rng.randrange(1 << 30), bytes_d2h=rng.randrange(1 << 24),
                   ring_slot=batch % 5, wb_phase=rng.randrange(4))
            hb.emit()
        return pulse.ring_path()
    finally:
        pulse.reset()
        pulse._enabled, pulse._ring_dir = saved


def test_rings_parse_in_either_package(tmp_path, monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w0")
    monkeypatch.setenv("SCTOOLS_TPU_PULSE_CAPACITY", "32")  # wraps: 40 beats, 32 slots
    port_ring = _write_ring(port_pulse, tmp_path / "port", seed=3)
    jax_ring = _write_ring(jax_pulse, tmp_path / "jax", seed=3)
    for path in (port_ring, jax_ring):
        data = Path(path).read_bytes()
        port_meta, port_records, port_torn = port_pulse.parse_ring_bytes(data)
        jax_meta, jax_records, jax_torn = jax_pulse.parse_ring_bytes(data)
        assert port_records == jax_records and port_torn == jax_torn == 0
        assert port_meta == jax_meta and len(port_records) == 32
    port_meta, port_records, _ = jax_pulse.parse_ring_bytes(Path(port_ring).read_bytes())
    jax_meta, jax_records, _ = jax_pulse.parse_ring_bytes(Path(jax_ring).read_bytes())
    for key in ("stages", "wb_phases", "legs", "worker"):
        assert port_meta[key] == jax_meta[key], key
    strip = lambda records: [{k: v for k, v in r.items() if k not in ("ts", "legs")} for r in records]
    assert strip(port_records) == strip(jax_records)
    assert [r["legs"] for r in port_records] == [r["legs"] for r in jax_records]
    assert port_pulse.fleet_pulse(str(tmp_path)) == {
        **jax_pulse.fleet_pulse(str(tmp_path)), "run_dir": str(tmp_path)}


def test_jax_validates_a_port_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w0")
    _write_ring(port_pulse, tmp_path, seed=5)
    profile = port_delta.profile_from_run_dir(
        str(tmp_path), platform=port_trajectory.platform_fingerprint(device="cpu"))
    assert profile["complete"] and profile["workers"] == 1 and profile["heartbeats"] == 40
    assert jax_delta.validate_profile(profile) == [] == port_delta.validate_profile(profile)
    written = port_delta.write_profile(profile, str(tmp_path / "profile.w0.json"))
    assert jax_delta.validate_profile(json.loads(Path(written).read_text())) == []
    legs = profile["legs"]
    assert sum(row["exposed_s"] for row in legs.values()) == pytest.approx(profile["wall_s"], abs=1e-6)
    assert port_delta.profile_from_run_dir(str(tmp_path)) == jax_delta.profile_from_run_dir(str(tmp_path))


@pytest.mark.parametrize("mix_a,mix_b", [
    ({"decode": 1.0, "compute": 2.0, "d2h": 0.5}, {"decode": 1.5, "compute": 2.0, "d2h": 0.25}),
    ({"h2d": 0.3, "compute": 1.0, "idle": 0.2}, {"h2d": 0.3, "compute": 1.0, "idle": 0.2}),
    ({"decode": 2.0, "overlap": 1.0}, {"decode": 0.5, "overlap": 3.0, "d2h": 1.0}),
])
def test_attribute_delta_matches_jax(mix_a, mix_b):
    fp = {"backend": "torch-cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1}
    a = port_delta.synthetic_profile(mix_a, kcells=3.0, platform=fp, source="a")
    b = port_delta.synthetic_profile(mix_b, kcells=4.0, platform=fp, source="b", gates={"value": 2.0})
    assert a == jax_delta.synthetic_profile(mix_a, kcells=3.0, platform=fp, source="a")
    view = port_delta.attribute_delta(a, b)
    assert view == jax_delta.attribute_delta(a, b)
    assert port_delta.render_delta(view) == jax_delta.render_delta(view)
    other = dict(b, platform={"backend": "cpu", "device_kind": "cpu", "device_count": 1})
    refused = port_delta.attribute_delta(a, other)
    assert refused == jax_delta.attribute_delta(a, other) and not refused["comparable"]


def _serve_world(tmp_path):
    """A serve journal with one packed pair and one solo job, and one
    worker's ring whose heartbeats carry their exec ids."""
    from sctools_tpu_torch.sched.journal import Journal, Task
    from sctools_tpu_torch.serve.api import SERVE_TASK_KIND, ServeJob
    from sctools_tpu_torch.serve.packer import pack_exec_id

    journal = Journal(str(tmp_path / "sched-journal"), worker_id="w0")
    tids = ["a" * 16, "b" * 16, "c" * 16]
    jobs = [ServeJob(t, f"/in/{i}.bam", f"/out/{i}", submitted=1000.0 + i) for i, t in
            enumerate(("t0", "t1", "t0"))]
    journal.register([Task(id=tid, kind=SERVE_TASK_KIND, name=f"{job.tenant}/{i}", payload=job.payload())
                      for i, (tid, job) in enumerate(zip(tids, jobs))])
    packed = pack_exec_id(tids[:2])
    execs = [{"exec_id": packed, "tids": tids[:2], "rows": [300, 100], "degraded": None}]
    for tid in tids:
        journal.record(tid, "leased", attempt=1, stolen=0)
    for tid in tids[:2]:
        journal.record(tid, "committed", attempt=1, part=f"/out/{tid}.csv.gz", sha256=None, pack=packed,
                       pack_members=tids[:2], pack_rows=[300, 100], pack_degraded=None, pack_bucket=4096,
                       pack_execs=execs)
    journal.record(tids[2], "committed", attempt=1, part="/out/c.csv.gz", sha256=None, pack=tids[2],
                   pack_members=[tids[2]], pack_rows=None, pack_degraded=None, pack_bucket=4096,
                   pack_execs=[{"exec_id": tids[2], "tids": [tids[2]], "rows": None, "degraded": None}])
    journal.close()
    return packed, tids


def _stamp_ring(pulse, obs, ring_dir, exec_ids):
    saved = pulse._enabled, pulse._ring_dir
    pulse.reset()
    pulse._enabled, pulse._ring_dir = True, str(ring_dir)
    try:
        for k, exec_id in enumerate(exec_ids):
            obs.set_context(task_id=exec_id)
            hb = pulse.heartbeat("gatherer.cell")
            hb.leg("h2d", k, k + 0.25)
            hb.leg("compute", k + 0.25, k + 0.5)
            hb.leg("d2h", k + 0.5, k + 0.75)
            hb.add(real_rows=400 - 100 * k, padded_rows=4096, entities=3, bytes_h2d=94212, bytes_d2h=7424)
            hb.emit()
        return pulse.ring_path()
    finally:
        obs.set_context(task_id=None)
        pulse.reset()
        pulse._enabled, pulse._ring_dir = saved


def test_slo_stitch_run_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w0")
    packed, tids = _serve_world(tmp_path)
    _stamp_ring(port_pulse, port_obs, tmp_path / "trace", ["warmup", packed, tids[2]])
    view = port_slo.stitch_run(str(tmp_path), target_s=10.0)
    assert view == jax_slo.stitch_run(str(tmp_path), target_s=10.0)
    assert port_slo.render_slo(view) == jax_slo.render_slo(view)
    assert port_slo.render_slo_metrics(view) == jax_slo.render_slo_metrics(view)
    assert view["fleet"]["committed"] == 3 and view["fleet"]["unattributed_device_s"] == 0
    assert {p["exec_id"] for p in view["packs"]} == {packed, tids[2]}
    profile = port_delta.profile_from_run_dir(str(tmp_path))
    assert profile == jax_delta.profile_from_run_dir(str(tmp_path))
    assert profile["serve"]["tenants"].keys() == {"t0", "t1"}


# the counters both packages count on the metrics and count paths
_PARITY_COUNTERS = ("records_decoded", "batches_uploaded", "entities_written", "run_keyed_batches",
                    "ingest_arena_batches", "prefetch_items", "xprof_real_rows", "xprof_padded_rows")
# the byte counters, compared where the two move the same bytes
_BYTE_COUNTERS = ("h2d_bytes", "d2h_bytes", "xprof_transfer_bytes_h2d", "xprof_transfer_bytes_d2h",
                  "xprof_transfer_wasted_bytes_d2h")
# JAX's counters of what the port does not do (the docstring says why)
_UNPORTED_COUNTER = re.compile(r"^(xprof_compiles|xprof_retraces|jax_event\.)")
# counters whose values depend on thread timing, in either package
_TIMING_COUNTERS = ("prefetch_producer_blocked", "prefetch_consumer_wait_seconds", "prefetch_abandoned_threads")


def _observe(obs, pulse, run):
    obs.reset()
    pulse.reset()
    obs.enable()
    try:
        with pulse.memory_session() as beats:
            run()
    finally:
        obs.disable()
    spans = [s for s in obs.spans() if not s["name"].startswith("jax:")]
    counters = {k: v for k, v in obs.counters().items()
                if not _UNPORTED_COUNTER.match(k) and k not in _TIMING_COUNTERS}
    obs.reset()
    pulse.reset()
    records = collections.Counter()
    for span in spans:
        records[span["name"]] += (span.get("attrs") or {}).get("records", 0)
    stages = collections.defaultdict(list)
    for beat in beats:
        stages[beat["stage"]].append((beat["real_rows"], beat["padded_rows"], beat["entities"]))
    beat_bytes = (sum(b["bytes_h2d"] for b in beats), sum(b["bytes_d2h"] for b in beats))
    return collections.Counter(s["name"] for s in spans), records, dict(stages), counters, beat_bytes


@pytest.fixture(scope="module")
def command_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_obs_commands")
    records, header = random_tagged_records(seed=0)
    cell = write_bam(str(tmp / "cell.bam"), list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])),
                     header)
    gene = write_bam(str(tmp / "gene.bam"), list(sort_by_tags_and_queryname(records, ["GE", "CB", "UB"])),
                     header)
    data = SyntheticCountData()
    count = write_bam(str(tmp / "count.bam"), data.records(), data.header)
    unsorted = write_bam(str(tmp / "unsorted.bam"), records, header)
    chunks = []
    for seed in (1, 2, 3):
        part, part_header = random_tagged_records(seed=seed, n_records=150)
        chunks.append(write_bam(str(tmp / f"chunk{seed}.bam"),
                                list(sort_by_tags_and_queryname(part, ["CB", "UB", "GE"])), part_header))
    return dict(cell=cell, gene=gene, count=count, gtf=_gtf_with_repeats(tmp), unsorted=unsorted,
                chunks=chunks, tmp=tmp)


@pytest.mark.parametrize("command,extra", [
    ("cell", []), ("gene", []), ("count", []), ("count", ["--batch-records", "32"]),
    ("tagsort", []), ("cell", ["--devices", "2"]), ("chunks", []),
])
def test_command_telemetry_matches_jax(command_inputs, command, extra):
    inputs, tmp = command_inputs, command_inputs["tmp"]
    if command == "tagsort":
        args = ["-i", inputs["unsorted"], "-t", "CB", "UB", "GE", "-a", inputs["gtf"]]

        def port():
            port_platform.GenericPlatform.tag_sort_bam(
                args + ["--cell-metrics-output", str(tmp / "pt"), "-o", str(tmp / "pt.bam")], device="cpu")

        def jax():
            jax_platform.GenericPlatform.tag_sort_bam(
                args + ["--cell-metrics-output", str(tmp / "jt"), "-o", str(tmp / "jt.bam")])
    elif command == "chunks":
        import jax as jax_module
        from jax.sharding import Mesh

        from sctools_tpu.parallel import launch as jax_launch
        from sctools_tpu_torch.parallel import launch as port_launch

        def port():
            port_launch.run_process_cell_metrics(inputs["chunks"], str(tmp / "pchunks" / "p"), 1, 0,
                                                 device="cpu")

        def jax():
            one_device = Mesh(np.array(jax_module.devices()[:1]), ("shard",))
            jax_launch.run_process_cell_metrics(inputs["chunks"], str(tmp / "jchunks" / "p"), 1, 0,
                                                mesh=one_device)
    elif command == "count":
        args = ["-b", inputs["count"], "-a", inputs["gtf"]] + extra

        def port():
            port_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "p")], device="cpu")

        def jax():
            jax_platform.GenericPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "j")])
    else:
        entry = f"calculate_{command}_metrics"

        def port():
            getattr(port_platform.GenericPlatform, entry)(
                ["-i", inputs[command], "-o", str(tmp / "p")] + extra, device="cpu")

        def jax():
            getattr(jax_platform.GenericPlatform, entry)(
                ["-i", inputs[command], "-o", str(tmp / "j"), "--backend", "device"] + extra)
    port_names, port_records, port_stages, port_counters, port_bytes = _observe(port_obs, port_pulse, port)
    jax_names, jax_records, jax_stages, jax_counters, jax_bytes = _observe(jax_obs, jax_pulse, jax)
    assert port_names == jax_names
    assert port_records == jax_records
    assert port_stages == jax_stages and port_stages
    assert sum(port_records[name] for name in ("decode",)) > 0
    compared = {k: port_counters.get(k) for k in _PARITY_COUNTERS}
    assert compared == {k: jax_counters.get(k) for k in _PARITY_COUNTERS}
    assert port_counters["xprof_real_rows"] > 0
    port_moved = {k: port_counters.pop(k, None) for k in _BYTE_COUNTERS}
    jax_moved = {k: jax_counters.pop(k, None) for k in _BYTE_COUNTERS}
    if command != "count":
        shards = {"chunks": 1}.get(command, 2 if extra == ["--devices", "2"] else 0)
        if shards:
            # the sharded gatherer's entity-count lane (the docstring says why)
            lanes = 4 * shards * port_counters["batches_uploaded"]
            for name in ("d2h_bytes", "xprof_transfer_bytes_d2h"):
                jax_moved[name] -= lanes
            jax_bytes = (jax_bytes[0], jax_bytes[1] - lanes)
        assert port_moved == jax_moved and port_bytes == jax_bytes
        assert port_moved["h2d_bytes"] == port_moved["xprof_transfer_bytes_h2d"] == port_bytes[0] > 0
        assert port_moved["d2h_bytes"] == port_moved["xprof_transfer_bytes_d2h"] == port_bytes[1] > 0
    else:
        assert (port_moved["xprof_transfer_bytes_h2d"], port_moved["xprof_transfer_bytes_d2h"]) == port_bytes
    assert port_counters == jax_counters


# ---------------------------------------------------------- the serve worker

_WORKER = r"""
import json, sys
from sctools_tpu_torch.serve import cli
sys.exit(cli.main(["worker", sys.argv[1], "--calibration-bam", sys.argv[2], "--drain",
                   "--batch-records", "4096", "--no-compress", "--worker-id", "w0",
                   "--poll-interval", "0.05"], device="cpu"))
"""


def test_traced_serve_worker_writes_a_complete_profile(tmp_path, command_inputs):
    from sctools_tpu_torch.serve.api import ServeJob
    from sctools_tpu_torch.serve.cli import submit_jobs

    journal = tmp_path / "run" / "sched-journal"
    bam = command_inputs["cell"]
    submit_jobs(str(journal), [ServeJob("t0", bam, str(tmp_path / "out" / "a")),
                               ServeJob("t1", bam, str(tmp_path / "out" / "b"))])
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCTOOLS_TPU_")}
    env.update(SCTOOLS_TPU_TRACE=str(tmp_path / "run" / "trace"), SCTOOLS_TPU_PULSE="1",
               SCTOOLS_TPU_TRACE_WORKER="w0", SCTOOLS_TPU_SLO="1",
               PYTHONPATH=os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]))
    done = subprocess.run([sys.executable, "-c", _WORKER, str(journal), bam], capture_output=True,
                          text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert done.returncode == 0, done.stderr[-3000:]
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    assert summary["jobs_committed"] == 2
    profile = json.loads(Path(summary["profile"]).read_text())
    assert summary["profile"] == str(tmp_path / "run" / "profile.w0.json")
    assert profile["complete"] and jax_delta.validate_profile(profile) == []
    assert profile["platform"] == {"backend": "torch-cpu", "device_kind": "cpu", "device_count": 1}
    assert profile["serve"] and profile["serve"]["unattributed_device_s"] == 0
    trace = tmp_path / "run" / "trace"
    spans = [json.loads(line) for line in (trace / "trace.w0.jsonl").read_text().splitlines()]
    names = collections.Counter(s.get("name") for s in spans if "meta" not in s)
    assert names["serve:pack"] >= 1 and names["upload"] == names["compute"] == names["writeback"]
    assert (trace / "metrics.w0.prom").read_text().count("sctools_tpu_sched_commits_total 2") == 1
    ring = port_pulse.load_ring(str(trace / "pulse.w0.ring"))
    assert {r["task_id"] for r in ring["records"]} >= {"warmup"}
    commits = [e for e in port_slo.load_journal(str(journal))[1] if e.get("event") == "committed"]
    assert all(set(e["slo_marks"]) == {"pack_start", "pack_done"} for e in commits)
    out = io.StringIO()
    from sctools_tpu_torch.sched import cli as sched_cli

    sched_cli._status(str(journal), out)
    text = out.getvalue()
    assert "pulse:" in text and "profile:" in text and "serve slo t0" in text
