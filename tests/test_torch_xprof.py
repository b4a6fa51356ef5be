"""The port's device-efficiency layer against the JAX package's, on the CPU.

``sctools_tpu_torch.obs.xprof`` is the port's copy of ``sctools_tpu.obs.xprof``
(per-site registry, occupancy, transfer ledger, memory watermarks and the
``obs efficiency`` report) and ``obs.fleet`` its copy of the merged run
timeline.

**Mirrored cases.** The cases of ``tests/test_xprof.py`` and
``tests/test_fleet.py`` run here against the port: each file is read, every
``sctools_tpu`` import in it is pointed at ``sctools_tpu_torch``, its
``xprof.instrument_jit(fn, name=...)`` becomes the port's
``xprof.instrument_site(name)(fn)``, its ``backend="device"`` gatherers take
``device="cpu"``, the flight record's one compile of an eager site becomes
its one call, and the rewritten module is executed. Every case runs but
these, which test what the port leaves out:

- ``test_instrument_jit_counts_compiles_and_retraces``,
  ``test_instrument_jit_static_kwargs_in_signature`` and
  ``test_efficiency_cli``: they count ``jax.jit`` compiles, and the port's
  eager sites compile nothing (:func:`test_eager_sites_record_calls_and_no_compiles`,
  :func:`test_record_compile_counts_retraces_and_flags_one_heartbeat` and
  :func:`test_efficiency_cli_reports_an_eager_site` are their port cases);
- ``test_sharding_distinguishes_signatures``: a ``NamedSharding``
  (:func:`test_per_shard_lists_are_tagged_shards` is its port case);
- ``test_instrument_jit_cost_analysis`` and
  ``test_compile_events_attributed_to_jax_spans``: ``cost_analysis`` and
  the jax.monitoring compile events;
- ``test_entity_buckets_inside_contract_universe``: it builds JAX's
  contract over JAX's tree; the port's counterpart is
  ``test_torch_shardcheck``'s
  ``test_contract_closed_over_the_ports_buckets_and_wire``.

**JAX parity of the commands.** CalculateCellMetrics, CalculateGeneMetrics,
CreateCountMatrix, Attach10xBarcodes ``-w`` and CalculateCellMetrics
``--devices 2`` run with recording on in both packages (the port with
``device="cpu"``). Per site, ``dispatches``, ``real_rows``, ``padded_rows``
and ``occupancy`` are equal, but for one difference, pinned here: JAX pads
each whitelist batch's queries to a multiple of 256 rows
(``sctools_tpu/ops/whitelist.py:298``) and the port pads none. The ledger is
held to the port's own span and heartbeat bytes per site and direction, and
to JAX's where both move the same bytes (the gatherers' upload and
writeback, the whitelist's pulled indices).
"""

from __future__ import annotations

import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest
from _pytest.mark.structures import ParameterSet

from sctools_tpu import obs as jax_obs
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.obs import pulse as jax_pulse
from sctools_tpu.obs import xprof as jax_xprof
from sctools_tpu_torch import obs as port_obs
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.obs import pulse as port_pulse
from sctools_tpu_torch.obs import xprof as port_xprof
from sctools_tpu_torch.obs.__main__ import main as port_cli

from helpers import make_header, make_record, write_bam, write_fastq
from test_metrics import random_tagged_records
from test_torch_count import SyntheticCountData, _gtf_with_repeats

TESTS = Path(__file__).resolve().parent

# ------------------------------------------------------------ mirrored cases

_JAX_IMPORT = re.compile(r"\b(from|import)(\s+)sctools_tpu\b(?!_torch)")
_REWRITES = (
    ("xprof.instrument_jit(", "_instrument_site("),
    ('backend="device"', 'backend="device", device="cpu"'),
    # the flight record's registry: an eager site records its one call,
    # where JAX's jit site records one compile
    ('["test.flight"]["compiles"] == 1', '["test.flight"]["calls"] == 1'),
)


def _instrument_site(fn, name=None, **jit_kwargs):
    """JAX's ``instrument_jit(fn, name=...)`` call shape over the port's
    decorator (the jit keywords mean nothing to an eager site)."""
    return port_xprof.instrument_site(name or fn.__name__)(fn)


def _ported(name: str) -> types.ModuleType:
    """``tests/<name>.py`` executed against the port (module docstring)."""
    path = TESTS / f"{name}.py"
    source = _JAX_IMPORT.sub(r"\1\2sctools_tpu_torch", path.read_text())
    for old, new in _REWRITES:
        source = source.replace(old, new)
    module = types.ModuleType(f"ported_{name}")
    module.__file__ = str(path)
    module._instrument_site = _instrument_site
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


_MIRRORED = {
    "test_xprof": {
        "test_instrument_jit_counts_compiles_and_retraces",
        "test_instrument_jit_static_kwargs_in_signature",
        "test_efficiency_cli",
        "test_sharding_distinguishes_signatures",
        "test_instrument_jit_cost_analysis",
        "test_compile_events_attributed_to_jax_spans",
        "test_entity_buckets_inside_contract_universe",
    },
    "test_fleet": set(),
}
_MODULES = {name: _ported(name) for name in _MIRRORED}

# the ported modules' fixtures, under their own names
recording = _MODULES["test_xprof"].recording
run_dir = _MODULES["test_fleet"].run_dir


def _parametrizations(fn):
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


# -------------------------------------------------------------- port cases

def test_eager_sites_record_calls_and_no_compiles(recording):
    fn = port_xprof.instrument_site("test.eager")(lambda x, k: x[:k])
    fn(np.ones(8, np.float32), k=4)
    fn(np.ones(8, np.float32), k=2)
    fn(np.ones(8, np.float32), k=2)
    site = port_xprof.snapshot()["sites"]["test.eager"]
    assert site["calls"] == 3 and site["compiles"] == 0 and site["retraces"] == 0
    assert site["signatures"] == {"(float32[8]) {k=4}": 0, "(float32[8]) {k=2}": 0}
    assert "test.eager" in port_xprof.declared_sites()


def test_per_shard_lists_are_tagged_shards(recording):
    import torch

    fn = port_xprof.instrument_site("test.shards")(lambda shards, cols: None)
    shards = [torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.int32)]
    per_shard = [{"b": torch.zeros(3), "a": torch.zeros(2, dtype=torch.int64)}, None]
    fn(shards, per_shard)
    (sig,) = port_xprof.snapshot()["sites"]["test.shards"]["signatures"]
    assert sig == "(int32[2,4,8]@(shards), int64[2,2]@(shards), float32[2,3]@(shards))"


def test_record_compile_counts_retraces_and_flags_one_heartbeat(recording):
    with port_pulse.memory_session() as beats:
        first, second = port_pulse.heartbeat("count"), port_pulse.heartbeat("count")
        port_xprof.record_compile("test.graph", "(int32[8])", seconds=0.5)
        port_xprof.record_compile("test.graph", "(int32[8])", retrace=True)
        for hb in (first, second):
            hb.emit()
    site = port_xprof.snapshot()["sites"]["test.graph"]
    assert (site["compiles"], site["retraces"], site["compile_s"]) == (2, 1, 0.5)
    assert site["retrace_signatures"] == [{"signature": "(int32[8])", "count": 1}]
    assert [beat["retrace"] for beat in beats] == [True, False]
    assert port_obs.counters()["xprof_retraces"] == 1 and port_xprof.retrace_seq() >= 1


# ``sctools_tpu.`` not followed by ``_torch``: a module of the JAX package
_JAX_MODULE = re.compile(r"sctools_tpu\.(?!_torch)|sctools_tpu\b(?!_torch)")


def test_suggestions_and_help_name_the_ports_autotuner(capsys):
    """The ``--suggest`` report and help send the operator to the port's
    ``--retune``: JAX's would rewrite the JAX package's segments file."""
    rows = port_xprof.suggest_buckets({"sites": {"s": {"dispatches": 4, "real_rows": 400, "padded_rows": 16384,
                                                       "occupancy": 400 / 16384}}})
    for text in (port_xprof.render_suggestions(rows), port_xprof.render_suggestions([])):
        assert "python -m sctools_tpu_torch.analysis --retune <run_dir>" in text
        assert not _JAX_MODULE.search(text), text
    with pytest.raises(SystemExit):
        port_cli(["efficiency", "--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    assert "python -m sctools_tpu_torch.analysis --retune" in help_text
    assert not _JAX_MODULE.search(help_text), help_text
    assert not _JAX_MODULE.search(port_xprof.suggest_buckets.__doc__)


def test_efficiency_cli_reports_an_eager_site(recording, tmp_path, capsys):
    assert port_cli(["efficiency", str(tmp_path)]) == 2
    capsys.readouterr()
    fn = port_xprof.instrument_site("test.cli")(lambda x: x * 3)
    fn(np.ones(8, np.float32))
    port_xprof.record_dispatch("test.cli", 8, 16)
    port_xprof.dump(str(tmp_path / "xprof.json"))
    assert port_cli(["efficiency", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "test.cli" in out and "occupancy" in out
    assert port_cli(["efficiency", str(tmp_path), "--json"]) == 0
    payload = __import__("json").loads(capsys.readouterr().out)
    assert payload["sites"]["test.cli"]["compiles"] == 0 and payload["sites"]["test.cli"]["calls"] == 1
    assert payload["totals"]["occupancy"] == 0.5


def test_memory_probe_on_the_cpu_is_unsupported_and_silent(recording):
    import torch

    assert port_xprof.sample_memory(devices=(torch.device("cpu"),)) is None
    memory = port_xprof.snapshot()["memory"]
    assert memory["supported"] is False and memory["samples"] == 0
    port_obs.disable()
    port_xprof.reset()
    assert port_xprof.sample_memory(devices=(torch.device("cpu"),)) is None
    assert port_xprof.snapshot()["memory"]["supported"] is None


def test_each_jax_jit_site_has_its_declared_counterpart():
    jax_source = "".join(path.read_text() for path in (TESTS.parent / "sctools_tpu").rglob("*.py"))
    jax_sites = set(re.findall(r'name="([a-z_]+\.[a-z_]+)"', jax_source))
    ported = set()
    for path in (TESTS.parent / "sctools_tpu_torch").rglob("*.py"):
        ported.update(re.findall(r'instrument_site\("([^"]+)"\)', path.read_text()))
    expected = {
        "metrics.compute_entity_metrics", "metrics.compact_results", "metrics.compact_results_wire",
        "metrics.collective_merge", "metrics.collective_merge_gene", "ops.count_molecules",
        "whitelist.correct_jnp", "whitelist.correct_pallas", "parallel.metrics_step",
        "parallel.sharded_metrics", "parallel.sharded_count", "parallel.mesh_preflight",
        "parallel.sample_sort",
    }
    assert ported == expected and expected <= jax_sites


def test_export_names_match_jax_where_carried():
    carried = set(port_xprof.__all__) - {"instrument_site", "signature", "record_call", "record_compile",
                                         "load_mesh_dumps"}
    assert carried <= set(jax_xprof.__all__)
    assert port_xprof.ENTITY_BUCKET_SITES == jax_xprof.ENTITY_BUCKET_SITES
    assert port_xprof.SIGNATURE_OVERFLOW == jax_xprof.SIGNATURE_OVERFLOW


# ------------------------------------------------------ commands against JAX

N_READS = 300


def _attach_inputs(tmp):
    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    seqs = lambda n, length: ["".join(row) for row in rng.choice(bases, size=(n, length))]  # noqa: E731
    whitelist = seqs(64, 16)
    (tmp / "wl.txt").write_text("\n".join(whitelist) + "\n")
    reads = []
    for i in range(N_READS):
        barcode = whitelist[int(rng.integers(len(whitelist)))]
        if i % 3 == 1:
            barcode = barcode[:5] + "N" + barcode[6:]
        elif i % 3 == 2:
            barcode = seqs(1, 16)[0]
        reads.append(barcode + seqs(1, 12)[0])
    r1 = write_fastq(str(tmp / "r1.fastq"), [(f"r{i}", s, "I" * len(s)) for i, s in enumerate(reads)])
    header = make_header()
    records = [make_record(name=f"r{i}", unmapped=True, sequence=s, quality=[30] * 24, header=header)
               for i, s in enumerate(seqs(N_READS, 24))]
    u2 = write_bam(str(tmp / "u2.bam"), records, header)
    return ["--r1", r1, "--u2", u2, "-w", str(tmp / "wl.txt")]


@pytest.fixture(scope="module")
def command_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_xprof_commands")
    records, header = random_tagged_records(seed=1, n_records=600)
    cell = write_bam(str(tmp / "cell.bam"), list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])),
                     header)
    gene = write_bam(str(tmp / "gene.bam"), list(sort_by_tags_and_queryname(records, ["GE", "CB", "UB"])),
                     header)
    data = SyntheticCountData()
    count = write_bam(str(tmp / "count.bam"), data.records(), data.header)
    return dict(cell=cell, gene=gene, count=count, gtf=_gtf_with_repeats(tmp), attach=_attach_inputs(tmp),
                tmp=tmp)


def _record(obs, pulse, xprof, run):
    """(registry snapshot, spans, heartbeats) of one traced run."""
    obs.reset()
    pulse.reset()
    xprof.reset()
    obs.enable()
    try:
        with pulse.memory_session() as beats:
            run()
        snap = xprof.snapshot()
        spans = obs.spans()
    finally:
        obs.disable()
        obs.reset()
        pulse.reset()
        xprof.reset()
    return snap, spans, list(beats)


def _dispatch_rows(snap):
    return {
        name: (row["dispatches"], row["real_rows"], row["padded_rows"], row["occupancy"])
        for name, row in snap["sites"].items() if row["dispatches"]
    }


def _ledger(snap):
    return {(direction, site): entry["bytes"]
            for direction, total in snap["ledger"].items() for site, entry in total["by_site"].items()}


def _span_bytes(spans, name):
    return sum((s.get("attrs") or {}).get("bytes", 0) for s in spans if s["name"] == name)


def _beat_bytes(beats, field):
    return sum(beat[field] for beat in beats)


# command -> (port call, JAX call) over the inputs and an output stem
def _commands(inputs, tmp):
    metrics = lambda kind, extra: (  # noqa: E731
        lambda: getattr(port_platform.GenericPlatform, f"calculate_{kind}_metrics")(
            ["-i", inputs[kind], "-o", str(tmp / f"p_{kind}")] + extra, device="cpu"),
        lambda: getattr(jax_platform.GenericPlatform, f"calculate_{kind}_metrics")(
            ["-i", inputs[kind], "-o", str(tmp / f"j_{kind}"), "--backend", "device"] + extra),
    )
    count_args = ["-b", inputs["count"], "-a", inputs["gtf"]]
    return {
        "cell": metrics("cell", []),
        "gene": metrics("gene", []),
        "cell_devices_2": metrics("cell", ["--devices", "2"]),
        "count": (
            lambda: port_platform.GenericPlatform.bam_to_count_matrix(count_args + ["-o", str(tmp / "pc")],
                                                                       device="cpu"),
            lambda: jax_platform.GenericPlatform.bam_to_count_matrix(count_args + ["-o", str(tmp / "jc")]),
        ),
        "attach": (
            lambda: port_platform.TenXV2.attach_barcodes(inputs["attach"] + ["-o", str(tmp / "pa.bam")],
                                                         device="cpu"),
            lambda: jax_platform.TenXV2.attach_barcodes(inputs["attach"] + ["-o", str(tmp / "ja.bam")]),
        ),
    }


# the whitelist pad: JAX rounds each batch's queries up to 256 rows
def _pad256(n):
    return -(-n // 256) * 256


@pytest.mark.parametrize("command", ["cell", "gene", "count", "attach", "cell_devices_2"])
def test_command_registry_matches_jax(command_inputs, command):
    tmp = command_inputs["tmp"]
    port_run, jax_run = _commands(command_inputs, tmp)[command]
    port_snap, port_spans, port_beats = _record(port_obs, port_pulse, port_xprof, port_run)
    jax_snap, _, _ = _record(jax_obs, jax_pulse, jax_xprof, jax_run)
    port_rows, jax_rows = _dispatch_rows(port_snap), _dispatch_rows(jax_snap)
    assert port_rows
    if command == "attach":
        # the pinned difference: the same queries, padded by JAX only
        (dispatches, real, padded, occupancy) = port_rows.pop("whitelist.correct_jnp")
        assert (dispatches, real, padded, occupancy) == (1, N_READS, N_READS, 1.0)
        sites = [name for name in jax_rows if name.startswith("whitelist.correct_")]
        assert len(sites) == 1
        jax_dispatches, jax_real, jax_padded, _ = jax_rows.pop(sites[0])
        assert (jax_dispatches, jax_real, jax_padded) == (dispatches, real, _pad256(real))
    assert port_rows == jax_rows

    ledger, jax_ledger = _ledger(port_snap), _ledger(jax_snap)
    if command in ("cell", "gene", "cell_devices_2"):
        # the ledger is the spans' and heartbeats' bytes, and JAX's
        assert ledger == {("h2d", "gatherer.upload"): _span_bytes(port_spans, "upload"),
                          ("d2h", "gatherer.writeback"): _span_bytes(port_spans, "writeback")}
        assert ledger[("h2d", "gatherer.upload")] == _beat_bytes(port_beats, "bytes_h2d")
        assert ledger[("d2h", "gatherer.writeback")] == _beat_bytes(port_beats, "bytes_d2h")
        if command == "cell_devices_2":
            # pinned: each shard's pull carries its entity count as one
            # int32 lane, where JAX (x64 in the tests) pulls an int64
            batches = port_rows["parallel.sharded_metrics"][0]
            jax_ledger[("d2h", "gatherer.writeback")] -= 4 * 2 * batches
        assert ledger == jax_ledger
        waste = port_snap["ledger"]["d2h"]["wasted"]
        assert waste == jax_snap["ledger"]["d2h"]["wasted"] and waste > 0
    elif command == "count":
        # the port moves one int32 [8, n] block up and one [5, n] down
        (_, _, padded, _), = port_rows.values()
        assert ledger == {("h2d", "count.upload"): 8 * 4 * padded, ("d2h", "count.writeback"): 5 * 4 * padded}
        assert ledger[("h2d", "count.upload")] == _beat_bytes(port_beats, "bytes_h2d")
        assert ledger[("d2h", "count.writeback")] == _beat_bytes(port_beats, "bytes_d2h")
        assert set(ledger) == set(jax_ledger)
    else:
        # L bytes a query up, one int32 index down; the table once
        assert ledger[("h2d", "whitelist.queries")] == 16 * N_READS
        assert ledger[("d2h", "whitelist.queries")] == 4 * N_READS == jax_ledger[("d2h", "whitelist.queries")]
        assert ledger[("h2d", "whitelist.table")] == 64 * 16 or ("h2d", "whitelist.table") not in ledger
        assert set(ledger) <= set(jax_ledger)


def test_command_run_dirs_read_in_either_package(command_inputs, tmp_path, monkeypatch, capsys):
    """A port registry dumped as the trace capture dumps it reads through
    JAX's ``obs efficiency``, and a JAX one through the port's."""
    from sctools_tpu.obs.__main__ import main as jax_cli

    tmp = command_inputs["tmp"]
    port_run, jax_run = _commands(command_inputs, tmp)["cell"]
    for name, (obs, pulse, xprof, run) in {
        "port": (port_obs, port_pulse, port_xprof, port_run),
        "jax": (jax_obs, jax_pulse, jax_xprof, jax_run),
    }.items():
        obs.reset()
        xprof.reset()
        obs.enable()
        try:
            run()
            (tmp_path / name).mkdir()
            assert xprof.dump(str(tmp_path / name / f"xprof.{name}.json"), worker=name)
        finally:
            obs.disable()
            obs.reset()
            xprof.reset()
    capsys.readouterr()
    reports = {}
    for name in ("port", "jax"):
        for cli in (port_cli, jax_cli):
            assert cli(["efficiency", str(tmp_path / name), "--json"]) == 0
            reports[name, cli is port_cli] = __import__("json").loads(capsys.readouterr().out)
            assert cli(["efficiency", str(tmp_path / name)]) == 0
            assert "gatherer.upload" in capsys.readouterr().out
    for name in ("port", "jax"):
        assert reports[name, True]["sites"] == reports[name, False]["sites"]
        assert reports[name, True]["ledger"] == reports[name, False]["ledger"]
    port_sites = {k: v["real_rows"] for k, v in reports["port", True]["sites"].items() if v["dispatches"]}
    jax_sites = {k: v["real_rows"] for k, v in reports["jax", True]["sites"].items() if v["dispatches"]}
    assert port_sites == jax_sites
