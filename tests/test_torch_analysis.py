"""The port's static checks (``sctools_tpu_torch.analysis``) against JAX's.

- Parity: on the JAX package's fixture corpus (race, life, ABI and SCX109),
  each port pass reports exactly the (rule, line) set of its JAX pass, and
  the two race passes emit the same lock graph over the port's tree.
- SCX1001 (unguarded-actuation): JAX's fixtures give JAX's findings and
  messages, the ``steer/`` directory (immediate parent only) and the knob
  modules are owners, and the port's tree and the smoke give none.
- Port-only: SCX112 on its fixtures and owners; the ABI pass on corrupted
  copies of the port's ``signatures`` table; seeded faults in copies of
  the port's own consumers; every pass clean on the port's tree, with the
  one suppression (``sched/journal.py``'s SCX109) doing its job.
- The runtime lock witness: the JAX package's witness cases on the port's
  witness, the six named lock sites, and each package reading the other's
  dump as its static graph.
- The CLI: module invocation, ``--race-only``, ``--life-only``, ``--json``
  and ``--emit-lock-graph`` on the clean tree and on a seeded bad corpus;
  ``--list-rules``, ``--no-lint``, ``--no-abi``, ``--no-supp`` and ``-q``
  against the JAX CLI's behaviour.
- SCX113 and SCX114: JAX's fixtures give JAX's findings where the port
  has the construct, torch-spelled bad and clean twins, the owners
  (``guard/``; ``ingest/`` and ``parallel/collective.py``), seeded faults
  in copies of the port's code, and the port's tree and the smoke give
  none.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``): nothing is written
beside the repository.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from sctools_tpu.analysis import abicheck as jax_abicheck
from sctools_tpu.analysis import jaxlint as jax_jaxlint
from sctools_tpu.analysis import lifecheck as jax_lifecheck
from sctools_tpu.analysis import racecheck as jax_racecheck
from sctools_tpu.analysis import witness as jax_witness
from sctools_tpu_torch.analysis import (
    check_abi,
    check_life,
    check_races,
    lint_file,
    lock_graph,
    witness,
)
from sctools_tpu_torch.analysis.astcache import collect_py_files
from sctools_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
NATIVE = PORT / "native"
FIXTURES = REPO / "tests" / "fixtures_scxlint"
ENV_VARS = ("SCTOOLS_TPU_LOCK_DEBUG", "SCTOOLS_TPU_LOCK_GRAPH", "SCTOOLS_TPU_LOCK_DEBUG_STALL_S",
            "SCTOOLS_TPU_TRACE", "SCTOOLS_TPU_TRACE_WORKER")
PORT_LOCKS = {"ops.whitelist_table", "kernels.loader", "native.loader", "sched.faults",
              "sched.journal", "ingest.framedebug", "obs.ring", "obs.sink", "obs.pulse", "obs.xprof",
              "obs.audit", "ingest.ring_state", "guard.open_retries", "guard.degrade",
              "guard.quarantine", "guard.watchdog.deadline", "ingest.wire_state"}


@pytest.fixture(autouse=True, scope="module")
def _no_parse_store():
    saved = os.environ.get("SCTOOLS_TPU_SCX_CACHE")
    os.environ["SCTOOLS_TPU_SCX_CACHE"] = "0"
    yield
    if saved is None:
        os.environ.pop("SCTOOLS_TPU_SCX_CACHE", None)
    else:
        os.environ["SCTOOLS_TPU_SCX_CACHE"] = saved


def rule_lines(findings, rule_prefix: str = "SCX"):
    return sorted((f.rule, f.line) for f in findings if f.rule.startswith(rule_prefix))


def marked_lines(text: str, rule: str):
    return [n for n, line in enumerate(text.splitlines(), 1) if f"# <- {rule}" in line]


# ------------------------------------------------------------------ parity

RACE_FIXTURES = sorted(p.name for p in (FIXTURES / "racecheck").glob("scx40*_*.py"))
LIFE_FIXTURES = sorted(p.name for p in (FIXTURES / "lifecheck").glob("scx60*_*.py"))


@pytest.mark.parametrize("name", RACE_FIXTURES)
def test_race_pass_matches_jax_on_its_fixtures(name):
    path = str(FIXTURES / "racecheck" / name)
    want = rule_lines(jax_racecheck.check_races([path]))
    assert rule_lines(check_races([path])) == want
    assert bool(want) == name.endswith("_bad.py")


PROVIDER_SCX402 = '''"""A flight-section provider blocks on a lock without a bound."""
import threading

from sctools_tpu_torch import obs

table_lock = threading.Lock()
safe_lock = threading.Lock()
table = {}


def table_section():
    with table_lock:  # <- SCX402
        return dict(table)


obs.register_flight_section("table", table_section)
obs.register_flight_section("safe", obs.bounded_snapshot(safe_lock, lambda: dict(table), {}))
'''


def test_race_pass_flags_a_provider_that_blocks_without_a_bound(tmp_path):
    """The flight-section providers are death roots (``flight_dump`` calls
    each of them): an unbounded acquire in one is SCX402, a provider made by
    ``obs.bounded_snapshot`` is not."""
    path = tmp_path / "provider.py"
    path.write_text(PROVIDER_SCX402)
    findings = check_races([str(path)])
    assert rule_lines(findings) == [("SCX402", line) for line in marked_lines(PROVIDER_SCX402, "SCX402")]
    assert rule_lines(findings) == rule_lines(jax_racecheck.check_races([str(path)]))


@pytest.mark.parametrize("name", LIFE_FIXTURES)
def test_life_pass_matches_jax_on_its_fixtures(name):
    path = str(FIXTURES / "lifecheck" / name)
    want = rule_lines(jax_lifecheck.check_life([path]))
    assert rule_lines(check_life([path])) == want
    assert bool(want) == name.endswith("_bad.py")


@pytest.mark.parametrize("kind", ["bad", "clean"])
def test_abi_pass_matches_jax_on_its_fixtures(kind):
    directory = FIXTURES / "abi" / kind
    bindings = str(directory / "bindings.py")
    want = rule_lines(jax_abicheck.check_abi(str(directory), bindings))
    assert rule_lines(check_abi(str(directory), bindings)) == want
    assert bool(want) == (kind == "bad")


@pytest.mark.parametrize("kind", ["bad", "clean"])
def test_scx1001_matches_jax_on_its_fixtures(kind):
    path = str(FIXTURES / "jaxlint" / f"scx1001_{kind}.py")
    want = [f for f in jax_jaxlint.lint_file(path) if f.rule == "SCX1001"]
    got = lint_file(path)
    assert rule_lines(got) == rule_lines(want)
    assert len(want) == (5 if kind == "bad" else 0)
    # JAX's messages, but for the floor rebind's, which names the port's remedy
    assert {f.message for f in got if "floor" not in f.message} == {
        f.message for f in want if "floor" not in f.message
    }


def test_scx1001_steer_dir_is_exempt(tmp_path):
    # SCX1001 is about ownership like SCX112: the steer package IS the
    # contract-checked apply path, wherever the checkout lives
    src = (
        "from sctools_tpu_torch.utils.prefetch import set_depth_override\n\n\n"
        "def apply(depth):\n    set_depth_override(depth)\n"
    )
    steer_dir = tmp_path / "steer"
    steer_dir.mkdir()
    (steer_dir / "apply.py").write_text(src)
    assert lint_file(str(steer_dir / "apply.py")) == []
    (tmp_path / "apply.py").write_text(src)
    findings = lint_file(str(tmp_path / "apply.py"))
    assert {f.rule for f in findings} == {"SCX1001"}
    # only the IMMEDIATE parent confers ownership (the SCX112 line)
    nested = steer_dir / "sub"
    nested.mkdir()
    (nested / "apply.py").write_text(src)
    assert {f.rule for f in lint_file(str(nested / "apply.py"))} == {"SCX1001"}


def test_scx1001_knob_owners_are_exempt(tmp_path):
    # the modules that DEFINE the knobs stay lintable: prefetch.py hosts
    # the override cell, segments.py pins the floors
    (tmp_path / "prefetch.py").write_text(
        "_depth_override = None\n\n\ndef set_depth_override(depth):\n"
        "    global _depth_override\n    _depth_override = depth\n"
    )
    assert lint_file(str(tmp_path / "prefetch.py")) == []
    (tmp_path / "segments.py").write_text("RECORD_BUCKET_MIN = 4096\n")
    assert lint_file(str(tmp_path / "segments.py")) == []


def test_scx1001_port_tree_and_smoke_are_clean():
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    findings = [f for path in paths for f in lint_file(str(path)) if f.rule == "SCX1001"]
    assert findings == [], [f.render() for f in findings]
    # the apply path is there, and owned
    assert "set_depth_override(" in (PORT / "steer" / "__init__.py").read_text()


@pytest.mark.parametrize("kind", ["bad", "clean"])
def test_scx109_matches_jax_on_its_fixtures(kind):
    path = str(FIXTURES / "jaxlint" / f"scx109_{kind}.py")
    want = rule_lines(jax_jaxlint.lint_file(path), "SCX109")
    got = lint_file(path)
    assert rule_lines(got) == want
    assert {f.message for f in got} == {f.message for f in jax_jaxlint.lint_file(path) if f.rule == "SCX109"}
    assert bool(want) == (kind == "bad")


def test_lock_graph_matches_jax_over_the_port():
    graph = lock_graph([str(PORT)])
    assert graph == jax_racecheck.lock_graph([str(PORT)])
    assert set(graph["locks"]) == PORT_LOCKS
    # the span sink's one nesting (obs.enable opens the sink under the ring
    # lock), and the stall watchdog's flight dump under its deadline lock,
    # which reads the counters and every flight section: JAX's own edges
    assert [(e["from"], e["to"], e["bounded"]) for e in graph["edges"]] == [
        ("guard.watchdog.deadline", "guard.degrade", True),
        ("guard.watchdog.deadline", "guard.open_retries", True),
        ("guard.watchdog.deadline", "ingest.ring_state", True),
        ("guard.watchdog.deadline", "ingest.wire_state", True),
        ("guard.watchdog.deadline", "obs.pulse", True),
        ("guard.watchdog.deadline", "obs.ring", False),
        ("guard.watchdog.deadline", "obs.xprof", False),
        ("obs.ring", "obs.sink", False)]
    entries = {(e["kind"], Path(e["site"].rsplit(":", 1)[0]).relative_to(PORT).as_posix())
               for e in graph["entries"]}
    # the death roots: the SIGTERM flight recorder, the watchdog's timer and
    # the flight-section providers (the rings' bounded snapshots and their
    # registrations, the pulse's, the guard's open retries and degraded sites)
    assert entries == {("thread", "sched/scheduler.py"), ("thread", "serve/engine.py"),
                       ("thread", "utils/prefetch.py"), ("thread", "obs/serve.py"),
                       ("signal", "obs/__init__.py"), ("provider", "ingest/ring.py"),
                       ("provider", "obs/pulse.py"), ("provider", "ingest/wire.py"),
                       ("provider", "guard/__init__.py"), ("provider", "guard/degrade.py"),
                       ("timer", "guard/watchdog.py")}


# ------------------------------------------------------- SCX112 and SCX109

SCX112_BAD = '''"""SCX112 bad: host->device crossings outside the seam."""
import torch


def stage(array, device):
    return torch.from_numpy(array).to(device)  # <- SCX112


def stage_cuda(array):
    return torch.from_numpy(array).cuda()  # <- SCX112


def stage_keyword(tensor, device):
    return tensor.to(device=device)  # <- SCX112


def stage_async(tensor):
    return tensor.to(torch.int32, non_blocking=True)  # <- SCX112


def build(values, device):
    return torch.tensor(values, device=device)  # <- SCX112


def wrap(values):
    return torch.as_tensor(values, device="cuda:0")  # <- SCX112
'''

SCX112_CLEAN = '''"""SCX112 clean: uploads through the seam, dtype casts, host tensors."""
import torch

from sctools_tpu_torch import ingest


def stage(array, device):
    return ingest.upload(array, device, site="stage")


def casts(tensor, like, out_dtype):
    return (tensor.to(torch.int32), tensor.to(like.dtype), tensor.to(out_dtype),
            tensor.to(dtype=torch.float32))


def host(values):
    return torch.tensor(values, device="cpu"), torch.as_tensor(values)


def escaped(tensor):
    return tensor.cuda()  # scx-lint: disable=SCX112 -- deliberate
'''


def test_scx112_fires_on_marked_lines(tmp_path):
    path = tmp_path / "staging.py"
    path.write_text(SCX112_BAD)
    assert rule_lines(lint_file(str(path))) == [("SCX112", n) for n in marked_lines(SCX112_BAD, "SCX112")]


def test_scx112_silent_on_clean_fixture(tmp_path):
    path = tmp_path / "staging.py"
    path.write_text(SCX112_CLEAN)
    assert lint_file(str(path)) == []


@pytest.mark.parametrize("where,owned", [
    ("ingest/staging.py", True),
    ("parallel/collective.py", True),
    ("ingest/sub/staging.py", False),  # only the immediate parent owns
    ("other/collective.py", False),
    ("parallel/staging.py", False),
])
def test_scx112_owners(tmp_path, where, owned):
    path = tmp_path / where
    path.parent.mkdir(parents=True)
    path.write_text(SCX112_BAD)
    assert (lint_file(str(path)) == []) == owned


def test_scx109_suppression_restored_in_the_journal(tmp_path):
    journal = PORT / "sched" / "journal.py"
    assert lint_file(str(journal)) == []
    text = journal.read_text()
    directive = "  # scx-lint: disable=SCX109 -- cross-process timestamp, not a duration"
    assert text.count(directive) == 1
    line = text[: text.index(directive)].count("\n") + 1
    stripped = tmp_path / "journal.py"
    stripped.write_text(text.replace(directive, ""))
    assert rule_lines(lint_file(str(stripped))) == [("SCX109", line)]


# --------------------------------------------------------------- ctypes ABI

def corrupted_bindings(tmp_path, old: str, new: str) -> str:
    text = (NATIVE / "__init__.py").read_text()
    assert text.count(old) == 1, f"binding text changed: {old!r}"
    path = tmp_path / "bindings.py"
    path.write_text(text.replace(old, new))
    return str(path)


@pytest.mark.parametrize("old,new,rule,symbol", [
    # an integer of another width
    ('"scx_stream_next": (c_long, [p, c_long]),', '"scx_stream_next": (c_long, [p, c_int]),',
     "SCX204", "scx_stream_next"),
    # a dropped argument
    ('"scx_n_records": (c_long, [p]),', '"scx_n_records": (c_long, []),', "SCX203", "scx_n_records"),
    # a corrupted typed restype
    ('"scx_col_i32": (ctypes.POINTER(ctypes.c_int32), [p, c_char_p]),',
     '"scx_col_i32": (ctypes.POINTER(ctypes.c_int64), [p, c_char_p]),', "SCX205", "scx_col_i32"),
    # an integer where C takes a pointer
    ('"scx_batch_fill_arena": (c_long, [p, p, c_long]),', '"scx_batch_fill_arena": (c_long, [p, c_long, c_long]),',
     "SCX204", "scx_batch_fill_arena"),
    # c_char_p for a pointer that is not char*
    ('"scx_fqm": (c_long, [c_char_p, p,', '"scx_fqm": (c_long, [c_char_p, c_char_p,', "SCX204", "scx_fqm"),
    # a binding removed: its export is unbound
    ('        "scx_pool_threads": (c_int, []),\n', "", "SCX202", "scx_pool_threads"),
    # a binding of no export
    ('"scx_pool_threads": (c_int, []),', '"scx_pool_threads": (c_int, []), "scx_ghost": (c_int, []),',
     "SCX201", "scx_ghost"),
])
def test_abi_catches_a_corrupted_signatures_entry(tmp_path, old, new, rule, symbol):
    findings = check_abi(str(NATIVE), corrupted_bindings(tmp_path, old, new))
    assert [(f.rule, symbol in f.message) for f in findings] == [(rule, True)], [f.render() for f in findings]


def test_abi_reads_the_tables_aliases_and_the_jax_spelling(tmp_path):
    (tmp_path / "fake.cpp").write_text(
        'extern "C" {\n'
        "long scx_a(void* h, const int32_t* xs, long n) { return n; }\n"
        "const int32_t* scx_b(void* h) { return nullptr; }\n"
        "}\n"
    )
    (tmp_path / "bindings.py").write_text(
        "import ctypes\n"
        "def bind(lib):\n"
        "    p, c_long = ctypes.c_void_p, ctypes.c_long\n"
        '    table = {"scx_a": (c_long, [p, p, c_long])}\n'
        "    lib.scx_b.restype = ctypes.POINTER(ctypes.c_int32)\n"
        "    lib.scx_b.argtypes = [p]\n"
    )
    assert check_abi(str(tmp_path), str(tmp_path / "bindings.py")) == []
    # the typed pointer stays exact in a restype, and a data pointer
    # argument takes no integer
    (tmp_path / "bindings.py").write_text(
        "import ctypes\n"
        "def bind(lib):\n"
        "    p, c_long = ctypes.c_void_p, ctypes.c_long\n"
        '    table = {"scx_a": (c_long, [p, c_long, c_long]), "scx_b": (p, [p])}\n'
    )
    assert rule_lines(check_abi(str(tmp_path), str(tmp_path / "bindings.py"))) == [("SCX204", 4), ("SCX205", 4)]


# ------------------------------------------------------ the port's own tree

@pytest.fixture(scope="module")
def port_findings():
    """Each pass's findings over the port's tree, computed once."""
    files = [path for path, _, _ in collect_py_files([str(PORT)])]
    return {
        "lint": [f for path in files for f in lint_file(path)],
        "abi": check_abi(str(NATIVE)),
        "race": check_races([str(PORT)]),
        "life": check_life([str(PORT)]),
    }


@pytest.mark.parametrize("name", ["lint", "abi", "race", "life"])
def test_each_pass_is_clean_on_the_port(port_findings, name):
    assert [f.render() for f in port_findings[name]] == []


def seeded_copy(tmp_path, name: str, old: str, new: str) -> str:
    text = (PORT / name).read_text()
    assert text.count(old) == 1, f"{name} changed: {old!r}"
    path = tmp_path / Path(name).name
    path.write_text(text.replace(old, new))
    return str(path)


@pytest.mark.parametrize("name,old,new,rule", [
    # the count's carried tail kept as a view past the next() look-ahead
    ("count.py", "carry = carried(frame, cut)", "carry = slice_frame(frame, cut, frame.n_records)", "SCX602"),
    # a third look-ahead in the count's while-pull loop
    ("count.py", "                following = next(iterator, None)\n",
     "                following = next(iterator, None)\n                spare = next(iterator, None)\n", "SCX602"),
    # the gatherer keeping a ring frame on its instance (the loop is
    # reached through the _timed pass-through generator)
    ("metrics/gatherer.py", "            processed += frame.n_records\n",
     "            processed += frame.n_records\n            self.last = frame\n", "SCX601"),
    # the serve packer's pack without its copy
    ("serve/packer.py", "                    frame = copy_frame(frame)\n",
     "                    self.held.append(frame)\n", "SCX601"),
])
def test_life_pass_catches_faults_seeded_in_the_ports_consumers(tmp_path, name, old, new, rule):
    path = seeded_copy(tmp_path, name, old, new)
    assert {f.rule for f in check_life([path])} == {rule}


def test_life_pass_follows_pass_through_generators(tmp_path):
    src = (
        "from sctools_tpu_torch import ingest\n\n\n"
        "def timed(frames):\n"
        "    for frame in frames:\n"
        "        yield frame\n\n\n"
        "class Sink:\n"
        "    def consume(self, bam):\n"
        "        for frame in timed(ingest.ring_frames(bam, 4096)):\n"
        "            self.last = frame  # <- SCX601\n"
        "            self.kept = frame.clone()\n"
    )
    path = tmp_path / "sink.py"
    path.write_text(src)
    assert rule_lines(check_life([str(path)])) == [("SCX601", n) for n in marked_lines(src, "SCX601")]


def test_life_pass_follows_the_obs_generators_into_consumer_loops(tmp_path):
    """``obs.iter_spans`` and ``pulse.iter_decode`` hand ring frames on, so
    a consumer loop over either is a loop over the ring's frames."""
    src = (
        "from sctools_tpu_torch import ingest, obs\n"
        "from sctools_tpu_torch.obs import pulse\n\n\n"
        "class Sink:\n"
        "    def spans(self, bam):\n"
        "        for frame in obs.iter_spans('decode', ingest.ring_frames(bam, 4096)):\n"
        "            self.last = frame  # <- SCX601\n\n"
        "    def notes(self, bam):\n"
        "        frames = pulse.iter_decode(ingest.ring_frames(bam, 4096))\n"
        "        for frame in frames:\n"
        "            self.last = frame  # <- SCX601\n"
        "            self.kept = frame.clone()\n"
    )
    path = tmp_path / "sink.py"
    path.write_text(src)
    found = [f for f in check_life([str(PORT), str(path)]) if Path(f.path).name == "sink.py"]
    assert rule_lines(found) == [("SCX601", n) for n in marked_lines(src, "SCX601")]


# -------------------------------------------------------- the lock witness

@pytest.fixture
def lock_debug(monkeypatch, tmp_path):
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SCTOOLS_TPU_LOCK_DEBUG", "1")
    witness.reset()
    jax_witness.reset()
    yield
    witness.reset()
    jax_witness.reset()


def test_witness_off_is_a_true_noop(monkeypatch):
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv("SCTOOLS_TPU_LOCK_DEBUG", raising=False)
        else:
            monkeypatch.setenv("SCTOOLS_TPU_LOCK_DEBUG", value)
        lock = witness.make_lock("test.noop")
        rlock = witness.make_rlock("test.noop_r")
        assert type(lock) is type(threading.Lock()), type(lock)
        assert type(rlock) is type(threading.RLock()), type(rlock)
        assert not isinstance(lock, witness.WitnessLock)


def test_witness_records_order_edges(lock_debug):
    a = witness.make_lock("test.a")
    b = witness.make_lock("test.b")
    assert isinstance(a, witness.WitnessLock)
    with a:
        with b:
            pass
    edges = witness.observed_edges()
    assert ("test.a", "test.b") in edges
    assert edges[("test.a", "test.b")]["count"] == 1
    assert witness.acquire_counts() == {"test.a": 1, "test.b": 1}
    assert witness.violations() == []


def test_witness_cross_thread_release_leaves_no_stale_entry(lock_debug):
    handoff = witness.make_lock("test.handoff")
    victim = witness.make_lock("test.handoff_victim")
    acquired = threading.Event()
    released = threading.Event()

    def worker():
        handoff.acquire()
        acquired.set()
        released.wait(timeout=5)
        with victim:  # after the handoff: this thread holds nothing
            pass

    thread = threading.Thread(target=worker)
    thread.start()
    assert acquired.wait(timeout=5)
    handoff.release()  # cross-thread release on the main thread
    released.set()
    thread.join(timeout=5)
    assert ("test.handoff", "test.handoff_victim") not in witness.observed_edges()
    assert witness.violations() == []


def test_witness_detects_constructed_abba_cycle(lock_debug, monkeypatch, tmp_path):
    # a cycle writes a flight record at once, as JAX's witness does; the
    # locks dump waits for the exit (or an explicit dump)
    monkeypatch.setenv("SCTOOLS_TPU_TRACE", str(tmp_path / "trace"))
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w/0")
    (tmp_path / "trace").mkdir()
    a = witness.make_lock("test.cycle_a")
    b = witness.make_lock("test.cycle_b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert "cycle" in [v["kind"] for v in witness.violations()], witness.violations()
    with open(tmp_path / "trace" / "flight.w_0.jsonl") as f:
        meta = json.loads(f.readline())
    assert meta["meta"] == "flight" and meta["reason"] == "lock-witness:cycle"
    assert witness.dump() == str(tmp_path / "trace" / "locks.w_0.json")
    dumped = json.loads((tmp_path / "trace" / "locks.w_0.json").read_text())
    assert [v["kind"] for v in dumped["violations"]] == ["cycle"]


def test_witness_flags_edges_unknown_to_the_static_graph(lock_debug, tmp_path, monkeypatch):
    graph_path = tmp_path / "graph.json"
    graph_path.write_text(json.dumps({"edges": [{"from": "test.g_a", "to": "test.g_b"}]}))
    monkeypatch.setenv("SCTOOLS_TPU_LOCK_GRAPH", str(graph_path))
    a = witness.make_lock("test.g_a")
    b = witness.make_lock("test.g_b")
    c = witness.make_lock("test.g_c")
    with a:
        with b:  # known edge: no violation
            pass
    assert witness.violations() == []
    with a:
        with c:  # edge absent from the static model
            pass
    assert [v["kind"] for v in witness.violations()] == ["unknown-edge"]


def test_witness_bounded_acquire_is_exempt_from_order_checks(lock_debug, tmp_path, monkeypatch):
    graph_path = tmp_path / "graph.json"
    graph_path.write_text(json.dumps({"edges": []}))
    monkeypatch.setenv("SCTOOLS_TPU_LOCK_GRAPH", str(graph_path))
    a = witness.make_lock("test.bnd_a")
    b = witness.make_lock("test.bnd_b")
    with a:
        assert b.acquire(timeout=0.5)
        b.release()
    with b:
        assert a.acquire(timeout=0.5)  # would close a cycle if counted
        a.release()
    assert witness.violations() == []
    edges = witness.observed_edges()
    assert edges[("test.bnd_a", "test.bnd_b")]["bounded"] is True
    assert edges[("test.bnd_b", "test.bnd_a")]["bounded"] is True
    with a:  # first blocking observation: it faces the skipped checks
        with b:
            pass
    assert [v["kind"] for v in witness.violations()] == ["unknown-edge"]


def test_witness_rlock_reentry_is_not_an_edge(lock_debug):
    r = witness.make_rlock("test.reentrant")
    with r:
        with r:
            pass
    assert witness.observed_edges() == {}
    assert witness.acquire_counts() == {"test.reentrant": 2}


def test_witness_stall_records_violation_then_acquires(lock_debug, monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_LOCK_DEBUG_STALL_S", "0.05")
    lock = witness.make_lock("test.stall")
    release = threading.Event()

    def holder():
        lock.acquire()
        release.wait(timeout=10.0)
        lock.release()

    thread = threading.Thread(target=holder, daemon=True)
    thread.start()
    timer = threading.Timer(0.3, release.set)
    timer.start()
    try:
        assert lock.acquire() is True  # blocks past the 0.05 s threshold
        lock.release()
    finally:
        release.set()
        thread.join(timeout=10.0)
        timer.cancel()
    assert "stall" in [v["kind"] for v in witness.violations()], witness.violations()


def test_witness_dump_roundtrip(lock_debug, tmp_path):
    a = witness.make_lock("test.dump_a")
    b = witness.make_lock("test.dump_b")
    with a:
        with b:
            pass
    target = tmp_path / "locks.json"
    assert witness.dump(str(target)) == str(target)
    data = json.loads(target.read_text())
    assert data["enabled"] is True
    assert {(e["from"], e["to"]) for e in data["edges"]} == {("test.dump_a", "test.dump_b")}
    assert data["violations"] == []
    assert data["acquires"] == {"test.dump_a": 1, "test.dump_b": 1}


def test_witness_dumps_to_the_trace_directory(lock_debug, monkeypatch, tmp_path):
    assert witness.dump() is None  # no SCTOOLS_TPU_TRACE: nowhere to write
    monkeypatch.setenv("SCTOOLS_TPU_TRACE", str(tmp_path))
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "proc0-of-2")
    with witness.make_lock("test.trace"):
        pass
    assert witness.dump() == str(tmp_path / "locks.proc0-of-2.json")


@pytest.mark.parametrize("writer,reader", [(witness, jax_witness), (jax_witness, witness)],
                         ids=["port_dump_read_by_jax", "jax_dump_read_by_port"])
def test_witness_dumps_are_read_by_the_other_package(lock_debug, monkeypatch, tmp_path, writer, reader):
    # the same operations give the same snapshot in both packages
    for module in (writer, reader):
        a, b = module.make_lock("test.x_a"), module.make_lock("test.x_b")
        with a:
            with b:
                pass
    assert writer.snapshot() == reader.snapshot()
    # the writer's dump is the reader's static graph: the known edge
    # passes, a new one is flagged
    dumped = tmp_path / "locks.json"
    assert writer.dump(str(dumped)) == str(dumped)
    reader.reset()
    monkeypatch.setenv("SCTOOLS_TPU_LOCK_GRAPH", str(dumped))
    a, b, c = (reader.make_lock(f"test.x_{n}") for n in "abc")
    with a:
        with b:
            pass
    assert reader.violations() == []
    with b:
        with c:
            pass
    assert [(v["kind"], v["edge"], v["graph"]) for v in reader.violations()] == [
        ("unknown-edge", ["test.x_b", "test.x_c"], str(dumped))]


def test_the_six_lock_sites_are_raw_with_the_witness_off(monkeypatch, tmp_path):
    from sctools_tpu_torch import kernels, native
    from sctools_tpu_torch.ingest import framedebug
    from sctools_tpu_torch.ops import whitelist
    from sctools_tpu_torch.sched import faults
    from sctools_tpu_torch.sched.journal import Journal

    raw = type(threading.Lock())
    for lock in (kernels._lock, native._lock, framedebug._lock, whitelist._table_lock, faults._lock):
        assert type(lock) is raw
    monkeypatch.delenv("SCTOOLS_TPU_LOCK_DEBUG", raising=False)
    assert type(Journal(str(tmp_path / "journal"), worker_id="w")._lock) is raw


def test_the_journal_lock_is_witnessed_under_its_name(lock_debug, tmp_path):
    from sctools_tpu_torch.sched.journal import Journal

    journal = Journal(str(tmp_path / "journal"), worker_id="w")
    assert isinstance(journal._lock, witness.WitnessLock)
    assert journal._lock.name == "sched.journal"


# ---------------------------------------------------------------- the CLI

def write_bad_corpus(root: Path) -> Path:
    """One seeded fault a pass: a wall-clock duration, a raw upload, an
    ABBA pair, a frame carried past next(), and a dropped argtype."""
    corpus = root / "corpus"
    (corpus / "native").mkdir(parents=True)
    (corpus / "timing.py").write_text(
        "import time\n\n\ndef elapsed(fn):\n    start = time.time()\n    fn()\n"
        "    return time.time() - start\n")
    (corpus / "staging.py").write_text(SCX112_BAD)
    (corpus / "locks.py").write_text((FIXTURES / "racecheck" / "scx401_bad.py").read_text())
    (corpus / "carry.py").write_text(
        "from sctools_tpu_torch import ingest\n\n\n"
        "def consume(bam, use):\n"
        "    it = iter(ingest.ring_frames(bam, 4096))\n"
        "    frame = next(it, None)\n"
        "    carry = None\n"
        "    while frame is not None:\n"
        "        following = next(it, None)\n"
        "        use(carry, frame)\n"
        "        carry = frame\n"
        "        frame = following\n")
    (corpus / "native" / "fake.cpp").write_text(
        'extern "C" {\nlong scx_next(void* h, long n) { return n; }\n}\n')
    (corpus / "native" / "__init__.py").write_text(
        "import ctypes\n\n\ndef bind(lib):\n"
        '    signatures = {"scx_next": (ctypes.c_long, [ctypes.c_void_p])}\n'
        "    return signatures\n")
    return corpus


def test_cli_module_invocation_on_a_bad_corpus(tmp_path):
    corpus = write_bad_corpus(tmp_path)
    env = dict(os.environ, SCTOOLS_TPU_SCX_CACHE="0")
    result = subprocess.run([sys.executable, "-m", "sctools_tpu_torch.analysis", str(corpus)],
                            cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert result.returncode == 1, result.stdout + result.stderr
    rules = {line.split()[1] for line in result.stdout.splitlines() if ": SCX" in line}
    assert rules == {"SCX109", "SCX112", "SCX203", "SCX401", "SCX602"}, result.stdout
    assert "passes: lint, abi, supp, race, shard, life, cost, mesh, aot;" in result.stdout


def test_cli_gate_is_clean_on_the_port_and_the_smoke(capsys):
    rc = cli_main([str(PORT), str(REPO / "chip_smoke.py")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 finding(s)" in out and "passes: lint, abi, supp, race, shard, life, cost, mesh, aot;" in out


@pytest.mark.parametrize("flag,rules,passes", [
    ("--race-only", {"SCX401"}, "race"),
    ("--life-only", {"SCX602"}, "life"),
])
def test_cli_only_flags(tmp_path, capsys, flag, rules, passes):
    rc = cli_main([flag, str(write_bad_corpus(tmp_path))])
    out = capsys.readouterr().out
    assert rc == 1
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == rules
    assert f"passes: {passes}" in out


def test_cli_no_flags_skip_a_pass(tmp_path, capsys):
    rc = cli_main(["--no-race", "--no-life", str(write_bad_corpus(tmp_path))])
    out = capsys.readouterr().out
    assert rc == 1 and "passes: lint, abi" in out
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == {"SCX109", "SCX112", "SCX203"}


def test_cli_json(tmp_path, capsys):
    rc = cli_main(["--json", str(write_bad_corpus(tmp_path))])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["rule"] for f in payload["findings"]} == {"SCX109", "SCX112", "SCX203", "SCX401", "SCX602"}
    assert all(f["path"] and f["line"] > 0 and f["message"] for f in payload["findings"])
    rc = cli_main(["--json", "--race-only", str(PORT)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["findings"] == [] and payload["checked_files"] > 60


def test_cli_emit_lock_graph(tmp_path, capsys):
    target = tmp_path / "graph.json"
    assert cli_main(["--emit-lock-graph", str(target), str(PORT)]) == 0
    assert "wrote 17 lock(s), 8 order edge(s), 15 thread/signal entr(ies)" in capsys.readouterr().out
    graph = json.loads(target.read_text())
    assert set(graph["locks"]) == PORT_LOCKS and len(graph["edges"]) == 8 and len(graph["entries"]) == 15


def test_cli_missing_path_fails(tmp_path, capsys):
    assert cli_main([str(tmp_path / "nowhere")]) == 2


# ------------------------------------------------------- SCX113 and SCX114

def test_scx1001_floor_rebind_names_the_ports_retune(tmp_path):
    path = tmp_path / "floors.py"
    path.write_text("RECORD_BUCKET_MIN = 1024\n")
    (finding,) = lint_file(str(path))
    assert finding.rule == "SCX1001"
    assert ("(use `python -m sctools_tpu_torch.analysis --retune` offline, or the steering "
            "controller online)") in finding.message


@pytest.mark.parametrize("rule,kind", [("SCX113", "bad"), ("SCX113", "clean"),
                                       ("SCX114", "bad"), ("SCX114", "clean")])
def test_scx113_scx114_match_jax_on_its_fixtures(rule, kind):
    """JAX's findings of the rule, less its `jax.device_get` and
    `.copy_to_host_async` ones (constructs the port has no spelling of),
    with its messages but for the package the remedy names."""
    path = str(FIXTURES / "jaxlint" / f"{rule.lower()}_{kind}.py")
    want = [f for f in jax_jaxlint.lint_file(path)
            if f.rule == rule and "device_get" not in f.message and "copy_to_host" not in f.message]
    got = lint_file(path)
    assert rule_lines(got) == rule_lines(want)
    assert [f.message for f in got] == [
        f.message.replace("sctools_tpu.", "sctools_tpu_torch.") for f in want]
    assert len(want) == (3 if kind == "bad" else 0)


SCX113_BAD = '''"""SCX113 bad: broad handlers swallowing device-boundary failures."""
from sctools_tpu_torch import ingest as wire
from sctools_tpu_torch.ingest import upload
from sctools_tpu_torch.ops import whitelist
from sctools_tpu_torch.ops.counting import count_molecules
from sctools_tpu_torch.parallel.sort import distributed_sort


def stage_or_none(cols, device):
    try:
        return wire.upload(cols, device, site="fixture.stage")
    except Exception:  # <- SCX113
        return None


def stage_imported(cols, device):
    try:
        staged = upload(cols, device, "fixture.stage")
    except BaseException:  # <- SCX113
        staged = None
    return staged


def count_and_shrug(cols, segments):
    try:
        return count_molecules(cols, num_segments=segments)
    except BaseException:  # <- SCX113
        pass


def sort_with_bare_except(stacked, mesh):
    try:
        return distributed_sort(stacked, ["key"], mesh)
    except:  # noqa: E722  # <- SCX113
        return stacked


def correct_or_nothing(queries, table):
    try:
        return whitelist.correct_codes(queries, table)
    except (ValueError, Exception):  # <- SCX113
        return None


def replay_quietly(entry):
    try:
        entry.graph.replay()
    except Exception:  # <- SCX113
        pass


def run_graphs_quietly(graphs, cols):
    try:
        return graphs.run(cols, kind="cell")
    except Exception:  # <- SCX113
        return None
'''

SCX113_CLEAN = '''"""SCX113 clean: recovery through the guard, cleanup-then-raise, narrow
handlers, and broad handlers away from the boundary."""
from sctools_tpu_torch import guard, ingest


def staged(cols, device):
    return guard.retrying(lambda: ingest.upload(cols, device, site="fixture.stage"),
                          site="fixture.stage", leg="upload")


def dispatched(fn, frame):
    return guard.run_batch(fn, frame, site="fixture.dispatch")


def cleanup_then_reraise(cols, device, writer):
    try:
        return ingest.upload(cols, device, site="fixture.stage")
    except BaseException:
        writer.discard()
        raise


def narrow_handler(cols, device):
    try:
        staged = ingest.upload(cols, device, site="fixture.stage")
    except ValueError:
        staged = None
    return staged


def swallow_away_from_the_boundary(path):
    try:
        with open(path) as f:
            return f.read()
    except Exception:
        return None


def an_upload_of_another_module(client, blob):
    try:
        client.upload(blob)
    except Exception:
        return None


def a_run_of_no_graph(runner, cols):
    try:
        return runner.run(cols)
    except Exception:
        return None


def escaped(cols, device):
    try:
        return ingest.upload(cols, device, site="fixture.stage")
    except Exception:  # scx-lint: disable=SCX113 -- deliberate
        return None
'''

SCX114_BAD = '''"""SCX114 bad: device values pulled to the host outside the seam."""
import numpy as np
import torch

from sctools_tpu_torch import ingest
from sctools_tpu_torch.metrics.device import compact_results_wire, compute_entity_metrics
from sctools_tpu_torch.ops import whitelist
from sctools_tpu_torch.ops.counting import count_molecules


def pull_dispatch_result(cols, n):
    result = compute_entity_metrics(cols, num_segments=n, kind="cell")
    return np.asarray(result["n_reads"])  # <- SCX114


def pull_subscripted(cols, n):
    out = count_molecules(cols, num_segments=n)["is_molecule"]
    return np.array(out)  # <- SCX114


def pull_staged(cols, device):
    staged = ingest.upload(cols, device, site="fixture.pull")
    return staged.cpu()  # <- SCX114


def pull_alias(cols, n):
    result = compute_entity_metrics(cols, num_segments=n, kind="cell")
    copy = result
    return copy["n_reads"].numpy()  # <- SCX114


def pull_block(result, k):
    block = compact_results_wire(result, ["a"], ["b"], k)
    return block.tolist()  # <- SCX114


def pull_codes(queries, table):
    codes = whitelist.correct_codes(queries, table)
    first = codes.to("cpu")  # <- SCX114
    second = codes.to(device=torch.device("cpu"))  # <- SCX114
    hits = codes.ge(0).sum().item()  # <- SCX114
    return first, second, hits
'''

SCX114_CLEAN = '''"""SCX114 clean: pulls through the seam, Pulled handles, host values."""
import numpy as np

from sctools_tpu_torch import ingest
from sctools_tpu_torch.metrics.device import compute_entity_metrics


def pull_result(cols, n):
    result = compute_entity_metrics(cols, num_segments=n, kind="cell")
    pulled = ingest.pull(result["n_reads"], site="fixture.pull")
    return pulled.numpy(), np.asarray(pulled.numpy())


def pull_ring(block):
    ring = ingest.WritebackRing(name="fixture")
    staged = ring.stage(block)
    host = ring.collect(staged, site="fixture.writeback")
    ring.close()
    return host.numpy().tolist()


def host_side(records, tensor):
    padded = np.asarray(records, dtype=np.int32)
    return np.array([padded.size]), tensor.cpu().numpy(), tensor.item()


def kept_on_the_device(cols, n):
    result = compute_entity_metrics(cols, num_segments=n, kind="cell")
    return result["n_reads"].float().mean()


def pull_escaped(cols, n):
    result = compute_entity_metrics(cols, num_segments=n, kind="cell")
    return np.asarray(result["n_reads"])  # scx-lint: disable=SCX114 -- deliberate
'''


@pytest.mark.parametrize("rule,bad,clean", [("SCX113", SCX113_BAD, SCX113_CLEAN),
                                            ("SCX114", SCX114_BAD, SCX114_CLEAN)],
                         ids=["SCX113", "SCX114"])
def test_scx113_scx114_torch_twins(tmp_path, rule, bad, clean):
    (tmp_path / "bad.py").write_text(bad)
    (tmp_path / "clean.py").write_text(clean)
    # `.to("cpu")` is a crossing SCX112 flags too
    got = [f for f in lint_file(str(tmp_path / "bad.py")) if f.rule == rule]
    assert rule_lines(got) == [(rule, n) for n in marked_lines(bad, rule)]
    remedy = ("sctools_tpu_torch.guard.run_batch / guard.retrying" if rule == "SCX113"
              else "sctools_tpu_torch.ingest.pull(value, site=...)")
    assert all(remedy in f.message for f in got)
    assert lint_file(str(tmp_path / "clean.py")) == []


@pytest.mark.parametrize("rule,where,owned", [
    ("SCX113", "guard/recover.py", True),
    ("SCX113", "guard/sub/recover.py", False),  # only the immediate parent owns
    ("SCX113", "ingest/recover.py", False),
    ("SCX114", "ingest/wire.py", True),
    ("SCX114", "parallel/collective.py", True),
    ("SCX114", "ingest/sub/wire.py", False),
    ("SCX114", "guard/wire.py", False),
])
def test_scx113_scx114_owners(tmp_path, rule, where, owned):
    path = tmp_path / where
    path.parent.mkdir(parents=True)
    path.write_text(SCX113_BAD if rule == "SCX113" else SCX114_BAD)
    assert (rule not in {f.rule for f in lint_file(str(path))}) == owned


def test_scx113_scx114_port_tree_and_smoke_are_clean():
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    findings = [f for path in paths for f in lint_file(str(path)) if f.rule in ("SCX113", "SCX114")]
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("name,old,new,rule", [
    # the gatherer's engine dispatch, its failure swallowed
    ("metrics/gatherer.py",
     "                result = device_engine.compute_entity_metrics(staged, **kwargs)\n",
     "                try:\n"
     "                    result = device_engine.compute_entity_metrics(staged, **kwargs)\n"
     "                except Exception:\n                    result = None\n", "SCX113"),
    # the count's dispatch, pulled bare
    ("count.py", "out = count_molecules(dict(zip(UPLOAD_COLUMNS, staged)), num_segments=block.shape[1])",
     "out = count_molecules(dict(zip(UPLOAD_COLUMNS, staged)), num_segments=block.shape[1])"
     "; out['n'].cpu()", "SCX114"),
])
def test_scx113_scx114_catch_faults_seeded_in_the_port(tmp_path, name, old, new, rule):
    text = (PORT / name).read_text()
    assert text.count(old) == 1, f"{name} changed: {old!r}"
    path = tmp_path / Path(name).name
    path.write_text(text.replace(old, new))
    assert [f.rule for f in lint_file(str(path))] == [rule]


def write_supp_corpus(root: Path) -> Path:
    """The bad corpus with a tsan.supp holding a stale entry and one that
    suppresses our own library."""
    corpus = write_bad_corpus(root)
    (corpus / "native" / "tsan.supp").write_text(
        "# a stale entry, then our own library\nrace:scx_gone\n"
        "called_from_lib:libsctools_native.tsan.so\n")
    return corpus


def test_cli_list_rules_is_the_union_of_the_pass_tables(capsys):
    from sctools_tpu.analysis.cli import main as jax_cli_main
    from sctools_tpu_torch.analysis import (
        ABI_RULES, AOT_RULES, COST_RULES, LIFE_RULES, MESH_RULES, RACE_RULES, SHARD_RULES,
        SUPP_RULES, TORCH_RULES,
    )

    assert cli_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    union = {}
    for table in (TORCH_RULES, ABI_RULES, SUPP_RULES, RACE_RULES, SHARD_RULES, LIFE_RULES,
                  COST_RULES, MESH_RULES, AOT_RULES):
        union.update(table)
    assert dict(line.split() for line in lines if line.startswith("    SCX")) == union
    assert len(lines) == 1 + 9 + len(union)
    # JAX's format: a heading, then each section's title and its sorted rules
    assert jax_cli_main(["--list-rules"]) == 0
    jax_lines = capsys.readouterr().out.splitlines()

    def sections(text_lines):
        return [line.strip() for line in text_lines if line.startswith("  ") and not
                line.startswith("    ")]

    assert sections(lines)[1:] == sections(jax_lines)[1:]
    assert sections(lines)[0] == "PyTorch/CUDA lint:" and sections(jax_lines)[0] == "JAX/TPU lint:"
    assert {line.split()[0] for line in jax_lines if line.startswith("    SCX")} - set(union) == {
        "SCX101", "SCX102", "SCX103", "SCX104", "SCX105", "SCX106", "SCX107", "SCX108",
        "SCX110", "SCX111"}


@pytest.mark.parametrize("flags,rules,passes", [
    ([], {"SCX109", "SCX112", "SCX203", "SCX302", "SCX303", "SCX401", "SCX602"},
     "lint, abi, supp, race, shard, life, cost, mesh, aot"),
    (["--no-lint"], {"SCX203", "SCX302", "SCX303", "SCX401", "SCX602"},
     "abi, supp, race, shard, life, cost, mesh, aot"),
    (["--no-abi"], {"SCX109", "SCX112", "SCX302", "SCX303", "SCX401", "SCX602"},
     "lint, supp, race, shard, life, cost, mesh, aot"),
    (["--no-supp"], {"SCX109", "SCX112", "SCX203", "SCX401", "SCX602"},
     "lint, abi, race, shard, life, cost, mesh, aot"),
    (["--no-lint", "--no-abi", "--no-supp", "--no-race"], {"SCX602"},
     "shard, life, cost, mesh, aot"),
    (["--race-only"], {"SCX401"}, "race"),  # an -only flag turns lint, ABI and supp off
])
def test_cli_no_lint_abi_supp(tmp_path, capsys, flags, rules, passes):
    rc = cli_main([*flags, str(write_supp_corpus(tmp_path))])
    out = capsys.readouterr().out
    assert rc == 1
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == rules
    assert f"passes: {passes};" in out


def test_cli_quiet_prints_the_findings_only(tmp_path, capsys):
    corpus = write_supp_corpus(tmp_path)
    assert cli_main(["-q", str(corpus)]) == 1
    out = capsys.readouterr().out
    assert out.strip() and all(": SCX" in line for line in out.splitlines())
    assert cli_main(["--quiet", str(PORT)]) == 0
    assert capsys.readouterr().out == ""
    # the emit lines and the skipped-native note are silenced too
    assert cli_main(["-q", "--emit-lock-graph", str(tmp_path / "g.json"), str(PORT)]) == 0
    assert (tmp_path / "g.json").exists() and capsys.readouterr().out == ""
    (tmp_path / "plain").mkdir()
    (tmp_path / "plain" / "a.py").write_text("x = 1\n")
    assert cli_main([str(tmp_path / "plain")]) == 0
    assert "ABI + suppression passes skipped" in capsys.readouterr().err
    assert cli_main(["-q", str(tmp_path / "plain")]) == 0
    assert tuple(capsys.readouterr()) == ("", "")


@pytest.mark.parametrize("flags", [["--no-abi"], ["--no-supp"], ["--no-abi", "--no-supp", "--no-race"],
                                   ["--mesh-only"], ["--no-race", "--no-shard", "--no-life"]])
def test_cli_flags_behave_as_jaxs(tmp_path, capsys, flags):
    """The JAX CLI with the same flags over the same corpus runs the same
    passes (its summary's names, its lint's aside) to the same exit, and
    prints as much under -q."""
    from sctools_tpu.analysis.cli import main as jax_cli_main

    corpus = str(write_supp_corpus(tmp_path))

    def passes(out):
        return out.rsplit("passes: ", 1)[1].split(";")[0].strip()

    rc = cli_main([*flags, "--no-lint", corpus])
    ours = passes(capsys.readouterr().out)
    jax_rc = jax_cli_main([*flags, "--no-jax-lint", corpus])
    assert ours == passes(capsys.readouterr().out) and rc == jax_rc
    assert cli_main([*flags, "-q", "--no-lint", corpus]) == rc
    quiet = capsys.readouterr()
    assert jax_cli_main([*flags, "-q", "--no-jax-lint", corpus]) == rc
    jax_quiet = capsys.readouterr()
    assert "finding(s)" not in quiet.out and "finding(s)" not in jax_quiet.out
    assert quiet.err == jax_quiet.err == ""
