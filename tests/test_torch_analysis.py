"""The port's static checks (``sctools_tpu_torch.analysis``) against JAX's.

- Parity: on the JAX package's fixture corpus (race, life, ABI and SCX109),
  each port pass reports exactly the (rule, line) set of its JAX pass, and
  the two race passes emit the same lock graph over the port's tree.
- Port-only: SCX112 on its fixtures and owners; the ABI pass on corrupted
  copies of the port's ``signatures`` table; seeded faults in copies of
  the port's own consumers; every pass clean on the port's tree, with the
  one suppression (``sched/journal.py``'s SCX109) doing its job.
- The runtime lock witness: the JAX package's witness cases on the port's
  witness, the six named lock sites, and each package reading the other's
  dump as its static graph.
- The CLI: module invocation, ``--race-only``, ``--life-only``, ``--json``
  and ``--emit-lock-graph`` on the clean tree and on a seeded bad corpus.

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
              "sched.journal", "ingest.framedebug"}


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
    assert graph["edges"] == []
    entries = {(e["kind"], Path(e["site"].rsplit(":", 1)[0]).relative_to(PORT).as_posix())
               for e in graph["entries"]}
    assert entries == {("thread", "sched/scheduler.py"), ("thread", "serve/engine.py"),
                       ("thread", "utils/prefetch.py")}


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
    return ingest.upload(array, device)


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
    # a cycle writes the dump at once (the port has no flight recorder)
    monkeypatch.setenv("SCTOOLS_TPU_TRACE", str(tmp_path / "trace"))
    monkeypatch.setenv("SCTOOLS_TPU_TRACE_WORKER", "w/0")
    a = witness.make_lock("test.cycle_a")
    b = witness.make_lock("test.cycle_b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert "cycle" in [v["kind"] for v in witness.violations()], witness.violations()
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
    assert "passes: lint, abi, race, life" in result.stdout


def test_cli_gate_is_clean_on_the_port_and_the_smoke(capsys):
    rc = cli_main([str(PORT), str(REPO / "chip_smoke.py")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 finding(s)" in out and "passes: lint, abi, race, life" in out


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
    assert "wrote 6 lock(s), 0 order edge(s), 3 thread/signal entr(ies)" in capsys.readouterr().out
    graph = json.loads(target.read_text())
    assert set(graph["locks"]) == PORT_LOCKS and graph["edges"] == [] and len(graph["entries"]) == 3


def test_cli_missing_path_fails(tmp_path, capsys):
    assert cli_main([str(tmp_path / "nowhere")]) == 2
