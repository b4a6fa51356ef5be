"""The port's device -> host door (``sctools_tpu_torch.ingest.wire``) on the CPU.

The port's cases of ``test_ingest.py``'s wire section (:794-1021), under
JAX's names: ``pull`` records the ledger and returns the host value (for a
tensor and for a structure of them), a pull's ledger entry carries no
seconds (JAX's timed pulls, a measuring mode for its benchmark, are not
ported: no port path measures with them), a transient at the wait copies again in place, the ``WritebackRing``'s flight
section and FIFO drain, the ``SCTOOLS_TPU_WIRE_OVERLAP`` knob, the
overlapped and blocking drains' equal CSVs, a SIGTERM while the ring holds
staged blocks, and the pull's deadline leg. JAX's API returns ``(host,
bytes)`` from ``pull``; the port's returns a ``Pulled`` handle whose
``numpy()`` is the guarded wait, so the cases read it there. The wire's
counters are compared with JAX's in ``test_torch_obs.py``
(``test_command_telemetry_matches_jax``), and the guarded-stall SIGTERM case
of ``test_sched.py`` is ``test_torch_sched.py``'s, under its own name.
"""

from __future__ import annotations

import gzip
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import write_bam
from sctools_tpu_torch import guard, ingest, obs
from sctools_tpu_torch.ingest import wire
from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics
from sctools_tpu_torch.obs import pulse, xprof
from sctools_tpu_torch.sched import faults
from test_metrics import random_tagged_records

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture
def recording():
    obs.reset()
    obs.enable()
    xprof.reset()
    try:
        yield obs
    finally:
        obs.disable()
        obs.reset()
        xprof.reset()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure("")
    yield
    faults.reset()


@pytest.fixture(scope="module")
def sorted_bam(tmp_path_factory):
    from sctools_tpu_torch.bam import sort_by_tags_and_queryname

    records, header = random_tagged_records(seed=3)
    path = str(tmp_path_factory.mktemp("torch_wire") / "sorted.bam")
    write_bam(path, list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])), header)
    return path


def test_pull_records_ledger_and_returns_host(recording):
    buf = np.arange(1 << 12, dtype=np.int32)
    device = ingest.upload(buf, CPU, site="test.wire")
    pulled = ingest.pull(device, site="test.wire_pull")
    host = pulled.numpy()
    assert isinstance(host, np.ndarray) and np.array_equal(host, buf)
    assert pulled.nbytes == buf.nbytes
    entry = xprof.ledger_totals()["d2h"]["by_site"]["test.wire_pull"]
    assert entry["bytes"] == buf.nbytes and entry["events"] == 1
    assert entry["seconds"] == 0.0  # hot-path pulls record no seconds


def test_pull_tree_and_wasted_accounting(recording):
    device = {"a": ingest.upload(np.zeros(64, np.int32), CPU, site="test.wire"),
              "b": ingest.upload(np.ones(32, np.float32), CPU, site="test.wire")}
    pulled = ingest.pull(device, site="test.wire_tree", wasted=128)
    host = pulled.numpy()
    assert set(host) == {"a", "b"} and host["b"].dtype == np.float32
    assert pulled.nbytes == 64 * 4 + 32 * 4
    entry = xprof.ledger_totals()["d2h"]["by_site"]["test.wire_tree"]
    assert entry["wasted"] == 128
    xprof.record_transfer_waste("d2h", "test.wire_tree", 64)
    entry = xprof.ledger_totals()["d2h"]["by_site"]["test.wire_tree"]
    assert entry["wasted"] == 192 and entry["events"] == 1
    pair = ingest.pull([device["a"], (device["b"],)], site="test.wire_list").numpy()
    assert isinstance(pair, list) and isinstance(pair[1], tuple) and pair[1][0].shape == (32,)


def test_pull_and_collect_record_no_seconds(recording):
    """A pull's wait includes the computation, so neither the pull nor the
    ring's drain puts seconds in the ledger: only bytes and events."""
    device = ingest.upload(np.zeros(1 << 16, np.int32), CPU, site="test.wire")
    assert ingest.pull(device, site="test.wire_untimed").numpy().shape == (1 << 16,)
    ring = ingest.WritebackRing(name="test", slots=2)
    try:
        host, nbytes = ring.collect(ring.stage(device), site="test.wire_ring_untimed")
    finally:
        ring.close()
    assert nbytes == host.nbytes == 1 << 18
    by_site = xprof.ledger_totals()["d2h"]["by_site"]
    for site in ("test.wire_untimed", "test.wire_ring_untimed"):
        assert by_site[site]["seconds"] == 0 and by_site[site]["bytes"] == 1 << 18
        assert by_site[site]["events"] == 1


def test_pull_retries_transient_in_place(recording, monkeypatch):
    """A transient at the wait copies the device-resident value again."""
    calls = {"n": 0}
    real_land = wire._land

    def flaky_land(copies):
        calls["n"] += 1
        if calls["n"] == 1:
            raise guard.Transient("d2h blip")
        return real_land(copies)

    monkeypatch.setattr(wire, "_land", flaky_land)
    device = ingest.upload(np.arange(16, dtype=np.int32), CPU, site="test.wire")
    assert np.array_equal(ingest.pull(device, site="test.wire_retry").numpy(), np.arange(16))
    assert calls["n"] == 2
    assert obs.counters()["guard_retries_test_wire_retry"] == 1


def test_pull_fault_at_the_wait_is_the_pull_sites(recording):
    faults.configure("xla_transient@test.wire_fault:times=2")
    device = ingest.upload(np.arange(8, dtype=np.int32), CPU, site="test.wire")
    pulled = ingest.pull(device, site="test.wire_fault")
    assert obs.counters().get("sched_fault_xla_transient") is None  # nothing waited yet
    assert np.array_equal(pulled.numpy(), np.arange(8))
    assert obs.counters()["guard_transient_retries"] == 2
    pulled.numpy()  # landed once: the second read waits for nothing
    assert obs.counters()["sched_fault_xla_transient"] == 2


def test_writeback_ring_flight_section_and_fifo(recording):
    ring = ingest.WritebackRing(name="test", slots=3)
    try:
        device = ingest.upload(np.arange(8, dtype=np.int32), CPU, site="t")
        staged = ring.stage(device)
        entries = [e for e in wire._wire_snapshot() if e["name"] == "test"]
        assert entries and entries[-1]["staged"] == 1 and entries[-1]["inflight"] == [0]
        assert ring.phase_code() == pulse.WB_PHASES["copying"]
        second = ring.stage(device + 1)
        host, nbytes = ring.collect(staged, site="test.wire_ring")
        assert np.array_equal(host, np.arange(8)) and nbytes == 32
        entries = [e for e in wire._wire_snapshot() if e["name"] == "test"]
        assert entries[-1]["drained"] == 1 and entries[-1]["inflight"] == [1]
        host, _ = ring.collect(second, site="test.wire_ring")
        assert np.array_equal(host, np.arange(8) + 1)
        entries = [e for e in wire._wire_snapshot() if e["name"] == "test"]
        assert entries[-1]["inflight"] == [] and entries[-1]["phase"] == "idle"
        assert obs.counters()["wire_writeback_staged"] == obs.counters()["wire_writeback_drained"] == 2
        assert xprof.ledger_totals()["d2h"]["by_site"]["test.wire_ring"]["bytes"] == 64
    finally:
        ring.close()
    assert [e for e in wire._wire_snapshot() if e["name"] == "test"] == []


def test_wire_overlap_env_knob(monkeypatch):
    monkeypatch.delenv("SCTOOLS_TPU_WIRE_OVERLAP", raising=False)
    assert ingest.wire_overlap_enabled()
    monkeypatch.setenv("SCTOOLS_TPU_WIRE_OVERLAP", "0")
    assert not ingest.wire_overlap_enabled()
    ring = ingest.WritebackRing(name="blocking", slots=2)
    try:
        staged = ring.stage(torch.arange(4))
        assert ring.phase_code() == pulse.WB_PHASES["staged"]
        assert staged._copies is None  # nothing queued: collect makes the copy
        assert np.array_equal(ring.collect(staged, site="test.blocking")[0], np.arange(4))
    finally:
        ring.close()


def test_overlapped_vs_blocking_writeback_byte_identity(sorted_bam, tmp_path, monkeypatch):
    monkeypatch.delenv("SCTOOLS_TPU_WIRE_OVERLAP", raising=False)
    GatherCellMetrics(sorted_bam, str(tmp_path / "overlapped"), batch_records=32, device="cpu").extract_metrics()
    monkeypatch.setenv("SCTOOLS_TPU_WIRE_OVERLAP", "0")
    GatherCellMetrics(sorted_bam, str(tmp_path / "blocking"), batch_records=32, device="cpu").extract_metrics()
    with gzip.open(tmp_path / "overlapped.csv.gz", "rb") as f:
        overlapped = f.read()
    with gzip.open(tmp_path / "blocking.csv.gz", "rb") as f:
        assert overlapped == f.read()


_GATHER = r"""
import sys
from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics
GatherCellMetrics(sys.argv[1], sys.argv[2], batch_records=int(sys.argv[3]), device="cpu").extract_metrics()
"""


def test_sigterm_mid_writeback_ring_flight_then_recovery(tmp_path, sorted_bam):
    """SIGTERM while the writeback ring holds staged blocks (the first drain
    stalled at the pull site): the flight record's ``writeback_slots`` names
    the batches in flight, no CSV is published, and a clean rerun equals an
    in-process run."""
    trace_dir = tmp_path / "trace"
    stem = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SCTOOLS_TPU_")}
    env.update(PYTHONPATH=os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]),
               SCTOOLS_TPU_TRACE=str(trace_dir), SCTOOLS_TPU_TRACE_WORKER="w0",
               SCTOOLS_TPU_FAULTS="stall@gatherer.writeback:secs=600")
    proc = subprocess.Popen([sys.executable, "-c", _GATHER, sorted_bam, stem, "16"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        trace_file = trace_dir / "trace.w0.jsonl"
        deadline = time.time() + 120
        computes = 0
        while time.time() < deadline and computes < 3:
            if trace_file.exists():
                computes = trace_file.read_text().count('"compute"')
            time.sleep(0.2)
        assert computes >= 3, "the worker never filled the writeback pipeline"
        time.sleep(1.5)  # let the first drain enter the injected stall
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0, out
    flight = trace_dir / "flight.w0.jsonl"
    assert flight.exists(), "SIGTERM must leave a flight record"
    sections = json.loads(flight.read_text().splitlines()[0]).get("sections") or {}
    ring = (sections.get("writeback_slots") or [])[-1]
    assert ring["staged"] >= 1 and ring["staged"] > ring["drained"] and ring["inflight"], ring
    assert not os.path.exists(stem + ".csv.gz")

    env.pop("SCTOOLS_TPU_FAULTS")
    env["SCTOOLS_TPU_TRACE_WORKER"] = "w1"
    done = subprocess.run([sys.executable, "-c", _GATHER, sorted_bam, stem, "16"],
                          capture_output=True, text=True, env=env, timeout=180)
    assert done.returncode == 0, done.stdout + done.stderr
    clean = str(tmp_path / "clean")
    GatherCellMetrics(sorted_bam, clean, batch_records=16, device="cpu").extract_metrics()
    with gzip.open(stem + ".csv.gz", "rb") as f:
        got = f.read()
    with gzip.open(clean + ".csv.gz", "rb") as f:
        assert got == f.read()


def test_pull_leg_falls_back_to_compute_deadline(monkeypatch):
    """With the pull leg unset the wait rides the compute leg's deadline (a
    deployment that sets only that one keeps a wedged copy covered); with
    it set, the pull leg's."""
    captured = {}
    real_retrying = guard.retrying

    def spying_retrying(fn, **kwargs):
        captured["leg"] = kwargs.get("leg")
        return real_retrying(fn, **kwargs)

    monkeypatch.setattr(wire.guard, "retrying", spying_retrying)
    monkeypatch.delenv("SCTOOLS_TPU_GUARD_TIMEOUT_PULL", raising=False)
    wire.pull(torch.zeros(4, dtype=torch.int32), site="test.leg").numpy()
    assert captured["leg"] == "compute"
    monkeypatch.setenv("SCTOOLS_TPU_GUARD_TIMEOUT_PULL", "30")
    wire.pull(torch.zeros(4, dtype=torch.int32), site="test.leg").numpy()
    assert captured["leg"] == "pull"


def test_upload_retries_on_the_upload_leg(recording, monkeypatch):
    """``ingest.upload`` runs under the guard's transient ladder on the
    upload leg (JAX ingest/__init__.py:127), its ledger written once."""
    captured = {}
    real_retrying = guard.retrying

    def spying_retrying(fn, **kwargs):
        captured.update(kwargs)
        return real_retrying(fn, **kwargs)

    monkeypatch.setattr(ingest.guard, "retrying", spying_retrying)
    faults.configure("xla_transient@test.up:times=1")
    staged = ingest.upload(np.arange(6, dtype=np.int64), CPU, site="test.up")
    assert captured["leg"] == "upload" and captured["site"] == "test.up"
    assert staged.tolist() == list(range(6))
    assert obs.counters()["guard_transient_retries"] == 1
    assert xprof.ledger_totals()["h2d"]["by_site"]["test.up"]["events"] == 1
