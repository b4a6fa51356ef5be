"""The port's guard ladder against the JAX package's, on the CPU.

``sctools_tpu_torch.guard`` is the port's copy of ``sctools_tpu.guard``:
the error taxonomy (with a torch table in place of the XLA one), the
transient retries, the OOM bisection, the poison quarantine and its
sidecars, the stall watchdogs, and the strike count of a degrade ladder
with no rungs.

**Mirrored cases.** ``tests/test_guard.py`` is read, its ``sctools_tpu``
imports are pointed at ``sctools_tpu_torch``, and its cases are imported
here under their own names, so the same bodies drive the port. Every case
runs but these seven:

- ``test_classify_by_meaning``: XLA's error types and status names; its
  port case is :func:`test_classify_torch_errors`, one case per row of the
  torch table.
- ``test_degrade_threshold_and_loudness`` and
  ``test_degrade_now_is_immediate_and_idempotent``: they degrade a site to
  a rung, and the port has no rung (port rule 4; ``guard.degrade``).
- ``test_retrying_exhausted_reraises_and_notes_degrade``,
  ``test_degrade_rungless_site_counts_but_never_degrades`` and
  ``test_flight_sections_capture_guard_state``: each asks
  ``degrade.is_degraded`` or calls ``degrade.degrade_now``, which the port
  does not have for the same reason; their port cases are
  :func:`test_retrying_exhausted_reraises_and_counts_a_strike`,
  :func:`test_rungless_sites_count_but_never_degrade` and
  :func:`test_flight_sections_capture_guard_state_with_no_rung`.
- ``test_guard_retries_env_validation``: its last lines read JAX's
  ``degrade.threshold()`` (``SCTOOLS_TPU_GUARD_DEGRADE_AFTER``), which the
  port, having no rung, does not have; a port case of the same name checks
  ``SCTOOLS_TPU_GUARD_RETRIES`` alone.

The issue that ported the guard named the first three; the other four
leave out what the port's rung-less degrade leaves out.

**Parity.** JAX and the port run on the CPU on the same BAMs under the
same fault spec: one ``device_oom``, one ``xla_transient`` and two
``corrupt_record`` faults, one of them inside the bisected batch. The cell
and gene gatherers, the count matrix and the sharded cell gatherer must
give equal CSVs (``test_torch_metrics.assert_csv_match``: bytes, but
the ``*_variance`` fields to rtol 1e-6) and count arrays, sidecar entries (but ``ts`` and
``worker``), ``guard_*`` and ``sched_fault_*`` counters (but the random
``guard_backoff_seconds``), ``guard:bisect`` and ``guard:quarantine``
spans, and audit ledgers.
"""

from __future__ import annotations

import re
import types
from pathlib import Path

import numpy as np
import pytest

from helpers import write_bam
from sctools_tpu import obs as jax_obs
from sctools_tpu.guard import degrade as jax_degrade
from sctools_tpu.guard import quarantine as jax_quarantine
from sctools_tpu.obs import audit as jax_audit
from sctools_tpu.sched import faults as jax_faults
from sctools_tpu_torch import guard as port_guard
from sctools_tpu_torch import obs as port_obs
from sctools_tpu_torch.guard import degrade as port_degrade
from sctools_tpu_torch.guard import quarantine as port_quarantine
from sctools_tpu_torch.guard.errors import classify
from sctools_tpu_torch.obs import audit as port_audit
from sctools_tpu_torch.sched import faults as port_faults
from test_metrics import random_tagged_records
from test_torch_count import SyntheticCountData, _gtf_with_repeats
from test_torch_metrics import assert_csv_match

TESTS = Path(__file__).resolve().parent

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


_LEFT_OUT = {
    "test_classify_by_meaning",
    "test_degrade_threshold_and_loudness",
    "test_degrade_now_is_immediate_and_idempotent",
    "test_retrying_exhausted_reraises_and_notes_degrade",
    "test_degrade_rungless_site_counts_but_never_degrades",
    "test_flight_sections_capture_guard_state",
    "test_guard_retries_env_validation",
}
_MIRRORED = _ported("test_guard")
_CASES = sorted(n for n, f in vars(_MIRRORED).items() if n.startswith("test_") and callable(f))
assert _LEFT_OUT <= set(_CASES), _LEFT_OUT - set(_CASES)
globals().update({name: getattr(_MIRRORED, name) for name in _CASES if name not in _LEFT_OUT})
_clean_state = _MIRRORED._clean_state  # the mirrored file's autouse fixture
_frame = _MIRRORED._frame


def test_mirrored_module_reaches_the_port():
    assert _MIRRORED.guard is port_guard
    assert _MIRRORED.faults is port_faults
    assert _MIRRORED.degrade is port_degrade
    assert _MIRRORED.quarantine is port_quarantine


# ------------------------------------------------------ the torch table


def test_classify_torch_errors():
    import torch
    import torch.distributed as dist

    from sctools_tpu_torch.guard.errors import (
        Fatal, NativeDecodeError, PoisonData, ResourceExhausted, Stall, Transient,
    )
    from sctools_tpu_torch.sched.faults import InjectedFault

    rows = [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "resource_exhausted"),
        (torch.cuda.OutOfMemoryError("CUDA out of memory"), "resource_exhausted"),
        (MemoryError(), "resource_exhausted"),
        (torch.AcceleratorError("CUDA error: out of memory"), "resource_exhausted"),
        # sticky: the context is dead, every retry would fail alike
        (torch.AcceleratorError("CUDA error: an illegal memory access was encountered"), "fatal"),
        (torch.AcceleratorError("CUDA error: unspecified launch failure"), "fatal"),
        (torch.AcceleratorError("CUDA error: misaligned address"), "fatal"),
        (torch.AcceleratorError("CUDA error: device-side assert triggered"), "fatal"),
        (torch.AcceleratorError("CUDA error: uncorrectable ECC error encountered"), "fatal"),
        (dist.DistNetworkError("Connection reset by peer"), "transient"),
        (dist.DistStoreError("Timed out after 60 seconds waiting for clients"), "transient"),
        (dist.DistBackendError("NCCL communicator was aborted on rank 1"), "fatal"),
        (dist.DistBackendError("NCCL error: unhandled cuda error, CUDA error: an illegal memory access"),
         "fatal"),
        # any backend error, a watchdog timeout that one rank alone may see
        (dist.DistBackendError("Watchdog caught collective operation timeout"), "fatal"),
        (dist.DistBackendError("Gloo connectFullMesh failed"), "fatal"),
        # the taxonomy's own classes win; everything else is not the guard's call
        (Transient("x"), "transient"),
        (Stall(), "transient"),
        (ResourceExhausted("x"), "resource_exhausted"),
        (PoisonData("x"), "poison"),
        (NativeDecodeError("bad block", batch_index=1, record_offset=2), "poison"),
        (Fatal("x"), "fatal"),
        (RuntimeError("whitelist_correct launch failed: cudaError_t 700"), "fatal"),
        (RuntimeError("CUDA out of memory"), "fatal"),
        (ValueError("host bug"), "fatal"),
        (InjectedFault("injected failure at x"), "fatal"),
    ]
    assert [(type(e).__name__, classify(e)) for e, _ in rows] == [(type(e).__name__, k) for e, k in rows]


def test_classify_never_imports_torch():
    import subprocess
    import sys

    code = ("import sys; from sctools_tpu_torch.guard.errors import classify; "
            "assert classify(MemoryError()) == 'resource_exhausted'; print('torch' in sys.modules)")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                          cwd=str(TESTS.parent))
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "False"


# ------------------------------------------ the two cases with no rung


def test_retrying_exhausted_reraises_and_counts_a_strike(monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_GUARD_RETRIES", "1")
    port_faults.configure("xla_transient@s")  # unlimited
    from sctools_tpu_torch.guard.errors import Transient

    with pytest.raises(Transient):
        port_guard.retrying(lambda: "never", site="s")
    counters = port_obs.counters()
    assert counters["guard_transient_retries"] == 1
    assert counters["guard_device_failures_s"] == 1
    assert "guard_degraded" not in counters
    assert port_degrade.degraded_sites() == {} and port_degrade.failure_counts() == {"s": 1}


def test_guard_retries_env_validation(monkeypatch):
    monkeypatch.setenv("SCTOOLS_TPU_GUARD_RETRIES", "garbage")
    assert port_guard.configured_retries() == port_guard.DEFAULT_RETRIES
    monkeypatch.setenv("SCTOOLS_TPU_GUARD_RETRIES", "-1")
    assert port_guard.configured_retries() == port_guard.DEFAULT_RETRIES
    monkeypatch.setenv("SCTOOLS_TPU_GUARD_RETRIES", "0")
    assert port_guard.configured_retries() == 0
    assert not hasattr(port_degrade, "threshold")


def test_rungless_sites_count_but_never_degrade(capsys):
    """Every port site is rung-less: failures count, no site degrades, and
    nothing announces a degradation."""
    for site in ("sort.dispatch", "gatherer.dispatch", "whitelist.correct_pallas", "ingest.native"):
        for _ in range(10):
            assert port_degrade.note_device_failure(site) is False
    assert port_degrade.degraded_sites() == {}
    assert port_obs.counters()["guard_device_failures"] == 40
    assert port_obs.counters()["guard_device_failures_sort_dispatch"] == 10
    assert not any(k.startswith("guard_degraded") for k in port_obs.counters())
    assert "degraded" not in capsys.readouterr().err
    assert not hasattr(port_degrade, "degrade_now") and not hasattr(port_degrade, "is_degraded")


def test_flight_sections_capture_guard_state_with_no_rung(tmp_path):
    import json

    captured = {}

    def snoop(sub, off):
        captured.update(port_guard.open_retries())
        return "ok"

    port_guard.run_batch(snoop, _frame([("AAAA", 2)]), site="flight.site", offset=7)
    assert captured["flight.site"] == {"attempt": 0, "offset": 7, "records": 2}
    assert port_guard.open_retries() == {}
    for _ in range(5):
        port_degrade.note_device_failure("gatherer.dispatch")
    path = tmp_path / "flight.jsonl"
    port_obs.flight_dump(reason="test", path=str(path))
    sections = json.loads(path.read_text().splitlines()[0])["sections"]
    assert sections["guard_degraded"] == {} and sections["guard_retries"] == {}
    assert "writeback_slots" in sections


def test_shielded_body_holds_the_stall_until_it_ends(monkeypatch):
    """A deadline that expires inside a shielded body (a build, a graph
    capture) counts and dumps on time, and raises only when the shield
    ends."""
    import time

    from sctools_tpu_torch.guard import watchdog
    from sctools_tpu_torch.guard.errors import Stall

    reached = []
    with pytest.raises(Stall):
        with watchdog.deadline("compute", site="build", seconds=0.2):
            with watchdog.shielded():
                time.sleep(0.6)
                assert port_obs.counters()["guard_stalls"] == 1  # counted on time
                reached.append("shield body finished")
            for _ in range(200):
                time.sleep(0.01)
    assert reached == ["shield body finished"]
    # a shield that outlives its deadline raises nothing
    with watchdog.shielded():
        with watchdog.deadline("compute", site="quick", seconds=5):
            pass
    time.sleep(0.1)


# ------------------------------------------------------------- parity


def _quiet_jax():
    """Leave JAX's obs, faults, degrade ladder and ledger as a fresh process
    has them: off and empty. A JAX test file that shares this process reads
    ``obs.enabled()``, and the mirrored ``_clean_state`` resets only the
    port's."""
    jax_obs.disable()
    jax_obs.reset()
    jax_degrade.reset()
    jax_faults.reset()
    jax_audit.reset()


def _observe(package, run, spec, qdir, tid):
    """Run ``run`` under ``spec`` with one package's obs, faults and
    quarantine -> (counters, guard spans, sidecar entries, ledger)."""
    obs, faults, quarantine, degrade, audit = package
    obs.reset()
    obs.enable()
    audit.reset()
    degrade.reset()
    faults.configure(spec)
    quarantine.set_quarantine_dir(str(qdir))
    obs.set_context(task="parity", task_id=tid)
    try:
        run()
    finally:
        obs.set_context(task=None, task_id=None)
        faults.reset()
        quarantine.set_quarantine_dir(None)
    counters = {k: v for k, v in obs.counters().items()
                if k.startswith(("guard_", "sched_fault_")) and k != "guard_backoff_seconds"}
    spans = sorted((s["name"], sorted((s.get("attrs") or {}).items()))
                   for s in obs.spans() if s["name"] in ("guard:bisect", "guard:quarantine"))
    entries = [{k: v for k, v in e.items() if k not in ("ts", "worker")}
               for e in quarantine.load_quarantine(str(qdir))]
    ledger = audit.take(tid)
    assert degrade.degraded_sites() == {}
    obs.reset()
    audit.reset()
    return counters, spans, entries, ledger


_PORT = (port_obs, port_faults, port_quarantine, port_degrade, port_audit)
_JAX = (jax_obs, jax_faults, jax_quarantine, jax_degrade, jax_audit)


@pytest.fixture(scope="module")
def parity_inputs(tmp_path_factory):
    from sctools_tpu.bam import sort_by_tags_and_queryname

    tmp = tmp_path_factory.mktemp("torch_guard")
    records, header = random_tagged_records(seed=0)
    cell = write_bam(str(tmp / "cell.bam"),
                     list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])), header)
    gene = write_bam(str(tmp / "gene.bam"),
                     list(sort_by_tags_and_queryname(records, ["GE", "CB", "UB"])), header)
    data = SyntheticCountData()
    count = write_bam(str(tmp / "count.bam"), data.records(), data.header)
    return dict(cell=cell, gene=gene, count=count, gtf=_gtf_with_repeats(tmp), tmp=tmp)


def _spec(site: str, poisoned) -> str:
    return ";".join([f"device_oom@{site}:times=1", f"xla_transient@{site}:times=1"]
                    + [f"corrupt_record@{site}:record={r}" for r in poisoned])


# the batch the device_oom bisects is the first one: records [0, 104) of the
# cell BAM at 128 a batch, cut at record 45, so record 3 lies in its left
# half and record 61 in its right; the gene BAM's first gene holds 89
# records, so its batch is 256 and both lie in the left half. Each must come
# out, and nothing else
_BATCH = {"gene": 256}
_POISONED = (3, 61)


@pytest.mark.parametrize("command", ["cell", "gene", "sharded", "count"])
def test_fault_ladder_matches_jax(parity_inputs, command):
    from sctools_tpu.metrics.gatherer import GatherCellMetrics as JaxCell
    from sctools_tpu.metrics.gatherer import GatherGeneMetrics as JaxGene
    from sctools_tpu.parallel import ShardedCellMetrics as JaxSharded
    from sctools_tpu.parallel import make_mesh as jax_mesh
    from sctools_tpu.platform import GenericPlatform as JaxPlatform
    from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics, GatherGeneMetrics
    from sctools_tpu_torch.parallel import ShardedCellMetrics, make_mesh
    from sctools_tpu_torch.platform import GenericPlatform

    inputs, tmp = parity_inputs, parity_inputs["tmp"] / command
    tmp.mkdir(exist_ok=True)
    site = "count.dispatch" if command == "count" else "gatherer.dispatch"
    spec = _spec(site, _POISONED)
    if command == "count":
        args = ["-b", inputs["count"], "-a", inputs["gtf"], "--batch-records", str(_BATCH.get(command, 128))]

        def port():
            GenericPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "p")], device="cpu")

        def jax():
            JaxPlatform.bam_to_count_matrix(args + ["-o", str(tmp / "j")])
    else:
        bam = inputs["gene" if command == "gene" else "cell"]
        port_cls, jax_cls = {"cell": (GatherCellMetrics, JaxCell), "gene": (GatherGeneMetrics, JaxGene),
                             "sharded": (ShardedCellMetrics, JaxSharded)}[command]
        port_kwargs = dict(device="cpu") if command != "sharded" else dict(mesh=make_mesh(2, device="cpu"))
        jax_kwargs = dict(backend="device") if command != "sharded" else dict(mesh=jax_mesh(2))

        def port():
            port_cls(bam, str(tmp / "p"), batch_records=_BATCH.get(command, 128), **port_kwargs).extract_metrics()

        def jax():
            jax_cls(bam, str(tmp / "j"), batch_records=_BATCH.get(command, 128), **jax_kwargs).extract_metrics()

    try:
        got = _observe(_PORT, port, spec, tmp / "pq", "t-" + command)
        want = _observe(_JAX, jax, spec, tmp / "jq", "t-" + command)
    finally:
        _quiet_jax()
    counters, spans, entries, ledger = got
    assert counters == want[0]
    assert spans == want[1]
    assert entries == want[2]
    assert ledger == want[3]
    # the ladder did what the spec asks, and nothing failed
    assert counters["sched_fault_device_oom"] == 1 and counters["guard_oom_bisections"] == 1
    assert counters["sched_fault_xla_transient"] == 1 and counters["guard_transient_retries"] == 1
    assert counters["guard_poison_records"] == 2
    assert [(e["record_start"], e["record_stop"]) for e in entries] == [(r, r + 1) for r in _POISONED]
    assert any(name == "guard:bisect" for name, _ in spans)
    assert ledger["records.quarantined:PoisonData"] == 2
    assert ledger["records.decoded"] == ledger["records.computed"] + 2
    if command == "count":
        from sctools_tpu.count import CountMatrix as JaxMatrix
        from sctools_tpu_torch.count import CountMatrix

        mine, theirs = CountMatrix.load(str(tmp / "p")), JaxMatrix.load(str(tmp / "j"))
        assert mine.matrix.shape == theirs.matrix.shape
        for name in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(mine.matrix, name), getattr(theirs.matrix, name))
        assert list(mine.row_index) == list(theirs.row_index)
        assert list(mine.col_index) == list(theirs.col_index)
    else:
        assert_csv_match(tmp / "p.csv.gz", tmp / "j.csv.gz")
