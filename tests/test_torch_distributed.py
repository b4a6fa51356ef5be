"""Processes joined into one mesh (``sctools_tpu_torch.parallel``) on the CPU, against the JAX package.

The port of ``test_distributed.py``. Two worker processes (the script
``WORKER`` below, run with ``python -c``; they import torch and numpy, never
JAX) join one gloo group with ``initialize_distributed(device="cpu")`` and
lay out a 2 x 2 global mesh: two CPU shards a process, process p owning
global shards 2p and 2p + 1. One spawn runs every case:

- **tier 1**, the chunk queue under the group: ``run_process_cell_metrics``
  over ``test_distributed._make_input``'s 48-cell BAM split by SplitBam into
  chunks, ``sync_processes("parts-written")``, rank 0's
  ``merge_sorted_csv_parts``; the merged CSV equals JAX's one-shot
  ``GatherCellMetrics(backend="device")`` CSV;
- **tier 2**, the global mesh: JAX's ``make_synthetic_columns(n_records=480,
  ..., seed=7)`` partitioned into 4 cell shards; each process feeds its two
  rows through ``host_local_to_global`` into ``distributed_metrics_step``,
  and into ``hybrid_metrics_step`` on ``make_hybrid_mesh`` over the global
  mesh, (dcn, shard) = (processes, local shards); the union of the
  processes' shards equals JAX's step on a 4-device mesh (its hybrid step
  on a 2 x 2 mesh) in this process, every column bit for bit but the
  ``*_variance`` columns, rtol 1e-6 (``test_torch_metrics`` says why);
  ``distributed_sort`` of stacked host keys on the global mesh equals JAX's;
- ``collective_preflight`` and ``mesh_fingerprint`` of the global mesh equal
  JAX's on 4 devices; the transport is gloo;
- an explicit capacity that only one process's rows exceed makes both
  processes raise ``ValueError``; records dropped by one process alone (its
  ``required_reshard_capacity`` patched to 0, as
  ``test_reshard_drops_raise_after_the_step`` does) make both raise
  ``RuntimeError``; a global batch that is not fully addressable makes
  ``distributed_sort`` raise ``RuntimeError`` in both; ``sync_processes``
  with different names makes both raise JAX's ``AssertionError``.

The workers find their coordinator on a free localhost port and gloo's own
connections on ports the system hands out. Every collective of the group
times out after 60 s and each worker after 180 s, and a worker left running
is killed. The cases with no process group run here: a global mesh's
ownership built from an owner list, collectives over groups inside one
process of it, and the one-process forms of the new functions.
"""

from __future__ import annotations

import gzip
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sctools_tpu import parallel as jax_par
from sctools_tpu.metrics.gatherer import GatherCellMetrics as JaxGatherCellMetrics
from sctools_tpu.platform import GenericPlatform as JaxGenericPlatform
from sctools_tpu.utils import make_synthetic_columns
from sctools_tpu_torch import parallel as port_par
from sctools_tpu_torch.parallel import collective
from test_distributed import _make_input
from test_torch_parallel import _same

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 2
LOCAL = 2  # CPU shards a process
SHARDS = PROCESSES * LOCAL
SORT_KEYS = ["k1", "k2"]

# One worker: argv = process_id coordinator workdir capacity. Joins the
# group, runs every case, writes its shards' outputs to <workdir>/out<p>.npz
# and what it saw to <workdir>/report<p>.json.
WORKER = """
import glob, json, os, sys
import numpy as np
import torch
from sctools_tpu_torch import parallel as par
from sctools_tpu_torch.parallel import metrics as par_metrics

pid, coordinator, workdir, capacity = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
report = {"transport": par.initialize_distributed(coordinator, 2, pid, device="cpu", timeout=60.0)}
report["index"], report["count"] = par.process_index(), par.process_count()

# tier 1: the chunk queue under the group, the rank-0 merge
chunks = sorted(glob.glob(os.path.join(workdir, "chunks", "*.bam")))
par.run_process_cell_metrics(chunks, os.path.join(workdir, f"proc{pid}"), 2, pid, device="cpu")
par.sync_processes("parts-written")
if pid == 0:
    report["rows"] = par.merge_sorted_csv_parts(
        os.path.join(workdir, "metrics.part*.csv.gz"), os.path.join(workdir, "merged.csv.gz"),
        expected_parts=len(chunks))

# tier 2: the global mesh
cpu = torch.device("cpu")
mesh = par.global_mesh(devices=[cpu, cpu])
report["local_shards"], report["owners"] = mesh.local_shards, list(mesh.owners)
inputs = np.load(os.path.join(workdir, "inputs.npz"))
stacked = {k[len("step/"):]: inputs[k] for k in inputs.files if k.startswith("step/")}
keys = {k[len("sort/"):]: inputs[k] for k in inputs.files if k.startswith("sort/")}
local = {k: v[mesh.local_shards] for k, v in stacked.items()}
batch = par.host_local_to_global(local, mesh)
out = {}
cell, gene = par.distributed_metrics_step(batch, mesh)
hybrid = par.make_hybrid_mesh(par.process_count(), devices=mesh)
report["hybrid_shape"] = hybrid.shape
hcell, hgene = par.hybrid_metrics_step(par.host_local_to_global(local, hybrid, ("dcn", "shard")), hybrid)
ordered = par.distributed_sort(keys, ["k1", "k2"], mesh)
for kind, result in (("cell", cell), ("gene", gene), ("hybrid_cell", hcell), ("hybrid_gene", hgene),
                     ("sort", ordered)):
    for row, columns in par.addressable_to_host(result).items():
        for name, value in columns.items():
            out[f"{kind}/{row}/{name}"] = value
np.savez(os.path.join(workdir, f"out{pid}.npz"), **out)
report["crossed"] = dict(par.collective.crossed)
report["preflight"] = par.collective_preflight(mesh)
report["fingerprint"] = par.mesh_fingerprint(mesh)

# every refusal, on both processes
try:
    par.distributed_metrics_step(batch, mesh, capacity=capacity)
except ValueError as error:
    report["capacity"] = str(error)
real = par_metrics.required_reshard_capacity
par_metrics.required_reshard_capacity = lambda *args: 0
try:
    par.distributed_metrics_step(batch, mesh, capacity=capacity)
except RuntimeError as error:
    report["dropped"] = str(error)
par_metrics.required_reshard_capacity = real
try:
    par.distributed_sort(par.host_local_to_global({k: v[mesh.local_shards] for k, v in keys.items()}, mesh),
                         ["k1", "k2"], mesh)
except RuntimeError as error:
    report["sort_global"] = str(error)
try:
    par.sync_processes(f"parts-of-{pid}")
except AssertionError as error:
    report["sync"] = str(error)
par.sync_processes("done")
par.distributed.shutdown()
with open(os.path.join(workdir, f"report{pid}.json"), "w") as f:
    json.dump(report, f)
print(f"[p{pid}] OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sort_keys(seed: int = 9):
    rng = np.random.default_rng(seed)
    n = 4 * 300
    valid = np.ones(n, dtype=bool)
    valid[-23:] = False
    cols = {"k1": rng.integers(0, 200, n).astype(np.int32), "k2": rng.integers(-40, 40, n).astype(np.int32),
            "payload": np.arange(n, dtype=np.int32), "valid": valid}
    return {k: v.reshape(SHARDS, -1) for k, v in cols.items()}


def _local_required(stacked, process):
    rows = slice(process * LOCAL, (process + 1) * LOCAL)
    return jax_par.required_reshard_capacity({k: stacked[k][rows] for k in ("gene", "valid")}, "gene", SHARDS)


@pytest.fixture(scope="module")
def stacked():
    cols = make_synthetic_columns(n_records=480, n_cells=4 * SHARDS, n_genes=2 * SHARDS, seed=7)
    return jax_par.partition_columns(cols, SHARDS, key="cell")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, stacked):
    """Both workers, once, on a 48-cell BAM's chunks and the stacked inputs."""
    workdir = tmp_path_factory.mktemp("distributed")
    bam = str(workdir / "input.bam")
    _make_input(bam)
    single = workdir / "single.csv.gz"
    JaxGatherCellMetrics(bam, str(single), backend="device").extract_metrics()
    (workdir / "chunks").mkdir()
    JaxGenericPlatform.split_bam(["-b", bam, "-p", str(workdir / "chunks" / "chunk"), "-s", "0.002", "-t", "CB"])
    n_chunks = len(list((workdir / "chunks").glob("*.bam")))
    keys = _sort_keys()
    np.savez(workdir / "inputs.npz", **{f"step/{k}": v for k, v in stacked.items()},
             **{f"sort/{k}": v for k, v in keys.items()})
    required = [_local_required(stacked, p) for p in range(PROCESSES)]
    capacity = min(required)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(p), coordinator, str(workdir), str(capacity)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for p in range(PROCESSES)
    ]
    try:
        outputs = [proc.communicate(timeout=180)[0] for proc in procs]
    finally:
        # a hung or failed worker must not outlive the test holding its ports
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for p, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0 and f"[p{p}] OK" in out, f"worker {p} failed:\n{out[-4000:]}"
    reports = [json.loads((workdir / f"report{p}.json").read_text()) for p in range(PROCESSES)]
    shards = {}
    for p in range(PROCESSES):
        with np.load(workdir / f"out{p}.npz") as out:
            for key in out.files:
                kind, row, name = key.split("/")
                shards.setdefault(kind, {}).setdefault(int(row), {})[name] = out[key]
    return dict(workdir=workdir, single=single, n_chunks=n_chunks, reports=reports, shards=shards,
                required=required, capacity=capacity, keys=keys)


def _jax_mesh(n):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("shard",))


def _assert_union_equals(shards, want, n=SHARDS):
    """The processes' shards, row by row, equal JAX's stacked result."""
    assert sorted(shards) == list(range(n))
    for row in range(n):
        assert set(shards[row]) == set(want)
        for name in want:
            _same(f"{name} row {row}", shards[row][name], np.asarray(want[name])[row],
                  tolerant=name.endswith("_variance"))


# ------------------------------------------------------------- the spawn


def test_two_processes_join_one_gloo_mesh(spawned):
    for p, report in enumerate(spawned["reports"]):
        assert report["transport"] == "gloo" and report["index"] == p and report["count"] == PROCESSES
        assert report["local_shards"] == [LOCAL * p + i for i in range(LOCAL)]
        assert report["owners"] == [0, 0, 1, 1]
        assert report["hybrid_shape"] == {"dcn": PROCESSES, "shard": LOCAL}


def test_chunk_parts_merged_by_rank_zero_equal_jax_one_shot(spawned):
    """Tier 1: the rank-0 merge equals JAX's one-shot CSV, decompressed."""
    assert spawned["n_chunks"] >= 2
    merged = spawned["workdir"] / "merged.csv.gz"
    assert spawned["reports"][0]["rows"] == 48
    with gzip.open(merged, "rb") as a, gzip.open(spawned["single"], "rb") as b:
        assert a.read() == b.read()


def test_cross_process_step_equals_jax(spawned, stacked):
    """Tier 2: every process's cell and gene shards equal JAX's step on a
    4-device mesh; the gene rekey sent bytes across the boundary."""
    jax_cell, jax_gene = jax_par.distributed_metrics_step(stacked, _jax_mesh(SHARDS))
    _assert_union_equals(spawned["shards"]["cell"], jax_cell)
    _assert_union_equals(spawned["shards"]["gene"], jax_gene)
    for report in spawned["reports"]:
        assert report["crossed"]["all_to_all"] > 0


def test_cross_process_hybrid_step_equals_jax(spawned, stacked):
    mesh = jax_par.make_hybrid_mesh(PROCESSES, devices_per_slice=LOCAL)
    jax_cell, jax_gene = jax_par.hybrid_metrics_step(stacked, mesh)
    _assert_union_equals(spawned["shards"]["hybrid_cell"], jax_cell)
    _assert_union_equals(spawned["shards"]["hybrid_gene"], jax_gene)


def test_cross_process_sort_equals_jax(spawned):
    want = jax_par.distributed_sort(spawned["keys"], SORT_KEYS, _jax_mesh(SHARDS))
    _assert_union_equals(spawned["shards"]["sort"], want)


def test_preflight_and_fingerprint_of_the_global_mesh_equal_jax(spawned):
    want = jax_par.collective_preflight(_jax_mesh(SHARDS))
    assert want == {"devices": 4, "total": 120}
    for report in spawned["reports"]:
        assert report["preflight"] == want
        assert report["fingerprint"] == jax_par.mesh_fingerprint(_jax_mesh(SHARDS))


def test_undersized_capacity_raises_on_every_process(spawned):
    """One process's rows fit the capacity, the other's do not: both raise
    JAX's ValueError, naming the allgathered requirement."""
    low, high = sorted(spawned["required"])
    assert low < high and spawned["capacity"] == low
    want = f"reshard capacity={low} too small: a (src,dst) shard pair exchanges up to {high} records"
    assert [report["capacity"] for report in spawned["reports"]] == [want, want]


def test_drops_of_one_process_raise_on_every_process(spawned):
    messages = [report["dropped"] for report in spawned["reports"]]
    assert messages[0] == messages[1]
    assert f"reshard capacity={spawned['capacity']} too small" in messages[0]
    assert "records were dropped in the all_to_all rekey" in messages[0]


def test_sort_of_a_global_batch_raises_on_every_process(spawned):
    for report in spawned["reports"]:
        assert "spans non-addressable" in report["sort_global"]


def test_mismatched_sync_names_raise_on_every_process(spawned):
    for p, report in enumerate(spawned["reports"]):
        assert report["sync"].startswith(f"sync_global_devices name mismatch ('parts-of-{p}'). Expected: [")


# --------------------------------------------------- no process group


def _owned_mesh(process):
    """A 2 x 2 global mesh seen from ``process``, without a group."""
    flat = port_par.Mesh([torch.device("cpu")] * SHARDS, ("shard",), owners=[0, 0, 1, 1], process=process)
    return flat, port_par.make_hybrid_mesh(PROCESSES, devices=flat)


@pytest.mark.parametrize("process", [0, 1])
def test_global_mesh_ownership_from_an_owner_list(process):
    flat, hybrid = _owned_mesh(process)
    assert flat.local_shards == [2 * process, 2 * process + 1] and not flat.is_fully_addressable
    assert hybrid.owners == (0, 0, 1, 1) and hybrid.local_shards == flat.local_shards
    assert hybrid.shape == {"dcn": 2, "shard": 2}
    assert f"owners=[0, 0, 1, 1], process={process}" in repr(flat)
    assert port_par.make_mesh(2, device="cpu").is_fully_addressable


@pytest.mark.parametrize("process", [0, 1])
def test_collectives_inside_one_process_of_a_global_mesh(process):
    """Groups along ``shard`` lie inside one process: local copies, no
    exchange (there is no group to exchange over), None for the others'."""
    _, mesh = _owned_mesh(process)
    mine = mesh.local_shards
    xs = [torch.tensor([float(i), 10.0 * i]) if i in mine else None for i in range(SHARDS)]
    a, b = mine
    summed = collective.psum(xs, mesh, "shard")
    assert [t is None for t in summed] == [i not in mine for i in range(SHARDS)]
    assert summed[a].tolist() == summed[b].tolist() == [a + b, 10.0 * (a + b)]
    gathered = collective.all_gather(xs, mesh, "shard", tiled=True)
    assert gathered[b].tolist() == [a, 10.0 * a, b, 10.0 * b]
    swapped = collective.all_to_all(xs, mesh, "shard", 0, 0, tiled=True)
    assert swapped[a].tolist() == [a, b] and swapped[b].tolist() == [10.0 * a, 10.0 * b]
    moved = collective.ppermute(xs, mesh, "shard", [(0, 1)])
    assert moved[a].tolist() == [0, 0] and moved[b].tolist() == xs[a].tolist() and moved[b] is not xs[a]
    before = dict(collective.crossed)
    with pytest.raises(RuntimeError, match="no process group"):
        collective.psum(xs, mesh, "dcn")  # crosses processes
    assert dict(collective.crossed) == before
    with pytest.raises(ValueError, match=rf"no value for this process's shards \[{a}, {b}\]"):
        collective.psum([None] * SHARDS, mesh, "shard")


def test_one_process_forms_match_the_stacked_step(stacked):
    """Without a group: process 0 of 1, the allgather of one, a no-op sync,
    a global mesh that is this process's own, and a global batch that steps,
    sorts and reads as the stacked columns do."""
    assert (port_par.process_index(), port_par.process_count(), port_par.distributed.transport()) == (0, 1, None)
    x = np.asarray([[1, 2]], dtype=np.int16)
    assert port_par.process_allgather(x).shape == (1, 1, 2)
    assert np.array_equal(port_par.process_allgather(x, tiled=True), x)
    port_par.sync_processes("alone")
    mesh = port_par.global_mesh(devices=[torch.device("cpu")] * SHARDS)
    assert mesh.owners == (0,) * SHARDS and mesh.is_fully_addressable
    batch = port_par.host_local_to_global(stacked, mesh)
    assert batch["cell"].shape == stacked["cell"].shape and np.array_equal(np.asarray(batch["cell"]), stacked["cell"])
    for got, want in zip(port_par.distributed_metrics_step(batch, mesh),
                         port_par.distributed_metrics_step(stacked, mesh)):
        got, want = port_par.stack_to_host(got), port_par.stack_to_host(want)
        for name in want:
            assert np.array_equal(got[name], want[name], equal_nan=True), name
    keys = _sort_keys()
    got = port_par.stack_to_host(port_par.distributed_sort(port_par.host_local_to_global(keys, mesh), SORT_KEYS, mesh))
    want = port_par.stack_to_host(port_par.distributed_sort(keys, SORT_KEYS, mesh))
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    with pytest.raises(ValueError, match="local rows"):
        port_par.host_local_to_global({k: v[:2] for k, v in stacked.items()}, mesh)
    with pytest.raises(ValueError, match="a global batch shards over all of them"):
        port_par.host_local_to_global(stacked, port_par.make_hybrid_mesh(2, 2, device="cpu"), "shard")
