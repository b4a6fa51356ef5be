"""The port's device mesh (``sctools_tpu_torch.parallel``) against the JAX package, on the CPU.

The JAX side runs on the 8 host devices that ``conftest.py`` forces; the
port runs meshes of 2 and 4 CPU shards (``make_mesh(n, device="cpu")``) and
a 2 x 2 hybrid mesh. The same inputs, made from a ``random`` or numpy seed
(``test_parallel``'s records, ``test_metrics``' tagged records,
``test_count.SyntheticCountData``), go through both:

- ``partition_columns``: the stacked columns equal, dtype and bytes;
- ``sharded_entity_metrics`` (cell, gene), ``distributed_metrics_step`` and
  ``hybrid_metrics_step``: every per-shard output equal to JAX's, and the
  rows equal to the port's one-device engine;
- ``reshard_by_key``: the received columns and the drop counts at the exact,
  a tight and a too-small capacity;
- ``distributed_sort``: two keys, one key dominating, negative keys, and a
  too-small capacity;
- ``sharded_count_molecules`` and ``collective_preflight``;
- the six ``--devices 2`` commands: their outputs equal JAX's ``--devices 2``
  and the port's one-device run; the gene merge's int32 overflow refusals
  and the parser errors equal JAX's.

Equality is exact, floats included, but for the metrics CSVs' ``*_variance``
columns against JAX, which keep ``test_torch_metrics``' rtol 1e-6 (XLA's CPU
backend contracts a multiply-add there; see that file). Against the port's
own one-device run every byte is equal. Count matrices are compared by their
arrays, as ``test_torch_count`` does.
"""

from __future__ import annotations

import functools
import gzip
import os
import random
import re

import jax
import numpy as np
import pytest
import torch

from sctools_tpu import parallel as jax_par
from sctools_tpu import platform as jax_platform
from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu.count import device_count_columns as jax_count_columns
from sctools_tpu.io import packed as jax_packed
from sctools_tpu.metrics import gatherer as jax_gatherer
from sctools_tpu.metrics.collective import CollectiveMergeGeneMetrics as JaxCollectiveGene
from sctools_tpu.metrics.merge import MergeGeneMetrics as JaxMergeGene
from sctools_tpu.parallel.metrics import reshard_by_key as jax_reshard
from sctools_tpu.parallel.sort import required_sort_capacity as jax_sort_capacity
from sctools_tpu_torch import count as port_count
from sctools_tpu_torch import parallel as port_par
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io import packed as port_packed
from sctools_tpu_torch.metrics import collective as port_collective
from sctools_tpu_torch.metrics import device as port_device
from sctools_tpu_torch.metrics import gatherer as port_gatherer
from sctools_tpu_torch.metrics import merge as port_merge

from helpers import make_record, write_bam, write_gtf
from test_count import GENE_TO_INDEX, SyntheticCountData
from test_metrics import random_tagged_records
from test_parallel import _random_records
from test_torch_count import _assert_same_matrix, _gtf_with_repeats
from test_torch_metrics import VARIANCE_RTOL, _csv, assert_csv_match

SHARDS = [2, 4]
P = jax.sharding.PartitionSpec


def _same(name, port, jax_value, tolerant=False):
    a, b = np.asarray(port), np.asarray(jax_value)
    # conftest runs JAX with x64 on, where a reduction's count comes back
    # int64; the port's, like JAX's on a device, is int32
    same_dtype = a.dtype == b.dtype or (a.dtype == np.int32 and b.dtype == np.int64)
    assert a.shape == b.shape and same_dtype, f"{name}: {a.shape} {a.dtype} != {b.shape} {b.dtype}"
    if tolerant:
        np.testing.assert_allclose(a, b, rtol=VARIANCE_RTOL, atol=0, equal_nan=True, err_msg=name)
    else:
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name


def _same_result(port, jax_result):
    """A port sharded result (per-shard lists) equals JAX's stacked one."""
    port = port_par.stack_to_host(port)
    assert set(port) == set(jax_result)
    for name in jax_result:
        _same(name, port[name], jax_result[name], tolerant=name.endswith("_variance"))


@functools.lru_cache(maxsize=None)
def _meshes(n: int):
    return port_par.make_mesh(n, device="cpu"), jax_par.make_mesh(n)


@pytest.fixture(scope="module")
def padded():
    """test_parallel's 600 random records as both packages pad them."""
    records = _random_records()
    port_frame, jax_frame = port_packed.frame_from_records(records), jax_packed.frame_from_records(records)
    port_cols = port_gatherer._pad_columns(port_frame, np.zeros(len(port_frame.gene_names), bool))[0]
    jax_cols = jax_gatherer._pad_columns(jax_frame, np.zeros(len(jax_frame.gene_names), bool))[0]
    return port_cols, jax_cols


def _one_device_rows(cols, kind):
    result = port_device.compute_entity_metrics(
        {k: torch.from_numpy(np.asarray(v)) for k, v in cols.items()}, num_segments=len(cols["valid"]), kind=kind
    )
    return port_par.collect_sharded_rows({k: [v] for k, v in result.items()})


def _assert_rows_equal(got, want):
    assert set(got) == set(want) and got
    for code, row in want.items():
        for metric, value in row.items():
            assert np.array_equal(np.asarray(got[code][metric]), np.asarray(value), equal_nan=True), (code, metric)


# --------------------------------------------------------------- partition


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("key", ["cell", "gene"])
def test_partition_columns_match_jax(padded, n, key):
    port_cols, jax_cols = padded
    port = port_par.partition_columns(port_cols, n, key=key)
    want = jax_par.partition_columns(jax_cols, n, key=key)
    assert list(port) == list(want)
    for name in want:
        _same(name, port[name], want[name])
    assert np.array_equal(port_par.shard_assignment(np.arange(37), n), np.arange(37) % n)
    with pytest.raises(ValueError, match="too small"):
        port_par.partition_columns(port_cols, n, key=key, shard_size=1)


# ----------------------------------------------------------------- metrics


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_sharded_entity_metrics_match_jax(padded, n, kind):
    port_cols, jax_cols = padded
    port_mesh, jax_mesh = _meshes(n)
    port = port_par.sharded_entity_metrics(port_par.partition_columns(port_cols, n, key=kind), port_mesh, kind)
    want = jax_par.sharded_entity_metrics(jax_par.partition_columns(jax_cols, n, key=kind), jax_mesh, kind=kind)
    _same_result(port, want)
    _assert_rows_equal(port_par.collect_sharded_rows(port), _one_device_rows(port_cols, kind))
    with pytest.raises(ValueError, match=f"batch has {n + 1} shards but mesh axes"):
        port_par.sharded_entity_metrics(port_par.partition_columns(port_cols, n + 1, key=kind), port_mesh, kind)


@pytest.mark.parametrize("n", SHARDS)
def test_distributed_metrics_step_matches_jax(padded, n):
    port_cols, jax_cols = padded
    port_mesh, jax_mesh = _meshes(n)
    port_cell, port_gene = port_par.distributed_metrics_step(port_par.partition_columns(port_cols, n), port_mesh)
    jax_cell, jax_gene = jax_par.distributed_metrics_step(jax_par.partition_columns(jax_cols, n), jax_mesh)
    _same_result(port_cell, jax_cell)
    _same_result(port_gene, jax_gene)
    _assert_rows_equal(port_par.collect_sharded_rows(port_gene), _one_device_rows(port_cols, "gene"))


def test_hybrid_metrics_step_matches_jax(padded):
    """2 x 2 (dcn, shard): cells over the flattened grid, the gene rekey
    over both axes. JAX's hybrid mesh is 2 x 4 over its 8 devices, so its
    side runs the step on a 1-D mesh of 4: the same exchange."""
    port_cols, jax_cols = padded
    mesh = port_par.make_hybrid_mesh(2, 2, device="cpu")
    assert mesh.axis_names == ("dcn", "shard") and mesh.size == 4
    port_cell, port_gene = port_par.hybrid_metrics_step(port_par.partition_columns(port_cols, 4), mesh)
    jax_cell, jax_gene = jax_par.distributed_metrics_step(jax_par.partition_columns(jax_cols, 4), _meshes(4)[1])
    _same_result(port_cell, jax_cell)
    _same_result(port_gene, jax_gene)


def _jax_reshard(stacked, mesh, n, capacity):
    from sctools_tpu.platform import shard_map

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("shard"),), out_specs=(P("shard"), P("shard")),
                       check_vma=False)
    def run(local):
        out, dropped = jax_reshard({k: v[0] for k, v in local.items()}, "gene", "shard", n, capacity=capacity)
        return {k: v[None] for k, v in out.items()}, dropped[None]

    out, dropped = jax.jit(run)(stacked)
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(dropped)


@pytest.mark.parametrize("n", SHARDS)
def test_reshard_by_key_matches_jax(padded, n):
    port_cols, jax_cols = padded
    port_mesh, jax_mesh = _meshes(n)
    port_stacked = port_par.partition_columns(port_cols, n, key="cell")
    jax_stacked = jax_par.partition_columns(jax_cols, n, key="cell")
    required = port_par.required_reshard_capacity(port_stacked, "gene", n)
    assert required == jax_par.required_reshard_capacity(jax_stacked, "gene", n)
    n_valid = int(port_stacked["valid"].sum())
    for capacity in (required, port_par.metrics.seg.bucket_size(required, minimum=8), required - 1):
        shards = port_par.metrics.place(port_stacked, port_mesh)
        out, dropped = port_par.reshard_by_key(shards, "gene", port_mesh, capacity=capacity)
        got = port_par.stack_to_host({k: [shard[k] for shard in out] for k in out[0]})
        got_dropped = np.stack([d.numpy() for d in dropped])
        want, want_dropped = _jax_reshard(jax_stacked, jax_mesh, n, capacity)
        assert set(got) == set(want)
        for name in want:
            _same(f"{name} at capacity {capacity}", got[name], want[name])
        _same("dropped", got_dropped, want_dropped)
        assert int(got["valid"].sum()) + int(got_dropped.sum()) == n_valid
        assert (got_dropped.sum() > 0) == (capacity < required)
    with pytest.raises(ValueError, match="too small") as port_error:
        port_par.distributed_metrics_step(port_stacked, port_mesh, capacity=required - 1)
    with pytest.raises(ValueError, match="too small") as jax_error:
        jax_par.distributed_metrics_step(jax_stacked, jax_mesh, capacity=required - 1)
    assert str(port_error.value) == str(jax_error.value)


def test_reshard_drops_raise_after_the_step(padded, monkeypatch):
    """A capacity that passes the host check but drops records on the
    device raises JAX's RuntimeError after the step."""
    port_cols, _ = padded
    mesh = _meshes(2)[0]
    stacked = port_par.partition_columns(port_cols, 2)
    monkeypatch.setattr(port_par.metrics, "required_reshard_capacity", lambda *a: 1)
    with pytest.raises(RuntimeError, match="records were dropped in the all_to_all rekey"):
        port_par.distributed_metrics_step(stacked, mesh, capacity=1)


# -------------------------------------------------------------------- sort


def _sort_cols(seed, case):
    rng = np.random.default_rng(seed)
    n = 1600
    valid = np.ones(n, dtype=bool)
    valid[-37:] = False
    cols = {
        "k1": rng.integers(0, 500, n).astype(np.int32),
        "k2": rng.integers(0, 97, n).astype(np.int32),
        "payload": np.arange(n, dtype=np.int32),
        "valid": valid,
    }
    if case == "skew":
        cols["k1"][: n // 2] = 7
        cols["k2"][: n // 2] = 3
    elif case == "one-key":
        cols["k1"][:] = 11
        cols["k2"][:] = 4
    elif case == "negative":
        cols["k1"] -= 250
        cols["k2"] -= 48
    return cols


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case,keys", [
    ("random", ["k1", "k2"]), ("skew", ["k1", "k2"]), ("one-key", ["k1", "k2"]),
    ("negative", ["k1", "k2"]), ("random", ["k1"]),
], ids=["two-keys", "half-one-key", "all-one-key", "negative", "single-key"])
def test_distributed_sort_matches_jax(n, case, keys):
    cols = _sort_cols(n, case)
    stacked = {k: v.reshape(n, -1) for k, v in cols.items()}
    port_mesh, jax_mesh = _meshes(n)
    required = port_par.required_sort_capacity(stacked, keys, n)
    assert required == jax_sort_capacity(stacked, keys, n)
    assert required <= 2 * (int(cols["valid"].sum()) // n)
    got = port_par.stack_to_host(port_par.distributed_sort(stacked, keys, port_mesh))
    want = jax_par.distributed_sort(stacked, keys, jax_mesh)
    for name in want:
        _same(name, got[name], want[name])
    flat = np.concatenate([got["k1"][s][got["valid"][s]] for s in range(n)])
    assert flat.size == int(cols["valid"].sum()) and np.all(np.diff(flat) >= 0)


def test_distributed_sort_refuses_small_capacity():
    stacked = {k: v.reshape(2, -1) for k, v in _sort_cols(5, "random").items()}
    errors = []
    for package, mesh in zip((port_par, jax_par), _meshes(2)):
        with pytest.raises(ValueError, match="too small") as error:
            package.distributed_sort(stacked, ["k1", "k2"], mesh, capacity=1)
        errors.append(str(error.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="1-2 key columns"):
        port_par.distributed_sort(stacked, ["k1", "k2", "payload"], _meshes(2)[0])


# ------------------------------------------------------- count, preflight


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_count_molecules_matches_jax(n):
    data = SyntheticCountData()
    records = data.records()
    port_cols = port_count.device_count_columns(port_packed.frame_from_records(records))
    jax_cols = jax_count_columns(jax_packed.frame_from_records(records))
    port_stacked = port_par.partition_columns(port_cols, n, key="cell")
    jax_stacked = jax_par.partition_columns(jax_cols, n, key="cell")
    for name in jax_stacked:
        _same(name, port_stacked[name], jax_stacked[name])
    port_mesh, jax_mesh = _meshes(n)
    got = port_par.stack_to_host(port_par.sharded_count_molecules(port_stacked, port_mesh))
    want = jax_par.sharded_count_molecules(jax_stacked, jax_mesh)
    for name in want:
        _same(name, got[name], want[name])
    assert got["is_molecule"].sum() > 0


@pytest.mark.parametrize("n", SHARDS)
def test_collective_preflight_matches_jax(n):
    port_mesh, jax_mesh = _meshes(n)
    assert port_par.collective_preflight(port_mesh) == jax_par.collective_preflight(jax_mesh)
    hybrid = port_par.make_hybrid_mesh(2, 2, device="cpu")
    assert port_par.collective_preflight(hybrid, "shard") == {"devices": 2, "total": 28}
    fingerprint = port_par.mesh_fingerprint(port_mesh)
    assert fingerprint == {"axes": ["shard"], "sizes": [n], "devices": n, "device_kind": "cpu"}


def test_collectives_on_a_two_by_two_mesh():
    """Groups along one axis, and ``ppermute``'s zeros, on the hybrid mesh."""
    mesh = port_par.make_hybrid_mesh(2, 2, device="cpu")
    xs = [torch.tensor([float(i), 10.0 * i]) for i in range(4)]
    assert [t.tolist() for t in port_par.collective.psum(xs, mesh, "shard")] == [[1, 10], [1, 10], [5, 50], [5, 50]]
    assert [t.tolist() for t in port_par.collective.psum(xs, mesh, "dcn")] == [[2, 20], [4, 40], [2, 20], [4, 40]]
    assert port_par.collective.axis_index(mesh, ("dcn", "shard")) == [0, 1, 2, 3]
    assert port_par.collective.axis_index(mesh, "dcn") == [0, 0, 1, 1]
    moved = port_par.collective.ppermute(xs, mesh, "shard", [(0, 1)])
    assert [t.tolist() for t in moved] == [[0, 0], [0, 0], [0, 0], [2, 20]]
    assert moved[1] is not xs[0]
    gathered = port_par.collective.all_gather(xs, mesh, ("dcn", "shard"), tiled=True)
    assert gathered[3].tolist() == [0, 0, 1, 10, 2, 20, 3, 30]
    assert [t.tolist() for t in port_par.collective.pmax(xs, mesh, "dcn")] == [[2, 20], [3, 30], [2, 20], [3, 30]]


# --------------------------------------------------------------------- CLI


def _tagged_bam(tmp_path, name, seed, tags):
    records, header = random_tagged_records(seed=seed)
    return write_bam(tmp_path / f"{name}.bam", list(sort_by_tags_and_queryname(records, tags)), header)


@pytest.fixture(scope="module")
def mito_gtf(tmp_path_factory):
    return write_gtf(str(tmp_path_factory.mktemp("parallel_gtf") / "mito.gtf"), [
        dict(gene_id="ACTB", gene_name="ACTB"), dict(gene_id="mt-Nd1", gene_name="mt-Nd1"),
        dict(gene_id="GAPDH", gene_name="GAPDH"),
    ])


def _three_ways(tmp_path, entry, args, csv=True):
    """``entry`` with ``--devices 2`` on the port (CPU mesh) and on JAX, and
    on the port's one device; returns the three output stems."""
    stems = {side: str(tmp_path / side) for side in ("mesh", "jax", "single")}
    assert getattr(port_platform.GenericPlatform, entry)(
        args(stems["mesh"]) + ["--devices", "2"], device="cpu") == 0
    getattr(jax_platform.GenericPlatform, entry)(args(stems["jax"]) + ["--devices", "2"])
    assert getattr(port_platform.GenericPlatform, entry)(args(stems["single"]), device="cpu") == 0
    return stems


@pytest.mark.parametrize("kind,seed", [("cell", 0), ("cell", 2), ("gene", 3)])
def test_metric_commands_on_two_devices_match_jax(tmp_path, mito_gtf, kind, seed):
    bam = _tagged_bam(tmp_path, "in", seed, ["CB", "UB", "GE"] if kind == "cell" else ["GE", "CB", "UB"])
    extra = ["-a", mito_gtf] if kind == "cell" else []
    stems = _three_ways(tmp_path, f"calculate_{kind}_metrics", lambda o: ["-i", bam, "-o", o] + extra)
    assert_csv_match(stems["mesh"] + ".csv.gz", stems["jax"] + ".csv.gz")
    assert _csv(stems["mesh"] + ".csv.gz") == _csv(stems["single"] + ".csv.gz")


def test_sharded_mito_wire_matches_one_device(tmp_path):
    """test_parallel's mito case: the mito bit rides the pair slot of the
    prepacked wire on every shard, and the CSV stays the one-device CSV."""
    rng = random.Random(23)
    records = []
    for cb in sorted("".join(rng.choice("ACGT") for _ in range(8)) for _ in range(60)):
        for i in range(6):
            records.append(make_record(
                name=f"{cb}{i}", cb=cb, cr=cb, cy="IIII", ub="".join(rng.choice("ACGT") for _ in range(4)),
                ur="ACGT", uy="IIII", ge=rng.choice(["ACTB", "mt-Nd1", "MT-CO1"]), xf="CODING", nh=1,
                pos=rng.randrange(1000)))
    bam = write_bam(str(tmp_path / "mito.bam"), list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])))
    assert port_gatherer.prepacked_gate(port_packed.frame_from_bam(bam), "cell")
    mito = {"mt-Nd1", "MT-CO1"}
    port_gatherer.GatherCellMetrics(bam, str(tmp_path / "single"), mito, device="cpu").extract_metrics()
    gatherer = port_par.ShardedCellMetrics(bam, str(tmp_path / "sharded"), mito, mesh=_meshes(4)[0],
                                           batch_records=100)
    gatherer.extract_metrics()
    jax_par.ShardedCellMetrics(bam, str(tmp_path / "jax"), mito, mesh=_meshes(4)[1]).extract_metrics()
    assert _csv(tmp_path / "sharded.csv.gz") == _csv(tmp_path / "single.csv.gz")
    assert_csv_match(tmp_path / "sharded.csv.gz", tmp_path / "jax.csv.gz")
    assert len(gatherer.batches) > 2 and all(b["prepacked"] and b["shards"] == 4 for b in gatherer.batches)
    lines = [line.split(",") for line in _csv(tmp_path / "sharded.csv.gz").decode().strip().split("\n")]
    column = lines[0].index("n_mitochondrial_molecules")
    assert sum(int(line[column]) for line in lines[1:]) > 0


@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_fused_tagsort_on_two_devices_matches_jax(tmp_path, mito_gtf, kind):
    records, header = random_tagged_records(seed=5)
    rng = random.Random(5)
    rng.shuffle(records)
    bam = write_bam(tmp_path / "shuffled.bam", records, header)
    tags, flag = (["CB", "UB", "GE"], "--cell-metrics-output") if kind == "cell" else (
        ["GE", "CB", "UB"], "--gene-metrics-output")
    extra = ["-a", mito_gtf] if kind == "cell" else []
    stems = _three_ways(tmp_path, "tag_sort_bam", lambda o: ["-i", bam, "-t", *tags, flag, o] + extra)
    assert_csv_match(stems["mesh"] + ".csv.gz", stems["jax"] + ".csv.gz")
    assert _csv(stems["mesh"] + ".csv.gz") == _csv(stems["single"] + ".csv.gz")


def test_count_matrix_on_two_devices_matches_jax(tmp_path):
    data = SyntheticCountData()
    records = data.records()
    bam = write_bam(str(tmp_path / "count.bam"), records, data.header)
    gtf_path = _gtf_with_repeats(tmp_path)
    stems = _three_ways(tmp_path, "bam_to_count_matrix",
                        lambda o: ["-b", bam, "-a", gtf_path, "-o", o, "--batch-records", "64"])
    mesh = port_count.CountMatrix.load(stems["mesh"])
    _assert_same_matrix(mesh, port_count.CountMatrix.load(stems["jax"]))
    _assert_same_matrix(mesh, port_count.CountMatrix.load(stems["single"]))
    assert int(mesh.matrix.sum()) == int(data.matrix.sum())
    # the accumulator's own record of a sharded run
    matrix = port_count.CountMatrix.from_sorted_tagged_bam(
        bam, GENE_TO_INDEX, batch_records=64, mesh=_meshes(4)[0])
    _assert_same_matrix(matrix, port_count.CountMatrix.from_sorted_tagged_bam(bam, GENE_TO_INDEX, device="cpu"))
    assert len(matrix.batches) > 1 and sum(b["records"] for b in matrix.batches) == len(records)


def _metric_csv(path, names, seed, columns, float_columns=()):
    rng = np.random.default_rng(seed)
    rows = []
    for name in names:
        values = [str(int(v)) for v in rng.integers(1, 50, len(columns))]
        values += [repr(float(v)) for v in rng.random(len(float_columns)) * 40]
        rows.append(",".join([name] + values))
    with gzip.open(path, "wt") as f:
        f.write(",".join([""] + list(columns) + list(float_columns)) + "\n" + "\n".join(rows) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def gene_parts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_merge")
    count, weighted = JaxMergeGene.COUNT_COLUMNS_TO_SUM, JaxMergeGene.READ_WEIGHTED_COLUMNS
    return [
        _metric_csv(tmp / f"g{i}.csv.gz", names, 3 + i, count, weighted)
        for i, names in enumerate((["ACT", "TUB", "GAP"], ["TUB", "MYC"], ["ACT", "MYC", "ZZZ"]))
    ]


@pytest.mark.parametrize("kind", ["cell", "gene"])
def test_metric_merges_on_two_devices_match_jax(tmp_path, gene_parts, kind):
    if kind == "cell":
        files = [_metric_csv(tmp_path / "a.csv.gz", ["AAA", "CCC"], 1, ["n_reads"], ["quality_mean"]),
                 _metric_csv(tmp_path / "b.csv.gz", ["GGG", "TTT"], 2, ["n_reads"], ["quality_mean"]),
                 _metric_csv(tmp_path / "c.csv.gz", ["ACG"], 3, [], ["n_reads", "quality_mean"])]
    else:
        files = gene_parts
    stems = _three_ways(tmp_path, f"merge_{kind}_metrics", lambda o: [*files, "-o", o])
    mesh = _csv(stems["mesh"] + ".csv.gz")
    assert mesh == _csv(stems["jax"] + ".csv.gz") == _csv(stems["single"] + ".csv.gz")
    assert mesh.count(b"\n") == 6


def test_collective_gene_merge_of_gatherer_csvs(tmp_path, gene_parts):
    """Gatherer gene CSVs hold a "None" row (records without GE), which the
    file-level merge drops; the port's collective merge does the same (the
    JAX one raises TypeError sorting its vocabulary), on 4 shards."""
    files = []
    for seed in (0, 1):
        bam = _tagged_bam(tmp_path, f"g{seed}", seed, ["GE", "CB", "UB"])
        port_gatherer.GatherGeneMetrics(bam, str(tmp_path / f"g{seed}"), device="cpu").extract_metrics()
        files.append(str(tmp_path / f"g{seed}.csv.gz"))
    assert b"\nNone," in _csv(files[0])
    port_collective.CollectiveMergeGeneMetrics(files, str(tmp_path / "coll"), mesh=_meshes(4)[0]).execute()
    port_merge.MergeGeneMetrics(files, str(tmp_path / "host")).execute()
    assert _csv(tmp_path / "coll.csv.gz") == _csv(tmp_path / "host.csv.gz")
    with pytest.raises(TypeError):
        JaxCollectiveGene(files, str(tmp_path / "jax"), mesh=_meshes(4)[1]).execute()


@pytest.mark.parametrize("copies,n_reads", [(2, 2**33), (8, 1_500_000_000)], ids=["one-shard", "across-shards"])
def test_gene_merge_refuses_int32_overflow_like_jax(tmp_path, copies, n_reads):
    """One value past int32 in a shard's partial, or partials that each fit
    but sum past it across the shards (8 copies on 8 shards)."""
    count, weighted = JaxMergeGene.COUNT_COLUMNS_TO_SUM, JaxMergeGene.READ_WEIGHTED_COLUMNS
    values = ["1"] * len(count)
    values[count.index("n_reads")] = str(n_reads)
    path = tmp_path / "part.csv.gz"
    with gzip.open(path, "wt") as f:
        f.write(",".join([""] + count + weighted) + "\nACT," + ",".join(values + ["0.5"] * len(weighted)) + "\n")
    errors = []
    for cls, mesh in ((port_collective.CollectiveMergeGeneMetrics, port_par.make_mesh(8, device="cpu")),
                      (JaxCollectiveGene, jax_par.make_mesh(8))):
        with pytest.raises(ValueError, match="int32") as error:
            cls([str(path)] * copies, str(tmp_path / "out"), mesh=mesh).execute()
        errors.append(str(error.value))
    assert errors[0] == errors[1]
    assert not list(tmp_path.glob("out*"))


def test_collective_merges_refuse_what_jax_refuses(tmp_path):
    a = tmp_path / "a.csv.gz"
    with gzip.open(a, "wt") as f:
        f.write(",n_reads,passed_qc\nAAA,3,True\n")
    b = _metric_csv(tmp_path / "b.csv.gz", ["CCC"], 1, ["n_reads", "other"])
    mesh = _meshes(2)[0]
    with pytest.raises(ValueError, match="non-numeric"):
        port_collective.CollectiveMergeCellMetrics([str(a), str(a)], str(tmp_path / "o"), mesh=mesh).execute()
    with pytest.raises(ValueError, match="disagree on columns"):
        port_collective.CollectiveMergeCellMetrics([b, str(a)], str(tmp_path / "o"), mesh=mesh).execute()


def test_too_many_devices_stop_at_the_parser_like_jax(tmp_path, capsys):
    """More devices than the machine has: JAX's parser error, with each
    package's own count of what is available (the CPU's cores here)."""
    n = max(os.cpu_count() or 1, len(jax.devices())) + 1
    args = ["-i", "missing.bam", "-o", str(tmp_path / "o"), "--devices", str(n)]
    errors = []
    for module, kwargs in ((port_platform, {"device": "cpu"}), (jax_platform, {})):
        with pytest.raises(SystemExit) as stop:
            module.GenericPlatform.calculate_cell_metrics(args, **kwargs)
        assert stop.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    pattern = r"error: requested (\d+) devices, only (\d+) available"
    port_match, jax_match = re.search(pattern, errors[0]), re.search(pattern, errors[1])
    assert port_match and jax_match and port_match.group(1) == jax_match.group(1) == str(n)
    assert port_match.group(2) == str(os.cpu_count())
    assert errors[0].replace(port_match.group(2), "M") == errors[1].replace(jax_match.group(2), "M")
    assert not list(tmp_path.iterdir())


def test_cuda_mesh_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_par.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_platform.GenericPlatform.merge_cell_metrics(["x.csv.gz", "-o", str(tmp_path / "o"), "--devices", "2"])
