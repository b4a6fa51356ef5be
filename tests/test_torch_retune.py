"""The port's autotuner (``sctools_tpu_torch.analysis.retune``) against JAX's.

``--retune`` rewrites a source file, so every case runs on a disposable
copy of ``sctools_tpu_torch`` (JAX's ``retune_tree`` fixture, for the
port) and the module checks that the repository's own
``sctools_tpu_torch/ops/segments.py`` holds the same bytes at its end as at
its start.

- A traced CPU run of the cell pass (``CalculateCellMetrics`` on the CPU,
  its xprof registry dumped into a run directory) drives the whole
  pipeline: suggestions, the derived floors (JAX's ``derive_constants``
  gives the same ones on the same rows), the rewrite, and both gates
  green over the edited copy (SCX5xx clean, the regenerated contract
  covering every signature the run recorded).
- JAX's cases on JAX's synthetic registry: a floor is never raised, the
  derivation clamps to the hard floors, an uncovered signature makes a
  gate reject the edit (exit 5) and restores the file byte for byte, a dry
  run writes nothing, and a run directory without registries fails loudly
  (exit 2), as does a tree with no ``ops/segments.py``.
- The default paths are the port's: the file found is
  ``sctools_tpu_torch/ops/segments.py``, never one under ``sctools_tpu/``.
- The CLI: ``--retune`` with ``--retune-dry-run``, ``--retune-target`` and
  ``--segments-file``, and its exit codes.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``).
"""

import hashlib
import json
import os
import shutil
from pathlib import Path

import pytest

from sctools_tpu.analysis import retune as jax_retune
from sctools_tpu_torch.analysis import retune
from sctools_tpu_torch.analysis.cli import main as cli_main

from test_analysis import _retune_registry

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
SEGMENTS = PORT / "ops" / "segments.py"
PINNED = {"RECORD_BUCKET_MIN": 4096, "ENTITY_BUCKET_MIN": 64}


@pytest.fixture(autouse=True, scope="module")
def _no_parse_store_and_the_repo_untouched():
    saved = os.environ.get("SCTOOLS_TPU_SCX_CACHE")
    os.environ["SCTOOLS_TPU_SCX_CACHE"] = "0"
    before = hashlib.sha256(SEGMENTS.read_bytes()).hexdigest()
    yield
    assert hashlib.sha256(SEGMENTS.read_bytes()).hexdigest() == before
    if saved is None:
        os.environ.pop("SCTOOLS_TPU_SCX_CACHE", None)
    else:
        os.environ["SCTOOLS_TPU_SCX_CACHE"] = saved


@pytest.fixture
def retune_tree(tmp_path):
    """A disposable copy of the port the autotuner may rewrite."""
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copytree(PORT, tree / "sctools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so", "*.o"))
    return tree


def _paths(tree):
    return [str(tree / "sctools_tpu_torch")]


def _segments(tree):
    return tree / "sctools_tpu_torch" / "ops" / "segments.py"


@pytest.fixture(scope="module")
def cell_run(tmp_path_factory):
    """The xprof registry of a traced CPU run of the cell pass."""
    from sctools_tpu_torch import obs
    from sctools_tpu_torch.obs import xprof
    from sctools_tpu_torch.platform import GenericPlatform

    from helpers import write_bam
    from sctools_tpu.bam import sort_by_tags_and_queryname
    from test_metrics import random_tagged_records

    base = tmp_path_factory.mktemp("cell_run")
    records, header = random_tagged_records(seed=4)
    bam = write_bam(base / "cell.bam", list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])), header)
    run = base / "run"
    run.mkdir()
    was = obs.enabled()
    obs.enable()
    xprof.reset()
    try:
        assert GenericPlatform.calculate_cell_metrics(["-i", bam, "-o", str(base / "cell")], device="cpu") == 0
        assert xprof.dump(str(run / "xprof.cell.json"), worker="cell")
    finally:
        xprof.reset()
        if not was:
            obs.disable()
    return run


def test_retune_of_a_traced_cpu_cell_pass_rewrites_and_gates_green(retune_tree, cell_run):
    from sctools_tpu_torch.obs import xprof

    segments = _segments(retune_tree)
    assert retune.read_constants(str(segments)) == PINNED
    lines = []
    code, report = retune.retune(str(cell_run), _paths(retune_tree), out=lines.append)
    assert code == 0, lines
    assert report["applied"] and report["gates"]["shardcheck"]["ok"] and report["gates"]["shape_contract"]["ok"]
    written = retune.read_constants(str(segments))
    assert written["RECORD_BUCKET_MIN"] < PINNED["RECORD_BUCKET_MIN"]
    assert written == {name: entry["derived"] for name, entry in report["constants"].items()}
    record = report["constants"]["RECORD_BUCKET_MIN"]
    assert record["projected_occupancy"] > record["observed_occupancy"]
    assert "metrics.compute_entity_metrics" in record["sites"]
    # JAX's derivation, on the same suggestion rows, pins the same floors
    suggestions = xprof.suggest_buckets(xprof.efficiency_report(str(cell_run)))
    assert jax_retune.derive_constants(suggestions, PINNED) == retune.derive_constants(suggestions, PINNED)
    assert any(line.startswith("scx-cost --retune: pinned") for line in lines)


def test_retune_never_raises_a_floor(tmp_path, retune_tree):
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run), record_mean=500000, entity_mean=4000)
    code, report = retune.retune(str(run), _paths(retune_tree), out=lambda s: None)
    assert code == 0 and report["applied"] is False and report["changed"] == {}
    assert retune.read_constants(str(_segments(retune_tree))) == PINNED


def test_retune_clamps_to_hard_floor(tmp_path, retune_tree):
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run), record_mean=3, entity_mean=1)
    code, report = retune.retune(str(run), _paths(retune_tree), out=lambda s: None)
    assert code == 0 and report["applied"]
    assert retune.read_constants(str(_segments(retune_tree))) == retune.HARD_FLOORS == jax_retune.HARD_FLOORS


def test_retune_gate_rejects_uncovered_signature(tmp_path, retune_tree):
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run), signature="(int32[12345], bool[12345])")
    segments = _segments(retune_tree)
    original = segments.read_bytes()
    lines = []
    code, report = retune.retune(str(run), _paths(retune_tree), out=lines.append)
    assert code == 5, lines
    assert report["applied"] is False and report["gates"]["shardcheck"]["ok"]
    assert not report["gates"]["shape_contract"]["ok"]
    assert any("12345" in v for v in report["gates"]["shape_contract"]["violations"])
    assert segments.read_bytes() == original
    assert not list(segments.parent.glob("segments.py.tmp.*"))


def test_retune_dry_run_writes_nothing(tmp_path, retune_tree):
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run))
    segments = _segments(retune_tree)
    original = segments.read_bytes()
    code, report = retune.retune(str(run), _paths(retune_tree), apply=False, out=lambda s: None)
    assert code == 0 and report["applied"] is False
    # mean 300 real rows -> 512; mean 20 entities -> 32, as in JAX
    assert report["changed"] == {"RECORD_BUCKET_MIN": 512, "ENTITY_BUCKET_MIN": 32}
    assert segments.read_bytes() == original


def test_retune_without_registries_or_segments_fails_loudly(tmp_path, retune_tree):
    empty = tmp_path / "empty"
    empty.mkdir()
    lines = []
    assert retune.retune(str(empty), _paths(retune_tree), out=lines.append)[0] == 2
    assert "no xprof registries" in lines[0]
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run))
    lines = []
    assert retune.retune(str(run), [str(retune_tree / "sctools_tpu_torch" / "serve")], out=lines.append)[0] == 2
    assert "no ops/segments.py" in lines[0]


def test_the_default_paths_find_the_ports_segments_file(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    found = retune.find_segments_file(["sctools_tpu_torch"])
    assert Path(found).resolve() == SEGMENTS
    assert "sctools_tpu" not in Path(found).resolve().relative_to(REPO).parts
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run))
    seen = []
    real = retune.find_segments_file
    monkeypatch.setattr(retune, "find_segments_file", lambda paths: seen.append(paths) or real(paths))
    assert cli_main(["--retune", str(run), "--retune-dry-run"]) == 0
    assert seen == [["sctools_tpu_torch"]]


def test_cli_retune_flags(tmp_path, retune_tree, capsys):
    run = tmp_path / "run"
    run.mkdir()
    _retune_registry(str(run))
    segments = _segments(retune_tree)
    original = segments.read_bytes()
    argv = ["--retune", str(run), "--retune-dry-run", "--retune-target", "0.5", "--segments-file", str(segments),
            str(retune_tree / "sctools_tpu_torch" / "metrics")]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "RECORD_BUCKET_MIN: 4096 -> 512" in out and "dry run; no file written" in out
    assert segments.read_bytes() == original
    assert cli_main(["--retune", str(tmp_path / "nothing-here"), str(retune_tree / "sctools_tpu_torch")]) == 2
    report = json.loads((run / "xprof.w0.json").read_text())
    assert report["sites"]
