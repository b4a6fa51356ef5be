"""scx-aot on the port (``sctools_tpu_torch.analysis.aotcheck``) against JAX's.

- Parity: on JAX's SCX904 and SCX905 fixtures the port's pass gives JAX's
  (rule, line) set; SCX901-903 use JAX-only spellings (``instrument_jit``,
  ``jax.jit``, ``.lower().compile()``, ``jax.config.update``), so each has a
  torch twin here (``xprof.instrument_site``, CUDA graph captures,
  ``torch.compile``, a ``torch.backends`` write) whose findings equal its
  ``# <- SCXnnn`` marks and whose count per rule equals JAX's on its
  fixture. Every clean fixture of JAX's and every clean twin is silent.
  The port's first-use kernel and native loads have a case of their own.
- The real tree and the smoke are clean; escapes work.
- The manifest: it names the port's serve entry and JAX's 13 sites;
  ``metrics.compute_entity_metrics`` is serve-reachable, its path running
  from ``ServeWorker.serve_forever`` through the gatherer into
  ``serve/graphs.py``'s ``GraphSet.run`` and ``capture`` (JAX's committed
  manifest marks no site reachable: its name-resolved model loses the
  call at the engine); a tampered manifest is rejected, a manifest
  certified for another tree is stale, and the committed
  ``serve/graph_manifest.json`` is fresh.
- The regenerated contract admits exactly the dims the hand-kept one
  (``serve/manifest.py``'s before the AOT pass generated the manifest)
  admitted (the steering controller's ladders and a set of raw sizes), and
  a controller built on it accepts the same buckets.
- The CLI: ``--aot-only``, ``--no-aot``, ``--json``, ``--emit-aot-manifest``
  and the ``--aot-manifest`` staleness gate.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``); each model over the
real tree is built once for the module.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from sctools_tpu.analysis import aotcheck as jax_aotcheck
from sctools_tpu_torch.analysis import aotcheck, shardcheck
from sctools_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
SMOKE = REPO / "chip_smoke.py"
AOT = REPO / "tests" / "fixtures_scxlint" / "aotcheck"
COMMITTED = PORT / "serve" / "graph_manifest.json"
JAX_MANIFEST = REPO / "sctools_tpu" / "serve" / "aot_manifest.json"
RULES = ["SCX901", "SCX902", "SCX903", "SCX904", "SCX905"]
SAME_FILE_RULES = ["SCX904", "SCX905"]
SERVE_ENTRY = "sctools_tpu_torch.serve.engine.ServeWorker.serve_forever"

# the contract serve/manifest.py kept by hand before the AOT pass made the manifest
HAND_KEPT_CONTRACT = {
    "bucket_minimums": [64, 4096], "pow2_min": 8, "small_dim_max": 256, "version": 1,
    "wire": {"header_words": 1, "max_record_bytes": 72, "min_record_bytes": 12, "pad_min": 4096,
             "run_table_lanes": 2},
}


@pytest.fixture(autouse=True, scope="module")
def _no_parse_store():
    saved = os.environ.get("SCTOOLS_TPU_SCX_CACHE")
    os.environ["SCTOOLS_TPU_SCX_CACHE"] = "0"
    yield
    if saved is None:
        os.environ.pop("SCTOOLS_TPU_SCX_CACHE", None)
    else:
        os.environ["SCTOOLS_TPU_SCX_CACHE"] = saved


@pytest.fixture(scope="module")
def contract():
    return shardcheck.build_shape_contract([str(PORT)])


@pytest.fixture(scope="module")
def model():
    return aotcheck.build_model([str(PORT)])


@pytest.fixture(scope="module")
def manifest(contract, model):
    return aotcheck.build_aot_manifest([str(PORT)], contract, model)


def rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def marked_lines(text: str, rule: str):
    return [n for n, line in enumerate(text.splitlines(), 1) if f"# <- {rule}" in line]


# -------------------------------------------------------- the torch twins

TWIN_SCX901_BAD = '''"""SCX901 bad twin: a device site on the serve path whose dims no caller
buckets."""
from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.serve.api import serve_entry


@xprof.instrument_site("fixture.serve_kernel")
def serve_kernel(cols):
    return cols


@serve_entry
def handle(frame):
    return serve_kernel(frame)  # <- SCX901
'''

TWIN_SCX901_CLEAN = '''"""SCX901 clean twin: the entry buckets the site's dims."""
from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.ops.segments import bucket_size
from sctools_tpu_torch.serve.api import serve_entry


@xprof.instrument_site("fixture.serve_kernel_closed")
def serve_kernel_closed(cols):
    return cols


@serve_entry
def handle(frame):
    n = bucket_size(len(frame))
    return serve_kernel_closed(frame[:n])
'''

TWIN_SCX902_BAD = '''"""SCX902 bad twin: captures and compiles on the request path."""
import torch

from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.ops.segments import bucket_size
from sctools_tpu_torch.serve.api import serve_entry


@xprof.instrument_site("fixture.kernel")
def kernel(cols):
    return cols


@serve_entry
def handle(frame, graphs):
    n = bucket_size(len(frame))
    graphs.capture(frame[:n])  # <- SCX902
    return kernel(frame[:n])


@serve_entry
def handle_raw(frame):
    graph = torch.cuda.CUDAGraph()  # <- SCX902
    return graph, frame


@serve_entry
def handle_compiled(frame):
    n = bucket_size(len(frame))
    return torch.compile(kernel)(frame[:n])  # <- SCX902
'''

TWIN_SCX902_CLEAN = '''"""SCX902 clean twin: the captures live in a warmup step; the request
path replays."""
import torch

from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.ops.segments import bucket_size
from sctools_tpu_torch.serve.api import serve_entry, warmup_step


@xprof.instrument_site("fixture.kernel")
def kernel(cols):
    return cols


@warmup_step
def warm(frame, graphs):
    n = bucket_size(len(frame))
    graphs.capture(frame[:n])
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        kernel(frame[:n])


@serve_entry
def handle(frame, graphs):
    n = bucket_size(len(frame))
    return graphs.run(frame[:n])
'''

TWIN_SCX903_BAD = '''"""SCX903 bad twin: per-request host state on a serve path."""
import datetime
import os

import torch

from sctools_tpu_torch.serve.api import serve_entry


@serve_entry
def handle(frame):
    flags = os.environ.get("FIXTURE_FLAGS", "")  # <- SCX903
    torch.backends.cudnn.benchmark = bool(flags)  # <- SCX903
    stamp = datetime.datetime.now().isoformat()  # <- SCX903
    return frame, stamp


@serve_entry
def handle_getenv(frame):
    mode = os.getenv("FIXTURE_MODE", "fast")  # <- SCX903
    return frame, mode
'''

TWIN_SCX903_CLEAN = '''"""SCX903 clean twin: host state resolved once, at import."""
import os

import torch

from sctools_tpu_torch.serve.api import serve_entry

_FLAGS = os.environ.get("FIXTURE_FLAGS", "")
_MODE = os.getenv("FIXTURE_MODE", "fast")
torch.backends.cudnn.benchmark = False


@serve_entry
def handle(frame):
    return frame, _FLAGS, _MODE
'''

TWINS = {
    "SCX901": (TWIN_SCX901_BAD, TWIN_SCX901_CLEAN),
    "SCX902": (TWIN_SCX902_BAD, TWIN_SCX902_CLEAN),
    "SCX903": (TWIN_SCX903_BAD, TWIN_SCX903_CLEAN),
}

# SCX904's port spellings: a hand kernel's or the native layer's first use
PORT_SCX904 = '''from sctools_tpu_torch import kernels, native
from sctools_tpu_torch.serve.api import serve_entry, warmup_step


@warmup_step
def warm():
    return kernels.library("whitelist_correct"), native.library()


@serve_entry
def handle(frame):
    lib = kernels.library("whitelist_correct")  # <- SCX904
    return native.library(), lib, frame  # <- SCX904
'''


def _jax_fixture_counts(rule):
    findings = jax_aotcheck.check_aot([str(AOT / f"{rule.lower()}_bad.py")])
    return len([f for f in findings if f.rule == rule])


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", SAME_FILE_RULES)
def test_aot_pass_matches_jax_on_its_fixtures(rule, kind):
    path = str(AOT / f"{rule.lower()}_{kind}.py")
    want = rule_lines(jax_aotcheck.check_aot([path]))
    assert rule_lines(aotcheck.check_aot([path])) == want
    assert bool(want) == (kind == "bad")


@pytest.mark.parametrize("rule", RULES)
def test_jax_clean_fixture_is_silent(rule):
    assert aotcheck.check_aot([str(AOT / f"{rule.lower()}_clean.py")]) == []


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires_on_its_marks_and_counts_as_jax(tmp_path, rule):
    bad = TWINS[rule][0]
    path = tmp_path / f"{rule.lower()}_bad.py"
    path.write_text(bad)
    got = rule_lines(aotcheck.check_aot([str(path)]))
    assert got == [(rule, line) for line in marked_lines(bad, rule)]
    assert len(got) == _jax_fixture_counts(rule)


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_clean_is_silent(tmp_path, rule):
    path = tmp_path / f"{rule.lower()}_clean.py"
    path.write_text(TWINS[rule][1])
    assert aotcheck.check_aot([str(path)]) == []


def test_scx904_holds_kernel_and_native_loads(tmp_path):
    path = tmp_path / "loads.py"
    path.write_text(PORT_SCX904)
    assert rule_lines(aotcheck.check_aot([str(path)])) == [
        ("SCX904", line) for line in marked_lines(PORT_SCX904, "SCX904")]


# ---------------------------------------------------------- the real tree

def test_real_tree_and_smoke_are_clean(contract):
    findings = aotcheck.check_aot([str(PORT), str(SMOKE)], contract)
    assert findings == [], [f.render() for f in findings]


def test_inline_escape(tmp_path):
    src = (
        "import os\n\n"
        "from sctools_tpu_torch.serve.api import serve_entry\n\n\n"
        "@serve_entry\n"
        "def handle(request):\n"
        "    mode = os.environ.get('MODE')  # scx-lint: disable=SCX903 -- pinned at spawn, never varies\n"
        "    return mode\n"
    )
    path = tmp_path / "suppressed_serve.py"
    path.write_text(src)
    assert aotcheck.check_aot([str(path)]) == []
    path.write_text(src.split("  # scx-lint")[0] + "\n    return mode\n")
    assert rule_lines(aotcheck.check_aot([str(path)])) == [("SCX903", 8)]


# ------------------------------------------------------------ the manifest

def test_manifest_names_the_real_universe(manifest):
    jax = json.loads(JAX_MANIFEST.read_text())
    assert manifest["version"] == jax["version"] == aotcheck.MANIFEST_VERSION
    assert set(manifest) == set(jax)
    assert manifest["serve_entries"] == [SERVE_ENTRY]
    assert manifest["contract_hash"] == aotcheck.contract_hash(manifest["contract"])
    assert set(manifest["sites"]) == set(jax["sites"])
    reachable = {name for name, entry in manifest["sites"].items() if entry["serve_reachable"]}
    assert reachable == {"metrics.compute_entity_metrics", "metrics.compact_results_wire"}
    assert not any(entry["serve_reachable"] for entry in jax["sites"].values())
    for name, entry in manifest["sites"].items():
        assert entry["precompile"] == (entry["dims"] == "bucketed") == jax["sites"][name]["precompile"], name


def test_the_engine_is_reached_through_the_graph_set(model):
    reach = model.serve_reach
    assert SERVE_ENTRY in reach
    for qual in ("sctools_tpu_torch.serve.graphs.GraphSet.run", "sctools_tpu_torch.serve.graphs.GraphSet.capture",
                 "sctools_tpu_torch.metrics.gatherer.MetricGatherer._dispatch_device_batch"):
        assert qual in reach, qual
    refs = {site for qual in reach for site, _ in model.functions[qual].jit_refs}
    assert "metrics.compute_entity_metrics" in refs
    capture = model.functions["sctools_tpu_torch.serve.graphs.GraphSet.capture"]
    assert ("metrics.compute_entity_metrics" in {site for site, _ in capture.jit_refs})
    # the capture is a compile on the request path, escaped with its reason
    assert capture.compile_calls
    # warmup is exempt: it captures the rungs before admission
    warmup = model.functions["sctools_tpu_torch.serve.engine.ServeWorker.warmup"]
    assert warmup.is_warmup and warmup.qual not in reach


def test_manifest_rejects_tamper_and_staleness(manifest, contract):
    assert aotcheck.validate_manifest(manifest, [str(PORT)], fresh=contract) == []
    tampered = dict(manifest, contract_hash="0" * 64)
    problems = aotcheck.validate_manifest(tampered, [str(PORT)], fresh=contract)
    assert problems and any("hash mismatch" in p for p in problems)
    stale = aotcheck.validate_manifest(manifest, [str(AOT)])
    assert stale and any("--emit-aot-manifest" in p for p in stale)


def test_committed_manifest_is_fresh(manifest, contract):
    committed = json.loads(COMMITTED.read_text())
    assert aotcheck.validate_manifest(committed, [str(PORT)], fresh=contract) == []
    assert committed == manifest


def _ladder_dims():
    rungs = [1 << k for k in range(3, 24)]
    raw = list(range(0, 1 << 13)) + [int(d) for d in np.random.default_rng(5).integers(0, 1 << 22, size=20_000)]
    return rungs + raw


def test_the_regenerated_contract_admits_what_the_hand_kept_one_did(contract):
    dims = _ladder_dims()
    assert [shardcheck.dim_admissible(d, contract) for d in dims] == [
        shardcheck.dim_admissible(d, HAND_KEPT_CONTRACT) for d in dims]


def test_steering_accepts_the_same_buckets_under_both_contracts(contract):
    from sctools_tpu_torch import steer

    for static in (4096, 8192, 1 << 16, 1 << 20):
        ours = steer.SteerController(static, contract=contract)
        before = steer.SteerController(static, contract=HAND_KEPT_CONTRACT)
        assert ours.ladder() == before.ladder()
        for bucket in [1 << k for k in range(8, 24)] + [4097, 5000, 12288, 24577]:
            assert ours._admissible(bucket) == before._admissible(bucket), (static, bucket)


# ----------------------------------------------------------------- the CLI

def _corpus(tmp_path, kind):
    corpus = tmp_path / kind
    corpus.mkdir()
    for rule in SAME_FILE_RULES:
        (corpus / f"{rule.lower()}_{kind}.py").write_text((AOT / f"{rule.lower()}_{kind}.py").read_text())
    for rule, pair in TWINS.items():
        (corpus / f"{rule.lower()}_{kind}.py").write_text(pair[kind == "clean"])
    return corpus


def test_cli_aot_only_and_no_aot(tmp_path, capsys):
    assert cli_main(["--aot-only", str(_corpus(tmp_path, "clean"))]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "passes: aot;" in out
    bad = str(_corpus(tmp_path, "bad"))
    assert cli_main(["--aot-only", bad]) == 1
    out = capsys.readouterr().out
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == set(RULES)
    assert cli_main(["--shard-only", "--aot-only", bad]) == 1
    assert "passes: shard, aot;" in capsys.readouterr().out
    cli_main(["--no-aot", "--no-race", "--no-shard", "--no-life", "--no-cost", "--no-mesh", bad])
    out = capsys.readouterr().out
    assert "passes: lint;" in out and ": SCX9" not in out


def test_cli_json_covers_the_aot_pass(tmp_path, capsys):
    assert cli_main(["--json", "--aot-only", str(_corpus(tmp_path, "bad"))]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == set(RULES)


def test_cli_emit_aot_manifest_and_its_gate(tmp_path, capsys):
    corpus = str(_corpus(tmp_path, "clean"))
    dest = tmp_path / "manifest.json"
    assert cli_main(["--emit-aot-manifest", str(dest), corpus]) == 0
    assert "scx-aot: wrote" in capsys.readouterr().out
    written = json.loads(dest.read_text())
    assert written["serve_entries"] and written["sites"]
    assert cli_main(["--aot-only", "--aot-manifest", str(dest), corpus]) == 0
    assert "matches the fresh shape contract" in capsys.readouterr().out
    # stale against another tree, then hand-edited: the gate fails both
    assert cli_main(["--aot-only", "--aot-manifest", str(dest), str(_corpus(tmp_path, "bad"))]) == 1
    assert "STALE" in capsys.readouterr().err
    written["contract_hash"] = "0" * 64
    dest.write_text(json.dumps(written))
    assert cli_main(["--aot-only", "--aot-manifest", str(dest), corpus]) == 1
    assert "hash mismatch" in capsys.readouterr().err
    assert cli_main(["--aot-only", "--aot-manifest", str(tmp_path / "missing.json"), corpus]) == 1
