"""scx-shard on the port (``sctools_tpu_torch.analysis.shardcheck``) against JAX's.

- Parity: on JAX's SCX502 fixtures the port's pass gives JAX's (rule, line)
  set; SCX501, SCX503, SCX504 and SCX505 use JAX-only spellings
  (``PartitionSpec``, ``shard_map``, ``lax``, ``instrument_jit``), so each
  has a torch twin here (``mesh.groups``, ``meshwitness.mapped`` over the
  ``parallel.collective`` wrappers, ``xprof.instrument_site``, SCX703's
  syncs) whose findings equal its ``# <- SCXnnn`` marks and whose count per
  rule equals JAX's on its fixture. JAX's two clauses with no port spelling
  (SCX501's ``in_specs`` arity, SCX504's unpartitioned axis) are stood in
  for by a second line of the clause that is ported. Every clean fixture
  of JAX's and every clean twin is silent. The port's own spellings (a
  per-shard device, a graph set's keyword arguments) have cases of their
  own.
- The real tree and the smoke are clean; escapes work; a reassignment
  clears the taint.
- The contract: ``dim_admissible`` and ``check_signatures`` give JAX's
  answers on the same contract and signatures (JAX's accept/reject cases,
  the overflow marker), the port's per-shard tag ``@(shards)`` passes at a
  sharded site and fails at one that is not, and every bucket output and
  wire length the port's tables can make is admitted.
- The port's contract over ``sctools_tpu_torch`` has JAX's 13 site names,
  with JAX's ``dims`` and ``sharded`` per site (JAX's side is its committed
  ``aot_manifest.json``, which JAX's own tests hold fresh). What differs,
  on purpose: the ``module`` names (the package's), the two whitelist
  sites' ``static_argnames`` (the port's plain pass takes the table object
  and a chunk, its kernel the table: JAX's ``length`` and tile sizes are
  the kernel's build parameters there), and the ``statics`` value sets
  (every caller of the port's engine passes ``kind`` as a variable, so the
  set is open and empty where JAX's lists ``'cell'`` and ``'gene'``).
- Every signature that traced CPU runs of the cell pass (one device and
  ``--devices 2``), the gene pass on two shards, the count (both) and a
  serve worker record lies inside the port's contract.
- The CLI: ``--shard-only``, ``--no-shard``, composed with ``--race-only``,
  ``--json`` and ``--emit-shape-contract``.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``); each model over the
real tree is built once for the module.
"""

import json
import os
from pathlib import Path

import pytest

from sctools_tpu.analysis import shardcheck as jax_shardcheck
from sctools_tpu_torch.analysis import shardcheck
from sctools_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
SMOKE = REPO / "chip_smoke.py"
SHARD = REPO / "tests" / "fixtures_scxlint" / "shardcheck"
JAX_MANIFEST = REPO / "sctools_tpu" / "serve" / "aot_manifest.json"
RULES = ["SCX501", "SCX502", "SCX503", "SCX504", "SCX505"]
SAME_FILE_RULES = ["SCX502"]


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


def rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def marked_lines(text: str, rule: str):
    return [n for n, line in enumerate(text.splitlines(), 1) if f"# <- {rule}" in line]


# -------------------------------------------------------- the torch twins

TWIN_SCX501_BAD = '''"""SCX501 bad twin: mesh groupings naming an axis no mesh declares."""

SHARD_AXIS = "shard"  # the twin's whole declared axis universe


def rows_of(mesh):
    return mesh.groups("rows")  # <- SCX501


def joint_size(mesh):
    return mesh.axis_size((SHARD_AXIS, "cols"))  # <- SCX501
'''

TWIN_SCX501_CLEAN = '''"""SCX501 clean twin: every grouping names a declared axis, directly or
through a parameter whose default is one."""

SHARD_AXIS = "shard"


def rows_of(mesh):
    return mesh.groups(SHARD_AXIS)


def size(mesh, axis_name=SHARD_AXIS):
    return mesh.axis_size(axis_name)
'''

TWIN_SCX503_BAD = '''"""SCX503 bad twin: a data-dependent scalar reaches a device site's
static argument and a site builder without a bucket helper."""
import functools

from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fixture.kernel")
def kernel(cols, num_segments):
    return cols


def _step(cols, capacity=0):
    return cols


def _build_fixture_step(capacity):
    # a site *builder*: each distinct capacity declares a fresh site
    return xprof.instrument_site("fixture.step")(functools.partial(_step, capacity=capacity))


def dispatch(frame):
    n = len(frame)
    return kernel(frame, num_segments=n)  # <- SCX503


def dispatch_shape(cols):
    rows = cols.shape[0]
    return kernel(cols, num_segments=rows)  # <- SCX503


def dispatch_builder(frame):
    n = len(frame)
    return _build_fixture_step(n)(frame)  # <- SCX503
'''

TWIN_SCX503_CLEAN = '''"""SCX503 clean twin: every data-dependent scalar passes through a bucket
helper first; literals are fine as they are."""
import functools

from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.ops.segments import bucket_size


@xprof.instrument_site("fixture.kernel")
def kernel(cols, num_segments):
    return cols


def _step(cols, capacity=0):
    return cols


def _build_fixture_step(capacity):
    return xprof.instrument_site("fixture.step")(functools.partial(_step, capacity=capacity))


def dispatch(frame):
    n = bucket_size(len(frame))
    return kernel(frame, num_segments=n)


def dispatch_pinned(frame):
    return kernel(frame, num_segments=4096)


def dispatch_builder(frame):
    n = bucket_size(len(frame), minimum=1024)
    return _build_fixture_step(n)(frame)
'''

TWIN_SCX504_BAD = '''"""SCX504 bad twin: a mapped region's collectives name axes no mesh
declares."""
from sctools_tpu_torch.analysis import meshwitness
from sctools_tpu_torch.parallel import collective

SHARD_AXIS = "shard"


@meshwitness.mapped("fixture.kernel")
def kernel(cols, mesh):
    total = collective.psum(cols, mesh, "rows")  # <- SCX504
    peer = collective.pmax(total, mesh, ("cols", SHARD_AXIS))  # <- SCX504
    return peer
'''

TWIN_SCX504_CLEAN = '''"""SCX504 clean twin: the region's collectives run over the declared axis,
directly or through the module's constant."""
from sctools_tpu_torch.analysis import meshwitness
from sctools_tpu_torch.parallel import collective

SHARD_AXIS = "shard"


@meshwitness.mapped("fixture.kernel")
def kernel(cols, mesh, axis_name=SHARD_AXIS):
    total = collective.psum(cols, mesh, SHARD_AXIS)
    index = collective.axis_index(mesh, axis_name)
    return total, index
'''

TWIN_SCX505_BAD = '''"""SCX505 bad twin: host syncs in a helper reachable from a device site."""
from sctools_tpu_torch import ingest
from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fixture.outer")
def outer(cols):
    return summarize(cols)


def summarize(cols):
    first = cols[0].item()  # <- SCX505
    host = ingest.pull(cols, site="fixture.pull").numpy()  # <- SCX505
    total = cols.sum().cpu()  # <- SCX505
    return first + host.sum() + total
'''

TWIN_SCX505_CLEAN = '''"""SCX505 clean twin: the helper stays on the device; host reads happen in
a reporting helper the site never reaches."""
from sctools_tpu_torch import ingest
from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fixture.outer")
def outer(cols):
    return summarize(cols)


def summarize(cols):
    return cols.sum() + cols.max()


def report(result):
    host = ingest.pull(result, site="fixture.report").numpy()
    return float(host[0]) + result.item()
'''

TWINS = {
    "SCX501": (TWIN_SCX501_BAD, TWIN_SCX501_CLEAN),
    "SCX503": (TWIN_SCX503_BAD, TWIN_SCX503_CLEAN),
    "SCX504": (TWIN_SCX504_BAD, TWIN_SCX504_CLEAN),
    "SCX505": (TWIN_SCX505_BAD, TWIN_SCX505_CLEAN),
}

# SCX502's port spelling: a device out of mesh.devices is a shard's, any
# other one in a mesh context is not
PORT_SCX502 = '''from sctools_tpu_torch import ingest


def place(cols, mesh, device):
    out = [ingest.upload(cols[i], mesh.devices[i], site="fix.a") for i in range(mesh.size)]
    for s, card in enumerate(mesh.devices):
        out.append(ingest.upload(cols[s], card, site="fix.b"))
    first = mesh.devices[0]
    out.append(ingest.upload(cols[0], first, site="fix.c"))
    out.append(ingest.upload(cols[0], device, site="fix.d"))  # <- SCX502
    return out


def single(cols, device):
    return ingest.upload(cols, device, site="fix.e")
'''

# SCX503 through a graph set: its keywords are the graph key of the site
# its module names (serve/graphs.py's STATIC_ARGS beside SITE)
PORT_SCX503_GRAPHS = {
    "engine.py": '''from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fix.engine")
def engine(cols, num_segments, kind="cell"):
    return cols
''',
    "graphs.py": '''SITE = "fix.engine"
STATIC_ARGS = (("num_segments", None), ("kind", "cell"))
''',
    "caller.py": '''from sctools_tpu_torch.ops.segments import bucket_size


class Runner:
    def __init__(self, graphs):
        self._graphs = graphs

    def run(self, frame):
        self._graphs.run(frame, num_segments=bucket_size(len(frame)))
        return self._graphs.run(frame, num_segments=len(frame))  # <- SCX503
''',
}

# SCX505's other syncs: tolist() and synchronize() of any receiver
PORT_SCX505_SYNCS = '''import torch

from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fix.outer")
def outer(cols):
    return helper(cols)


def helper(cols):
    torch.cuda.synchronize()  # <- SCX505
    return cols.tolist()  # <- SCX505
'''


def _jax_fixture_counts(rule):
    findings = jax_shardcheck.check_shards([str(SHARD / f"{rule.lower()}_bad.py")])
    return len([f for f in findings if f.rule == rule])


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", SAME_FILE_RULES)
def test_shard_pass_matches_jax_on_its_fixtures(rule, kind):
    path = str(SHARD / f"{rule.lower()}_{kind}.py")
    want = rule_lines(jax_shardcheck.check_shards([path]))
    assert rule_lines(shardcheck.check_shards([path])) == want
    assert bool(want) == (kind == "bad")


@pytest.mark.parametrize("rule", RULES)
def test_jax_clean_fixture_is_silent(rule):
    assert shardcheck.check_shards([str(SHARD / f"{rule.lower()}_clean.py")]) == []


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires_on_its_marks_and_counts_as_jax(tmp_path, rule):
    bad = TWINS[rule][0]
    path = tmp_path / f"{rule.lower()}_bad.py"
    path.write_text(bad)
    got = rule_lines(shardcheck.check_shards([str(path)]))
    assert got == [(rule, line) for line in marked_lines(bad, rule)]
    assert len(got) == _jax_fixture_counts(rule)


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_clean_is_silent(tmp_path, rule):
    path = tmp_path / f"{rule.lower()}_clean.py"
    path.write_text(TWINS[rule][1])
    assert shardcheck.check_shards([str(path)]) == []


def test_scx502_accepts_per_shard_devices_only(tmp_path):
    path = tmp_path / "place.py"
    path.write_text(PORT_SCX502)
    assert rule_lines(shardcheck.check_shards([str(path)])) == [
        ("SCX502", line) for line in marked_lines(PORT_SCX502, "SCX502")]


def test_scx503_reads_a_graph_sets_keywords_as_the_graph_key(tmp_path):
    for name, text in PORT_SCX503_GRAPHS.items():
        (tmp_path / name).write_text(text)
    model = shardcheck.build_model([str(tmp_path)])
    assert model.graph_keys == {"fix.engine": ("num_segments", "kind")}
    got = rule_lines(shardcheck.check_shards([str(tmp_path)], model))
    assert got == [("SCX503", line) for line in marked_lines(PORT_SCX503_GRAPHS["caller.py"], "SCX503")]


def test_scx505_holds_synchronize_and_tolist(tmp_path):
    path = tmp_path / "syncs.py"
    path.write_text(PORT_SCX505_SYNCS)
    assert rule_lines(shardcheck.check_shards([str(path)])) == [
        ("SCX505", line) for line in marked_lines(PORT_SCX505_SYNCS, "SCX505")]


# ---------------------------------------------------------- the real tree

def test_real_tree_and_smoke_are_clean():
    findings = shardcheck.check_shards([str(PORT), str(SMOKE)])
    assert findings == [], [f.render() for f in findings]


def test_inline_escape(tmp_path):
    src = (
        "from sctools_tpu_torch.obs import xprof\n\n\n"
        "@xprof.instrument_site('t.kernel')\n"
        "def kernel(cols, n):\n"
        "    return cols\n\n\n"
        "def dispatch(frame):\n"
        "    n = len(frame)\n"
        "    return kernel(frame, n=n)  "
        "# scx-lint: disable=SCX503 -- bucketed upstream by construction\n"
    )
    path = tmp_path / "suppressed_shard.py"
    path.write_text(src)
    assert shardcheck.check_shards([str(path)]) == []
    path.write_text(src.split("  # scx-lint")[0] + "\n")
    assert rule_lines(shardcheck.check_shards([str(path)])) == [("SCX503", 11)]


def test_taint_cleared_by_reassignment(tmp_path):
    src = (
        "from sctools_tpu_torch.obs import xprof\n\n\n"
        "@xprof.instrument_site('t.kernel')\n"
        "def kernel(cols, n):\n"
        "    return cols\n\n\n"
        "def dispatch(frame):\n"
        "    n = len(frame)\n"
        "    n = 4096\n"
        "    return kernel(frame, n=n)\n"
    )
    path = tmp_path / "retainted_shard.py"
    path.write_text(src)
    assert shardcheck.check_shards([str(path)]) == []


# ------------------------------------------------------------ the contract

def _toy_contract():
    return {
        "version": 1,
        "axis_universe": ["shard"],
        "bucket_minimums": [4096],
        "pad_multiples": [],
        "pow2_min": 8,
        "small_dim_max": 256,
        "wire": {"header_words": 1, "run_table_lanes": 2, "min_record_bytes": 12, "max_record_bytes": 72},
        "sites": {
            "m.kernel": {
                "module": "m", "kind": "jit", "static_argnames": ["kind", "k"], "dims": "bucketed",
                "statics": {"kind": {"open": False, "values": ["'cell'", "'gene'"]},
                            "k": {"open": True, "values": []}},
                "sharded": False, "axes": [],
            },
            "m.sharded": {
                "module": "m", "kind": "shard_map", "static_argnames": [], "dims": "any", "statics": {},
                "sharded": True, "axes": ["shard"],
            },
        },
    }


# JAX's cases: (sites, how many violations, a fragment each must hold)
SIGNATURE_CASES = {
    "accepts_legal_observations": ({
        "m.kernel": {"signatures": {"(int32[4096,16]) {k=8192, kind='cell'}": 1}},
        "m.sharded": {"signatures": {"(float32[2,4096]@(shard))": 1}},
        "m.idle": {"signatures": {}},
    }, 0, ""),
    "rejects_unknown_site": ({"m.rogue": {"signatures": {"(int32[4096])": 1}}}, 1, "not present"),
    "rejects_raw_dim_at_bucketed_site": ({"m.kernel": {"signatures": {"(int32[12345]) {kind='cell'}": 1}}},
                                         1, "12345"),
    "accepts_raw_dim_at_any_site": ({"m.sharded": {"signatures": {"(int32[12345]@(shard))": 1}}}, 0, ""),
    "rejects_undeclared_axis": ({"m.sharded": {"signatures": {"(int32[4096]@(rows))": 1}}}, 1, "rows"),
    "rejects_sharded_operand_at_unsharded_site": (
        {"m.kernel": {"signatures": {"(int32[4096]@(shard)) {kind='cell'}": 1}}}, 1, "non-shard_map"),
    "rejects_static_outside_closed_universe": ({"m.kernel": {"signatures": {"(int32[4096]) {kind='umi'}": 1}}},
                                               1, "kind"),
    "rejects_raw_open_static_int": ({"m.kernel": {"signatures": {"(int32[4096]) {k=5000}": 1}}}, 1, "k=5000"),
    "rejects_undeclared_static_name": ({"m.kernel": {"signatures": {"(int32[4096]) {rows=4096}": 1}}}, 1, "rows"),
    "flags_overflow_marker_as_lost_coverage": ({"m.kernel": {"signatures": {"(other signatures)": 3}}},
                                               1, "overflow"),
}


@pytest.mark.parametrize("case", sorted(SIGNATURE_CASES))
def test_check_signatures_gives_jax_answers(case):
    sites, count, fragment = SIGNATURE_CASES[case]
    port = shardcheck.check_signatures(_toy_contract(), sites)
    assert port == jax_shardcheck.check_signatures(_toy_contract(), sites)
    assert len(port) == count and all(fragment in v for v in port)


def test_the_ports_shard_tag_passes_where_sharded_and_fails_elsewhere():
    contract = _toy_contract()
    assert shardcheck.check_signatures(contract, {"m.sharded": {"signatures": {"(int32[2,4096]@(shards))": 1}}}) == []
    (violation,) = shardcheck.check_signatures(
        contract, {"m.kernel": {"signatures": {"(int32[2,4096]@(shards)) {kind='cell'}": 1}}})
    assert "non-shard_map" in violation
    # JAX's check reads the tag as an axis name, which no mesh declares
    assert jax_shardcheck.check_signatures(
        contract, {"m.sharded": {"signatures": {"(int32[2,4096]@(shards))": 1}}})


def test_dim_admissible_gives_jax_answers(contract):
    import numpy as np

    dims = list(range(5000)) + [int(d) for d in np.random.default_rng(21).integers(0, 1 << 24, size=5000)]
    for c in (contract, _toy_contract()):
        assert [shardcheck.dim_admissible(d, c) for d in dims] == [
            jax_shardcheck.dim_admissible(d, c) for d in dims]
    for raw in (300, 4097, 5000, 12345, 999_999):
        assert not shardcheck.dim_admissible(raw, contract), raw
    for legal in (0, 1, 37, 256, 4096, 8192, 1 << 20):
        assert shardcheck.dim_admissible(legal, contract), legal


def test_contract_closed_over_the_ports_buckets_and_wire(contract):
    """Every size the port's bucket tables can emit, at every literal
    minimum, and every monoblock wire length its packer can produce."""
    from sctools_tpu_torch.io.packed import wire_layout
    from sctools_tpu_torch.ops.segments import ENTITY_BUCKET_MIN, bucket_size, entity_bucket

    ns = list(range(1, 300)) + [1000, 4095, 4096, 4097, 12345, 1 << 17, (1 << 20) + 7]
    for minimum in contract["bucket_minimums"] + [ENTITY_BUCKET_MIN]:
        for n in ns:
            assert shardcheck.dim_admissible(bucket_size(n, minimum=minimum), contract), (minimum, n)
    for n in ns:
        assert shardcheck.dim_admissible(entity_bucket(n, bucket_size(n)), contract), n
    for wide in (False, True):
        for small in (False, True):
            for run_keys in (False, True):
                for with_cb in (False, True):
                    widths = sum(w for _, w in wire_layout(wide, small, run_keys=run_keys, with_cb=with_cb))
                    for exp in range(12, 21):
                        for runs in ([0] if not run_keys else [4096, 1 << 16]):
                            dim = 1 + (1 << exp) * widths // 4 + 2 * runs
                            assert shardcheck.dim_admissible(dim, contract), (wide, small, run_keys, exp, dim)


def test_contract_has_jaxs_sites_dims_and_sharding(contract):
    jax = json.loads(JAX_MANIFEST.read_text())["contract"]
    assert contract["version"] == jax["version"] == shardcheck.CONTRACT_VERSION
    assert set(contract["sites"]) == set(jax["sites"]) and len(contract["sites"]) == 13
    for name, entry in contract["sites"].items():
        theirs = jax["sites"][name]
        assert (entry["dims"], entry["sharded"], entry["kind"], entry["axes"]) == (
            theirs["dims"], theirs["sharded"], theirs["kind"], theirs["axes"]), name
        assert entry["module"] == theirs["module"].replace("sctools_tpu.", "sctools_tpu_torch.", 1)
        if not name.startswith("whitelist."):
            assert entry["static_argnames"] == theirs["static_argnames"], name
    for key in ("axis_universe", "bucket_minimums", "pad_multiples", "pow2_min", "small_dim_max", "wire"):
        assert contract[key] == jax[key], key


def test_contract_records_aliased_bucket_minimums(tmp_path):
    path = tmp_path / "aliased_bucket.py"
    path.write_text(
        "from sctools_tpu_torch.ops.segments import bucket_size as bs\n\n\n"
        "def dispatch(frame):\n"
        "    return bs(len(frame), minimum=512)\n"
    )
    assert 512 in shardcheck.build_shape_contract([str(path)])["bucket_minimums"]


def test_traced_cpu_runs_stay_inside_the_contract(tmp_path, contract):
    """The signatures traced CPU runs record: the cell pass on one device
    and on two shards, the gene pass on two shards, the count on one
    device and on two shards, and a serve worker's drain."""
    from sctools_tpu_torch import obs
    from sctools_tpu_torch.obs import xprof
    from sctools_tpu_torch.platform import GenericPlatform
    from sctools_tpu_torch.serve import cli as serve_cli

    from helpers import write_bam
    from sctools_tpu.bam import sort_by_tags_and_queryname
    from test_count import SyntheticCountData
    from test_metrics import random_tagged_records
    from test_torch_count import _gtf_with_repeats

    records, header = random_tagged_records(seed=4)
    cell = write_bam(tmp_path / "cell.bam", list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])), header)
    gene = write_bam(tmp_path / "gene.bam", list(sort_by_tags_and_queryname(records, ["GE", "CB", "UB"])), header)
    data = SyntheticCountData()
    count_bam = write_bam(str(tmp_path / "count.bam"), data.records(), data.header)
    gtf = _gtf_with_repeats(tmp_path)
    journal = str(tmp_path / "journal")
    was = obs.enabled()
    obs.enable()
    xprof.reset()
    try:
        for argv in (["-i", cell, "-o", str(tmp_path / "c1")], ["-i", cell, "-o", str(tmp_path / "c2"), "--devices", "2"]):
            assert GenericPlatform.calculate_cell_metrics(argv, device="cpu") == 0
        assert GenericPlatform.calculate_gene_metrics(["-i", gene, "-o", str(tmp_path / "g2"), "--devices", "2"],
                                                      device="cpu") == 0
        for extra in ([], ["--devices", "2"]):
            assert GenericPlatform.bam_to_count_matrix(
                ["-b", count_bam, "-a", gtf, "-o", str(tmp_path / f"count{len(extra)}")] + extra, device="cpu") == 0
        assert serve_cli.main(["submit", journal, "--job", "t0", cell, str(tmp_path / "served")]) == 0
        assert serve_cli.main(["worker", journal, "--drain", "--batch-records", "4096", "--no-compress"],
                              device="cpu") == 0
        sites = xprof.snapshot()["sites"]
    finally:
        xprof.reset()
        if not was:
            obs.disable()
    seen = {name for name, row in sites.items() if row.get("signatures")}
    assert {"metrics.compute_entity_metrics", "metrics.compact_results_wire", "ops.count_molecules",
            "parallel.sharded_metrics", "parallel.sharded_count"} <= seen
    assert any("@(shards)" in sig for sig in sites["parallel.sharded_metrics"]["signatures"])
    assert shardcheck.check_signatures(contract, sites) == []


# ----------------------------------------------------------------- the CLI

def _corpus(tmp_path, kind):
    corpus = tmp_path / kind
    corpus.mkdir()
    for rule in SAME_FILE_RULES:
        (corpus / f"{rule.lower()}_{kind}.py").write_text((SHARD / f"{rule.lower()}_{kind}.py").read_text())
    for rule, pair in TWINS.items():
        (corpus / f"{rule.lower()}_{kind}.py").write_text(pair[kind == "clean"])
    return corpus


def test_cli_shard_only(tmp_path, capsys):
    assert cli_main(["--shard-only", str(_corpus(tmp_path, "clean"))]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "passes: shard;" in out
    assert cli_main(["--shard-only", str(_corpus(tmp_path, "bad"))]) == 1
    out = capsys.readouterr().out
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == set(RULES)


def test_cli_no_shard_and_composition(tmp_path, capsys):
    bad = str(_corpus(tmp_path, "bad"))
    assert cli_main(["--race-only", "--shard-only", bad]) == 1
    out = capsys.readouterr().out
    assert "passes: race, shard;" in out and ": SCX503" in out
    assert cli_main(["--no-shard", "--no-race", "--no-life", "--no-cost", "--no-mesh", "--no-aot", bad]) == 0
    out = capsys.readouterr().out
    assert "passes: lint;" in out and "SCX5" not in out


def test_cli_json_covers_the_shard_pass(tmp_path, capsys):
    assert cli_main(["--json", "--shard-only", str(_corpus(tmp_path, "bad"))]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == set(RULES)
    assert all(f["path"] and f["line"] > 0 and f["message"] for f in payload["findings"])


def test_cli_emit_shape_contract(tmp_path, capsys):
    dest = tmp_path / "contract.json"
    assert cli_main(["--emit-shape-contract", str(dest), str(PORT / "metrics"), str(PORT / "ops")]) == 0
    assert "scx-shard: wrote" in capsys.readouterr().out
    payload = json.loads(dest.read_text())
    assert payload["version"] == 1 and payload["sites"]["metrics.compute_entity_metrics"]["dims"] == "bucketed"
