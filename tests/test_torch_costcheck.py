"""scx-cost on the port (``sctools_tpu_torch.analysis.costcheck``) against JAX's.

- Parity: on JAX's SCX701, SCX704 and SCX705 fixtures the port's pass gives
  JAX's (rule, line) set; SCX702 and SCX703 use JAX-only spellings
  (``instrument_jit``, ``block_until_ready``, ``timed_pulls``), so each has
  a torch twin here whose findings equal its ``# <- SCXnnn`` marks and whose
  count per rule equals JAX's on its fixture. Every clean fixture and twin
  is silent.
- The real tree: ``ingest/`` and ``parallel/collective.py`` are exempt;
  escapes work; site forwarding crosses helpers as in JAX (the port and
  ``chip_smoke.py`` are clean under the gate:
  ``test_torch_analysis``'s ``test_cli_gate_is_clean_on_the_port_and_the_smoke``
  runs this pass).
- Seeded faults in copies of the port's own code: a pull of an invariant
  inside the sharded count's loop (SCX701), an ``.item()`` between the
  gatherer's ``stage`` and ``collect`` (SCX703).
- The transfer inventory and ``check_transfer_sites``, and the sites of the
  ledger of traced CPU runs of the cell, count and serve paths inside it.
- The CLI: ``--cost-only``, ``--json`` and ``--emit-transfer-inventory``,
  on the tree and on a bad corpus.

The parse store is off (``SCTOOLS_TPU_SCX_CACHE=0``).
"""

import json
import os
from pathlib import Path

import pytest

from sctools_tpu.analysis import costcheck as jax_costcheck
from sctools_tpu_torch.analysis import check_cost, check_transfer_sites, transfer_inventory
from sctools_tpu_torch.analysis.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sctools_tpu_torch"
COST = REPO / "tests" / "fixtures_scxlint" / "costcheck"
RULES = ["SCX701", "SCX702", "SCX703", "SCX704", "SCX705"]
SAME_FILE_RULES = ["SCX701", "SCX704", "SCX705"]


@pytest.fixture(autouse=True, scope="module")
def _no_parse_store():
    saved = os.environ.get("SCTOOLS_TPU_SCX_CACHE")
    os.environ["SCTOOLS_TPU_SCX_CACHE"] = "0"
    yield
    if saved is None:
        os.environ.pop("SCTOOLS_TPU_SCX_CACHE", None)
    else:
        os.environ["SCTOOLS_TPU_SCX_CACHE"] = saved


def rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def marked_lines(text: str, rule: str):
    return [n for n, line in enumerate(text.splitlines(), 1) if f"# <- {rule}" in line]


# -------------------------------------------------------- the torch twins

TWIN_SCX702_BAD = '''"""SCX702 bad twin: an instrumented device site called with invariant
arguments, and a helper that re-uploads a pure function of its parameter
with no content-hash cache."""
from sctools_tpu_torch import ingest
from sctools_tpu_torch.obs import xprof


@xprof.instrument_site("fix.step")
def step(x):
    return x * 2


def upload_expanded(table, device):
    expanded = table * 3
    return ingest.upload(expanded, device, site="fix.expanded")


def drive(batches, table, anchor, device):
    outs = []
    for batch in batches:
        staged = upload_expanded(table, device)  # <- SCX702
        stepped = step(anchor)  # <- SCX702
        outs.append((batch.n_records, staged, stepped))
    return outs
'''

# the port's two other device dispatches, with no JAX fixture: the kernel
# wrapper and a CUDA graph replay (the receiver counts as an argument)
PORT_SCX702_DISPATCHES = '''from sctools_tpu_torch.ops import whitelist


def drive(batches, queries, wl_table, graph, graphs):
    outs = []
    for batch in batches:
        outs.append(whitelist.correct_codes(queries, wl_table))  # <- SCX702
        graph.replay()  # <- SCX702
        outs.append(graphs.run(queries))  # <- SCX702
        outs.append(whitelist.correct_codes(batch.queries, wl_table))
        entry = graphs.entry(batch)
        entry.graph.replay()
    return outs
'''

TWIN_SCX702_CLEAN = '''"""SCX702 clean twin: the helper's upload sits behind a content-hash
cache (the whitelist table's shape), and the device sites are fed
loop-varying operands; the replayed graph is the loop's own."""
from sctools_tpu_torch import ingest
from sctools_tpu_torch.obs import xprof
from sctools_tpu_torch.ops import whitelist

_table_cache: dict = {}


@xprof.instrument_site("fix.step")
def step(x):
    return x * 2


def upload_expanded(table, key, device):
    cached = _table_cache.get(key)
    if cached is not None:
        return cached
    expanded = table * 3
    staged = ingest.upload(expanded, device, site="fix.expanded")
    _table_cache[key] = staged
    return staged


def drive(batches, table, key, device, wl_table, graphs):
    outs = []
    for batch in batches:
        staged = upload_expanded(table, key, device)
        cols = batch.columns()
        outs.append((staged, step(cols), whitelist.correct_codes(cols, wl_table)))
        entry = graphs[batch.key]
        entry.graph.replay()
    return outs
'''

TWIN_SCX703_BAD = '''"""SCX703 bad twin: host syncs inside the writeback overlap window."""
import torch

from sctools_tpu_torch import ingest


def drain_serialized(device_blocks, compute):
    ring = ingest.WritebackRing(name="fix", slots=4)
    out = []
    for block in device_blocks:
        staged = ring.stage(block)
        following = compute(block)
        torch.cuda.synchronize()  # <- SCX703
        probed = ingest.pull(following, site="fix.probe")
        out.append(probed.numpy())  # <- SCX703
        host, _ = ring.collect(staged, site="fix.drain")
        out.append(host)
    return out
'''

TWIN_SCX703_CLEAN = '''"""SCX703 clean twin: syncs land before the stage() kick or after the
collect() drain; the window itself stays sync-free."""
import torch

from sctools_tpu_torch import ingest


def drain_overlapped(device_blocks, compute):
    ring = ingest.WritebackRing(name="fix", slots=4)
    out = []
    for block in device_blocks:
        torch.cuda.synchronize()
        staged = ring.stage(block)
        following = compute(block)
        probed = ingest.pull(following, site="fix.probe")
        host, _ = ring.collect(staged, site="fix.drain")
        out.append((host, probed.numpy(), following.sum().item()))
    ring.close()
    return out
'''

TWINS = {"SCX702": (TWIN_SCX702_BAD, TWIN_SCX702_CLEAN), "SCX703": (TWIN_SCX703_BAD, TWIN_SCX703_CLEAN)}


def _jax_fixture_counts(rule):
    findings = jax_costcheck.check_cost([str(COST / f"{rule.lower()}_bad.py")])
    return len([f for f in findings if f.rule == rule])


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", SAME_FILE_RULES)
def test_cost_pass_matches_jax_on_its_fixtures(rule, kind):
    path = str(COST / f"{rule.lower()}_{kind}.py")
    want = rule_lines(jax_costcheck.check_cost([path]))
    assert rule_lines(check_cost([path])) == want
    assert bool(want) == (kind == "bad")


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires_on_its_marks_and_counts_as_jax(tmp_path, rule):
    bad = TWINS[rule][0]
    path = tmp_path / f"{rule.lower()}_bad.py"
    path.write_text(bad)
    got = rule_lines(check_cost([str(path)]))
    assert got == [(rule, line) for line in marked_lines(bad, rule)]
    assert len(got) == _jax_fixture_counts(rule)


def test_scx702_holds_the_kernel_wrapper_and_graph_replays(tmp_path):
    path = tmp_path / "dispatches.py"
    path.write_text(PORT_SCX702_DISPATCHES)
    assert rule_lines(check_cost([str(path)])) == [
        ("SCX702", line) for line in marked_lines(PORT_SCX702_DISPATCHES, "SCX702")]


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_clean_is_silent(tmp_path, rule):
    path = tmp_path / f"{rule.lower()}_clean.py"
    path.write_text(TWINS[rule][1])
    assert check_cost([str(path)]) == []


# ---------------------------------------------------------- the real tree

def test_inline_escape(tmp_path):
    src = (
        "from sctools_tpu_torch import ingest\n\n\n"
        "def per_batch(batches, table, device):\n"
        "    for batch in batches:\n"
        "        ingest.upload(table, device, site='fix.table')  "
        "# scx-lint: disable=SCX701 -- two-batch tool, link idle\n"
    )
    path = tmp_path / "suppressed_cost.py"
    path.write_text(src)
    assert check_cost([str(path)]) == []
    path.write_text(src.split("  # scx-lint")[0] + "\n")
    assert rule_lines(check_cost([str(path)])) == [("SCX701", 6)]


@pytest.mark.parametrize("parent,name,exempt", [
    ("ingest", "staging.py", True),
    ("parallel", "collective.py", True),
    ("parallel", "metrics.py", False),
    ("ingest/sub", "staging.py", False),  # only the IMMEDIATE parent owns
])
def test_choke_point_owners_are_exempt(tmp_path, parent, name, exempt):
    src = (
        "from sctools_tpu_torch.obs import xprof\n\n\n"
        "def door(value, site):\n"
        "    xprof.record_transfer('h2d', 8, site=str(site) + '!')\n"
        "    return value\n"
    )
    directory = tmp_path / parent
    directory.mkdir(parents=True)
    (directory / name).write_text(src)
    findings = check_cost([str(directory / name)])
    assert {f.rule for f in findings} == (set() if exempt else {"SCX705"})


def test_site_forwarding_crosses_helpers(tmp_path):
    src = (
        "from sctools_tpu_torch import ingest\n\n\n"
        "def timed_pull(site, value):\n"
        "    return ingest.pull(value, site=site)\n\n\n"
        "def paired(site, block):\n"
        "    return timed_pull(site, block)\n\n\n"
        "def drive(block, label):\n"
        "    good = paired('fix.compact', block)\n"
        "    bad = paired('fix.' + label, block)\n"
        "    return good, bad\n"
    )
    path = tmp_path / "forwarding_cost.py"
    path.write_text(src)
    assert rule_lines(check_cost([str(path)])) == [("SCX705", 14)]
    assert transfer_inventory([str(path)])["sites"]["fix.compact"]["directions"] == ["d2h"]


def test_positional_sites_follow_the_ports_signatures(tmp_path):
    """``upload(array, device, site)``, ``pull(value, site)``,
    ``record_transfer(direction, nbytes, seconds, site)``."""
    src = (
        "from sctools_tpu_torch import ingest\n"
        "from sctools_tpu_torch.obs import xprof\n\n\n"
        "def moves(array, device, value):\n"
        "    staged = ingest.upload(array, device, 'fix.up')\n"
        "    pulled = ingest.pull(value, 'fix.down')\n"
        "    xprof.record_transfer('d2h', 8, 0.0, 'fix.noted')\n"
        "    return staged, pulled\n"
    )
    path = tmp_path / "positional.py"
    path.write_text(src)
    assert check_cost([str(path)]) == []
    sites = transfer_inventory([str(path)])["sites"]
    assert {name: entry["directions"] for name, entry in sites.items()} == {
        "fix.up": ["h2d"], "fix.down": ["d2h"], "fix.noted": ["d2h"]}


# ------------------------------------------- seeded faults in port copies

def seeded_copy(tmp_path, name: str, old: str, new: str) -> str:
    text = (PORT / name).read_text()
    assert text.count(old) == 1, f"{name} changed: {old!r}"
    path = tmp_path / Path(name).name
    path.write_text(text.replace(old, new))
    return str(path)


@pytest.mark.parametrize("name,old,new,rule", [
    # a pull of an invariant inside the sharded count's per-shard loop
    ("parallel/count.py", '        staged = ingest.upload(block, device, site="count.upload")\n',
     '        staged = ingest.upload(block, device, site="count.upload")\n'
     '        ingest.pull(stacked_cols["qname"], site="count.writeback")\n', "SCX701"),
    # an .item() between the gatherer's stage() and its collect()
    ("metrics/gatherer.py", "                staged = self._writeback.stage(block)\n",
     "                staged = self._writeback.stage(block)\n                n_check = block[0, 0].item()\n",
     "SCX703"),
])
def test_faults_seeded_in_the_ports_code(tmp_path, name, old, new, rule):
    path = seeded_copy(tmp_path, name, old, new)
    assert {f.rule for f in check_cost([path])} == {rule}


# ------------------------------------------------- the transfer inventory

@pytest.fixture(scope="module")
def inventory():
    return transfer_inventory([str(PORT)])


def test_transfer_inventory_names_the_ports_sites(inventory):
    sites = inventory["sites"]
    for name, direction in [("gatherer.upload", "h2d"), ("gatherer.writeback", "d2h"),
                            ("count.upload", "h2d"), ("count.writeback", "d2h"),
                            ("whitelist.table", "h2d"), ("merge.collect", "d2h"),
                            ("parallel.upload", "h2d"), ("parallel.writeback", "d2h")]:
        assert direction in sites[name]["directions"], name
    assert all(entry["occurrences"] for entry in sites.values())


def test_check_transfer_sites_flags_phantoms_and_directions(inventory):
    clean = {"h2d": {"by_site": {"gatherer.upload": {"bytes": 10}}},
             "d2h": {"by_site": {"gatherer.writeback": {"bytes": 10}}}}
    assert check_transfer_sites(inventory, clean) == []
    phantom = check_transfer_sites(inventory, {"h2d": {"by_site": {"nowhere.site": {"bytes": 1}}}})
    assert len(phantom) == 1 and "phantom" in phantom[0]
    flipped = check_transfer_sites(inventory, {"h2d": {"by_site": {"gatherer.writeback": {"bytes": 1}}}})
    assert len(flipped) == 1 and "direction" in flipped[0]


def test_traced_ledgers_of_the_cell_count_and_serve_paths_are_inside_the_inventory(tmp_path, inventory):
    """The sites a traced CPU run records (cell metrics, the count, a serve
    worker's drain) are all in the static inventory, directions included."""
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
    bam = write_bam(tmp_path / "cell.bam", list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])), header)
    data = SyntheticCountData()
    count_bam = write_bam(str(tmp_path / "count.bam"), data.records(), data.header)
    gtf = _gtf_with_repeats(tmp_path)
    journal = str(tmp_path / "journal")
    was = obs.enabled()
    obs.enable()
    xprof.reset()
    try:
        assert GenericPlatform.calculate_cell_metrics(["-i", bam, "-o", str(tmp_path / "cell")], device="cpu") == 0
        assert GenericPlatform.bam_to_count_matrix(["-b", count_bam, "-a", gtf, "-o", str(tmp_path / "count")],
                                                   device="cpu") == 0
        assert serve_cli.main(["submit", journal, "--job", "t0", bam, str(tmp_path / "served")]) == 0
        assert serve_cli.main(["worker", journal, "--drain", "--batch-records", "4096", "--no-compress"],
                              device="cpu") == 0
        ledger = xprof.ledger_totals()
    finally:
        xprof.reset()
        if not was:
            obs.disable()
    seen = {site for total in ledger.values() for site in total["by_site"]}
    assert {"gatherer.upload", "gatherer.writeback", "count.upload", "count.writeback"} <= seen
    assert check_transfer_sites(inventory, ledger) == []


# ----------------------------------------------------------------- the CLI

def _bad_corpus(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for rule in SAME_FILE_RULES:
        (corpus / f"{rule.lower()}_bad.py").write_text((COST / f"{rule.lower()}_bad.py").read_text())
    for rule, (bad, _) in TWINS.items():
        (corpus / f"{rule.lower()}_bad.py").write_text(bad)
    return corpus


def _clean_corpus(tmp_path):
    corpus = tmp_path / "clean"
    corpus.mkdir()
    for rule in SAME_FILE_RULES:
        (corpus / f"{rule.lower()}_clean.py").write_text((COST / f"{rule.lower()}_clean.py").read_text())
    for rule, (_, clean) in TWINS.items():
        (corpus / f"{rule.lower()}_clean.py").write_text(clean)
    return corpus


def test_cli_cost_only(tmp_path, capsys):
    assert cli_main(["--cost-only", str(_clean_corpus(tmp_path))]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "passes: cost;" in out
    assert cli_main(["--cost-only", str(_bad_corpus(tmp_path))]) == 1
    out = capsys.readouterr().out
    assert {line.split()[1] for line in out.splitlines() if ": SCX" in line} == set(RULES)


def test_cli_json_covers_the_cost_pass(tmp_path, capsys):
    assert cli_main(["--json", "--cost-only", str(_bad_corpus(tmp_path))]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == set(RULES)
    assert all(f["path"] and f["line"] > 0 and f["message"] for f in payload["findings"])


def test_cli_emit_transfer_inventory(tmp_path, capsys):
    dest = tmp_path / "inventory.json"
    assert cli_main(["--emit-transfer-inventory", str(dest), str(PORT / "metrics")]) == 0
    assert "scx-cost: wrote" in capsys.readouterr().out
    payload = json.loads(dest.read_text())
    assert payload["version"] == 1 and payload["sites"]["gatherer.upload"]["directions"] == ["h2d"]
    bad = tmp_path / "bad.json"
    assert cli_main(["--emit-transfer-inventory", str(bad), str(_bad_corpus(tmp_path))]) == 0
    assert "fix.table" in json.loads(bad.read_text())["sites"]
