"""The port's tsan.supp audit (``analysis.suppaudit``, SCX301-303) against JAX's.

- On JAX's fixtures (``tests/fixtures_scxlint/supp``, audited against the
  ABI fixture's clean sources) the port gives JAX's findings: rule, line
  and message.
- The port's own ``native/tsan.supp`` audits clean against the port's
  sources, and entries seeded into a copy of it give JAX's findings,
  escapes honoured.
"""

import shutil
from pathlib import Path

import pytest

from sctools_tpu.analysis.suppaudit import audit_suppressions as jax_audit
from sctools_tpu_torch.analysis import SUPP_RULES, audit_suppressions
from sctools_tpu_torch.native import sanitize

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures_scxlint"
NATIVE = REPO / "sctools_tpu_torch" / "native"


def triples(findings):
    return [(f.rule, f.line, f.message) for f in findings]


@pytest.mark.parametrize("kind", ["bad", "clean"])
def test_matches_jax_on_its_fixtures(kind):
    supp = str(FIXTURES / "supp" / f"{kind}.supp")
    native_dir = str(FIXTURES / "abi" / "clean")
    want = jax_audit(supp, native_dir)
    assert triples(audit_suppressions(supp, native_dir)) == triples(want)
    if kind == "bad":
        assert [f.rule for f in want] == ["SCX301", "SCX301", "SCX301", "SCX303", "SCX302"]
    else:
        assert want == []


def test_the_ports_suppressions_audit_clean():
    assert sanitize.SUPPRESSIONS == NATIVE / "tsan.supp"
    assert audit_suppressions(str(NATIVE / "tsan.supp"), str(NATIVE)) == []
    # JAX's entries name libraries the port's leg never loads: none is copied
    text = (NATIVE / "tsan.supp").read_text()
    entries = [line for line in text.splitlines() if line.strip() and not line.startswith("#")]
    assert not any("libjax_common" in e or "xla_extension" in e for e in entries)


SEEDED = """\
race:scx_stream_next
race:scx_tagsort*
race:scx_no_such_symbol
mutex:libsctools_native.tsan-1234.so
deadlock
frobnicate:scx_free
# scx-lint: disable=SCX302 -- kept while the known race is open
race:scx_gone_but_escaped
called_from_lib:libz.so.1
race:std::thread::join
"""


def test_seeded_entries_give_jaxs_findings(tmp_path):
    native_dir = tmp_path / "native"
    shutil.copytree(NATIVE, native_dir, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    supp = native_dir / "tsan.supp"
    supp.write_text(supp.read_text() + SEEDED)
    got = audit_suppressions(str(supp), str(native_dir))
    assert triples(got) == triples(jax_audit(str(supp), str(native_dir)))
    offset = len((NATIVE / "tsan.supp").read_text().splitlines())
    assert [(f.rule, f.line - offset) for f in got] == [
        ("SCX302", 3), ("SCX303", 4), ("SCX301", 5), ("SCX301", 6)]
    assert {f.rule for f in got} == set(SUPP_RULES)


def test_a_missing_file_is_nothing_to_audit(tmp_path):
    assert audit_suppressions(str(tmp_path / "tsan.supp"), str(NATIVE)) == []
