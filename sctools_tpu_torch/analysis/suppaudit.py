"""Audit of the native layer's ``tsan.supp`` (rules SCX301-SCX303).

The port's copy of ``sctools_tpu.analysis.suppaudit``, with its rule ids,
names, messages and escapes. The TSan leg of ``native.sanitize`` runs the
threaded native tests with a suppression file. Suppressions rot in two
directions: an entry naming a symbol that no longer exists silently stops
matching (harmless but misleading), and an entry that matches *our*
instrumented library turns the leg off for exactly the code it exists to
check. This pass validates every entry against the native sources.

- SCX301 bad-suppression-syntax: unknown suppression type or empty
  pattern (TSan ignores malformed lines without complaint).
- SCX302 stale-suppression: pattern names neither a symbol present in the
  native sources nor a recognizable external (a ``*.so`` library, a
  ``std::`` / ``__``-prefixed runtime symbol, or a wildcard thereof).
- SCX303 self-suppression: pattern covers ``libsctools_native`` itself —
  suppressing the instrumented library defeats the entire gate.

An entry that must stay despite the audit (e.g. a temporarily-suppressed
known race) carries ``# scx-lint: disable=SCX302 -- reason`` on the line
above it.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Set

from .findings import Finding, Suppressions

SUPP_RULES = {
    "SCX301": "bad-suppression-syntax",
    "SCX302": "stale-suppression",
    "SCX303": "self-suppression",
}

# the suppression types tsan's SuppressionContext registers
_VALID_TYPES = {
    "race", "race_top", "thread", "mutex", "signal", "deadlock",
    "called_from_lib",
}

_IDENT = re.compile(r"[A-Za-z_]\w*")


def _source_identifiers(native_dir: str) -> Set[str]:
    idents: Set[str] = set()
    for path in glob.glob(os.path.join(native_dir, "*.cpp")) + glob.glob(
        os.path.join(native_dir, "*.h")
    ):
        with open(path, encoding="utf-8") as f:
            idents.update(_IDENT.findall(f.read()))
    return idents


def _is_external(pattern: str) -> bool:
    """Patterns naming runtime/third-party code we could never match in
    our sources: shared libraries, std::, and reserved __ symbols."""
    bare = pattern.replace("*", "")
    return (
        ".so" in bare
        or bare.startswith("std::")
        or bare.startswith("__")
    )


def audit_suppressions(supp_path: str, native_dir: str) -> List[Finding]:
    if not os.path.exists(supp_path):
        return []  # nothing to audit (the tsan leg would fail on its own)
    with open(supp_path, encoding="utf-8") as f:
        text = f.read()
    idents = _source_identifiers(native_dir)
    findings: List[Finding] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if ":" not in line:
            findings.append(
                Finding(
                    "SCX301", supp_path, lineno,
                    f"not a `type:pattern` suppression: {line!r}",
                )
            )
            continue
        kind, pattern = line.split(":", 1)
        pattern = pattern.strip()
        if kind not in _VALID_TYPES:
            findings.append(
                Finding(
                    "SCX301", supp_path, lineno,
                    f"unknown suppression type `{kind}` (tsan silently "
                    "ignores it)",
                )
            )
            continue
        if not pattern:
            findings.append(
                Finding(
                    "SCX301", supp_path, lineno,
                    f"empty pattern for `{kind}` suppression",
                )
            )
            continue
        if "libsctools_native" in pattern:
            findings.append(
                Finding(
                    "SCX303", supp_path, lineno,
                    f"`{line}` suppresses our own instrumented library — "
                    "this disables the ci-deep race gate for the code it "
                    "exists to check",
                )
            )
            continue
        if _is_external(pattern):
            continue
        # internal symbol reference: every identifier component must still
        # exist in the native sources. A wildcard pattern's fragments match
        # as substrings of real identifiers (`race:scx_stream*` stays
        # valid while any scx_stream_* symbol exists).
        components = _IDENT.findall(pattern.replace("*", " "))
        has_wildcard = "*" in pattern

        def known(component: str) -> bool:
            if component in idents:
                return True
            return has_wildcard and any(component in i for i in idents)

        if not components or not all(known(c) for c in components):
            missing = [c for c in components if not known(c)]
            findings.append(
                Finding(
                    "SCX302", supp_path, lineno,
                    f"`{line}` references symbol(s) not found in "
                    f"{native_dir}/*.cpp|h: "
                    f"{', '.join(missing) or '(none parsed)'} — stale "
                    "suppression",
                )
            )
    return Suppressions.from_text(text, "#").apply(findings)
