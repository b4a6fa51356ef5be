"""Finding model + suppression comments shared by every pass of the port's
static checks.

The port's copy of ``sctools_tpu.analysis.findings``. A finding is one rule
violation anchored at a file:line. Every rule has a stable ``SCXNNN`` id,
the JAX package's (1xx = lint of the port's Python, 2xx = ctypes ABI,
4xx = concurrency, 6xx = frame lifetime), so findings can be suppressed
individually with an inline escape hatch::

    value = read()  # scx-lint: disable=SCXNNN -- the reason it is safe

A comment-only line applies to the next source line; ``disable-file=`` in
any comment suppresses the rule(s) for the whole file; ``disable=all``
suppresses everything on that line. The suppression syntax is shared by
Python (``#``) and C++ (``//``) sources.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Set

_DIRECTIVE = re.compile(
    r"scx-lint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9,\s]+?)\s*(?:--|$)"
)
_RULE_ID = re.compile(r"^SCX\d{3}$")


@dataclass(frozen=True)
class Finding:
    rule: str  # SCXNNN
    path: str
    line: int
    message: str
    # last physical line of the flagged construct (0 == same as `line`):
    # an inline directive on ANY line of a multi-line statement suppresses
    end_line: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Suppressions:
    """Per-file map of suppressed rules, parsed from comment directives."""

    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    whole_file: Set[str] = field(default_factory=set)

    @classmethod
    def from_text(cls, text: str, marker: str = "#") -> "Suppressions":
        """Scan comment directives in ``text``.

        ``marker`` is the line-comment opener for the language. Directives
        are only honored inside comments; the scan is line-based, which is
        exact for the two file kinds the passes read (a ``marker`` inside
        a string literal on the same line as real code cannot *introduce*
        a directive unless the literal itself contains the full
        ``scx-lint:`` syntax — not a case worth an AST round-trip).
        """
        supp = cls()
        pending: Set[str] = set()  # from comment-only lines, awaiting code
        for lineno, raw in enumerate(text.splitlines(), start=1):
            pos = raw.find(marker)
            comment_only = pos >= 0 and raw[:pos].strip() == ""
            if pending and raw.strip() and not comment_only:
                # first code line after a comment-only directive (possibly
                # part of a multi-line comment block) inherits it
                supp.by_line.setdefault(lineno, set()).update(pending)
                pending = set()
            if pos < 0:
                continue
            match = _DIRECTIVE.search(raw[pos:])
            if not match:
                continue
            kind, rule_text = match.groups()
            rules = {
                r.strip().upper()
                for r in rule_text.split(",")
                if r.strip()
            }
            rules = {r for r in rules if _RULE_ID.match(r) or r == "ALL"}
            if not rules:
                continue
            if kind == "disable-file":
                supp.whole_file |= rules
            elif comment_only:
                pending |= rules
            else:
                supp.by_line.setdefault(lineno, set()).update(rules)
        return supp

    def is_suppressed(self, rule: str, line: int) -> bool:
        for rules in (self.whole_file, self.by_line.get(line, set())):
            if rule in rules or "ALL" in rules:
                return True
        return False

    def apply(self, findings: Iterable[Finding]) -> List[Finding]:
        out = []
        for f in findings:
            # bounded span walk: a directive on any physical line of the
            # flagged statement counts (capped defensively so a degenerate
            # span cannot make this quadratic)
            end = max(f.end_line, f.line)
            end = min(end, f.line + 50)
            if any(
                self.is_suppressed(f.rule, line)
                for line in range(f.line, end + 1)
            ):
                continue
            out.append(f)
        return out
