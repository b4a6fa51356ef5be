"""AST lint of the port's Python (rules SCX109 and SCX112).

The port's counterpart of ``sctools_tpu.analysis.jaxlint``. It keeps the
two rules of that pass whose bug class exists in a PyTorch package, under
their ids:

- **SCX109 wallclock-duration**: ``time.time()`` / ``datetime.now()`` /
  ``datetime.utcnow()`` anywhere. Wall clocks step under NTP and never
  belong in duration math; durations go through ``time.perf_counter()``.
  JAX's rule, with its messages.
- **SCX112 device-put-outside-ingest**: a host->device crossing outside
  the port's seam. Every upload goes through
  ``sctools_tpu_torch.ingest.upload`` (pinned memory, asynchronous), so a
  crossing elsewhere is one that skips it. Flagged: ``.cuda()``; a
  ``.to(...)`` whose target is not a dtype (a dtype is ``torch.<dtype>``
  or a name or attribute ending in ``dtype``), or that passes
  ``device=`` or ``non_blocking=``; ``torch.tensor`` / ``torch.as_tensor``
  with a ``device=`` other than ``"cpu"``. The owners are the files of
  ``ingest/`` (the immediate parent directory only, as in JAX) and
  ``parallel/collective.py``, the collectives' choke point.

The JAX pass's other rules model jit, ``shard_map``, the guard and steer:
code the port does not have. Its SCX101/SCX114 (host syncs and pulls)
are not ported either: the port has no static mark for a batch's device
pass, and ``.numpy()``/``.tolist()`` on a tensor cannot be told from
numpy's without types (a sync inside a captured pass already fails CUDA
graph capture at warmup, ``serve/graphs.py``).

Pure stdlib: the module under analysis is parsed, never imported.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set, Tuple

from .findings import Finding, Suppressions

TORCH_RULES = {
    "SCX109": "wallclock-duration",
    "SCX112": "device-put-outside-ingest",
}

# files allowed host->device crossings (SCX112): the seam's directory
# (immediate parent only) and the collectives' exchange
DEVICE_PUT_OWNER_DIRS = ("ingest",)
DEVICE_PUT_OWNER_FILES = (("parallel", "collective.py"),)

_TORCH_DTYPES = frozenset(
    (
        "bool", "uint8", "int8", "int16", "int32", "int64", "uint16",
        "uint32", "uint64", "float16", "bfloat16", "float32", "float64",
        "half", "float", "double", "short", "int", "long", "complex64",
        "complex128", "cfloat", "cdouble", "float8_e4m3fn", "float8_e5m2",
    )
)
_TENSOR_CTORS = ("tensor", "as_tensor")


def _root_and_chain(node: ast.AST) -> Tuple[Optional[str], List[str]]:
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, list(reversed(chain))
    return None, []


class _Aliases:
    """Names the module binds to torch and to the wall clocks."""

    def __init__(self, tree: ast.Module) -> None:
        self.torch: Set[str] = set()
        self.time_mod: Set[str] = set()  # import time [as t]
        self.time_fn: Set[str] = set()  # from time import time [as t]
        self.datetime_mod: Set[str] = set()  # import datetime [as dt]
        self.datetime_cls: Set[str] = set()  # from datetime import datetime
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    if alias.name == "torch" or (
                        alias.name.startswith("torch.") and not alias.asname
                    ):
                        self.torch.add(name)  # `import torch.cuda` binds torch
                    elif alias.name == "time":
                        self.time_mod.add(name)
                    elif alias.name == "datetime":
                        self.datetime_mod.add(name)
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if node.module == "time" and alias.name == "time":
                        self.time_fn.add(bound)
                    elif node.module == "datetime" and alias.name == "datetime":
                        self.datetime_cls.add(bound)

    def wallclock_call(self, func: ast.AST) -> Optional[str]:
        """The spelling (e.g. ``time.time``) when ``func`` reads a wall
        clock unfit for duration math; None otherwise."""
        if isinstance(func, ast.Name) and func.id in self.time_fn:
            return "time.time"
        root, chain = _root_and_chain(func)
        if root in self.time_mod and chain == ["time"]:
            return "time.time"
        if root in self.datetime_cls and chain in (["now"], ["utcnow"]):
            return f"datetime.{chain[0]}"
        if (
            root in self.datetime_mod
            and len(chain) == 2
            and chain[0] == "datetime"
            and chain[1] in ("now", "utcnow")
        ):
            return f"datetime.datetime.{chain[1]}"
        return None

    def is_dtype(self, node: ast.AST) -> bool:
        """``torch.<dtype>``, or a name or attribute ending in ``dtype``."""
        if isinstance(node, ast.Name):
            return node.id.endswith("dtype")
        if isinstance(node, ast.Attribute):
            root, chain = _root_and_chain(node)
            if root in self.torch and len(chain) == 1:
                return chain[0] in _TORCH_DTYPES
            return node.attr.endswith("dtype")
        return False


def _owns_device_puts(path: str) -> bool:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    # only the IMMEDIATE parent directory confers ownership: an "ingest"
    # ancestor elsewhere in a checkout's path must not disable the rule
    if len(parts) >= 2 and parts[-2] in DEVICE_PUT_OWNER_DIRS:
        return True
    return tuple(parts[-2:]) in DEVICE_PUT_OWNER_FILES


class TorchLinter:
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.aliases = _Aliases(self.tree)
        self.findings: List[Finding] = []

    def _report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        end = getattr(node, "end_lineno", line) or line
        self.findings.append(Finding(rule, self.path, line, message, end))

    def _crossing(self, call: ast.Call) -> Optional[str]:
        """What makes ``call`` a host->device crossing, else None."""
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        keywords = {kw.arg for kw in call.keywords}
        if func.attr == "cuda":
            return "`.cuda()`"
        if func.attr == "to":
            if "non_blocking" in keywords:
                return "`.to(..., non_blocking=...)`"
            if "device" in keywords:
                return "`.to(device=...)`"
            if call.args and not self.aliases.is_dtype(call.args[0]):
                return f"`.to({ast.unparse(call.args[0])})`"
            return None
        root, chain = _root_and_chain(func)
        if root in self.aliases.torch and len(chain) == 1 and chain[0] in _TENSOR_CTORS:
            for kw in call.keywords:
                if kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant) and kw.value.value == "cpu"
                ):
                    return f"`torch.{chain[0]}(..., device={ast.unparse(kw.value)})`"
        return None

    def run(self) -> List[Finding]:
        owner = _owns_device_puts(self.path)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            wallclock = self.aliases.wallclock_call(node.func)
            if wallclock is not None:
                self._report(
                    "SCX109", node,
                    f"`{wallclock}()` reads the wall clock, which steps "
                    "under NTP and must not time durations; use "
                    "time.perf_counter() or an obs.span",
                )
            crossing = None if owner else self._crossing(node)
            if crossing is not None:
                self._report(
                    "SCX112", node,
                    f"{crossing} is a host->device crossing outside the "
                    "seam; stage through "
                    "sctools_tpu_torch.ingest.upload(array, device)",
                )
        return self.findings


def lint_file(path: str) -> List[Finding]:
    """Lint one Python file; returns suppression-filtered findings."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        linter = TorchLinter(path, source)
    except SyntaxError as exc:
        return [
            Finding(
                "SCX100", path, exc.lineno or 0,
                f"file does not parse: {exc.msg}",
            )
        ]
    unique: dict = {}
    for finding in linter.run():
        unique.setdefault((finding.rule, finding.line), finding)
    return Suppressions.from_text(source, "#").apply(unique.values())
