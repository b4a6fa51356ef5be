"""AST lint of the port's Python (rules SCX109, SCX112-SCX114 and SCX1001).

The port's counterpart of ``sctools_tpu.analysis.jaxlint``. It keeps the
rules of that pass whose bug class exists in a PyTorch package, under
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
- **SCX113 unguarded-device-boundary**: a ``try`` whose body makes a
  device-boundary call with a broad handler (bare ``except``,
  ``Exception``, ``BaseException``) that holds no ``raise``. Swallowing
  at the device boundary bypasses the guard's taxonomy: a transient loses
  its retry, an OOM its bisection, poison its quarantine sidecar, and the
  failure leaves every counter. The boundary is JAX's (the engine
  dispatches ``compute_entity_metrics``, ``sharded_entity_metrics``,
  ``count_molecules``, ``sharded_count_molecules``, ``distributed_sort``,
  and ``ingest.upload`` under its import aliases) and the port's other
  device dispatches that SCX702 knows: the kernel wrapper
  ``correct_codes`` and a CUDA graph replay (``<...graph>.replay()``,
  ``<...graphs>.run(...)``). Cleanup-then-raise handlers pass; the files
  of ``guard/`` (the immediate parent directory only) are exempt. JAX's
  rule, with its message naming the port's guard.
- **SCX114 device-pull-outside-wire**: a device->host pull of a device
  value outside the port's seam. A device value is a name bound, per
  scope, from an engine dispatch, ``compact_results[_wire]`` or
  ``correct_codes``, or from ``ingest.upload`` (which returns the tensor
  itself, where JAX's returns ``(value, nbytes)``), plus subscripts and
  alias copies of such names (JAX's two-pass taint). A name bound from
  ``ingest.pull`` is a host ``Pulled`` handle and never a device value.
  Flagged on a device value (its receiver chain of subscripts,
  attributes and method calls reaching the name): ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``.item()``, ``.to("cpu")`` /
  ``.to(device="cpu")``, and ``np.asarray`` / ``np.array``. The owners
  are SCX112's: ``ingest/`` (immediate parent only) and
  ``parallel/collective.py``, whose gloo route stages through the host
  on purpose. The messages name ``sctools_tpu_torch.ingest.pull``.
- **SCX1001 unguarded-actuation**: a write to a steering-actuated knob
  outside the steering controller's validated apply path: rebinding
  ``RECORD_BUCKET_MIN`` / ``ENTITY_BUCKET_MIN``, calling (or importing from
  a ``prefetch`` module) ``set_depth_override``, or assigning
  ``os.environ["SCTOOLS_TPU_PREFETCH_DEPTH"]`` in-process. The owners are
  the files of ``steer/`` (the immediate parent directory only) and the
  modules that define the knobs (``prefetch.py``, ``segments.py``). JAX's
  rule, with its messages: the floor rebind's remedy names the port's
  offline ``--retune``.

The JAX pass's other rules model jit, ``shard_map``, ``jax.config`` and
``jax.device_get``: code the port does not have. Its SCX101 (host syncs
inside a traced function) is not ported: the port has no static mark for
a batch's device pass, and a sync inside a captured pass already fails
CUDA graph capture at warmup (``serve/graphs.py``); the cost pass's
SCX703 holds syncs out of the writeback ring's overlap window.

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
    "SCX113": "unguarded-device-boundary",
    "SCX114": "device-pull-outside-wire",
    "SCX1001": "unguarded-actuation",
}

# files allowed host<->device crossings (SCX112, SCX114): the seam's
# directory (immediate parent only) and the collectives' exchange
DEVICE_PUT_OWNER_DIRS = ("ingest",)
DEVICE_PUT_OWNER_FILES = (("parallel", "collective.py"),)
# the recovery ladder owns its broad handlers (SCX113)
GUARD_OWNER_DIRS = ("guard",)
# calls that cross the device boundary (SCX113), matched by the call's
# terminal name: JAX's engine dispatches and the kernel wrapper
# (`ingest.upload` and graph replays are matched apart)
_BOUNDARY_CALL_NAMES = frozenset(
    (
        "compute_entity_metrics",
        "sharded_entity_metrics",
        "count_molecules",
        "sharded_count_molecules",
        "distributed_sort",
        "correct_codes",
    )
)
# calls whose result is a device value (SCX114 taint sources)
_DEVICE_PRODUCER_NAMES = _BOUNDARY_CALL_NAMES | {
    "compact_results",
    "compact_results_wire",
}
# methods that pull a tensor to the host (SCX114); `.to(...)` apart
_PULL_METHODS = ("cpu", "numpy", "tolist", "item")
# steering-actuated knobs (SCX1001): bucket floors, prefetch/ring depth.
# Only steer/'s validated apply path may write them at runtime; the owner
# files are the modules that DEFINE the knobs (segments.py pins the
# floors, prefetch.py hosts the override steer/ sets)
STEER_OWNER_DIRS = ("steer",)
STEER_OWNERS = ("prefetch.py", "segments.py")
_STEER_KNOB_CONSTANTS = ("RECORD_BUCKET_MIN", "ENTITY_BUCKET_MIN")
_STEER_KNOB_CALLS = ("set_depth_override",)
_STEER_KNOB_ENVS = ("SCTOOLS_TPU_PREFETCH_DEPTH",)

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
        self.np: Set[str] = set()  # import numpy [as np]
        self.ingest_mods: Set[str] = set()  # from .. import ingest [as x]
        self.upload_names: Set[str] = set()  # from ..ingest import upload
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
                    elif alias.name == "numpy":
                        self.np.add(name)
                    elif alias.name.endswith(".ingest") and alias.asname:
                        self.ingest_mods.add(alias.asname)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if mod == "time" and alias.name == "time":
                        self.time_fn.add(bound)
                    elif mod == "datetime" and alias.name == "datetime":
                        self.datetime_cls.add(bound)
                    elif alias.name == "ingest":
                        self.ingest_mods.add(bound)
                    elif alias.name == "upload" and mod.endswith("ingest"):
                        self.upload_names.add(bound)

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

    def is_upload(self, func: ast.AST) -> bool:
        """``ingest.upload`` under the module's import aliases."""
        if isinstance(func, ast.Name):
            return func.id in self.upload_names
        return (
            isinstance(func, ast.Attribute)
            and func.attr == "upload"
            and isinstance(func.value, ast.Name)
            and func.value.id in self.ingest_mods
        )

    def np_call(self, func: ast.AST) -> Optional[str]:
        root, chain = _root_and_chain(func)
        return chain[0] if root in self.np and len(chain) == 1 else None

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


def _terminal_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_graph_replay(func: ast.AST) -> bool:
    """``<...graph>.replay()`` (a CUDA graph) or ``<...graphs>.run(...)``
    (a ``serve.graphs.GraphSet``): costcheck's SCX702 reading."""
    if not isinstance(func, ast.Attribute) or func.attr not in ("replay", "run"):
        return False
    root, chain = _root_and_chain(func.value)
    last = (chain[-1] if chain else root or "").lower()
    if func.attr == "replay":
        return last.endswith("graph")
    return last.endswith("graphs") or last == "graph_set"


def _receiver_root(node: ast.AST) -> Optional[str]:
    """The name a receiver chain of subscripts, attributes and method
    calls starts from (``out["n"].sum().item`` -> ``out``)."""
    while True:
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            node = node.func.value
        else:
            break
    return node.id if isinstance(node, ast.Name) else None


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and _terminal_name(node.func) == "device"
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def _scope_walk(scope: ast.AST):
    """A scope's own nodes: a module's without its function bodies (their
    names are local), a function's with its nested defs (closures see the
    enclosing names). JAX's scoping."""
    if not isinstance(scope, ast.Module):
        yield from ast.walk(scope)
        return
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _owns_device_puts(path: str) -> bool:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    # only the IMMEDIATE parent directory confers ownership: an "ingest"
    # ancestor elsewhere in a checkout's path must not disable the rule
    if len(parts) >= 2 and parts[-2] in DEVICE_PUT_OWNER_DIRS:
        return True
    return tuple(parts[-2:]) in DEVICE_PUT_OWNER_FILES


def _owns_recovery(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return len(parts) >= 2 and parts[-2] in GUARD_OWNER_DIRS


def _owns_actuation(path: str) -> bool:
    if os.path.basename(path) in STEER_OWNERS:
        return True
    parts = os.path.normpath(path).split(os.sep)
    # only the IMMEDIATE parent confers ownership (the SCX112 line)
    return len(parts) >= 2 and parts[-2] in STEER_OWNER_DIRS


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

    def _check_unguarded_actuation(self) -> None:
        """Writes to steering-actuated knobs outside the apply path (SCX1001)."""
        if _owns_actuation(self.path):
            return
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    name = None
                    if isinstance(target, ast.Name):
                        name = target.id
                    elif isinstance(target, ast.Attribute):
                        name = target.attr
                    if name in _STEER_KNOB_CONSTANTS:
                        self._report(
                            "SCX1001", node,
                            f"write to steering-actuated knob `{name}` "
                            "outside steer/'s contract-checked apply "
                            "path: rebinding a pinned bucket floor at "
                            "runtime bypasses the shape-contract and "
                            "residency validation (use `python -m "
                            "sctools_tpu_torch.analysis --retune` offline, "
                            "or the steering controller online)",
                        )
                    elif isinstance(target, ast.Subscript):
                        base = target.value
                        key = target.slice
                        if (
                            isinstance(base, ast.Attribute)
                            and base.attr == "environ"
                            and isinstance(key, ast.Constant)
                            and key.value in _STEER_KNOB_ENVS
                        ):
                            self._report(
                                "SCX1001", node,
                                f"in-process write to {key.value}: the "
                                "prefetch/ring depth is a steering-"
                                "actuated knob; only steer/'s validated "
                                "apply path may change it at runtime",
                            )
            elif isinstance(node, ast.Call):
                func = node.func
                called = (
                    func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None
                )
                if called in _STEER_KNOB_CALLS:
                    self._report(
                        "SCX1001", node,
                        f"`{called}` outside steer/'s contract-checked "
                        "apply path: the prefetch depth override is a "
                        "steering actuation and must go through the "
                        "controller's validated decision loop",
                    )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.endswith("prefetch") and any(
                    alias.name in _STEER_KNOB_CALLS for alias in node.names
                ):
                    self._report(
                        "SCX1001", node,
                        "importing set_depth_override outside steer/: "
                        "the prefetch depth override is a steering "
                        "actuation; read prefetch_depth() instead",
                    )

    # -- SCX113 ------------------------------------------------------------

    def _boundary_call(self, call: ast.Call) -> Optional[str]:
        """The spelling when ``call`` crosses the device boundary."""
        func = call.func
        if self.aliases.is_upload(func):
            return f"{ast.unparse(func)}(...)"
        if _is_graph_replay(func):
            return f"...{func.attr}(...)"
        name = _terminal_name(func)
        if name in _BOUNDARY_CALL_NAMES:
            return f"{name}(...)" if isinstance(func, ast.Name) else f"...{name}(...)"
        return None

    @staticmethod
    def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
        kind = handler.type
        if kind is None:
            return True  # bare except
        elts = kind.elts if isinstance(kind, ast.Tuple) else [kind]
        return any(isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
                   for e in elts)

    def _check_unguarded_boundary(self) -> None:
        """try/except that swallows device-boundary failures (SCX113)."""
        if _owns_recovery(self.path):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Try):
                continue
            swallowing = [
                h for h in node.handlers
                if self._is_broad_handler(h)
                and not any(isinstance(sub, ast.Raise) for sub in ast.walk(h))
            ]
            if not swallowing:
                continue
            boundary = next(
                (b for stmt in node.body for sub in ast.walk(stmt)
                 if isinstance(sub, ast.Call) and (b := self._boundary_call(sub))),
                None,
            )
            if boundary:
                self._report(
                    "SCX113", swallowing[0],
                    f"broad `except` swallows failures from the "
                    f"device-boundary call `{boundary}`: the error loses "
                    "its taxonomy (no transient retry, no OOM bisection, "
                    "no poison quarantine) and vanishes from every "
                    "counter; route recovery through "
                    "sctools_tpu_torch.guard.run_batch / guard.retrying",
                )

    # -- SCX114 ------------------------------------------------------------

    def _tainted_names(self, scope: ast.AST) -> Set[str]:
        """Names bound to device values within one scope (syntactic; two
        passes, so a late alias is not hidden by definition order)."""
        tainted: Set[str] = set()
        for _ in range(2):
            for node in _scope_walk(scope):
                if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                    continue
                target = node.targets[0]
                base = node.value
                while isinstance(base, ast.Subscript):
                    base = base.value
                names = (
                    [e for e in target.elts if isinstance(e, ast.Name)]
                    if isinstance(target, ast.Tuple)
                    else [target] if isinstance(target, ast.Name) else []
                )
                if isinstance(base, ast.Call) and (
                    _terminal_name(base.func) in _DEVICE_PRODUCER_NAMES
                    or self.aliases.is_upload(base.func)
                ):
                    tainted.update(n.id for n in names)
                elif (
                    isinstance(base, ast.Name)
                    and base.id in tainted
                    and isinstance(target, ast.Name)
                ):
                    tainted.add(target.id)
        return tainted

    def _pull(self, call: ast.Call, tainted: Set[str]) -> Optional[str]:
        """The spelling when ``call`` pulls a device value to the host."""
        func = call.func
        np_fn = self.aliases.np_call(func)
        if np_fn in ("asarray", "array") and call.args:
            root = _receiver_root(call.args[0])
            return f"`np.{np_fn}` on device value `{root}`" if root in tainted else None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr == "to":
            target = call.args[0] if call.args else next(
                (kw.value for kw in call.keywords if kw.arg == "device"), None)
            if target is None or not _is_cpu(target):
                return None
        elif func.attr not in _PULL_METHODS:
            return None
        root = _receiver_root(func.value)
        if root not in tainted:
            return None
        spelled = '.to("cpu")' if func.attr == "to" else f".{func.attr}()"
        return f"`{spelled}` on device value `{root}`"

    def _check_device_pull(self) -> None:
        """Pulls of device values outside the seam (SCX114)."""
        if _owns_device_puts(self.path):
            return
        scopes: List[ast.AST] = [self.tree] + [
            node for node in ast.walk(self.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            tainted = self._tainted_names(scope)
            if not tainted:
                continue
            for node in _scope_walk(scope):
                if not isinstance(node, ast.Call):
                    continue
                pull = self._pull(node, tainted)
                if pull is not None:
                    self._report(
                        "SCX114", node,
                        f"{pull} (result of an engine dispatch / "
                        "ingest.upload): this pull bypasses the transfer "
                        "ledger and the guard transient ladder; "
                        "materialize through "
                        "sctools_tpu_torch.ingest.pull(value, site=...)",
                    )

    def run(self) -> List[Finding]:
        self._check_unguarded_actuation()
        self._check_unguarded_boundary()
        self._check_device_pull()
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
                    "sctools_tpu_torch.ingest.upload(array, device, site=...)",
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
