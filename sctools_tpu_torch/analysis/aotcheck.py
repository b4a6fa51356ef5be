"""scx-aot: static dispatch-closure certifier for the serving plane.

The port's copy of ``sctools_tpu.analysis.aotcheck``: the same rule ids,
messages, JSON fields, escapes, manifest layout and
``MANIFEST_VERSION``, with the constructs the model recognises respelled
for the port. A resident serve worker must answer its *first* request
hot: every CUDA graph the request path replays is captured in warmup,
and nothing on the request path builds, loads, uploads or reads host
state that could fork one worker's graphs from another's.

- **SCX901 unclosed-serve-dispatch** — a device site
  (``xprof.instrument_site``) referenced on a serve path whose
  shape-contract entry is missing or not bucketed (``dims: "any"``): its
  signature universe is open, so some request will capture at dispatch
  time.
- **SCX902 request-path-compile** — a compile-capable call inside a
  serve-reachable function that is not a ``@warmup_step``. A capture is
  the port's compile (README, "Captures are the compiles"):
  ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
  ``torch.cuda.make_graphed_callables``, ``torch.compile``,
  ``torch.jit.script`` / ``trace``, and a graph set's ``capture(...)``.
- **SCX903 request-forked-executable** — per-request host state on a
  serve request path: ``os.environ`` reads, ``os.getenv``, writes to
  ``torch.backends.*``, and JAX's datetime and locale clauses.
- **SCX904 first-request-lazy-work** — lazy imports, a native or kernel
  build/load (``kernels.library``, ``native.library``, ``CDLL``,
  ``load_inline``, JAX's ``ensure_native`` family), or an
  ``ingest.upload`` of a table in a request-path function: one-time
  setup that belongs in ``@warmup_step``.
- **SCX905 unbounded-admission** — an intake/packing loop (``while
  True`` around journal/queue intake) reachable from a serve entry with
  no admission bound or fairness reference: one tenant's backlog can
  starve the rest.

Entry points are functions decorated ``@serve_entry`` (the port's
``ServeWorker.serve_forever``); ``@warmup_step`` functions (its
``warmup``) and everything only they reach are exempt from SCX902/904 by
construction. SCX901/902 follow the call graph across the whole
package; SCX903/904/905 are scoped to request-path functions in serving
modules (a module that defines a serve entry, or anything under the
``serve`` package).

The call graph resolves what JAX's name-resolved model does, and, so
that the serve path reaches the engine through the gatherer and
``serve/graphs.py``, a little of the types the port's serve path goes
through: a class's constructor call resolves to its ``__init__``, a
local bound from a constructor call resolves its method calls through
the class and its bases, ``self.m()`` resolves through the class, its
bases and the subclasses that override ``m``, and a receiver named
``graphs`` or ``_graphs`` is a ``GraphSet``. JAX's committed manifest
marks no site serve-reachable; the port's marks the engine's two sites.

The acting half: :func:`build_aot_manifest` writes the certified
(site, signature, sharding) universe — the shape contract plus the
serve-reachable site set, content-hashed — which the resident worker
(:mod:`sctools_tpu_torch.serve.engine`) loads, warms and validates
before accepting work: ``serve/graph_manifest.json`` is its output over
the port. ``--aot-manifest FILE`` re-derives the contract and fails when
the committed manifest's hash drifts (the staleness guard).

Stdlib-only, shares the astcache parse with the other whole-package
passes.
"""

from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field
from typing import (
    Any,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions
from .shardcheck import build_shape_contract

AOT_RULES = {
    "SCX901": "unclosed-serve-dispatch",
    "SCX902": "request-path-compile",
    "SCX903": "request-forked-executable",
    "SCX904": "first-request-lazy-work",
    "SCX905": "unbounded-admission",
}

# the analyzer machinery is the mechanism, not the subject
AOT_EXEMPT_DIRS = ("analysis",)

MANIFEST_VERSION = 1

# decorator spellings that mark entry/warmup functions
_ENTRY_DECORATORS = frozenset(("serve_entry",))
_WARMUP_DECORATORS = frozenset(("warmup_step",))

# torch attribute chains that *capture or compile* (SCX902)
_COMPILE_CHAINS = frozenset(
    (
        ("cuda", "CUDAGraph"),
        ("cuda", "graph"),
        ("cuda", "make_graphed_callables"),
        ("compile",),
        ("jit", "script"),
        ("jit", "trace"),
    )
)

# datetime/time/locale terminals whose values fork static args (SCX903)
_CLOCK_TERMINALS = frozenset(("now", "utcnow", "today", "localtime"))

# one-time-setup call terminals that belong in warmup (SCX904)
_LAZY_WORK_TERMINALS = frozenset(
    (
        "ensure_native", "build_native", "ensure_built", "LoadLibrary",
        "CDLL", "load_inline",
    )
)
# ``<module>.library(...)``: the first use of a hand kernel (kernels.py)
# or of the native layer builds and loads it (SCX904)
_LIBRARY_MODULES = frozenset(("kernels", "native"))

# the receivers of a CUDA graph set (serve/graphs.py) and its class
_GRAPH_RECEIVERS = frozenset(("graphs", "_graphs"))
_GRAPH_CLASS = "GraphSet"

# intake terminals that pull work inside a resident loop (SCX905)
_INTAKE_TERMINALS = frozenset(
    ("replay", "poll", "get_nowait", "claim", "steal", "popleft")
)

# identifier fragments that evidence an admission bound / fairness
# mechanism in the enclosing function (SCX905)
_ADMISSION_FRAGMENTS = ("admi", "fair", "max_depth", "depth_bound")


# ------------------------------------------------------------- records


@dataclass
class FuncInfo:
    """One analyzed function/method."""

    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str]
    cls_qual: Optional[str] = None
    is_serve_entry: bool = False
    is_warmup: bool = False
    # resolved call targets (qualnames) for the reach closure
    calls: List[Tuple[str, ...]] = field(default_factory=list)
    # (site_registry_name, line) — jit-site references in this body
    jit_refs: List[Tuple[str, int]] = field(default_factory=list)
    # (line, description) per rule signal
    compile_calls: List[Tuple[int, str]] = field(default_factory=list)
    host_state: List[Tuple[int, str]] = field(default_factory=list)
    lazy_work: List[Tuple[int, str]] = field(default_factory=list)
    intake_loops: List[Tuple[int, str]] = field(default_factory=list)
    has_admission_ref: bool = False


@dataclass
class ModInfo:
    """Per-module symbol tables."""

    name: str
    path: str
    is_pkg: bool
    tree: ast.AST
    # every node of the tree, walked once for the whole-module scans
    nodes: List[ast.AST] = field(default_factory=list)
    serves: bool = False  # defines a serve entry or lives under serve/
    torch_aliases: Set[str] = field(default_factory=set)
    os_aliases: Set[str] = field(default_factory=set)
    datetime_aliases: Set[str] = field(default_factory=set)
    datetime_classes: Set[str] = field(default_factory=set)
    time_aliases: Set[str] = field(default_factory=set)
    locale_aliases: Set[str] = field(default_factory=set)
    instrument_aliases: Set[str] = field(default_factory=set)
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    from_funcs: Dict[str, Tuple[Optional[str], str]] = field(
        default_factory=dict
    )
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    class_index: Dict[str, str] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)
    # local symbol -> jit-site registry name
    jit_symbols: Dict[str, str] = field(default_factory=dict)


class AotModel:
    """The whole-package serve-closure model."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.serve_entries: List[str] = []
        self.serve_reach: Set[str] = set()
        # class qual -> (defining module, base expressions)
        self.classes: Dict[str, Tuple[str, List[ast.AST]]] = {}
        self.findings: List[Finding] = []


# -------------------------------------------------------- ast helpers


def _root_chain(node: ast.AST) -> Tuple[Optional[str], List[str]]:
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, list(reversed(chain))
    return None, []


def _terminal_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _decorator_names(node: ast.AST) -> Set[str]:
    """Terminal names of every decorator (Name/Attribute/Call forms)."""
    out: Set[str] = set()
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = _terminal_name(target)
        if name is not None:
            out.add(name)
    return out


# ------------------------------------------------------------ analyzer


class _Analyzer:
    def __init__(self) -> None:
        self.model = AotModel()

    # ------------------------------------------------------- phase A

    def load(self, files: Sequence[Tuple[str, str, bool]]) -> None:
        for path, name, is_pkg in files:
            parsed = parse_cached(path)
            if parsed is None:
                continue
            _, tree = parsed
            self.model.modules[name] = ModInfo(
                name=name, path=path, is_pkg=is_pkg, tree=tree,
                nodes=list(ast.walk(tree)),
                serves="serve" in name.split("."),
            )
        for mod in self.model.modules.values():
            self._collect_imports(mod)
            self._index_functions(mod)
        for mod in self.model.modules.values():
            self._collect_jit_sites(mod)
        self._resolve_imported_sites()

    def _collect_imports(self, mod: ModInfo) -> None:
        known = self.model.modules
        for node in mod.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.name.split(".")[0] == "torch":
                        mod.torch_aliases.add(bound)
                    elif alias.name == "os":
                        mod.os_aliases.add(bound)
                    elif alias.name == "datetime":
                        mod.datetime_aliases.add(bound)
                    elif alias.name == "time":
                        mod.time_aliases.add(bound)
                    elif alias.name == "locale":
                        mod.locale_aliases.add(bound)
                    if alias.name in known:
                        mod.mod_aliases[alias.asname or alias.name] = alias.name
            elif isinstance(node, ast.ImportFrom):
                source = node.module or ""
                target = self._resolve_from(mod, node)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    orig = alias.name
                    if orig == "instrument_site":
                        mod.instrument_aliases.add(bound)
                    elif orig == "datetime" and source == "datetime":
                        mod.datetime_classes.add(bound)
                    elif orig == "getenv" and source == "os":
                        mod.os_aliases.add(bound)
                    if target is not None:
                        candidate = f"{target}.{orig}" if target else orig
                        if candidate in known:
                            mod.mod_aliases[bound] = candidate
                        else:
                            mod.from_funcs[bound] = (target, orig)

    def _resolve_from(
        self, mod: ModInfo, node: ast.ImportFrom
    ) -> Optional[str]:
        if node.level == 0:
            return node.module or None
        base = mod.name if mod.is_pkg else mod.name.rpartition(".")[0]
        parts = base.split(".") if base else []
        if node.level > 1:
            cut = node.level - 1
            if cut >= len(parts):
                return None
            parts = parts[: len(parts) - cut]
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts) or None

    def _index_functions(self, mod: ModInfo) -> None:
        def index(node, prefix, cls, cls_qual=None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}.{child.name}"
                    decorators = _decorator_names(child)
                    info = FuncInfo(
                        qual=qual, module=mod.name, path=mod.path,
                        name=child.name, line=child.lineno, cls=cls,
                        cls_qual=cls_qual,
                        is_serve_entry=bool(
                            decorators & _ENTRY_DECORATORS
                        ),
                        is_warmup=bool(decorators & _WARMUP_DECORATORS),
                    )
                    info._node = child  # type: ignore[attr-defined]
                    mod.functions.append(info)
                    mod.def_index.setdefault(child.name, []).append(qual)
                    self.model.functions[qual] = info
                    if info.is_serve_entry:
                        mod.serves = True
                        self.model.serve_entries.append(qual)
                    index(child, qual, cls, cls_qual)
                elif isinstance(child, ast.ClassDef):
                    class_qual = f"{prefix}.{child.name}"
                    mod.class_index.setdefault(child.name, class_qual)
                    self.model.classes[class_qual] = (mod.name, child.bases)
                    index(child, class_qual, child.name, class_qual)
                else:
                    index(child, prefix, cls, cls_qual)

        index(mod.tree, mod.name, None)

    # --------------------------------------------------- jit site map

    def _site_name_from_call(
        self, mod: ModInfo, call: ast.Call, default: str
    ) -> Optional[str]:
        """Registry name when ``call`` declares an instrument_site site:
        ``instrument_site(name)`` (a decorator) or its binding form
        ``instrument_site(name)(fn)``."""
        if isinstance(call.func, ast.Call):
            return self._site_name_from_call(mod, call.func, default)
        terminal = _terminal_name(call.func)
        if terminal not in mod.instrument_aliases and terminal != "instrument_site":
            return None
        return (
            _const_str(call.args[0] if call.args else None)
            or _const_str(_kw(call, "name"))
            or default
        )

    def _collect_jit_sites(self, mod: ModInfo) -> None:
        for node in mod.nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                for target in node.targets:
                    if not isinstance(target, ast.Name):
                        continue
                    site = self._site_name_from_call(
                        mod, node.value, target.id
                    )
                    if site is not None:
                        mod.jit_symbols[target.id] = site
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call):
                        site = self._site_name_from_call(
                            mod, dec, node.name
                        )
                        if site is not None:
                            mod.jit_symbols[node.name] = site

    def _resolve_imported_sites(self) -> None:
        """`from metrics.cell import cell_metrics` binds the site name."""
        for mod in self.model.modules.values():
            for bound, (target, orig) in mod.from_funcs.items():
                source = self.model.modules.get(target or "")
                if source is not None and orig in source.jit_symbols:
                    mod.jit_symbols.setdefault(
                        bound, source.jit_symbols[orig]
                    )

    # ------------------------------------------------------- phase B

    def analyze(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                self._scan_function(mod, info, info._node)  # type: ignore
        self._compute_reach()

    @staticmethod
    def _own_nodes(node: ast.AST):
        """Walk ``node`` without descending into nested function defs."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            yield sub
            if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(sub))

    def _resolve_jit_symbol(
        self, mod: ModInfo, node: ast.AST
    ) -> Optional[str]:
        """Site registry name when ``node`` references a jit site."""
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                return None
            return mod.jit_symbols.get(node.id)
        if isinstance(node, ast.Attribute):
            root, chain = _root_chain(node)
            if root in mod.mod_aliases and len(chain) == 1:
                other = self.model.modules.get(mod.mod_aliases[root])
                if other is not None:
                    return other.jit_symbols.get(chain[0])
        return None

    def _scan_function(self, mod: ModInfo, info: FuncInfo, node) -> None:
        seen_refs: Set[Tuple[str, int]] = set()
        # locals bound from a constructor call: name -> class qual
        local_types: Dict[str, str] = {}
        # closures defined here: a reference passes one on as a callback
        # (a guard's retried dispatch), which runs on this path
        nested: Dict[str, str] = {}
        own = list(self._own_nodes(node))
        for sub in own:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested[sub.name] = f"{info.qual}.{sub.name}"
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                cls_qual = self._resolve_class(mod, sub.value.func)
                for target in sub.targets:
                    if isinstance(target, ast.Name) and cls_qual is not None:
                        local_types[target.id] = cls_qual
        for sub in own:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, (ast.Name, ast.Attribute)):
                ident = (
                    sub.id if isinstance(sub, ast.Name) else sub.attr
                ).lower()
                if any(f in ident for f in _ADMISSION_FRAGMENTS):
                    info.has_admission_ref = True
                site = self._resolve_jit_symbol(mod, sub)
                if site is not None:
                    key = (site, sub.lineno)
                    if key not in seen_refs:
                        seen_refs.add(key)
                        info.jit_refs.append(key)
                self._scan_host_state_read(mod, info, sub)
                if (
                    isinstance(sub, ast.Name)
                    and isinstance(sub.ctx, ast.Load)
                    and sub.id in nested
                ):
                    info.calls.append((nested[sub.id],))
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._scan_host_state_write(mod, info, sub)
            if isinstance(sub, (ast.Import, ast.ImportFrom)):
                names = ", ".join(a.name for a in sub.names)
                info.lazy_work.append(
                    (sub.lineno, f"lazy import of '{names}'")
                )
            if isinstance(sub, ast.While):
                self._scan_intake_loop(mod, info, sub)
            if not isinstance(sub, ast.Call):
                continue
            targets = self._resolve_call(mod, sub.func, info, local_types)
            if targets:
                info.calls.append(targets)
            self._scan_compile_call(mod, info, sub)
            self._scan_host_state_call(mod, info, sub)
            self._scan_lazy_work_call(mod, info, sub)

    def _scan_compile_call(
        self, mod: ModInfo, info: FuncInfo, call: ast.Call
    ) -> None:
        func = call.func
        root, chain = _root_chain(func)
        if root in mod.torch_aliases and tuple(chain) in _COMPILE_CHAINS:
            info.compile_calls.append(
                (call.lineno, f"torch.{'.'.join(chain)}")
            )
        elif (
            isinstance(func, ast.Attribute)
            and func.attr == "capture"
            and _terminal_name(func.value) in _GRAPH_RECEIVERS
        ):
            info.compile_calls.append((call.lineno, "graph set capture"))

    def _scan_host_state_read(
        self, mod: ModInfo, info: FuncInfo, node: ast.AST
    ) -> None:
        if not isinstance(node, ast.Attribute):
            return
        root, chain = _root_chain(node)
        if root in mod.os_aliases and chain[:1] == ["environ"]:
            info.host_state.append((node.lineno, "os.environ read"))

    def _scan_host_state_write(
        self, mod: ModInfo, info: FuncInfo, node: ast.AST
    ) -> None:
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for target in targets:
            root, chain = _root_chain(target)
            if root in mod.torch_aliases and chain[:1] == ["backends"]:
                info.host_state.append(
                    (node.lineno, f"torch.{'.'.join(chain)} write")
                )

    def _scan_host_state_call(
        self, mod: ModInfo, info: FuncInfo, call: ast.Call
    ) -> None:
        func = call.func
        terminal = _terminal_name(func)
        if isinstance(func, ast.Name):
            if func.id in mod.os_aliases and terminal == "getenv":
                info.host_state.append((call.lineno, "os.getenv"))
            return
        root, chain = _root_chain(func)
        if root is None:
            return
        if root in mod.os_aliases and chain == ["getenv"]:
            info.host_state.append((call.lineno, "os.getenv"))
        elif (
            root in (mod.datetime_aliases | mod.datetime_classes)
            and chain
            and chain[-1] in _CLOCK_TERMINALS
        ):
            info.host_state.append(
                (call.lineno, f"wall-clock read ({'.'.join(chain)})")
            )
        elif root in mod.time_aliases and chain == ["localtime"]:
            info.host_state.append((call.lineno, "time.localtime"))
        elif root in mod.locale_aliases and chain:
            info.host_state.append(
                (call.lineno, f"locale.{chain[-1]} read")
            )

    def _scan_lazy_work_call(
        self, mod: ModInfo, info: FuncInfo, call: ast.Call
    ) -> None:
        terminal = _terminal_name(call.func)
        if terminal in _LAZY_WORK_TERMINALS:
            info.lazy_work.append(
                (call.lineno, f"one-time setup call '{terminal}'")
            )
            return
        if terminal not in ("upload", "library"):
            return
        # resolved back to its module: the ingest choke point, or the
        # kernel / native layer's loader
        source = ""
        if isinstance(call.func, ast.Name):
            source = (mod.from_funcs.get(call.func.id, ("", ""))[0]) or ""
        else:
            root, chain = _root_chain(call.func)
            if root is not None and len(chain) == 1:
                bound = mod.from_funcs.get(root)
                source = mod.mod_aliases.get(root, "") or (
                    f"{bound[0]}.{bound[1]}" if bound else ""
                )
        parts = source.split(".")
        if terminal == "upload" and "ingest" in parts:
            info.lazy_work.append(
                (call.lineno, "table upload on the request path")
            )
        elif terminal == "library" and parts[-1] in _LIBRARY_MODULES:
            info.lazy_work.append(
                (call.lineno, f"one-time setup call '{parts[-1]}.library'")
            )

    def _scan_intake_loop(
        self, mod: ModInfo, info: FuncInfo, loop: ast.While
    ) -> None:
        test = loop.test
        if not (
            isinstance(test, ast.Constant) and test.value in (True, 1)
        ):
            return
        for sub in ast.walk(loop):
            if isinstance(sub, ast.Call):
                terminal = _terminal_name(sub.func)
                if terminal in _INTAKE_TERMINALS:
                    info.intake_loops.append(
                        (loop.lineno, f"intake via .{terminal}()")
                    )
                    return

    # ------------------------------------------------------ resolution

    def _resolve_class(self, mod: ModInfo, expr: ast.AST) -> Optional[str]:
        """The qual of the class ``expr`` names, when it is modeled."""
        classes = self.model.classes
        if isinstance(expr, ast.Name):
            if expr.id in mod.class_index:
                return mod.class_index[expr.id]
            bound = mod.from_funcs.get(expr.id)
            if bound is not None and f"{bound[0]}.{bound[1]}" in classes:
                return f"{bound[0]}.{bound[1]}"
            return None
        if isinstance(expr, ast.Attribute):
            root, chain = _root_chain(expr)
            if root in mod.mod_aliases and len(chain) == 1:
                qual = f"{mod.mod_aliases[root]}.{chain[0]}"
                if qual in classes:
                    return qual
        return None

    def _mro(self, cls_qual: str) -> List[str]:
        """The class and its modeled bases, depth first."""
        out: List[str] = []
        stack = [cls_qual]
        while stack:
            qual = stack.pop(0)
            if qual in out or qual not in self.model.classes:
                continue
            out.append(qual)
            module, bases = self.model.classes[qual]
            mod = self.model.modules[module]
            stack.extend(
                base for base in (self._resolve_class(mod, b) for b in bases)
                if base is not None
            )
        return out

    def _method(self, cls_qual: str, name: str) -> Tuple[str, ...]:
        for qual in self._mro(cls_qual):
            if f"{qual}.{name}" in self.model.functions:
                return (f"{qual}.{name}",)
        return ()

    def _self_method(self, cls_qual: str, name: str) -> Tuple[str, ...]:
        """``self.name`` in a method of ``cls_qual``: the method found
        through the class and its bases, and every subclass override."""
        found = list(self._method(cls_qual, name))
        for other in self.model.classes:
            if other != cls_qual and cls_qual in self._mro(other):
                qual = f"{other}.{name}"
                if qual in self.model.functions and qual not in found:
                    found.append(qual)
        return tuple(found)

    def _resolve_call(
        self,
        mod: ModInfo,
        func: ast.AST,
        info: Optional[FuncInfo] = None,
        local_types: Optional[Dict[str, str]] = None,
    ) -> Tuple[str, ...]:
        cls_qual = self._resolve_class(mod, func)
        if cls_qual is not None:
            return self._method(cls_qual, "__init__")
        if isinstance(func, ast.Name):
            name = func.id
            if name in mod.def_index:
                return tuple(mod.def_index[name])
            bound = mod.from_funcs.get(name)
            if bound is not None:
                qual = f"{bound[0]}.{bound[1]}"
                if qual in self.model.functions:
                    return (qual,)
            return ()
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if root is None or not chain:
                return ()
            if root == "self" and info is not None and info.cls_qual and len(chain) == 1:
                return self._self_method(info.cls_qual, chain[0])
            if len(chain) == 1 and root in (local_types or {}):
                return self._method(local_types[root], chain[0])  # type: ignore[index]
            if len(chain) >= 1 and _terminal_name(func.value) in _GRAPH_RECEIVERS:
                for qual, (_, _) in self.model.classes.items():
                    if qual.rpartition(".")[2] == _GRAPH_CLASS:
                        return self._method(qual, chain[-1])
                return ()
            if root in mod.mod_aliases:
                qual = ".".join([mod.mod_aliases[root]] + chain)
                if qual in self.model.functions:
                    return (qual,)
        return ()

    def _compute_reach(self) -> None:
        """Closure from serve entries, stopping at warmup boundaries."""
        model = self.model
        reach: Set[str] = set(model.serve_entries)
        frontier = list(reach)
        while frontier:
            qual = frontier.pop()
            info = model.functions.get(qual)
            if info is None:
                continue
            for targets in info.calls:
                for target in targets:
                    sub = model.functions.get(target)
                    if sub is None or sub.is_warmup:
                        continue
                    if target not in reach:
                        reach.add(target)
                        frontier.append(target)
        model.serve_reach = reach

    # ----------------------------------------------------- rule checks

    @staticmethod
    def _dedupe(pairs: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        """One signal per line (nested attribute walks can double-see)."""
        seen: Dict[int, str] = {}
        for line, desc in sorted(pairs):
            seen.setdefault(line, desc)
        return sorted(seen.items())

    def check(self, contract: Optional[Dict[str, Any]] = None) -> None:
        model = self.model
        if not model.serve_entries:
            return
        sites = (contract or {}).get("sites", {})
        for qual in sorted(model.serve_reach):
            info = model.functions[qual]
            if info.is_warmup:
                continue
            mod = model.modules[info.module]
            for site, line in sorted(info.jit_refs, key=lambda r: r[1]):
                entry = sites.get(site)
                dims = entry["dims"] if entry else "absent"
                if entry is None or dims != "bucketed":
                    model.findings.append(
                        Finding(
                            rule="SCX901",
                            path=info.path,
                            line=line,
                            message=(
                                f"jit site '{site}' on the serve path from "
                                f"a @serve_entry has an open signature "
                                f"universe (shape-contract dims="
                                f"{dims}); bucket every serve-reachable "
                                f"dispatch (ops.segments.bucket_size) so "
                                f"the AOT manifest closes over it "
                                f"(docs/serving.md)"
                            ),
                        )
                    )
            for line, desc in self._dedupe(info.compile_calls):
                model.findings.append(
                    Finding(
                        rule="SCX902",
                        path=info.path,
                        line=line,
                        message=(
                            f"compile-capable call ({desc}) on a serve "
                            f"request path — a dispatch-time compile; "
                            f"move executable construction into a "
                            f"@warmup_step so replicas warm before "
                            f"admission (docs/serving.md)"
                        ),
                    )
                )
            if not mod.serves:
                continue
            for line, desc in self._dedupe(info.host_state):
                model.findings.append(
                    Finding(
                        rule="SCX903",
                        path=info.path,
                        line=line,
                        message=(
                            f"per-request host state ({desc}) on a serve "
                            f"request path forks executables between "
                            f"replicas/requests; resolve it once at "
                            f"replica startup and pass it in "
                            f"(docs/serving.md)"
                        ),
                    )
                )
            for line, desc in self._dedupe(info.lazy_work):
                model.findings.append(
                    Finding(
                        rule="SCX904",
                        path=info.path,
                        line=line,
                        message=(
                            f"{desc} on the first-request path; move it "
                            f"into a @warmup_step so the first request "
                            f"is served hot (docs/serving.md)"
                        ),
                    )
                )
            if not info.has_admission_ref:
                for line, desc in self._dedupe(info.intake_loops):
                    model.findings.append(
                        Finding(
                            rule="SCX905",
                            path=info.path,
                            line=line,
                            message=(
                                f"unbounded admission: resident loop "
                                f"({desc}) reachable from a @serve_entry "
                                f"with no admission depth/fairness bound; "
                                f"gate intake through an "
                                f"AdmissionController (docs/serving.md)"
                            ),
                        )
                    )


# ------------------------------------------------------------- entries


def build_model(paths: Sequence[str]) -> AotModel:
    """Parse + analyze every ``.py`` under ``paths`` into one AotModel."""
    analyzer = _Analyzer()
    analyzer.load(collect_py_files(paths, AOT_EXEMPT_DIRS))
    analyzer.analyze()
    return analyzer.model


def check_aot(
    paths: Sequence[str], contract: Optional[Dict[str, Any]] = None
) -> List[Finding]:
    """Run the SCX9xx pass; returns suppression-filtered findings."""
    analyzer = _Analyzer()
    analyzer.load(collect_py_files(paths, AOT_EXEMPT_DIRS))
    analyzer.analyze()
    if analyzer.model.serve_entries and contract is None:
        contract = build_shape_contract(paths)
    analyzer.check(contract)
    by_path: Dict[str, List[Finding]] = {}
    for finding in analyzer.model.findings:
        by_path.setdefault(finding.path, []).append(finding)
    out: List[Finding] = []
    for path, findings in by_path.items():
        parsed = parse_cached(path)
        if parsed is None:
            out.extend(findings)
            continue
        out.extend(Suppressions.from_text(parsed[0], "#").apply(findings))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# ------------------------------------------------------- the manifest


def contract_hash(contract: Dict[str, Any]) -> str:
    """Content hash of a shape contract (canonical JSON, sha256)."""
    canonical = json.dumps(
        contract, sort_keys=True, separators=(",", ":")
    )
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def build_aot_manifest(
    paths: Sequence[str],
    contract: Optional[Dict[str, Any]] = None,
    model: Optional[AotModel] = None,
) -> Dict[str, Any]:
    """The certified (site, signature, sharding) universe.

    The shape contract (closed bucket grammar per site) plus the
    serve-reach annotation and the content hash the staleness guard and
    the resident worker validate against.  The build step precompiles
    every ``precompile: true`` site against the persistent compilation
    cache; the worker warms them before admission.
    """
    if contract is None:
        contract = build_shape_contract(paths)
    if model is None:
        model = build_model(paths)
    reachable_sites: Set[str] = set()
    for qual in model.serve_reach:
        info = model.functions.get(qual)
        if info is not None:
            reachable_sites.update(site for site, _ in info.jit_refs)
    # warmup steps reference the sites they calibrate: those are part
    # of the certified universe too (warmed by construction)
    for info in model.functions.values():
        if info.is_warmup:
            reachable_sites.update(site for site, _ in info.jit_refs)
    sites: Dict[str, Any] = {}
    for name, entry in sorted(contract.get("sites", {}).items()):
        sites[name] = {
            "dims": entry["dims"],
            "module": entry["module"],
            "axes": entry["axes"],
            "sharded": entry["sharded"],
            "static_argnames": entry["static_argnames"],
            "serve_reachable": name in reachable_sites,
            "precompile": entry["dims"] == "bucketed",
        }
    return {
        "version": MANIFEST_VERSION,
        "contract_hash": contract_hash(contract),
        "serve_entries": sorted(
            model.functions[q].qual for q in model.serve_entries
        ),
        "sites": sites,
        "contract": contract,
    }


def validate_manifest(
    manifest: Dict[str, Any],
    paths: Sequence[str],
    fresh: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """Staleness/integrity problems with a committed manifest.

    Empty list == valid: the embedded contract matches its recorded
    hash AND a freshly derived contract over ``paths`` (or ``fresh``, one
    already derived there) hashes the same — i.e. the precompile set was
    built from the code being served.
    """
    problems: List[str] = []
    version = manifest.get("version")
    if version != MANIFEST_VERSION:
        problems.append(
            f"manifest version {version!r} != {MANIFEST_VERSION}"
        )
    embedded = manifest.get("contract")
    recorded = manifest.get("contract_hash")
    if not isinstance(embedded, dict) or not recorded:
        problems.append("manifest missing embedded contract or hash")
        return problems
    actual = contract_hash(embedded)
    if actual != recorded:
        problems.append(
            f"embedded contract hash mismatch (recorded {recorded[:12]}…, "
            f"actual {actual[:12]}…): manifest was hand-edited"
        )
    fresh_hash = contract_hash(
        fresh if fresh is not None else build_shape_contract(paths)
    )
    if fresh_hash != recorded:
        problems.append(
            f"manifest is STALE: fresh shape contract hashes "
            f"{fresh_hash[:12]}… but the committed manifest was built from "
            f"{recorded[:12]}…; regenerate with --emit-aot-manifest"
        )
    return problems
