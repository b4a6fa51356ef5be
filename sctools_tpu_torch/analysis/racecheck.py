"""Static concurrency & death-path analysis (SCX4xx) of the port.

The port's counterpart of ``sctools_tpu.analysis.racecheck``. The port
holds a handful of named locks (the native and kernel loaders, the
whitelist table cache, the fault registry, the scheduler journal, the
frame witness) and three thread entries (the scheduler's and the serve
worker's lease heartbeats and the prefetch producer). This pass checks
their invariants over a whole-package model. Every ``.py`` file under the
given paths is parsed into one model:

1. a **lock inventory**: module-global, class-instance, and
   function-local locks, created raw (``threading.Lock()``) or named
   (``make_lock("native.loader")`` — the :mod:`.witness` factories, whose
   string argument is the lock's stable identity shared with the runtime
   witness);
2. a **thread-entry inventory**: ``threading.Thread(target=...)``
   producers, ``threading.Timer`` callbacks and ``signal.signal``
   handlers;
3. an **interprocedural call graph** (name-based, best effort — see
   `Model limits` below) over which per-function *locksets* and a
   global lock **acquisition-order graph** are computed.

Rules:

- **SCX401 lock-order-inversion** — the blocking edges of the order
  graph contain a cycle: two code paths acquire the same locks in
  opposite orders (potential ABBA deadlock). Bounded acquires
  (``acquire(timeout=...)``) cannot deadlock permanently and are
  excluded from cycle detection (but kept in the emitted graph).
- **SCX402 blocking-lock-on-death-path** — a function reachable from a
  signal handler takes a blocking ``with lock:`` / ``lock.acquire()``.
  The signal may have interrupted the holder of that very lock on the
  same thread; use a bounded acquire.
- **SCX403 unlocked-cross-thread-write** — a mutable module-global is
  written from >= 2 distinct entry roots (main + a thread/timer/signal
  entry) with no common lock held across the write sites. Heuristic by
  design (aliased mutations and instance state are out of scope);
  suppress deliberate exceptions inline with a justification.
- **SCX404 unbounded-teardown-wait** — ``thread.join()`` /
  ``queue.get()`` without a timeout on a teardown path (a ``finally:``
  block, or a function named/reached from ``close``/``stop``/
  ``shutdown``/``__exit__``...). A source wedged in I/O must not hang
  abandonment; bound the wait and leave a counter, as
  ``utils/prefetch.py`` does.

The JAX package's pass models more death roots than this one: its
flight recorder (``obs.flight_dump``), the flight-section providers it
calls (``obs.register_flight_section``, ``obs.bounded_snapshot``) and a
SIGTERM handler. The port has none of them, so its death roots are
``signal.signal`` handlers only, and on the port's tree there are none.

Model limits (documented, deliberate): calls are resolved by name
through package-internal imports, ``self.method``, and module-level
aliases — calls through arbitrary objects (``stream.next(...)``) and
containers are invisible; ``with`` blocks define held regions while
bare ``.acquire()`` records an acquisition but not a region; instance
attributes are outside SCX403. The runtime witness
(``SCTOOLS_TPU_LOCK_DEBUG=1``, :mod:`.witness`) exists exactly to check
the model against live runs: ``chip_smoke.py``'s analysis phase asserts
every *observed* acquisition-order edge is in the static graph emitted
here (``--emit-lock-graph``).

Pure stdlib, imports nothing under analysis, honors ``# scx-lint:
disable=SCX4xx`` escapes. The ``analysis/`` package itself (this pass +
the witness machinery) is exempt — it is the mechanism, not the subject.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions

RACE_RULES = {
    "SCX401": "lock-order-inversion",
    "SCX402": "blocking-lock-on-death-path",
    "SCX403": "unlocked-cross-thread-write",
    "SCX404": "unbounded-teardown-wait",
}
# the analyzer + witness are the mechanism, not the subject: their
# internal (raw, deliberately un-witnessed) locks are exempt
RACE_EXEMPT_DIRS = ("analysis",)

# function names that ARE teardown context (their bodies, and everything
# they call, run during close/abandonment)
TEARDOWN_NAMES = frozenset(
    (
        "close", "stop", "shutdown", "abandon", "teardown", "terminate",
        "finalize", "cleanup", "__exit__", "__del__",
    )
)

# mutating method names that count as a write to the receiver (SCX403)
_MUTATORS = frozenset(
    (
        "append", "extend", "insert", "add", "update", "setdefault",
        "pop", "popleft", "popitem", "remove", "discard", "clear",
        "appendleft",
    )
)

# constructors whose instances are internally synchronized: writes
# through them are not data races (queue.Queue IS the sanctioned
# cross-thread channel; threading.local is per-thread by definition)
_THREAD_SAFE_CTORS = frozenset(
    (
        "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "Event",
        "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
        "Barrier", "local",
    )
)
_MUTABLE_CTORS = frozenset(
    ("dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter")
)


# --------------------------------------------------------------- records

@dataclass
class Acq:
    """One lock acquisition site."""

    lock_id: str
    path: str
    line: int
    end_line: int
    bounded: bool  # timeout= / acquire(False); cannot deadlock forever
    held: Tuple[str, ...]  # lock ids held (via with-blocks) at this point


@dataclass
class CallSite:
    targets: Tuple[str, ...]  # resolved candidate qualnames
    path: str
    line: int
    held: Tuple[str, ...]
    in_finally: bool


@dataclass
class Write:
    var: str  # module-qualified global name
    path: str
    line: int
    end_line: int
    held: Tuple[str, ...]


@dataclass
class Wait:
    kind: str  # "join" | "get"
    path: str
    line: int
    end_line: int
    in_finally: bool


@dataclass
class FuncInfo:
    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str] = None
    parent: Optional[str] = None  # enclosing function qual (closures)
    acqs: List[Acq] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    writes: List[Write] = field(default_factory=list)
    waits: List[Wait] = field(default_factory=list)
    local_locks: Dict[str, str] = field(default_factory=dict)
    global_decls: Set[str] = field(default_factory=set)
    local_binds: Set[str] = field(default_factory=set)


@dataclass
class ModuleInfo:
    name: str
    path: str
    is_pkg: bool
    tree: Optional[ast.Module] = None
    mod_aliases: Dict[str, str] = field(default_factory=dict)  # name -> module
    from_funcs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    threading_aliases: Set[str] = field(default_factory=set)
    signal_aliases: Set[str] = field(default_factory=set)
    from_threading: Dict[str, str] = field(default_factory=dict)  # bound -> orig
    global_locks: Dict[str, str] = field(default_factory=dict)  # var -> lock id
    class_locks: Dict[Tuple[str, str], str] = field(default_factory=dict)
    global_vars: Set[str] = field(default_factory=set)
    mutable_globals: Set[str] = field(default_factory=set)
    safe_globals: Set[str] = field(default_factory=set)
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)


@dataclass
class Registration:
    kind: str  # "thread" | "timer" | "signal"
    targets: Tuple[str, ...]
    path: str
    line: int


class RaceModel:
    """The whole-package concurrency model (shared by rules + graph)."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.registrations: List[Registration] = []
        self.locks: Dict[str, Dict[str, object]] = {}  # id -> decl info
        # (a, b) -> {"bounded": bool, "sites": [(path, line), ...]}
        self.edges: Dict[Tuple[str, str], Dict[str, object]] = {}
        self.findings: List[Finding] = []

    def lock_graph(self) -> Dict[str, object]:
        """The lock inventory + order graph as JSON-safe data (the
        ``--emit-lock-graph`` payload the runtime witness validates
        against)."""
        edges = [
            {
                "from": a,
                "to": b,
                "bounded": entry["bounded"],
                "sites": [
                    f"{path}:{line}" for path, line in sorted(entry["sites"])
                ],
            }
            for (a, b), entry in sorted(self.edges.items())
        ]
        return {
            "version": 1,
            "locks": {
                lock_id: {
                    "kind": decl["kind"],
                    "module": decl["module"],
                    "line": decl["line"],
                }
                for lock_id, decl in sorted(self.locks.items())
            },
            "edges": edges,
            "entries": [
                {
                    "kind": reg.kind,
                    "targets": sorted(reg.targets),
                    "site": f"{reg.path}:{reg.line}",
                }
                for reg in self.registrations
            ],
        }


# ------------------------------------------------------------ collection

def _collect_py_files(paths: Sequence[str]) -> List[Tuple[str, str, bool]]:
    """(file_path, module_name, is_pkg) for every analyzable .py file."""
    return collect_py_files(paths, RACE_EXEMPT_DIRS)


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


def _lock_ctor(mod: ModuleInfo, call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
    """("lock"|"rlock", explicit_name) when ``call`` constructs a lock."""
    func = call.func
    terminal = _terminal_name(func)
    if terminal in ("make_lock", "make_rlock"):
        kind = "lock" if terminal == "make_lock" else "rlock"
        name = _const_str(call.args[0] if call.args else None)
        return kind, name
    if terminal in ("Lock", "RLock"):
        root, chain = _root_chain(func)
        if (
            (root in mod.threading_aliases and chain == [terminal])
            or (
                isinstance(func, ast.Name)
                and mod.from_threading.get(func.id) == terminal
            )
        ):
            return ("lock" if terminal == "Lock" else "rlock"), None
    return None


def _ctor_terminal(mod: ModuleInfo, value: ast.AST) -> Optional[str]:
    """The constructor name when ``value`` is a plain ``Ctor(...)`` call."""
    if not isinstance(value, ast.Call):
        return None
    terminal = _terminal_name(value.func)
    if isinstance(value.func, ast.Name):
        return mod.from_threading.get(terminal, terminal)
    return terminal


def _module_stmts(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
    """Module-scope statements, descending into compound blocks.

    A global assigned under ``try:``/``if:`` (the ``try: lock =
    threading.Lock() except ImportError: ...`` idiom) still binds the
    module namespace; only def/class bodies open a new scope.
    """
    for stmt in body:
        yield stmt
        if isinstance(stmt, ast.Try):
            for sub in (
                [stmt.body, stmt.orelse, stmt.finalbody]
                + [h.body for h in stmt.handlers]
            ):
                yield from _module_stmts(sub)
        elif isinstance(stmt, (ast.If, ast.While, ast.For, ast.AsyncFor)):
            yield from _module_stmts(stmt.body)
            yield from _module_stmts(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield from _module_stmts(stmt.body)
        elif isinstance(stmt, ast.Match):
            for case in stmt.cases:
                yield from _module_stmts(case.body)


def _bind_target(target: ast.AST, binds: Set[str]) -> None:
    if isinstance(target, ast.Name):
        binds.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _bind_target(elt, binds)
    elif isinstance(target, ast.Starred):
        _bind_target(target.value, binds)


def _local_binds(node: ast.AST) -> Set[str]:
    """Names bound in this function's own scope (params + assignments).

    Nested def/class/lambda bodies are pruned (their own scope), as are
    comprehension targets (their own scope since py3). A local binding
    shadows a same-named module global for SCX403's write attribution.
    """
    binds: Set[str] = set()
    args = node.args
    for arg in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        binds.add(arg.arg)
    if args.vararg is not None:
        binds.add(args.vararg.arg)
    if args.kwarg is not None:
        binds.add(args.kwarg.arg)
    todo: List[ast.AST] = list(node.body)
    while todo:
        sub = todo.pop()
        if isinstance(
            sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            binds.add(sub.name)
            continue
        if isinstance(sub, ast.Lambda):
            continue
        if isinstance(sub, ast.Assign):
            for target in sub.targets:
                _bind_target(target, binds)
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
            _bind_target(sub.target, binds)
        elif isinstance(sub, (ast.For, ast.AsyncFor)):
            _bind_target(sub.target, binds)
        elif isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if item.optional_vars is not None:
                    _bind_target(item.optional_vars, binds)
        elif isinstance(sub, ast.ExceptHandler) and sub.name:
            binds.add(sub.name)
        todo.extend(ast.iter_child_nodes(sub))
    return binds


class _Analyzer:
    def __init__(self) -> None:
        self.model = RaceModel()

    # ---------------------------------------------------------- phase A

    def load(self, files: Sequence[Tuple[str, str, bool]]) -> None:
        for path, name, is_pkg in files:
            parsed = parse_cached(path)
            if parsed is None:
                continue  # SCX100 is the jaxlint pass's job
            _, tree = parsed
            mod = ModuleInfo(name=name, path=path, is_pkg=is_pkg, tree=tree)
            self.model.modules[name] = mod
        for mod in self.model.modules.values():
            self._collect_imports(mod)
            self._collect_globals(mod)
            self._index_functions(mod)
        for mod in self.model.modules.values():
            self._collect_instance_locks(mod)

    def _collect_imports(self, mod: ModuleInfo) -> None:
        known = self.model.modules
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.name == "threading":
                        mod.threading_aliases.add(bound)
                    elif alias.name == "signal":
                        mod.signal_aliases.add(bound)
                    elif alias.name in known:
                        mod.mod_aliases[alias.asname or alias.name] = alias.name
                    elif alias.name.split(".")[0] in known and not alias.asname:
                        mod.mod_aliases[bound] = bound
            elif isinstance(node, ast.ImportFrom):
                target = self._resolve_from(mod, node)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if node.module == "threading" and node.level == 0:
                        mod.from_threading[bound] = alias.name
                        continue
                    if target is None:
                        continue
                    candidate = f"{target}.{alias.name}" if target else alias.name
                    if candidate in known:
                        mod.mod_aliases[bound] = candidate
                    else:
                        mod.from_funcs[bound] = (target, alias.name)

    def _resolve_from(self, mod: ModuleInfo, node: ast.ImportFrom) -> Optional[str]:
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

    def _collect_globals(self, mod: ModuleInfo) -> None:
        for stmt in _module_stmts(mod.tree.body):
            targets: List[ast.expr] = []
            value: Optional[ast.AST] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            for target in targets:
                if not isinstance(target, ast.Name):
                    continue
                var = target.id
                mod.global_vars.add(var)
                if isinstance(value, ast.Call):
                    ctor = _lock_ctor(mod, value)
                    if ctor is not None:
                        kind, explicit = ctor
                        lock_id = explicit or f"{mod.name}.{var}"
                        mod.global_locks[var] = lock_id
                        self.model.locks[lock_id] = {
                            "kind": kind, "module": mod.name,
                            "path": mod.path, "line": stmt.lineno,
                        }
                        continue
                    terminal = _ctor_terminal(mod, value)
                    if terminal in _THREAD_SAFE_CTORS:
                        mod.safe_globals.add(var)
                    elif terminal in _MUTABLE_CTORS:
                        mod.mutable_globals.add(var)
                    # module-level function alias: X = faults.fire
                elif isinstance(value, ast.Attribute):
                    root, chain = _root_chain(value)
                    if root in mod.mod_aliases and chain:
                        base = mod.mod_aliases[root]
                        mod.from_funcs[var] = (
                            ".".join([base] + chain[:-1]), chain[-1]
                        )
                elif isinstance(
                    value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                            ast.ListComp, ast.SetComp)
                ):
                    mod.mutable_globals.add(var)

    def _index_functions(self, mod: ModuleInfo) -> None:
        def index(node, prefix: str, cls: Optional[str], parent: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}.{child.name}"
                    info = FuncInfo(
                        qual=qual, module=mod.name, path=mod.path,
                        name=child.name, line=child.lineno, cls=cls,
                        parent=parent,
                    )
                    info._node = child  # type: ignore[attr-defined]
                    mod.functions.append(info)
                    mod.def_index.setdefault(child.name, []).append(qual)
                    self.model.functions[qual] = info
                    index(child, qual, cls, qual)
                elif isinstance(child, ast.ClassDef):
                    index(child, f"{prefix}.{child.name}", child.name, parent)
                else:
                    index(child, prefix, cls, parent)

        index(mod.tree, mod.name, None, None)
        # module-level statements form the "<module>" pseudo-function
        pseudo = FuncInfo(
            qual=f"{mod.name}.<module>", module=mod.name, path=mod.path,
            name="<module>", line=1,
        )
        pseudo._node = mod.tree  # type: ignore[attr-defined]
        mod.functions.append(pseudo)
        self.model.functions[pseudo.qual] = pseudo

    def _collect_instance_locks(self, mod: ModuleInfo) -> None:
        for info in mod.functions:
            if info.cls is None or info.name == "<module>":
                continue
            node = getattr(info, "_node", None)
            if node is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                if not isinstance(sub.value, ast.Call):
                    continue
                ctor = _lock_ctor(mod, sub.value)
                if ctor is None:
                    continue
                kind, explicit = ctor
                for target in sub.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        lock_id = explicit or (
                            f"{mod.name}.{info.cls}.{target.attr}"
                        )
                        mod.class_locks[(info.cls, target.attr)] = lock_id
                        self.model.locks[lock_id] = {
                            "kind": kind, "module": mod.name,
                            "path": mod.path, "line": sub.lineno,
                        }

    # ------------------------------------------------------- resolution

    def _resolve_call(
        self, mod: ModuleInfo, func: ast.AST, cls: Optional[str]
    ) -> Tuple[str, ...]:
        if isinstance(func, ast.Name):
            name = func.id
            if name in mod.def_index:
                return tuple(mod.def_index[name])
            if name in mod.from_funcs:
                fmod, attr = mod.from_funcs[name]
                qual = f"{fmod}.{attr}"
                if qual in self.model.functions:
                    return (qual,)
            return ()
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if root is None or not chain:
                return ()
            if root == "self" and cls is not None and len(chain) == 1:
                qual = f"{mod.name}.{cls}.{chain[0]}"
                if qual in self.model.functions:
                    return (qual,)
                return ()
            if root in mod.mod_aliases:
                base = mod.mod_aliases[root]
                qual = ".".join([base] + chain)
                if qual in self.model.functions:
                    return (qual,)
        return ()

    def _resolve_lock_expr(
        self,
        mod: ModuleInfo,
        expr: ast.AST,
        info: FuncInfo,
        cls: Optional[str],
    ) -> Optional[str]:
        if isinstance(expr, ast.Name):
            probe: Optional[FuncInfo] = info
            while probe is not None:
                if expr.id in probe.local_locks:
                    return probe.local_locks[expr.id]
                probe = (
                    self.model.functions.get(probe.parent)
                    if probe.parent else None
                )
            return mod.global_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            root, chain = _root_chain(expr)
            if root == "self" and cls is not None and len(chain) == 1:
                return mod.class_locks.get((cls, chain[0]))
            if root in mod.mod_aliases and len(chain) == 1:
                other = self.model.modules.get(mod.mod_aliases[root])
                if other is not None:
                    return other.global_locks.get(chain[0])
        return None

    # ---------------------------------------------------------- phase B

    def analyze_bodies(self) -> None:
        # local lock decls + global statements first (closures resolve
        # through enclosing functions, so all locals must exist before
        # any body walk)
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                body_nodes = (
                    node.body if not isinstance(node, ast.Module)
                    else node.body
                )
                if not isinstance(node, ast.Module):
                    info.local_binds = _local_binds(node)
                for stmt in body_nodes:
                    if isinstance(stmt, ast.Global):
                        info.global_decls.update(stmt.names)
                    if isinstance(stmt, ast.Assign) and isinstance(
                        stmt.value, ast.Call
                    ):
                        ctor = _lock_ctor(mod, stmt.value)
                        if ctor is not None and info.name != "<module>":
                            kind, explicit = ctor
                            for target in stmt.targets:
                                if isinstance(target, ast.Name):
                                    lock_id = explicit or (
                                        f"{info.qual}.{target.id}"
                                    )
                                    info.local_locks[target.id] = lock_id
                                    self.model.locks.setdefault(
                                        lock_id,
                                        {
                                            "kind": kind,
                                            "module": mod.name,
                                            "path": mod.path,
                                            "line": stmt.lineno,
                                        },
                                    )
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                if isinstance(node, ast.Module):
                    stmts = [
                        s for s in node.body
                        if not isinstance(
                            s,
                            (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef),
                        )
                    ]
                else:
                    stmts = node.body
                self._walk_body(mod, info, stmts, (), False)

    def _walk_body(
        self,
        mod: ModuleInfo,
        info: FuncInfo,
        stmts: Sequence[ast.stmt],
        held: Tuple[str, ...],
        in_finally: bool,
    ) -> None:
        for stmt in stmts:
            self._walk_stmt(mod, info, stmt, held, in_finally)

    def _walk_stmt(
        self,
        mod: ModuleInfo,
        info: FuncInfo,
        stmt: ast.stmt,
        held: Tuple[str, ...],
        in_finally: bool,
    ) -> None:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return  # separate FuncInfo walks the nested body
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                self._scan_expr(mod, info, item.context_expr, inner, in_finally)
                lock_id = self._resolve_lock_expr(
                    mod, item.context_expr, info, info.cls
                )
                if lock_id is not None:
                    info.acqs.append(
                        Acq(
                            lock_id=lock_id, path=mod.path,
                            line=item.context_expr.lineno,
                            end_line=getattr(
                                item.context_expr, "end_lineno",
                                item.context_expr.lineno,
                            ) or item.context_expr.lineno,
                            bounded=False, held=inner,
                        )
                    )
                    inner = inner + (lock_id,)
            self._walk_body(mod, info, stmt.body, inner, in_finally)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(mod, info, stmt.body, held, in_finally)
            for handler in stmt.handlers:
                self._walk_body(mod, info, handler.body, held, in_finally)
            self._walk_body(mod, info, stmt.orelse, held, in_finally)
            self._walk_body(mod, info, stmt.finalbody, held, True)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(mod, info, stmt.test, held, in_finally)
            self._walk_body(mod, info, stmt.body, held, in_finally)
            self._walk_body(mod, info, stmt.orelse, held, in_finally)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(mod, info, stmt.iter, held, in_finally)
            self._walk_body(mod, info, stmt.body, held, in_finally)
            self._walk_body(mod, info, stmt.orelse, held, in_finally)
            return
        if isinstance(stmt, ast.Match):
            self._scan_expr(mod, info, stmt.subject, held, in_finally)
            for case in stmt.cases:
                if case.guard is not None:
                    self._scan_expr(mod, info, case.guard, held, in_finally)
                self._walk_body(mod, info, case.body, held, in_finally)
            return
        # leaf statements: writes + expression scan
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._check_write_target(mod, info, target, stmt, held)
            self._scan_expr(mod, info, stmt.value, held, in_finally)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._check_write_target(mod, info, stmt.target, stmt, held)
                self._scan_expr(mod, info, stmt.value, held, in_finally)
            return
        if isinstance(stmt, ast.AugAssign):
            self._check_write_target(mod, info, stmt.target, stmt, held)
            self._scan_expr(mod, info, stmt.value, held, in_finally)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self._check_write_target(mod, info, target, stmt, held)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan_expr(mod, info, child, held, in_finally)

    def _is_locally_bound(self, info: FuncInfo, name: str) -> bool:
        """True when ``name`` resolves to a function-scope binding.

        Walks the enclosing-function chain the same way
        :meth:`_resolve_lock_expr` does: a ``global`` declaration at any
        level re-exposes the module global; a local binding at any level
        shadows it (closures write the enclosing local, not the global).
        """
        probe: Optional[FuncInfo] = info
        while probe is not None:
            if name in probe.global_decls:
                return False
            if name in probe.local_binds:
                return True
            probe = (
                self.model.functions.get(probe.parent)
                if probe.parent else None
            )
        return False

    def _check_write_target(
        self,
        mod: ModuleInfo,
        info: FuncInfo,
        target: ast.AST,
        stmt: ast.stmt,
        held: Tuple[str, ...],
    ) -> None:
        var: Optional[str] = None
        if isinstance(target, ast.Name):
            # a bare-name rebind only touches the module global when the
            # function declared it `global`
            if target.id in info.global_decls or info.name == "<module>":
                var = target.id
        elif isinstance(target, ast.Subscript) and isinstance(
            target.value, ast.Name
        ):
            # a function-local binding (here or in an enclosing scope)
            # shadows a same-named module global; the subscript mutates
            # the local, not shared state
            if self._is_locally_bound(info, target.value.id):
                return
            var = target.value.id
        if var is None:
            return
        if info.name == "<module>":
            return  # module-level init is single-threaded import time
        if var not in mod.global_vars or var in mod.safe_globals:
            return
        if var in mod.global_locks:
            return
        info.writes.append(
            Write(
                var=f"{mod.name}.{var}", path=mod.path, line=stmt.lineno,
                end_line=getattr(stmt, "end_lineno", stmt.lineno)
                or stmt.lineno,
                held=held,
            )
        )

    def _scan_expr(
        self,
        mod: ModuleInfo,
        info: FuncInfo,
        expr: ast.AST,
        held: Tuple[str, ...],
        in_finally: bool,
    ) -> None:
        # prune-aware walk: a call inside a lambda body is deferred, not
        # executed under the current held lockset (ast.walk would still
        # yield it, minting phantom order edges). Lambda default values
        # DO evaluate at creation time, so those stay in the walk.
        todo: List[ast.AST] = [expr]
        while todo:
            node = todo.pop()
            if isinstance(node, ast.Lambda):
                todo.extend(node.args.defaults)
                todo.extend(
                    d for d in node.args.kw_defaults if d is not None
                )
                continue
            if isinstance(node, ast.Call):
                self._classify_call(mod, info, node, held, in_finally)
            todo.extend(ast.iter_child_nodes(node))

    def _classify_call(
        self,
        mod: ModuleInfo,
        info: FuncInfo,
        node: ast.Call,
        held: Tuple[str, ...],
        in_finally: bool,
    ) -> None:
        func = node.func
        terminal = _terminal_name(func)
        end_line = getattr(node, "end_lineno", node.lineno) or node.lineno
        # lock constructor: a declaration, not a call edge
        if _lock_ctor(mod, node) is not None:
            return
        # registrations ---------------------------------------------------
        if terminal in ("Thread", "Timer"):
            root, chain = _root_chain(func)
            from_threading = (
                isinstance(func, ast.Name)
                and mod.from_threading.get(func.id) == terminal
            )
            if (root in mod.threading_aliases and chain == [terminal]) or \
                    from_threading:
                target_expr = None
                if terminal == "Thread":
                    if len(node.args) >= 2:
                        # Thread(group, target, ...) positional form
                        target_expr = node.args[1]
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target_expr = kw.value
                elif len(node.args) >= 2:
                    target_expr = node.args[1]
                else:
                    for kw in node.keywords:
                        if kw.arg == "function":
                            target_expr = kw.value
                if target_expr is not None:
                    targets = self._resolve_call(mod, target_expr, info.cls)
                    if targets:
                        self.model.registrations.append(
                            Registration(
                                "thread" if terminal == "Thread" else "timer",
                                targets, mod.path, node.lineno,
                            )
                        )
                return
        if terminal == "signal":
            root, chain = _root_chain(func)
            if root in mod.signal_aliases and chain == ["signal"] and \
                    len(node.args) >= 2:
                targets = self._resolve_call(mod, node.args[1], info.cls)
                if targets:
                    self.model.registrations.append(
                        Registration("signal", targets, mod.path, node.lineno)
                    )
                return
        # lock.acquire() --------------------------------------------------
        if terminal == "acquire" and isinstance(func, ast.Attribute):
            lock_id = self._resolve_lock_expr(mod, func.value, info, info.cls)
            if lock_id is not None:
                bounded = any(kw.arg == "timeout" for kw in node.keywords)
                if not bounded and len(node.args) >= 2:
                    bounded = True  # positional timeout
                if not bounded and node.args:
                    first = node.args[0]
                    if isinstance(first, ast.Constant) and first.value is False:
                        bounded = True  # non-blocking probe
                if not bounded:
                    bounded = any(
                        kw.arg == "blocking"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                        for kw in node.keywords
                    )  # non-blocking probe, keyword form
                info.acqs.append(
                    Acq(
                        lock_id=lock_id, path=mod.path, line=node.lineno,
                        end_line=end_line, bounded=bounded, held=held,
                    )
                )
                return
        # unbounded waits (SCX404 candidates) ----------------------------
        if terminal == "join" and isinstance(func, ast.Attribute):
            if not node.args and not node.keywords:
                info.waits.append(
                    Wait("join", mod.path, node.lineno, end_line, in_finally)
                )
                return
        if terminal == "get" and isinstance(func, ast.Attribute):
            has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
            blockish = not node.args and not node.keywords
            if not blockish and not has_timeout:
                if len(node.args) == 1 and isinstance(
                    node.args[0], ast.Constant
                ) and node.args[0].value is True and len(node.args) < 2:
                    blockish = True
                elif not node.args and all(
                    kw.arg == "block" for kw in node.keywords
                ) and node.keywords:
                    values = [
                        kw.value for kw in node.keywords if kw.arg == "block"
                    ]
                    blockish = all(
                        isinstance(v, ast.Constant) and v.value is True
                        for v in values
                    )
            if blockish and not has_timeout:
                info.waits.append(
                    Wait("get", mod.path, node.lineno, end_line, in_finally)
                )
                return
        # mutator-method global writes (SCX403) --------------------------
        if (
            terminal in _MUTATORS
            and isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            var = func.value.id
            if (
                var in mod.global_vars
                and var not in mod.safe_globals
                and var not in mod.global_locks
                and info.name != "<module>"
                and not self._is_locally_bound(info, var)
            ):
                info.writes.append(
                    Write(
                        var=f"{mod.name}.{var}", path=mod.path,
                        line=node.lineno, end_line=end_line, held=held,
                    )
                )
            # a mutator is also a call expression; fall through is fine
        # ordinary resolvable call ---------------------------------------
        targets = self._resolve_call(mod, func, info.cls)
        if targets:
            info.calls.append(
                CallSite(
                    targets=targets, path=mod.path, line=node.lineno,
                    held=held, in_finally=in_finally,
                )
            )

    # ---------------------------------------------------------- phase C

    def finish(self) -> None:
        self._build_edges()
        self._check_cycles()
        self._check_death_paths()
        self._check_cross_thread_writes()
        self._check_teardown_waits()

    def _acq_closures(self) -> Dict[str, Set[Tuple[str, bool]]]:
        funcs = self.model.functions
        closure: Dict[str, Set[Tuple[str, bool]]] = {
            qual: {(a.lock_id, a.bounded) for a in info.acqs}
            for qual, info in funcs.items()
        }
        changed = True
        while changed:
            changed = False
            for qual, info in funcs.items():
                mine = closure[qual]
                before = len(mine)
                for call in info.calls:
                    for target in call.targets:
                        other = closure.get(target)
                        if other:
                            mine |= other
                if len(mine) != before:
                    changed = True
        return closure

    def _build_edges(self) -> None:
        closure = self._acq_closures()
        edges = self.model.edges

        def add_edge(a: str, b: str, bounded: bool, path: str, line: int):
            if a == b:
                return  # reentrant / same-name sibling instances
            entry = edges.get((a, b))
            if entry is None:
                edges[(a, b)] = {"bounded": bounded, "sites": [(path, line)]}
            else:
                entry["bounded"] = entry["bounded"] and bounded
                if (path, line) not in entry["sites"]:
                    entry["sites"].append((path, line))

        for info in self.model.functions.values():
            for acq in info.acqs:
                for h in acq.held:
                    add_edge(h, acq.lock_id, acq.bounded, acq.path, acq.line)
            for call in info.calls:
                if not call.held:
                    continue
                reachable: Set[Tuple[str, bool]] = set()
                for target in call.targets:
                    reachable |= closure.get(target, set())
                for lock_id, bounded in reachable:
                    for h in call.held:
                        add_edge(h, lock_id, bounded, call.path, call.line)

    def _check_cycles(self) -> None:
        blocking: Dict[str, Set[str]] = {}
        for (a, b), entry in self.model.edges.items():
            if not entry["bounded"]:
                blocking.setdefault(a, set()).add(b)
        # iterative Tarjan SCC
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        sccs: List[List[str]] = []

        def strongconnect(start: str) -> None:
            work = [(start, iter(sorted(blocking.get(start, ()))))]
            index[start] = low[start] = counter[0]
            counter[0] += 1
            stack.append(start)
            on_stack.add(start)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(sorted(blocking.get(nxt, ())))))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    component: List[str] = []
                    while True:
                        member = stack.pop()
                        on_stack.discard(member)
                        component.append(member)
                        if member == node:
                            break
                    if len(component) > 1:
                        sccs.append(sorted(component))

        nodes = set(blocking)
        for targets in blocking.values():
            nodes |= targets
        for node in sorted(nodes):
            if node not in index:
                strongconnect(node)

        reported: Set[Tuple[str, int]] = set()
        for component in sccs:
            members = set(component)
            cycle_name = " -> ".join(component + [component[0]])
            for (a, b), entry in sorted(self.model.edges.items()):
                if entry["bounded"] or a not in members or b not in members:
                    continue
                path, line = sorted(entry["sites"])[0]
                if (path, line) in reported:
                    continue
                reported.add((path, line))
                self.model.findings.append(
                    Finding(
                        "SCX401", path, line,
                        f"lock-order inversion: acquiring `{b}` while "
                        f"holding `{a}` closes the cycle {{{cycle_name}}} "
                        "— two paths take these locks in opposite orders "
                        "(potential ABBA deadlock); pick one global order",
                    )
                )

    def _death_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for reg in self.model.registrations:
            if reg.kind == "signal":
                roots.update(reg.targets)
        return roots

    def _reachable(self, roots: Set[str]) -> Set[str]:
        seen = set(roots)
        frontier = list(roots)
        funcs = self.model.functions
        while frontier:
            qual = frontier.pop()
            info = funcs.get(qual)
            if info is None:
                continue
            for call in info.calls:
                for target in call.targets:
                    if target not in seen:
                        seen.add(target)
                        frontier.append(target)
        return seen

    def _check_death_paths(self) -> None:
        roots = self._death_roots()
        if not roots:
            return
        reachable = self._reachable(roots)
        reported: Set[Tuple[str, int]] = set()
        for qual in sorted(reachable):
            info = self.model.functions.get(qual)
            if info is None:
                continue
            for acq in info.acqs:
                if acq.bounded:
                    continue
                if (acq.path, acq.line) in reported:
                    continue
                reported.add((acq.path, acq.line))
                self.model.findings.append(
                    Finding(
                        "SCX402", acq.path, acq.line,
                        f"blocking acquire of `{acq.lock_id}` in "
                        f"`{qual}`, which is reachable from a signal "
                        "handler: the signal may have interrupted this "
                        "very lock's holder on the same thread, "
                        "deadlocking the death path — use a bounded "
                        "acquire (timeout=...)",
                        acq.end_line,
                    )
                )

    def _entry_roots(self) -> Dict[str, Set[str]]:
        funcs = self.model.functions
        roots: Dict[str, Set[str]] = {qual: set() for qual in funcs}
        entry_targets: Set[str] = set()
        for reg in self.model.registrations:
            if reg.kind in ("thread", "timer", "signal"):
                label = {
                    "thread": "thread", "timer": "timer", "signal": "signal",
                }[reg.kind]
                for target in reg.targets:
                    if target in roots:
                        short = target.rsplit(".", 1)[-1]
                        roots[target].add(f"{label}:{short}")
                        entry_targets.add(target)
        called: Set[str] = set()
        for info in funcs.values():
            for call in info.calls:
                called.update(call.targets)
        for qual, info in funcs.items():
            if qual not in called and qual not in entry_targets:
                roots[qual].add("main")
            if info.name == "<module>":
                roots[qual].add("main")
        changed = True
        while changed:
            changed = False
            for qual, info in funcs.items():
                mine = roots[qual]
                if not mine:
                    continue
                for call in info.calls:
                    for target in call.targets:
                        other = roots.get(target)
                        if other is not None and not mine <= other:
                            other |= mine
                            changed = True
        return roots

    def _check_cross_thread_writes(self) -> None:
        roots = self._entry_roots()
        by_var: Dict[str, List[Tuple[Write, Set[str]]]] = {}
        for qual, info in self.model.functions.items():
            for write in info.writes:
                by_var.setdefault(write.var, []).append(
                    (write, roots.get(qual, set()))
                )
        for var, sites in sorted(by_var.items()):
            union_roots: Set[str] = set()
            for _, site_roots in sites:
                union_roots |= site_roots
            if len(union_roots) < 2:
                continue
            common: Optional[FrozenSet[str]] = None
            for write, _ in sites:
                held = frozenset(write.held)
                common = held if common is None else (common & held)
            if common:
                continue
            for write, site_roots in sorted(
                sites, key=lambda s: (s[0].path, s[0].line)
            ):
                self.model.findings.append(
                    Finding(
                        "SCX403", write.path, write.line,
                        f"mutable module state `{var}` is written from "
                        f">=2 entry roots ({', '.join(sorted(union_roots))})"
                        " with no common lock across the write sites — a "
                        "torn/lost update race; guard every write with one "
                        "lock (heuristic: suppress with justification if "
                        "the race is benign by construction)",
                        write.end_line,
                    )
                )

    def _check_teardown_waits(self) -> None:
        funcs = self.model.functions
        teardown_roots: Set[str] = set()
        for qual, info in funcs.items():
            if info.name in TEARDOWN_NAMES:
                teardown_roots.add(qual)
            for call in info.calls:
                if call.in_finally:
                    teardown_roots.update(call.targets)
        reachable = self._reachable(teardown_roots) if teardown_roots else set()
        reported: Set[Tuple[str, int]] = set()
        for qual, info in funcs.items():
            in_teardown = qual in reachable
            for wait in info.waits:
                if not (wait.in_finally or in_teardown):
                    continue
                if (wait.path, wait.line) in reported:
                    continue
                reported.add((wait.path, wait.line))
                what = (
                    "Thread.join()" if wait.kind == "join" else "Queue.get()"
                )
                self.model.findings.append(
                    Finding(
                        "SCX404", wait.path, wait.line,
                        f"unbounded {what} on a teardown/abandonment path: "
                        "a peer wedged in I/O hangs the close forever — "
                        "pass timeout=... and count the abandonment "
                        "(utils/prefetch.py is the reference pattern)",
                        wait.end_line,
                    )
                )



# ------------------------------------------------------------- public API

def build_model(paths: Sequence[str]) -> RaceModel:
    """Parse + analyze every ``.py`` under ``paths`` into one RaceModel."""
    analyzer = _Analyzer()
    analyzer.load(_collect_py_files(paths))
    analyzer.analyze_bodies()
    analyzer.finish()
    return analyzer.model


def check_races(paths: Sequence[str]) -> List[Finding]:
    """Run the SCX4xx pass; returns suppression-filtered findings."""
    model = build_model(paths)
    by_path: Dict[str, List[Finding]] = {}
    for finding in model.findings:
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


def lock_graph(paths: Sequence[str]) -> Dict[str, object]:
    """The static lock inventory + acquisition-order graph as JSON data.

    The contract file for the runtime witness: ``--emit-lock-graph``
    writes this, ``SCTOOLS_TPU_LOCK_GRAPH`` points the witness at it,
    and ``chip_smoke.py`` asserts observed edges form a subgraph.
    """
    return build_model(paths).lock_graph()
