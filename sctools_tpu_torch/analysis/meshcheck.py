"""scx-mesh: static collective-safety and SPMD-divergence analysis (SCX801-805).

The port's copy of ``sctools_tpu.analysis.meshcheck``: the same rule ids,
messages, JSON fields, escapes, exempt directories and model limits, with
the constructs the model recognises respelled for the port. The port's
collectives run between the processes of a ``torch.distributed`` group
(``parallel/collective.py`` over ``parallel/distributed.py``), and every
process must call the same collectives in the same order, or the run waits
on a missing peer until the group's timeout: the hang that CPU tests show
least and a card shows most.

Whole-package and interprocedural over the shared :mod:`.astcache` parse,
like racecheck, lifecheck and costcheck. The model holds:

1. every mapped region, the port's counterpart of a JAX ``shard_map``
   site: a function decorated with ``meshwitness.mapped(label,
   replicated=...)`` (or bound as ``meshwitness.mapped(...)(fn)``), its
   ``replicated`` results (JAX's ``P()`` out_specs), and the set of
   functions reachable from mapped bodies along the name-resolved call
   graph ("mapped reach": the reshard's ``all_to_all`` lives in
   ``reshard_by_key``, not in the step's own text);
2. every collective issue site: the wrappers of
   :mod:`sctools_tpu_torch.parallel.collective` (``COLLECTIVE_NAMES``),
   with the axis argument (``psum(xs, mesh, axis_name)``; ``axis_index``'s
   is its second) resolved against the package axis universe (``*_AXIS``
   constants, axis-name parameter defaults), and the control group's
   blocking calls of ``parallel/distributed.py`` (``process_allgather``,
   ``all_gather_objects``, ``all_to_all_bytes``; ``CONTROL_NAMES``);
3. mesh-context functions (a ``mesh`` parameter, ``self._mesh``, or a
   local ``make_mesh`` / ``Mesh`` binding) for the portability rule.

**The control group's calls.** They block every peer just as a mesh
collective does (a ``process_allgather`` one process skips hangs the
others), so SCX801-803 count them, on the pseudo axis ``"process"``. They
run outside mapped regions by design (the step's capacity and drop count,
``sync_processes``, ``global_mesh``), so SCX801 and SCX803 look at every
function that issues a collective or a control call, not only at the
mapped reach; SCX802, the heuristic rule, keeps JAX's mapped-reach scope.
The collective schedule (the witness's contract) holds the mesh
collectives only: the witness records those alone.

Rules:

- **SCX801 divergent-collective-path** — a collective under a Python
  branch or loop whose condition or trip count depends on the process or
  on the data: a condition derived from ``distributed.process_index()``,
  ``mesh.process`` or ``torch.distributed.get_rank()``, or from the values
  of a tensor (``.item()``, ``.any()``, ``.all()``, ``bool(t)``); or a
  loop over ``mesh.local_shards`` that issues a collective. Processes can
  disagree about whether (or how many times) the collective issues, so
  peers wait on a collective that never comes. (JAX's ``lax.cond`` /
  ``axis_index`` spellings have no port counterpart: the port's
  ``axis_index`` is the same host list on every process.)
- **SCX802 mismatched-collective-order** — two paths through one mapped
  body issue different collective sequences or axis sets (an
  ``if``/``else`` whose branches disagree). Heuristic and
  suppression-friendly, as in JAX.
- **SCX803 host-sync-in-collective-region** — ``ingest.pull``,
  ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()`` or
  ``torch.cuda.synchronize()`` lexically between two collective issues of
  one function: every peer stalls at its next collective for as long as
  the host waits.
- **SCX804 mesh-portability** — an ``n_shards`` / ``n_devices`` /
  ``n_slices``-style name assigned an integer literal (or passed
  literally) inside a mesh-context function.
- **SCX805 unreduced-partial-escape** — a region that marks a result
  replicated (``replicated=True``, the port's ``P()``) with no reducing
  collective in its reach: each shard returns ITS partial as if it were
  the total.

The runtime half mirrors the lock witness: ``--emit-collective-schedule
FILE`` writes the statically predicted collective universe
(:func:`build_collective_schedule`), ``SCTOOLS_TPU_MESH_DEBUG=1`` makes
every issued collective record into :mod:`.meshwitness`, and
``chip_smoke.py``'s discipline phase asserts each worker's observed
schedule is non-empty, identical across processes, violation-free and
inside the static schedule.

Model limits (deliberate, documented): name-based call resolution; branch
analysis is lexical; an axis forwarded through a parameter is symbolic,
so the schedule admits it against every declared axis (``"*"``).
``analysis/`` is exempt as the mechanism; so are
``parallel/collective.py`` and ``parallel/distributed.py`` (their bodies
hold the exchanges every wrapper forwards to).

Pure stdlib; imports nothing heavyweight; honors ``# scx-lint:
disable=SCX8xx`` escapes.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions

MESH_RULES = {
    "SCX801": "divergent-collective-path",
    "SCX802": "mismatched-collective-order",
    "SCX803": "host-sync-in-collective-region",
    "SCX804": "mesh-portability",
    "SCX805": "unreduced-partial-escape",
}

# the analyzer + witness machinery is the mechanism, not the subject
MESH_EXEMPT_DIRS = ("analysis",)
# the wrapper modules, by basename, under parallel/ (or alone, as JAX's
# single-file rule has it)
_MECHANISM = ("collective", "distributed")

# the choke-point wrappers of parallel/collective.py
COLLECTIVE_NAMES = frozenset(
    (
        "psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
        "ppermute", "axis_index",
    )
)
# collectives that REDUCE/COMBINE across the axis (SCX805: a replicated
# result is only sound when one of these produced the value)
REDUCING_COLLECTIVES = frozenset(
    ("psum", "pmean", "pmax", "pmin", "all_gather")
)
# positional index of the axis-name argument: wrapper(xs, mesh, axis_name)
_COLLECTIVE_AXIS_ARG = {name: 2 for name in COLLECTIVE_NAMES}
_COLLECTIVE_AXIS_ARG["axis_index"] = 1

# the control group's blocking calls (parallel/distributed.py), counted by
# SCX801-803 on this pseudo axis
CONTROL_NAMES = frozenset(
    ("process_allgather", "all_gather_objects", "all_to_all_bytes")
)
CONTROL_AXIS = "process"

# rank sources (SCX801): calls, and attributes of a mesh
_RANK_CALLS = frozenset(("process_index", "get_rank"))
# tensor-value reads (SCX801): methods, and the bool() builtin
_VALUE_ATTRS = frozenset(("item", "any", "all"))

# host-sync spellings (SCX803)
_SYNC_ATTRS = frozenset(("item", "cpu", "numpy", "tolist", "synchronize"))

# SCX804: names that carry a device/shard count
_COUNT_NAME = re.compile(r"^(n|num)_(shards?|devices?|slices?)$")

_AXIS_PARAM_NAMES = frozenset(("axis_name", "axis", "ici_axis", "dcn_axis"))


# ------------------------------------------------------------- records


@dataclass
class SmSite:
    """One mapped region (``meshwitness.mapped``)."""

    module: str
    path: str
    line: int
    fn_qual: Optional[str]
    label: Optional[str] = None
    # one entry per result: True when it is replicated; None when the
    # ``replicated`` expression was unresolvable
    out_replicated: Tuple[Optional[bool], ...] = ()


@dataclass
class CollectiveCall:
    name: str
    axis: str  # resolved axis, or "*" for a symbolic/unresolved axis
    module: str
    path: str
    line: int
    func_qual: Optional[str]  # enclosing function
    control: bool = False  # a control-group call of parallel/distributed.py


@dataclass
class FuncInfo:
    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str] = None
    params: Tuple[str, ...] = ()
    mesh_context: bool = False
    calls: List[Tuple[Tuple[str, ...], Optional[str]]] = field(
        default_factory=list
    )


@dataclass
class ModInfo:
    name: str
    path: str
    is_pkg: bool
    tree: ast.Module
    # the wrapper modules hold the exchanges every caller forwards to:
    # they are the MECHANISM and never the subject of the SCX8xx rules
    mechanism: bool = False
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    from_funcs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    collective_mods: Set[str] = field(default_factory=set)
    collective_funcs: Set[str] = field(default_factory=set)
    distributed_mods: Set[str] = field(default_factory=set)
    control_funcs: Set[str] = field(default_factory=set)
    witness_mods: Set[str] = field(default_factory=set)
    mapped_names: Set[str] = field(default_factory=set)
    ingest_mods: Set[str] = field(default_factory=set)
    pull_names: Set[str] = field(default_factory=set)
    mesh_ctor_names: Set[str] = field(default_factory=set)
    str_constants: Dict[str, str] = field(default_factory=dict)
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)


class MeshModel:
    """The whole-package collective-safety model."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.sm_sites: List[SmSite] = []
        self.mapped_quals: Set[str] = set()
        self.mapped_reach: Set[str] = set()
        self.axis_universe: Set[str] = set()
        # per-function collective calls, in lexical order
        self.collectives: Dict[str, List[CollectiveCall]] = {}
        self.findings: List[Finding] = []


# --------------------------------------------------------- small helpers


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


def _end(node: ast.AST) -> int:
    return getattr(node, "end_lineno", node.lineno) or node.lineno


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _own_nodes(node: ast.AST):
    """Walk ``node`` WITHOUT descending into nested function defs.

    A nested def's body belongs to the nested function's own scan —
    attributing its collectives to the enclosing builder would give every
    closure factory a phantom collective schedule.
    """
    stack = [node]
    while stack:
        current = stack.pop()
        yield current
        for child in ast.iter_child_nodes(current):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


# ------------------------------------------------------------ the build


class _Analyzer:
    def __init__(self) -> None:
        self.model = MeshModel()
        # (path, lineno) of rank-dependent If/While nodes: SCX801 owns
        # those; SCX802 must not double-report the same branch
        self._rank_branches: Set[Tuple[str, int]] = set()

    # ------------------------------------------------------- phase A

    def load(self, files: Sequence[Tuple[str, str, bool]]) -> None:
        for path, name, is_pkg in files:
            parsed = parse_cached(path)
            if parsed is None:
                continue
            _, tree = parsed
            parts = name.split(".")
            base = parts[-1]
            parent = parts[-2] if len(parts) > 1 else ""
            # the parallel/ wrapper modules are the mechanism; a module
            # merely NAMED collective elsewhere (metrics/collective.py,
            # the collective merge) is a subject
            self.model.modules[name] = ModInfo(
                name=name, path=path, is_pkg=is_pkg, tree=tree,
                mechanism=base in _MECHANISM and parent in ("", "parallel"),
            )
        for mod in self.model.modules.values():
            self._collect_imports(mod)
            self._collect_constants(mod)
            self._index_functions(mod)
        self._collect_axes()

    def _collect_imports(self, mod: ModInfo) -> None:
        known = self.model.modules
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name in known:
                        mod.mod_aliases[alias.asname or alias.name] = alias.name
            elif isinstance(node, ast.ImportFrom):
                source = node.module or ""
                last = source.rpartition(".")[2]
                target = self._resolve_from(mod, node)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    orig = alias.name
                    # name-keyed role bindings work even when the source
                    # module lives outside the analyzed path set
                    if orig == "collective":
                        mod.collective_mods.add(bound)
                    elif orig == "distributed":
                        mod.distributed_mods.add(bound)
                    elif orig == "meshwitness":
                        mod.witness_mods.add(bound)
                    elif orig in COLLECTIVE_NAMES and last == "collective":
                        mod.collective_funcs.add(bound)
                    elif orig in CONTROL_NAMES and last == "distributed":
                        mod.control_funcs.add(bound)
                    elif orig == "mapped" and last == "meshwitness":
                        mod.mapped_names.add(bound)
                    elif orig == "ingest":
                        mod.ingest_mods.add(bound)
                    elif orig == "pull" and (
                        "ingest" in source.split(".") or last == "wire"
                    ):
                        mod.pull_names.add(bound)
                    elif orig in ("make_mesh", "make_hybrid_mesh", "Mesh",
                                  "global_mesh"):
                        mod.mesh_ctor_names.add(bound)
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

    def _collect_constants(self, mod: ModInfo) -> None:
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                if not isinstance(target, ast.Name):
                    continue
                text = _const_str(stmt.value)
                if text is not None:
                    mod.str_constants[target.id] = text
                    if "AXIS" in target.id.upper():
                        self.model.axis_universe.add(text)

    def _index_functions(self, mod: ModInfo) -> None:
        def index(node, prefix, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}.{child.name}"
                    args = child.args
                    params = tuple(
                        a.arg
                        for a in list(args.posonlyargs) + list(args.args)
                    )
                    info = FuncInfo(
                        qual=qual, module=mod.name, path=mod.path,
                        name=child.name, line=child.lineno, cls=cls,
                        params=params, mesh_context="mesh" in params,
                    )
                    info._node = child  # type: ignore[attr-defined]
                    mod.functions.append(info)
                    mod.def_index.setdefault(child.name, []).append(qual)
                    self.model.functions[qual] = info
                    index(child, qual, cls)
                elif isinstance(child, ast.ClassDef):
                    index(child, f"{prefix}.{child.name}", child.name)
                else:
                    index(child, prefix, cls)

        index(mod.tree, mod.name, None)

    # ------------------------------------------------- axis resolution

    def _collect_axes(self) -> None:
        universe = self.model.axis_universe
        for mod in self.model.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    args = node.args
                    named = list(args.posonlyargs) + list(args.args)
                    defaults = list(args.defaults)
                    for param, default in zip(named[-len(defaults):], defaults):
                        if self._is_axis_param(param.arg):
                            resolved = self._axis_value(mod, default)
                            if resolved is not None:
                                universe.add(resolved)
                    for param, default in zip(args.kwonlyargs, args.kw_defaults):
                        if default is not None and self._is_axis_param(
                            param.arg
                        ):
                            resolved = self._axis_value(mod, default)
                            if resolved is not None:
                                universe.add(resolved)
                elif isinstance(node, ast.Call):
                    for kw in node.keywords:
                        if kw.arg is not None and self._is_axis_param(kw.arg):
                            resolved = self._axis_value(mod, kw.value)
                            if resolved is not None:
                                universe.add(resolved)

    @staticmethod
    def _is_axis_param(name: str) -> bool:
        return name in _AXIS_PARAM_NAMES or name.endswith("_axis")

    def _axis_value(self, mod: ModInfo, expr: ast.AST) -> Optional[str]:
        text = _const_str(expr)
        if text is not None:
            return text
        if isinstance(expr, ast.Name):
            if expr.id in mod.str_constants:
                return mod.str_constants[expr.id]
            bound = mod.from_funcs.get(expr.id)
            if bound is not None:
                other = self.model.modules.get(bound[0])
                if other is not None:
                    return other.str_constants.get(bound[1])
        if isinstance(expr, ast.Attribute):
            root, chain = _root_chain(expr)
            if root in mod.mod_aliases and len(chain) == 1:
                other = self.model.modules.get(mod.mod_aliases[root])
                if other is not None:
                    return other.str_constants.get(chain[0])
        return None

    # --------------------------------------------------- site inventory

    def collect_sites(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call) and self._is_mapped_expr(
                        mod, dec.func
                    ):
                        self._add_sm_site(mod, dec, info.qual)
            # the call form: NAME = meshwitness.mapped(label, ...)(fn)
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Call)
                    and self._is_mapped_expr(mod, node.func.func)
                    and node.args
                ):
                    self._add_sm_site(mod, node.func, None, node.args[0])
        for sm in self.model.sm_sites:
            if sm.fn_qual:
                self.model.mapped_quals.add(sm.fn_qual)

    def _is_mapped_expr(self, mod: ModInfo, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in mod.mapped_names
        if isinstance(expr, ast.Attribute) and expr.attr == "mapped":
            root, chain = _root_chain(expr)
            return len(chain) == 1 and (
                root in mod.witness_mods
                or mod.mod_aliases.get(root, "").endswith("meshwitness")
            )
        return False

    def _add_sm_site(
        self, mod: ModInfo, call: ast.Call, fn_qual: Optional[str],
        fn_arg: Optional[ast.AST] = None,
    ) -> SmSite:
        if fn_qual is None and isinstance(fn_arg, ast.Name):
            quals = mod.def_index.get(fn_arg.id)
            if quals:
                fn_qual = self._nearest_qual(quals, call.lineno)
        label = _const_str(call.args[0]) if call.args else _const_str(
            _kw(call, "label")
        )
        replicated_expr = _kw(call, "replicated")
        if replicated_expr is None and len(call.args) > 1:
            replicated_expr = call.args[1]
        replicated: List[Optional[bool]] = []
        if replicated_expr is None:
            replicated.append(False)
        else:
            specs = (
                list(replicated_expr.elts)
                if isinstance(replicated_expr, (ast.Tuple, ast.List))
                else [replicated_expr]
            )
            for spec in specs:
                if isinstance(spec, ast.Constant) and isinstance(
                    spec.value, bool
                ):
                    replicated.append(spec.value)
                else:
                    replicated.append(None)
        top = mod.name.partition(".")[0]
        site = SmSite(
            module=mod.name, path=mod.path, line=call.lineno,
            fn_qual=fn_qual,
            label=f"{top}.{label}" if label is not None else None,
            out_replicated=tuple(replicated),
        )
        self.model.sm_sites.append(site)
        return site

    def _nearest_qual(self, quals: List[str], line: int) -> str:
        best = quals[0]
        best_line = -1
        for qual in quals:
            info = self.model.functions.get(qual)
            if info is not None and best_line < info.line <= line + 2:
                best, best_line = qual, info.line
        return best

    # --------------------------------------------------- body analysis

    def analyze(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                self._scan_function(mod, info, node, mod.mechanism)
        self._compute_reach()
        self._check_divergent_paths()
        self._check_branch_order()
        self._check_sync_regions()
        self._check_portability()
        self._check_partial_escape()

    def _scan_function(
        self, mod: ModInfo, info: FuncInfo, node, mechanism: bool
    ) -> None:
        for sub in _own_nodes(node):
            if sub is not node and isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if isinstance(sub, ast.Attribute):
                root, chain = _root_chain(sub)
                if root == "self" and chain and chain[-1] in ("_mesh", "mesh"):
                    info.mesh_context = True
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                # a local mesh construction makes this a mesh-context fn
                ctor = _terminal_name(sub.value.func)
                if ctor in mod.mesh_ctor_names or ctor in (
                    "make_mesh", "make_hybrid_mesh", "global_mesh",
                ):
                    info.mesh_context = True
            if not isinstance(sub, ast.Call):
                continue
            targets = self._resolve_call(mod, sub.func, info.cls)
            terminal = _terminal_name(sub.func)
            if targets or terminal:
                info.calls.append((targets, terminal))
            if not mechanism:
                collective = self._collective_call(mod, sub)
                if collective is not None:
                    name, axis, control = collective
                    self.model.collectives.setdefault(info.qual, []).append(
                        CollectiveCall(
                            name=name, axis=axis, module=mod.name,
                            path=mod.path, line=sub.lineno,
                            func_qual=info.qual, control=control,
                        )
                    )

    def _collective_call(
        self, mod: ModInfo, call: ast.Call
    ) -> Optional[Tuple[str, str, bool]]:
        """(name, axis, control) when ``call`` issues a collective or a
        control-group call, else None."""
        terminal = _terminal_name(call.func)
        func = call.func
        if terminal in CONTROL_NAMES:
            if isinstance(func, ast.Attribute):
                root, chain = _root_chain(func)
                recognized = len(chain) == 1 and (
                    root in mod.distributed_mods
                    or mod.mod_aliases.get(root, "").endswith("distributed")
                )
            else:
                recognized = isinstance(func, ast.Name) and (
                    func.id in mod.control_funcs
                )
            return (terminal, CONTROL_AXIS, True) if recognized else None
        if terminal not in COLLECTIVE_NAMES:
            return None
        recognized = False
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            recognized = len(chain) == 1 and (
                root in mod.collective_mods
                or mod.mod_aliases.get(root, "").endswith(
                    "parallel.collective"
                )
            )
        elif isinstance(func, ast.Name):
            recognized = func.id in mod.collective_funcs
        if not recognized:
            return None
        index = _COLLECTIVE_AXIS_ARG[terminal]
        axis_expr = _kw(call, "axis_name")
        if axis_expr is None and len(call.args) > index:
            axis_expr = call.args[index]
        axis = "*"
        if axis_expr is not None:
            resolved = self._axis_value(mod, axis_expr)
            if resolved is not None:
                axis = resolved
        return terminal, axis, False

    def _resolve_call(
        self, mod: ModInfo, func: ast.AST, cls: Optional[str]
    ) -> Tuple[str, ...]:
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
            if root == "self" and cls is not None and len(chain) == 1:
                qual = f"{mod.name}.{cls}.{chain[0]}"
                if qual in self.model.functions:
                    return (qual,)
                return ()
            if root in mod.mod_aliases:
                qual = ".".join([mod.mod_aliases[root]] + chain)
                if qual in self.model.functions:
                    return (qual,)
        return ()

    def _compute_reach(self) -> None:
        """Mapped reach: closure over the call graph from mapped bodies."""
        model = self.model
        reach: Set[str] = set(model.mapped_quals)
        frontier = list(reach)
        while frontier:
            qual = frontier.pop()
            info = model.functions.get(qual)
            if info is None:
                continue
            for targets, _ in info.calls:
                for target in targets:
                    if target not in reach:
                        reach.add(target)
                        frontier.append(target)
        model.mapped_reach = reach

    # ----------------------------------------------------- rule checks

    def _function_collectives(self, qual: str) -> List[CollectiveCall]:
        return self.model.collectives.get(qual, [])

    def _issuing_scope(self) -> List[str]:
        """SCX801/SCX803's scope: the mapped reach, and every function that
        issues a collective or a control-group call itself."""
        model = self.model
        return sorted(model.mapped_reach | set(model.collectives))

    def _reach_has_reducer(self, qual: str) -> bool:
        """Whether ``qual`` or anything it reaches issues a reducing
        collective."""
        seen: Set[str] = set()
        frontier = [qual]
        while frontier:
            current = frontier.pop()
            if current in seen:
                continue
            seen.add(current)
            for call in self._function_collectives(current):
                if call.name in REDUCING_COLLECTIVES and not call.control:
                    return True
            info = self.model.functions.get(current)
            if info is None:
                continue
            for targets, _ in info.calls:
                frontier.extend(targets)
        return False

    def _collectives_in(self, mod: ModInfo, node: ast.AST) -> List[
        Tuple[str, str, int]
    ]:
        """(name, axis, line) for every collective lexically inside
        ``node``."""
        out: List[Tuple[str, str, int]] = []
        if mod.mechanism:
            return out
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                hit = self._collective_call(mod, sub)
                if hit is not None:
                    out.append((hit[0], hit[1], sub.lineno))
        return out

    @staticmethod
    def _is_rank_source(node: ast.AST) -> bool:
        """A read of the process's identity or of a tensor's values."""
        if isinstance(node, ast.Call):
            terminal = _terminal_name(node.func)
            if terminal in _RANK_CALLS:
                return True
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _VALUE_ATTRS
            ):
                return True
            if isinstance(node.func, ast.Name) and node.func.id == "bool" \
                    and node.args:
                return True
        if isinstance(node, ast.Attribute) and node.attr == "process":
            root, chain = _root_chain(node.value)
            last = chain[-1] if chain else root
            return last is not None and last.lower().endswith("mesh")
        return False

    def _check_divergent_paths(self) -> None:
        """SCX801: collectives under process- or data-dependent branches."""
        model = self.model
        for qual in self._issuing_scope():
            info = model.functions.get(qual)
            node = getattr(info, "_node", None) if info else None
            if node is None:
                continue
            mod = model.modules.get(info.module)
            if mod is None or mod.mechanism:
                continue
            rank_names: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    carries_rank = any(
                        self._is_rank_source(inner)
                        or (
                            isinstance(inner, ast.Name)
                            and inner.id in rank_names
                        )
                        for inner in ast.walk(sub.value)
                    )
                    if carries_rank:
                        for target in sub.targets:
                            for leaf in ast.walk(target):
                                if isinstance(leaf, ast.Name):
                                    rank_names.add(leaf.id)
            for sub in ast.walk(node):
                if isinstance(sub, (ast.If, ast.While)):
                    divergent = any(
                        self._is_rank_source(inner)
                        or (
                            isinstance(inner, ast.Name)
                            and inner.id in rank_names
                        )
                        for inner in ast.walk(sub.test)
                    )
                    why = (
                        "rank- or data-dependent branch (condition derives "
                        "from the process index or a tensor's values)"
                    )
                    branch_nodes = list(sub.body) + list(sub.orelse)
                elif isinstance(sub, (ast.For, ast.AsyncFor)):
                    divergent = any(
                        isinstance(inner, ast.Attribute)
                        and inner.attr == "local_shards"
                        for inner in ast.walk(sub.iter)
                    )
                    why = (
                        "loop over `mesh.local_shards` (its trip count is "
                        "this process's)"
                    )
                    branch_nodes = list(sub.body)
                else:
                    continue
                if not divergent:
                    continue
                self._rank_branches.add((mod.path, sub.lineno))
                for branch_stmt in branch_nodes:
                    for name, _axis, line in self._collectives_in(
                        mod, branch_stmt
                    ):
                        model.findings.append(
                            Finding(
                                "SCX801", mod.path, line,
                                f"collective `{name}` issues under a {why}: "
                                "each process issues a different schedule "
                                "and the group waits at the first "
                                "disagreement until its timeout",
                            )
                        )

    def _check_branch_order(self) -> None:
        """SCX802: if/else branches with differing collective sequences."""
        model = self.model
        for qual in sorted(model.mapped_reach):
            info = model.functions.get(qual)
            node = getattr(info, "_node", None) if info else None
            if node is None:
                continue
            mod = model.modules.get(info.module)
            if mod is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.If):
                    continue
                if (mod.path, sub.lineno) in self._rank_branches:
                    continue  # SCX801 already owns rank-dependent branches
                body_seq = [
                    (n, a)
                    for stmt in sub.body
                    for n, a, _ in self._collectives_in(mod, stmt)
                ]
                else_seq = [
                    (n, a)
                    for stmt in sub.orelse
                    for n, a, _ in self._collectives_in(mod, stmt)
                ]
                if body_seq == else_seq or not (body_seq or else_seq):
                    continue

                def render(seq):
                    return (
                        ", ".join(f"{n}@{a}" for n, a in seq) or "(none)"
                    )
                model.findings.append(
                    Finding(
                        "SCX802", mod.path, sub.lineno,
                        "two paths through mapped computation "
                        f"`{info.name}` issue different collective "
                        f"sequences ({render(body_seq)} vs "
                        f"{render(else_seq)}): any per-worker divergence "
                        "of this condition deadlocks the mesh",
                    )
                )

    def _check_sync_regions(self) -> None:
        """SCX803: host syncs lexically between collectives."""
        model = self.model
        for qual in self._issuing_scope():
            info = model.functions.get(qual)
            node = getattr(info, "_node", None) if info else None
            if node is None:
                continue
            mod = model.modules.get(info.module)
            if mod is None:
                continue
            lines = [c.line for c in self._function_collectives(qual)]
            if len(lines) < 2:
                continue
            first, last = min(lines), max(lines)
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                if not first < sub.lineno < last:
                    continue
                label = self._sync_label(mod, sub)
                if label is None:
                    continue
                model.findings.append(
                    Finding(
                        "SCX803", mod.path, sub.lineno,
                        f"{label} between collectives of one mapped "
                        f"computation (`{info.name}` issues collectives "
                        f"at lines {first} and {last}): the host sync "
                        "stalls every peer at its next collective for "
                        "as long as the host dawdles",
                        _end(sub),
                    )
                )

    def _sync_label(self, mod: ModInfo, call: ast.Call) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
            return f"`.{func.attr}()`"
        if isinstance(func, ast.Name) and func.id in mod.pull_names:
            return "`ingest.pull`"
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if root in mod.ingest_mods and chain == ["pull"]:
                return "`ingest.pull`"
        return None

    def _check_portability(self) -> None:
        """SCX804: hardcoded device counts in mesh-context functions."""
        model = self.model
        for info in model.functions.values():
            in_scope = info.mesh_context or info.qual in model.mapped_reach
            if not in_scope:
                continue
            node = getattr(info, "_node", None)
            if node is None:
                continue
            mod = model.modules.get(info.module)
            if mod is None:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    if not (
                        isinstance(sub.value, ast.Constant)
                        and isinstance(sub.value.value, int)
                        and not isinstance(sub.value.value, bool)
                    ):
                        continue
                    for target in sub.targets:
                        if isinstance(target, ast.Name) and _COUNT_NAME.match(
                            target.id
                        ):
                            model.findings.append(
                                Finding(
                                    "SCX804", mod.path, sub.lineno,
                                    f"`{target.id} = {sub.value.value}` "
                                    "hardcodes a device count in a "
                                    "mesh-context function: shapes derived "
                                    "from it break on any other topology — "
                                    "derive it from `mesh.shape[axis]`",
                                )
                            )
                elif isinstance(sub, ast.Call):
                    for kw in sub.keywords:
                        if (
                            kw.arg is not None
                            and _COUNT_NAME.match(kw.arg)
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, int)
                            and not isinstance(kw.value.value, bool)
                        ):
                            model.findings.append(
                                Finding(
                                    "SCX804", mod.path, kw.value.lineno,
                                    f"`{kw.arg}={kw.value.value}` hardcodes "
                                    "a device count in a mesh-context "
                                    "function: derive it from the mesh "
                                    "axis size instead",
                                )
                            )

    def _check_partial_escape(self) -> None:
        """SCX805: replicated results over a reduction-free body."""
        model = self.model
        for sm in model.sm_sites:
            if sm.fn_qual is None or not sm.out_replicated:
                continue
            if not any(rep is True for rep in sm.out_replicated):
                continue
            if self._reach_has_reducer(sm.fn_qual):
                continue
            info = model.functions.get(sm.fn_qual)
            name = info.name if info else sm.fn_qual
            model.findings.append(
                Finding(
                    "SCX805", sm.path, sm.line,
                    f"mapped region over `{name}` marks a result "
                    "replicated (replicated=True) but the body issues no "
                    "reducing collective: each shard returns ITS partial "
                    "as if it were the total — the on-device analog of "
                    "concatenating per-chunk CSVs without a merge",
                )
            )


# ------------------------------------------------------------- public API


def build_model(paths: Sequence[str]) -> MeshModel:
    """Parse + analyze every ``.py`` under ``paths`` into one MeshModel."""
    analyzer = _Analyzer()
    analyzer.load(collect_py_files(paths, MESH_EXEMPT_DIRS))
    analyzer.collect_sites()
    analyzer.analyze()
    return analyzer.model


def check_mesh(paths: Sequence[str]) -> List[Finding]:
    """Run the SCX8xx pass; returns suppression-filtered findings."""
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


def build_collective_schedule(paths: Sequence[str]) -> Dict[str, Any]:
    """The statically predicted collective universe (the witness contract).

    ``collectives`` is the global allowed set of ``[name, axis]`` pairs of
    the mesh collectives (axis ``"*"`` marks a parameter-forwarded axis,
    admitted against any declared axis — an over-approximation, sound for
    the runtime subset check). ``computations`` maps each function in the
    mapped reach that issues collectives to its per-function collective
    set. ``regions`` are the witness's region labels (the package prefix
    and the ``mapped`` label), ``region_functions`` the function each
    tags. The control group's calls stay out: the witness records the mesh
    collectives alone.
    """
    model = build_model(paths)
    pairs: Set[Tuple[str, str]] = set()
    computations: Dict[str, List[List[str]]] = {}
    for qual, calls in sorted(model.collectives.items()):
        if qual not in model.mapped_reach:
            continue
        rows: List[List[str]] = []
        for call in calls:
            if call.control:
                continue
            pair = [call.name, call.axis]
            pairs.add((call.name, call.axis))
            if pair not in rows:
                rows.append(pair)
        if rows:
            computations[qual] = rows
    return {
        "collectives": sorted([list(p) for p in pairs]),
        "computations": computations,
        "axis_universe": sorted(model.axis_universe),
        "regions": sorted(sm.label for sm in model.sm_sites if sm.label),
        "region_functions": {
            sm.label: sm.fn_qual
            for sm in sorted(model.sm_sites, key=lambda s: s.label or "")
            if sm.label and sm.fn_qual
        },
    }
