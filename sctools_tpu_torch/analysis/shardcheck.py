"""scx-shard: static shape & sharding flow analysis (SCX501-SCX505).

The port's copy of ``sctools_tpu.analysis.shardcheck``: the same rule ids,
messages, JSON fields, escapes, exempt directories, contract layout and
``CONTRACT_VERSION``, with the constructs the model recognises respelled
for the port. The serve path's and the streaming loop's shape discipline
is what it checks: every distinct static value at a device site is a
fresh CUDA graph key (a capture while serving) and a raw record count
where a bucketed one belongs breaks the graph set's residency.

Whole-package and interprocedural over the shared :mod:`.astcache` parse,
like the other model passes. The model holds:

1. every device site: a function decorated with
   ``xprof.instrument_site(name)`` (or bound as
   ``instrument_site(name)(fn)``), JAX's ``instrument_jit`` sites under
   the same 13 names. Its static arguments (JAX's ``static_argnames``)
   are the keyword-passable parameters after its operand: what
   ``xprof.signature`` records as ``{k=v}`` statics when a caller passes
   them by name (none when the function takes ``**kwargs``, as JAX's
   shard_map sites declare none). A module that binds a graph key table
   (``STATIC_ARGS = ((name, default), ...)`` beside ``SITE = "<site>"``,
   ``serve/graphs.py``) names that site's statics, and a graph set's
   ``run`` / ``capture`` (a receiver named ``graphs`` or ``_graphs``) is
   a dispatch of that site. A site is sharded (JAX's ``kind:
   "shard_map"``) when its function is a ``meshwitness.mapped`` region
   or reaches one along the name-resolved call graph;
2. the bucket/pad vocabulary — ``bucket_size`` minimums, ``pad_to``
   multiples, ``sub_pad_to``, ``arena_capacity`` — and which call paths
   go through it;
3. the mesh axis-name universe: ``*_AXIS`` module constants (``shard``
   and ``dcn`` of ``parallel/mesh.py``), axis-name parameter defaults,
   literal ``Mesh(devices, (names,))`` constructions, ``axis_name=``
   keywords;
4. a name-resolved call graph over which mesh context, sanitizer
   reachability, and traced-function reachability propagate.

Rules:

- **SCX501 partition-spec-axis** — an axis name given to a mesh's
  ``groups(...)`` or ``axis_size(...)`` (the port's counterpart of a
  ``PartitionSpec``: the axes a value is grouped over) that no mesh in
  the package declares. JAX's second clause, a ``shard_map``
  ``in_specs`` arity against the wrapped function's operands, has no
  port spelling: a mapped region declares no specs.
- **SCX502 unsharded-mesh-upload** — an ``ingest.upload`` in a
  mesh-context function (a ``mesh`` parameter or ``self._mesh``) whose
  device is not a per-shard one (``mesh.devices[i]``, or a name bound by
  a loop over ``mesh.devices``): the put targets one device and
  materializes the whole batch there. JAX's ``sharding=`` built by
  ``ingest.mesh_sharding`` is still accepted.
- **SCX503 retrace-risk** — a data-dependent Python scalar (``len()``,
  ``.shape[i]``, ``int(...)`` of a runtime value) flows into a site's
  static argument, or into a site-*builder* call, without passing
  through a recognized bucket/pad helper. Every distinct value is a
  fresh graph key and a distinct recorded signature.
- **SCX504 collective-axis** — a collective wrapper of
  ``parallel/collective.py`` (``psum``, ``all_gather``, ... with the axis
  as its third argument, ``axis_index``'s second) inside a mapped
  region's body names an axis absent from the axis universe. JAX's
  second clause (an axis the site's ``in_specs`` do not partition) has
  no port spelling, for the reason above.
- **SCX505 host-roundtrip-in-traced-reach** — a host synchronisation,
  SCX703's set (``.item()``, ``.tolist()``, ``.cpu()``, any
  ``.synchronize()``, ``.numpy()`` of an ``ingest.pull``), in a function
  *reachable from* a site's body (a device pass, port rule 6) or a
  mapped region through the call graph. As in JAX the roots' own bodies
  are not the subject: this rule covers the helpers they call.

The runtime half: ``--emit-shape-contract FILE`` writes the statically
predicted per-site signature/sharding universe
(:func:`build_shape_contract`), and ``chip_smoke.py`` asserts every
signature observed in the merged registries of its traced workers is
admitted by it (:func:`check_signatures`).

The port tags a per-shard list of tensors ``dtype[n,dims]@(shards)``
(``obs.xprof.signature``): the list carries no mesh, so no axis name.
:func:`check_signatures` reads the tag :data:`PORT_SHARDS_TAG` as "split
over the mesh's shards": never an undeclared axis, still a sharded
operand, which a site that is not sharded rejects.

Model limits (deliberate, documented): name-based call resolution (calls
through arbitrary objects are invisible except for well-known terminal
names like ``compute_entity_metrics`` and a graph set's methods); taint
does not cross function boundaries; ``sharding=`` expressions that are
neither absent, ``None``, nor a recognized ``mesh_sharding`` binding are
accepted. The shape contract over-approximates (it admits slightly more
than the code can emit) so the smoke check can never fail on a legal
dispatch; it still rejects raw unbucketed record counts, unknown sites,
unknown axis names, and sharded operands at unsharded sites.

Pure stdlib; imports nothing under analysis but the shared cache;
honors ``# scx-lint: disable=SCX5xx`` escapes; ``analysis/`` itself is
exempt.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions

SHARD_RULES = {
    "SCX501": "partition-spec-axis",
    "SCX502": "unsharded-mesh-upload",
    "SCX503": "retrace-risk",
    "SCX504": "collective-axis",
    "SCX505": "host-roundtrip-in-traced-reach",
}

# the analyzer + witness machinery is the mechanism, not the subject
SHARD_EXEMPT_DIRS = ("analysis",)

# canonical padding/bucketing helpers: a value that went through one of
# these is shape-disciplined (SCX503 sanitizers; contract bucket grammar)
SANITIZER_NAMES = frozenset(
    ("bucket_size", "pad_to", "sub_pad_to", "arena_capacity")
)

# the collective wrappers of parallel/collective.py and the positional
# index of their axis-name argument: wrapper(xs, mesh, axis_name)
_COLLECTIVE_AXIS_ARG = {
    "psum": 2,
    "pmax": 2,
    "pmin": 2,
    "pmean": 2,
    "all_gather": 2,
    "all_to_all": 2,
    "ppermute": 2,
    "axis_index": 1,
}

# mesh methods that name the axes a value is grouped over (SCX501)
_MESH_AXIS_METHODS = frozenset(("groups", "axis_size"))

# host-sync attribute calls (SCX505, costcheck SCX703's set): with no
# arguments, and synchronize() of any receiver with any
_HOST_SYNC_ATTRS = frozenset(("item", "tolist", "cpu"))

# parameter names that carry mesh axis identity (axis universe sources)
_AXIS_PARAM_NAMES = frozenset(("axis_name", "axis", "ici_axis", "dcn_axis"))

# terminal-name fallback resolution: method calls on injected engines
# (``device_engine.compute_entity_metrics``) dispatch by name to the one
# package function of that name — without this, the hottest dispatch in
# the tree would be invisible to the SCX503 sink check
_DISPATCHY_MIN_NAME_LEN = 6

# the receivers of a CUDA graph set (serve/graphs.py GraphSet) and its
# methods that dispatch the graph-keyed site
_GRAPH_RECEIVERS = frozenset(("graphs", "_graphs"))
_GRAPH_METHODS = frozenset(("run", "capture"))

#: the tag ``obs.xprof.signature`` gives a per-shard list of tensors
PORT_SHARDS_TAG = "shards"


# ------------------------------------------------------------- records


@dataclass
class JitSite:
    """One ``xprof.instrument_site`` device site."""

    name: str
    module: str
    path: str
    line: int
    static_argnames: Tuple[str, ...] = ()
    fn_qual: Optional[str] = None  # wrapped function, when resolvable
    kind: str = "jit"  # "jit" | "shard_map"


@dataclass
class SmSite:
    """One ``meshwitness.mapped`` region."""

    module: str
    path: str
    line: int
    fn_qual: Optional[str]


@dataclass
class FuncInfo:
    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str] = None
    parent: Optional[str] = None
    params: Tuple[str, ...] = ()
    has_mesh_param: bool = False
    uses_self_mesh: bool = False
    calls: List[Tuple[Tuple[str, ...], Optional[str]]] = field(
        default_factory=list
    )  # (resolved targets, terminal name)
    calls_sanitizer: bool = False


@dataclass
class ModInfo:
    name: str
    path: str
    is_pkg: bool
    tree: ast.Module
    # every node of the tree, walked once for the whole-module scans
    nodes: List[ast.AST] = field(default_factory=list)
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    from_funcs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    mapped_names: Set[str] = field(default_factory=set)
    witness_mods: Set[str] = field(default_factory=set)
    instrument_names: Set[str] = field(default_factory=set)
    xprof_mods: Set[str] = field(default_factory=set)
    ingest_mods: Set[str] = field(default_factory=set)
    upload_names: Set[str] = field(default_factory=set)
    pull_names: Set[str] = field(default_factory=set)
    collective_mods: Set[str] = field(default_factory=set)
    collective_funcs: Set[str] = field(default_factory=set)
    mesh_sharding_names: Set[str] = field(default_factory=set)
    sanitizer_aliases: Set[str] = field(default_factory=set)
    str_constants: Dict[str, str] = field(default_factory=dict)
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)


class ShardModel:
    """The whole-package shape & sharding model."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.jit_sites: List[JitSite] = []
        self.sm_sites: List[SmSite] = []
        self.sm_by_fn: Dict[str, SmSite] = {}
        self.axis_universe: Set[str] = set()
        self.bucket_minimums: Set[int] = set()
        self.pad_multiples: Set[int] = set()
        # the pinned record-bucket floor from ops/segments.py — the
        # bucket_size default, and therefore the padded-record base the
        # monoblock wire envelope builds on. The scx-cost autotuner
        # (--retune) rewrites the pin, so the contract must READ it
        # rather than hardcode 4096: a retuned tree's next live run
        # emits wire dims at the new floor and the smokes' subset check
        # has to keep admitting them.
        self.record_bucket_min: int = 4096
        self.builder_quals: Set[str] = set()  # functions that build jits
        self.traced_quals: Set[str] = set()  # jit/shard_map wrapped defs
        # site name -> static param name -> set of literal values (None in
        # the set marks "open": a non-literal value was seen)
        self.static_values: Dict[str, Dict[str, Set[Any]]] = {}
        # site name -> functions that evidence its dispatch (callers of
        # the wrapped fn / builder, record_dispatch literals)
        self.site_callers: Dict[str, Set[str]] = {}
        # functions from which a canonical bucket/pad helper is reachable
        self.sanitizer_reach: Set[str] = set()
        # graph-keyed sites: site name -> the graph key's static names
        # (a module's STATIC_ARGS table beside its SITE constant)
        self.graph_keys: Dict[str, Tuple[str, ...]] = {}
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


def _const_int(node: Optional[ast.AST]) -> Optional[int]:
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    ):
        return node.value
    return None


def _end(node: ast.AST) -> int:
    return getattr(node, "end_lineno", node.lineno) or node.lineno


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _literal_options(node: Optional[ast.AST]) -> List[str]:
    """The string literals ``node`` may evaluate to: itself, or both
    branches of a conditional expression."""
    if isinstance(node, ast.IfExp):
        return _literal_options(node.body) + _literal_options(node.orelse)
    text = _const_str(node)
    return [text] if text is not None else []


def _mentions_devices(expr: ast.AST) -> bool:
    """Whether ``expr`` reads a ``.devices`` attribute (a mesh's)."""
    return any(
        isinstance(sub, ast.Attribute) and sub.attr == "devices"
        for sub in ast.walk(expr)
    )


def _is_shard_device(expr: ast.AST, shard_devices: Set[str]) -> bool:
    """One shard's device: ``mesh.devices[i]``, or a name bound to one."""
    if isinstance(expr, ast.Subscript):
        return isinstance(expr.value, ast.Attribute) and (
            expr.value.attr == "devices"
        )
    return isinstance(expr, ast.Name) and expr.id in shard_devices


# ------------------------------------------------------------ the build


class _Analyzer:
    def __init__(self) -> None:
        self.model = ShardModel()

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
            )
        for mod in self.model.modules.values():
            self._collect_imports(mod)
            self._collect_constants(mod)
            self._index_functions(mod)
        self._link_aliases()

    def _link_aliases(self) -> None:
        """Propagate role bindings through cross-module re-imports.

        ``from .metrics import mapped`` must make ``mapped`` a region
        decorator in the importer when it is one in the source module
        (same for the site/sanitizer/upload names). One round per hop;
        two rounds cover the package's import depth with margin.
        """
        for _ in range(3):
            changed = False
            for mod in self.model.modules.values():
                for bound, (src, attr) in mod.from_funcs.items():
                    other = self.model.modules.get(src)
                    if other is None:
                        continue
                    for role in (
                        "mapped_names", "instrument_names",
                        "mesh_sharding_names", "sanitizer_aliases",
                        "upload_names", "pull_names", "collective_funcs",
                    ):
                        if attr in getattr(other, role) and bound not in getattr(
                            mod, role
                        ):
                            getattr(mod, role).add(bound)
                            changed = True
            if not changed:
                break

    def _collect_imports(self, mod: ModInfo) -> None:
        known = self.model.modules
        for node in mod.nodes:
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
                    # name-keyed bindings work even when the source module
                    # is outside the analyzed path set (fixtures import the
                    # library by its installed name)
                    if orig == "instrument_site":
                        mod.instrument_names.add(bound)
                    elif orig == "mapped" and last == "meshwitness":
                        mod.mapped_names.add(bound)
                    elif orig == "meshwitness":
                        mod.witness_mods.add(bound)
                    elif orig == "mesh_sharding":
                        mod.mesh_sharding_names.add(bound)
                    elif orig in SANITIZER_NAMES:
                        mod.sanitizer_aliases.add(bound)
                    elif orig == "xprof":
                        mod.xprof_mods.add(bound)
                    elif orig == "ingest":
                        mod.ingest_mods.add(bound)
                    elif orig == "collective":
                        mod.collective_mods.add(bound)
                    elif orig in _COLLECTIVE_AXIS_ARG and last == "collective":
                        mod.collective_funcs.add(bound)
                    elif orig == "upload" and "ingest" in source.split("."):
                        mod.upload_names.add(bound)
                    elif orig == "pull" and "ingest" in source.split("."):
                        mod.pull_names.add(bound)
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
        is_segments = mod.name.endswith("segments")
        graph_key: Optional[Tuple[str, ...]] = None
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                if not isinstance(target, ast.Name):
                    continue
                value = stmt.value
                if (
                    is_segments
                    and target.id == "RECORD_BUCKET_MIN"
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, int)
                ):
                    self.model.record_bucket_min = int(value.value)
                text = _const_str(value)
                if text is not None:
                    mod.str_constants[target.id] = text
                    if "AXIS" in target.id.upper():
                        self.model.axis_universe.add(text)
                # the graph key table: STATIC_ARGS = (("name", default), ...)
                if target.id == "STATIC_ARGS" and isinstance(
                    value, (ast.Tuple, ast.List)
                ):
                    names = [
                        _const_str(elt.elts[0])
                        for elt in value.elts
                        if isinstance(elt, (ast.Tuple, ast.List)) and elt.elts
                    ]
                    if names and all(names):
                        graph_key = tuple(names)  # type: ignore[arg-type]
        site = mod.str_constants.get("SITE")
        if graph_key is not None and site is not None:
            self.model.graph_keys[site] = graph_key

    def _index_functions(self, mod: ModInfo) -> None:
        def index(node, prefix, cls, parent):
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
                        parent=parent, params=params,
                        has_mesh_param="mesh" in params,
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
        pseudo = FuncInfo(
            qual=f"{mod.name}.<module>", module=mod.name, path=mod.path,
            name="<module>", line=1,
        )
        pseudo._node = mod.tree  # type: ignore[attr-defined]
        mod.functions.append(pseudo)
        self.model.functions[pseudo.qual] = pseudo

    # --------------------------------------------- axis universe (B1)

    def collect_axes(self) -> None:
        universe = self.model.axis_universe
        for mod in self.model.modules.values():
            for node in mod.nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    args = node.args
                    named = list(args.posonlyargs) + list(args.args)
                    defaults = list(args.defaults)
                    # defaults align to the tail of the parameter list
                    for param, default in zip(named[-len(defaults):], defaults):
                        if not self._is_axis_param(param.arg):
                            continue
                        resolved = self._axis_value(mod, default)
                        if resolved is not None:
                            universe.add(resolved)
                    for param, default in zip(args.kwonlyargs, args.kw_defaults):
                        if default is None:
                            continue
                        if not self._is_axis_param(param.arg):
                            continue
                        resolved = self._axis_value(mod, default)
                        if resolved is not None:
                            universe.add(resolved)
                elif isinstance(node, ast.Call):
                    # Mesh(devices, ("a", "b")) — literal axis-name tuples
                    terminal = _terminal_name(node.func)
                    if terminal == "Mesh" and len(node.args) >= 2:
                        names = node.args[1]
                        elts = (
                            names.elts
                            if isinstance(names, (ast.Tuple, ast.List))
                            else [names]
                        )
                        for elt in elts:
                            resolved = self._axis_value(mod, elt)
                            if resolved is not None:
                                universe.add(resolved)
                    # axis_name="..." keyword at any call site
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
            # cross-module constant: from .mesh import DEFAULT_AXIS
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

    # ----------------------------------------------- site inventory (B2)

    def collect_sites(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None or isinstance(node, ast.Module):
                    continue
                self._site_from_decorators(mod, info, node)
            for node in mod.nodes:
                if isinstance(node, ast.Call):
                    self._site_from_call(mod, node)
        # every site-decorated or mapped def is a traced root
        for site in self.model.jit_sites:
            if site.fn_qual:
                self.model.traced_quals.add(site.fn_qual)
        for sm in self.model.sm_sites:
            if sm.fn_qual:
                self.model.traced_quals.add(sm.fn_qual)

    def _link_mapped(self) -> None:
        """A site whose function is a mapped region, or reaches one along
        the resolved call graph, is sharded (JAX's ``kind: "shard_map"``)
        and, as JAX's shard_map sites, declares no static arguments."""
        mapped = set(self.model.sm_by_fn)
        for site in self.model.jit_sites:
            if not site.fn_qual:
                continue
            seen = {site.fn_qual}
            frontier = [site.fn_qual]
            while frontier and not seen & mapped:
                info = self.model.functions.get(frontier.pop())
                for targets, _ in info.calls if info is not None else ():
                    for target in targets:
                        if target not in seen:
                            seen.add(target)
                            frontier.append(target)
            if seen & mapped:
                site.kind = "shard_map"
                site.static_argnames = ()

    def _is_instrument_expr(self, mod: ModInfo, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in mod.instrument_names
        if isinstance(expr, ast.Attribute):
            root, chain = _root_chain(expr)
            return root in mod.xprof_mods and chain == ["instrument_site"]
        return False

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

    def _enclosing_qual(self, mod: ModInfo, node: ast.AST) -> Optional[str]:
        """qual of the function whose body contains ``node`` (by lines)."""
        best: Optional[FuncInfo] = None
        for info in mod.functions:
            fnode = getattr(info, "_node", None)
            if fnode is None or isinstance(fnode, ast.Module):
                continue
            if fnode.lineno <= node.lineno <= _end(fnode):
                if best is None or fnode.lineno >= best._node.lineno:  # type: ignore[attr-defined]
                    best = info
        return best.qual if best else None

    def _site_from_decorators(
        self, mod: ModInfo, info: FuncInfo, node: ast.AST
    ) -> None:
        """``@xprof.instrument_site(name)`` / ``@meshwitness.mapped(label)``."""
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            if self._is_instrument_expr(mod, dec.func):
                self._add_jit_site(mod, dec, info.qual, default=info.name)
            elif self._is_mapped_expr(mod, dec.func):
                self._add_sm_site(mod, dec, info.qual)

    def _site_from_call(self, mod: ModInfo, call: ast.Call) -> None:
        """The binding forms ``instrument_site(name)(fn)`` and
        ``meshwitness.mapped(label)(fn)``."""
        inner = call.func
        if not isinstance(inner, ast.Call) or not call.args:
            return
        fn_qual = None
        first = call.args[0]
        if isinstance(first, ast.Name):
            quals = mod.def_index.get(first.id)
            # innermost matching def: nested builder functions
            # reuse names like `run` across builders
            if quals:
                fn_qual = self._nearest_qual(quals, call.lineno)
        if self._is_instrument_expr(mod, inner.func):
            default = first.id if isinstance(first, ast.Name) else "jit"
            self._add_jit_site(mod, inner, fn_qual, default=default)
        elif self._is_mapped_expr(mod, inner.func) and fn_qual is not None:
            self._add_sm_site(mod, inner, fn_qual)

    def _nearest_qual(self, quals: List[str], line: int) -> str:
        best = quals[0]
        best_line = -1
        for qual in quals:
            info = self.model.functions.get(qual)
            if info is not None and best_line < info.line <= line + 2:
                best, best_line = qual, info.line
        return best

    def _site_statics(self, name: str, fn_qual: Optional[str]) -> Tuple[str, ...]:
        """The site's static arguments: its graph key's, else the
        keyword-passable parameters after its operand (none when the
        function takes ``**kwargs``)."""
        if name in self.model.graph_keys:
            return self.model.graph_keys[name]
        info = self.model.functions.get(fn_qual or "")
        node = getattr(info, "_node", None)
        if node is None or isinstance(node, ast.Module):
            return ()
        args = node.args
        if args.kwarg is not None:
            return ()
        named = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        if named and named[0] in ("self", "cls"):
            named = named[1:]
        return tuple(named[1:] + [a.arg for a in args.kwonlyargs])

    def _add_jit_site(
        self,
        mod: ModInfo,
        call: ast.Call,
        fn_qual: Optional[str],
        default: str,
    ) -> JitSite:
        name = (
            _const_str(call.args[0] if call.args else None)
            or _const_str(_kw(call, "name"))
            or default
        )
        site = JitSite(
            name=name, module=mod.name, path=mod.path, line=call.lineno,
            static_argnames=self._site_statics(name, fn_qual), fn_qual=fn_qual,
        )
        self.model.jit_sites.append(site)
        return site

    def _add_sm_site(
        self, mod: ModInfo, call: ast.Call, fn_qual: Optional[str]
    ) -> SmSite:
        site = SmSite(
            module=mod.name, path=mod.path, line=call.lineno, fn_qual=fn_qual,
        )
        self.model.sm_sites.append(site)
        if fn_qual:
            self.model.sm_by_fn[fn_qual] = site
        return site

    def _axis_fingerprint(self, mod: ModInfo, expr: ast.AST) -> Optional[str]:
        resolved = self._axis_value(mod, expr)
        if resolved is not None:
            return resolved
        if isinstance(expr, ast.Name):
            return f"~{expr.id}"
        return None

    # ----------------------------------------------------- body walks (C)

    def analyze_bodies(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                self._scan_function(mod, info, node)
        self._link_mapped()
        self._propagate()
        self._check_mesh_axes()
        self._check_collectives()
        self._check_mesh_uploads()
        self._check_retrace_taint()
        self._check_traced_reach()

    def _scan_function(self, mod: ModInfo, info: FuncInfo, node) -> None:
        body = node.body if not isinstance(node, ast.Module) else [
            s for s in node.body
            if not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            )
        ]
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and sub is not node:
                    # nested defs get their own FuncInfo scan; still record
                    # the *reference* so closures appear in the call graph
                    continue
                if isinstance(sub, ast.Attribute):
                    root, chain = _root_chain(sub)
                    if root == "self" and chain and chain[-1] in (
                        "_mesh", "mesh"
                    ):
                        info.uses_self_mesh = True
                if not isinstance(sub, ast.Call):
                    continue
                targets = self._resolve_call(mod, sub.func, info.cls)
                terminal = _terminal_name(sub.func)
                if targets or terminal:
                    info.calls.append((targets, terminal))
                if self._is_sanitizer_call(mod, sub):
                    info.calls_sanitizer = True
                    self._record_bucket_literals(mod, sub)
                if terminal == "record_dispatch":
                    # a literal, or a conditional between literals (one
                    # dispatch helper serving a site and its sharded twin)
                    for site_name in _literal_options(
                        sub.args[0] if sub.args else _kw(sub, "site_name")
                    ):
                        self.model.site_callers.setdefault(
                            site_name, set()
                        ).add(info.qual)

    def _is_sanitizer_call(self, mod: ModInfo, call: ast.Call) -> bool:
        terminal = _terminal_name(call.func)
        if terminal in SANITIZER_NAMES:
            return True
        return terminal in mod.sanitizer_aliases

    def _record_bucket_literals(self, mod: ModInfo, call: ast.Call) -> None:
        # resolve an aliased import (`bucket_size as bs`) back to its
        # canonical helper name so the literal still enters the contract
        terminal = _terminal_name(call.func)
        bound = mod.from_funcs.get(terminal or "")
        canonical = bound[1] if bound else terminal
        if canonical == "bucket_size":
            minimum = _const_int(_kw(call, "minimum"))
            if minimum is None and len(call.args) >= 2:
                minimum = _const_int(call.args[1])
            if minimum is not None:
                self.model.bucket_minimums.add(minimum)
        if canonical == "pad_to":
            multiple = _const_int(_kw(call, "multiple"))
            if multiple is None and len(call.args) >= 2:
                multiple = _const_int(call.args[1])
            if multiple is not None:
                self.model.pad_multiples.add(multiple)

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

    def _propagate(self) -> None:
        """Builder set, sanitizer reach, site caller evidence."""
        model = self.model
        # builders: a function whose body constructs a jit or sm site
        for site in model.jit_sites + model.sm_sites:  # type: ignore[operator]
            mod = model.modules.get(site.module)
            if mod is None:
                continue
            owner = self._enclosing_qual(mod, _LinePoint(site.line))
            if owner is not None:
                model.builder_quals.add(owner)
        # a builder that IS a traced def is not a host-side builder
        model.builder_quals -= model.traced_quals
        # sanitizer reach: fixpoint down the call graph
        reach: Set[str] = {
            info.qual
            for info in model.functions.values()
            if info.calls_sanitizer
        }
        changed = True
        while changed:
            changed = False
            for info in model.functions.values():
                if info.qual in reach:
                    continue
                for targets, _ in info.calls:
                    if any(t in reach for t in targets):
                        reach.add(info.qual)
                        changed = True
                        break
        model.sanitizer_reach = reach
        # site caller evidence: callers of the wrapped fn or its builder
        by_fn: Dict[str, List[str]] = {}
        for site in model.jit_sites:
            if site.fn_qual:
                by_fn.setdefault(site.fn_qual, []).append(site.name)
                info = model.functions.get(site.fn_qual)
                if info is not None and info.parent:
                    by_fn.setdefault(info.parent, []).append(site.name)
        name_index: Dict[str, List[str]] = {}
        for qual in by_fn:
            info = model.functions.get(qual)
            if info is not None:
                name_index.setdefault(info.name, []).append(qual)
        for info in model.functions.values():
            for targets, terminal in info.calls:
                hits: List[str] = []
                for target in targets:
                    hits.extend(by_fn.get(target, ()))
                if not hits and terminal in name_index:
                    for qual in name_index[terminal]:
                        hits.extend(by_fn.get(qual, ()))
                for site_name in hits:
                    model.site_callers.setdefault(site_name, set()).add(
                        info.qual
                    )

    # ------------------------------------------------------ rule checks

    def _check_mesh_axes(self) -> None:
        """SCX501: axes named to a mesh's grouping must be declared."""
        universe = self.model.axis_universe
        reported: Set[Tuple[str, int, str]] = set()
        for mod in self.model.modules.values():
            for node in mod.nodes:
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MESH_AXIS_METHODS
                    and node.args
                ):
                    continue
                arg = node.args[0]
                elts = (
                    arg.elts
                    if isinstance(arg, (ast.Tuple, ast.List))
                    else [arg]
                )
                for elt in elts:
                    axis = _const_str(elt) or (
                        self._axis_value(mod, elt)
                        if isinstance(elt, (ast.Name, ast.Attribute))
                        else None
                    )
                    if axis is None or axis in universe:
                        continue
                    key = (mod.path, elt.lineno, axis)
                    if key in reported:
                        continue
                    reported.add(key)
                    declared = ", ".join(sorted(universe)) or "(none)"
                    self.model.findings.append(
                        Finding(
                            "SCX501", mod.path, elt.lineno,
                            f"mesh grouping names axis `{axis}`, which no "
                            f"mesh in the package declares (declared axes: "
                            f"{declared}) — the grouping would fail at "
                            "dispatch",
                            _end(elt),
                        )
                    )

    def _collective_terminal(self, mod: ModInfo, func: ast.AST) -> Optional[str]:
        """The wrapper's name when ``func`` is a ``parallel.collective``
        wrapper (``collective.psum`` or an imported ``psum``)."""
        if isinstance(func, ast.Name):
            return func.id if func.id in mod.collective_funcs else None
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if len(chain) == 1 and chain[0] in _COLLECTIVE_AXIS_ARG and (
                root in mod.collective_mods
                or mod.mod_aliases.get(root, "").endswith("collective")
            ):
                return chain[0]
        return None

    def _check_collectives(self) -> None:
        """SCX504: a mapped region's collective axes must be declared."""
        universe = self.model.axis_universe
        for sm in self.model.sm_sites:
            if sm.fn_qual is None:
                continue
            info = self.model.functions.get(sm.fn_qual)
            node = getattr(info, "_node", None) if info else None
            if node is None:
                continue
            mod = self.model.modules.get(sm.module)
            if mod is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                terminal = self._collective_terminal(mod, sub.func)
                if terminal is None:
                    continue
                index = _COLLECTIVE_AXIS_ARG[terminal]
                axis_expr = _kw(sub, "axis_name")
                if axis_expr is None and len(sub.args) > index:
                    axis_expr = sub.args[index]
                if axis_expr is None:
                    continue
                exprs = (
                    axis_expr.elts
                    if isinstance(axis_expr, (ast.Tuple, ast.List))
                    else [axis_expr]
                )
                for expr in exprs:
                    fp = self._axis_fingerprint(mod, expr)
                    if fp is None or fp.startswith("~") or fp in universe:
                        continue
                    declared = ", ".join(sorted(universe)) or "(none)"
                    self.model.findings.append(
                        Finding(
                            "SCX504", mod.path, expr.lineno,
                            f"collective `{terminal}` names axis "
                            f"`{fp}`, which no mesh in the package "
                            f"declares (declared axes: {declared})",
                            _end(expr),
                        )
                    )

    def _check_mesh_uploads(self) -> None:
        """SCX502: uploads in mesh-context functions must shard-place."""
        for mod in self.model.modules.values():
            for info in mod.functions:
                if not (info.has_mesh_param or info.uses_self_mesh):
                    continue
                node = getattr(info, "_node", None)
                if node is None or isinstance(node, ast.Module):
                    continue
                # local names bound from a mesh_sharding(...) call, and
                # names bound to one shard's device
                sharded_names: Set[str] = set()
                shard_devices: Set[str] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call
                    ):
                        if self._is_mesh_sharding(mod, sub.value.func):
                            for target in sub.targets:
                                if isinstance(target, ast.Name):
                                    sharded_names.add(target.id)
                    elif isinstance(sub, ast.Assign) and _is_shard_device(
                        sub.value, shard_devices
                    ):
                        for target in sub.targets:
                            if isinstance(target, ast.Name):
                                shard_devices.add(target.id)
                    elif isinstance(sub, (ast.For, ast.comprehension)):
                        if _mentions_devices(sub.iter):
                            for name in ast.walk(sub.target):
                                if isinstance(name, ast.Name):
                                    shard_devices.add(name.id)
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    if not self._is_upload_call(mod, sub):
                        continue
                    device = _kw(sub, "device")
                    if device is None and len(sub.args) >= 2:
                        device = sub.args[1]
                    if device is not None and _is_shard_device(
                        device, shard_devices
                    ):
                        continue
                    sharding = _kw(sub, "sharding")
                    if sharding is not None and not (
                        isinstance(sharding, ast.Constant)
                        and sharding.value is None
                    ):
                        ok = True
                        if isinstance(sharding, ast.Call):
                            ok = self._is_mesh_sharding(mod, sharding.func)
                        elif isinstance(sharding, ast.Name):
                            ok = sharding.id in sharded_names
                        if ok:
                            continue
                    self.model.findings.append(
                        Finding(
                            "SCX502", mod.path, sub.lineno,
                            f"device upload in mesh-context "
                            f"`{info.name}` without a per-shard device "
                            "(`mesh.devices[i]`): the put targets one "
                            "device, materializes the whole batch there, "
                            "and reshards inside the pass",
                            _end(sub),
                        )
                    )

    def _is_upload_call(self, mod: ModInfo, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in mod.upload_names
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            return root in mod.ingest_mods and chain == ["upload"]
        return False

    def _is_mesh_sharding(self, mod: ModInfo, func: ast.AST) -> bool:
        if isinstance(func, ast.Name):
            return func.id in mod.mesh_sharding_names
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            return root in mod.ingest_mods and chain == ["mesh_sharding"]
        return False

    # ------------------------------------------------- SCX503 taint

    def _check_retrace_taint(self) -> None:
        statics_by_fn: Dict[str, Tuple[str, Tuple[str, ...], str]] = {}
        statics_by_name: Dict[str, Tuple[str, Tuple[str, ...], str]] = {}
        for site in self.model.jit_sites:
            if not site.fn_qual:
                continue
            entry = (site.name, site.static_argnames, site.fn_qual)
            statics_by_fn[site.fn_qual] = entry
            info = self.model.functions.get(site.fn_qual)
            if info is not None and len(info.name) >= _DISPATCHY_MIN_NAME_LEN:
                statics_by_name.setdefault(info.name, entry)
        builder_names = {
            self.model.functions[q].name: q
            for q in self.model.builder_quals
            if q in self.model.functions
        }
        for mod in self.model.modules.values():
            for info in mod.functions:
                if info.qual in self.model.traced_quals:
                    continue  # inside a trace, .shape IS static
                node = getattr(info, "_node", None)
                if node is None or isinstance(node, ast.Module):
                    continue
                self._taint_walk(
                    mod, info, node, statics_by_fn, statics_by_name,
                    builder_names,
                )

    def _taint_walk(
        self, mod, info, node, statics_by_fn, statics_by_name, builder_names
    ) -> None:
        tainted: Set[str] = set()

        def expr_tainted(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in tainted
            if isinstance(expr, ast.Call):
                terminal = _terminal_name(expr.func)
                if self._is_sanitizer_call(mod, expr):
                    return False
                if terminal == "len":
                    return True
                if terminal == "int" and expr.args and not isinstance(
                    expr.args[0], ast.Constant
                ):
                    return True
                if terminal in ("min", "max"):
                    for arg in expr.args:
                        if isinstance(arg, ast.GeneratorExp):
                            if expr_tainted(arg.elt):
                                return True
                        elif expr_tainted(arg):
                            return True
                return False
            if isinstance(expr, ast.Subscript):
                value = expr.value
                if isinstance(value, ast.Attribute) and value.attr == "shape":
                    return True
                return expr_tainted(value)
            if isinstance(expr, ast.BinOp):
                return expr_tainted(expr.left) or expr_tainted(expr.right)
            if isinstance(expr, ast.UnaryOp):
                return expr_tainted(expr.operand)
            if isinstance(expr, ast.IfExp):
                return expr_tainted(expr.body) or expr_tainted(expr.orelse)
            return False

        def visit(stmts) -> None:
            for stmt in stmts:
                if isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    continue
                if isinstance(stmt, ast.Assign):
                    value = stmt.value
                    is_tainted = expr_tainted(value)
                    shape_tuple = (
                        isinstance(value, ast.Attribute)
                        and value.attr == "shape"
                    )
                    for target in stmt.targets:
                        names = (
                            [target]
                            if isinstance(target, ast.Name)
                            else list(getattr(target, "elts", ()))
                        )
                        for name in names:
                            if not isinstance(name, ast.Name):
                                continue
                            if is_tainted or shape_tuple:
                                tainted.add(name.id)
                            else:
                                tainted.discard(name.id)
                elif isinstance(stmt, ast.AugAssign):
                    if isinstance(stmt.target, ast.Name) and expr_tainted(
                        stmt.value
                    ):
                        tainted.add(stmt.target.id)
                # scan every call in the statement for sinks (including
                # calls inside deferred lambdas: the closure captures the
                # tainted binding and dispatches with it later)
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        check_sink(sub)
                # recurse into compound bodies in order
                for attr in ("body", "orelse", "finalbody"):
                    inner = getattr(stmt, attr, None)
                    if inner:
                        visit(inner)
                for handler in getattr(stmt, "handlers", ()):
                    visit(handler.body)

        reported: Set[int] = set()

        def check_sink(call: ast.Call) -> None:
            targets = self._resolve_call(mod, call.func, info.cls)
            terminal = _terminal_name(call.func)
            entry = statics_by_fn.get(self._graph_fn(call) or "")
            for target in targets:
                if entry is not None:
                    break
                if target in statics_by_fn:
                    entry = statics_by_fn[target]
            if entry is None and terminal in statics_by_name and not targets:
                entry = statics_by_name[terminal]
            if entry is not None:
                site_name, statics, fn_qual = entry
                target_info = self.model.functions.get(fn_qual)
                bad: List[str] = []
                for kw in call.keywords:
                    if kw.arg in statics and expr_tainted(kw.value):
                        bad.append(kw.arg)
                if target_info is not None:
                    params = list(target_info.params)
                    for position, arg in enumerate(call.args):
                        if position < len(params) and params[
                            position
                        ] in statics and expr_tainted(arg):
                            bad.append(params[position])
                if bad and call.lineno not in reported:
                    reported.add(call.lineno)
                    self.model.findings.append(
                        Finding(
                            "SCX503", mod.path, call.lineno,
                            "data-dependent scalar flows into static "
                            f"argument(s) {', '.join(sorted(set(bad)))} of "
                            f"jit site `{site_name}` without a bucket/pad "
                            "helper — every distinct value is a fresh "
                            "compile (retrace) at this site",
                            _end(call),
                        )
                    )
                return
            builder_qual = None
            for target in targets:
                if target in self.model.builder_quals:
                    builder_qual = target
                    break
            if builder_qual is None and not targets:
                builder_qual = builder_names.get(terminal or "")
            if builder_qual is not None:
                if any(expr_tainted(arg) for arg in call.args) or any(
                    expr_tainted(kw.value) for kw in call.keywords
                ):
                    if call.lineno in reported:
                        return
                    reported.add(call.lineno)
                    short = builder_qual.rsplit(".", 1)[-1]
                    self.model.findings.append(
                        Finding(
                            "SCX503", mod.path, call.lineno,
                            "data-dependent scalar flows into jit-builder "
                            f"`{short}` without a bucket/pad helper — "
                            "each distinct value builds and compiles a "
                            "fresh executable",
                            _end(call),
                        )
                    )

        visit(node.body)

    def _graph_fn(self, call: ast.Call) -> Optional[str]:
        """The graph-keyed site's function when ``call`` is a graph set's
        ``run`` / ``capture`` (whose keywords are the graph key)."""
        func = call.func
        if not (
            isinstance(func, ast.Attribute)
            and func.attr in _GRAPH_METHODS
            and _terminal_name(func.value) in _GRAPH_RECEIVERS
        ):
            return None
        for site in self.model.jit_sites:
            if site.name in self.model.graph_keys and site.fn_qual:
                return site.fn_qual
        return None

    # ----------------------------------------------- SCX505 reachability

    def _check_traced_reach(self) -> None:
        model = self.model
        # closure over the name-resolved call graph from traced roots
        reachable: Set[str] = set()
        frontier = list(model.traced_quals)
        while frontier:
            qual = frontier.pop()
            info = model.functions.get(qual)
            if info is None:
                continue
            for targets, _ in info.calls:
                for target in targets:
                    if target not in reachable and (
                        target not in model.traced_quals
                    ):
                        reachable.add(target)
                        frontier.append(target)
        for qual in sorted(reachable):
            info = model.functions.get(qual)
            if info is None or qual in model.builder_quals:
                continue
            mod = model.modules.get(info.module)
            node = getattr(info, "_node", None)
            if mod is None or node is None or isinstance(node, ast.Module):
                continue
            pulled: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ) and self._is_pull_call(mod, sub.value):
                    for target in sub.targets:
                        if isinstance(target, ast.Name):
                            pulled.add(target.id)

            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                func = sub.func
                if not isinstance(func, ast.Attribute):
                    continue
                receiver = func.value
                if (
                    func.attr in _HOST_SYNC_ATTRS and not sub.args
                ) or func.attr == "synchronize" or (
                    func.attr == "numpy"
                    and (
                        (isinstance(receiver, ast.Name) and receiver.id in pulled)
                        or (
                            isinstance(receiver, ast.Call)
                            and self._is_pull_call(mod, receiver)
                        )
                    )
                ):
                    self.model.findings.append(
                        Finding(
                            "SCX505", mod.path, sub.lineno,
                            f"`.{func.attr}()` in `{info.name}`, which is "
                            "reachable from a traced function: inside the "
                            "device pass this is a forced device->host "
                            "sync per call (and a CUDA graph capture "
                            "refuses it)",
                            _end(sub),
                        )
                    )

    def _is_pull_call(self, mod: ModInfo, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in mod.pull_names
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            return root in mod.ingest_mods and chain == ["pull"]
        return False

    # --------------------------------------- static value universes (D)

    def collect_static_values(self) -> None:
        """Literal values flowing into each site's static parameters.

        Scans every call to a site's wrapped function (resolved or by
        terminal name): a literal kwarg/positional for a static parameter
        joins that parameter's closed value set; a non-literal marks the
        parameter *open* (``None`` sentinel in the set) — the contract
        then falls back to the dim grammar for ints and accepts
        strings/bools.
        """
        model = self.model
        by_fn: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        by_name: Dict[str, Tuple[str, Tuple[str, ...], str]] = {}
        for site in model.jit_sites:
            if not site.fn_qual or not site.static_argnames:
                model.static_values.setdefault(site.name, {})
                continue
            model.static_values.setdefault(site.name, {})
            by_fn[site.fn_qual] = (site.name, site.static_argnames)
            info = model.functions.get(site.fn_qual)
            if info is not None and len(info.name) >= _DISPATCHY_MIN_NAME_LEN:
                by_name.setdefault(
                    info.name, (site.name, site.static_argnames, site.fn_qual)
                )
        seen_calls: Set[Tuple[int, Optional[str]]] = set()
        for mod in model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                for sub in mod.nodes if node is mod.tree else ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    if (id(sub), info.cls) in seen_calls:
                        continue  # the same call, seen from its enclosure
                    seen_calls.add((id(sub), info.cls))
                    targets = self._resolve_call(mod, sub.func, info.cls)
                    fn_qual = self._graph_fn(sub)
                    entry = by_fn.get(fn_qual or "")
                    for target in targets:
                        if entry is not None:
                            break
                        if target in by_fn:
                            entry = by_fn[target]
                            fn_qual = target
                    if entry is None and not targets:
                        terminal = _terminal_name(sub.func)
                        named = by_name.get(terminal or "")
                        if named is not None:
                            entry = (named[0], named[1])
                            fn_qual = named[2]
                    if entry is None:
                        continue
                    site_name, statics = entry
                    values = model.static_values.setdefault(site_name, {})
                    seen: Set[str] = set()
                    target_info = model.functions.get(fn_qual or "")
                    if target_info is not None:
                        params = list(target_info.params)
                        for position, arg in enumerate(sub.args):
                            if position >= len(params):
                                break
                            if params[position] in statics:
                                self._note_static(
                                    values, params[position], arg
                                )
                                seen.add(params[position])
                    for kw in sub.keywords:
                        if kw.arg in statics:
                            self._note_static(values, kw.arg, kw.value)
                            seen.add(kw.arg)
                        elif kw.arg is None:
                            # **kwargs splat may carry any static: open all
                            for name in statics:
                                if name not in seen:
                                    values.setdefault(name, set()).add(None)

    @staticmethod
    def _note_static(
        values: Dict[str, Set[Any]], name: str, expr: ast.AST
    ) -> None:
        slot = values.setdefault(name, set())
        if isinstance(expr, ast.Constant) and isinstance(
            expr.value, (str, bool, int)
        ):
            slot.add(expr.value)
        else:
            slot.add(None)  # open: a non-literal value reaches this param


class _LinePoint:
    """Minimal line-carrying stand-in for _enclosing_qual lookups."""

    def __init__(self, lineno: int):
        self.lineno = lineno


# ------------------------------------------------------------- public API


def build_model(paths: Sequence[str]) -> ShardModel:
    """Parse + analyze every ``.py`` under ``paths`` into one ShardModel."""
    analyzer = _Analyzer()
    analyzer.load(collect_py_files(paths, SHARD_EXEMPT_DIRS))
    analyzer.collect_axes()
    analyzer.collect_sites()
    analyzer.analyze_bodies()
    analyzer.collect_static_values()
    return analyzer.model


def check_shards(
    paths: Sequence[str], model: Optional[ShardModel] = None
) -> List[Finding]:
    """Run the SCX5xx pass; returns suppression-filtered findings.
    ``model``: one :func:`build_model` already built over ``paths``."""
    if model is None:
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


# -------------------------------------------------------- shape contract

# the monoblock wire envelope: one leading n_valid word plus
# per-record-bytes/4 words per padded record, optionally followed by two
# num_runs-bucket int32 run-key tables (io.packed.wire_layout). The
# per-record byte width depends on the schema variant; the contract
# admits the full envelope rather than re-deriving wire_layout's
# conditionals (over-approximation: sound for the subset check)
_WIRE_HEADER_WORDS = 1
_WIRE_RUN_TABLE_LANES = 2
_WIRE_MIN_RECORD_BYTES = 12
_WIRE_MAX_RECORD_BYTES = 72
_POW2_CAP = 1 << 30

CONTRACT_VERSION = 1


def build_shape_contract(
    paths: Sequence[str], model: Optional[ShardModel] = None
) -> Dict[str, Any]:
    """The statically predicted per-site signature/sharding universe.

    The runtime half of the pass, mirroring scx-race's
    ``--emit-lock-graph``: ``chip_smoke.py`` runs the pipeline for real
    and asserts every observed signature in the merged xprof registries
    is admitted (:func:`check_signatures`). The
    contract is closed over the bucket universe — every shape the
    bucket/pad tables can emit is admitted for any n (property-tested) —
    and deliberately over-approximates, so a legal bucketed dispatch can
    never fail CI; what it rejects is the regression class: raw
    unbucketed dims, unknown sites, undeclared axis names, sharded
    operands at unsharded sites, and raw data-dependent static values.

    A site counts as ``"dims": "bucketed"`` when ANY modeled caller
    reaches a bucket/pad helper. That is a sensitivity choice: a site
    with one bucketed streaming caller stays gated even if a second
    dispatch path is modeled without sanitizer reach (fixed shapes in
    this codebase are small or pow2, both admitted by the dim grammar);
    weakening to "all callers" would let one thin wrapper un-gate the
    hot path.
    """
    if model is None:
        model = build_model(paths)
    minimums = sorted(
        model.bucket_minimums | {model.record_bucket_min}
    ) or [4096]
    sites: Dict[str, Any] = {}
    for site in model.jit_sites:
        callers = model.site_callers.get(site.name, set())
        bucketed = any(q in model.sanitizer_reach for q in callers)
        statics: Dict[str, Any] = {}
        for name, values in (model.static_values.get(site.name) or {}).items():
            statics[name] = {
                "open": None in values,
                "values": sorted(
                    (repr(v) for v in values if v is not None), key=str
                ),
            }
        entry = {
            "module": site.module,
            "kind": site.kind,
            "static_argnames": list(site.static_argnames),
            "dims": "bucketed" if bucketed else "any",
            "statics": statics,
            "sharded": site.kind == "shard_map",
            # a mapped region declares no specs: no per-site axes, and the
            # observed axis names validate against the global universe
            "axes": [],
        }
        existing = sites.get(site.name)
        if existing is not None:
            # one site name declared at several code sites (rare): merge
            # to the weaker (safer) contract
            if existing["dims"] == "any" or entry["dims"] == "any":
                entry["dims"] = "any"
            entry["sharded"] = existing["sharded"] or entry["sharded"]
            entry["axes"] = sorted(set(existing["axes"]) | set(entry["axes"]))
        sites[site.name] = entry
    return {
        "version": CONTRACT_VERSION,
        "axis_universe": sorted(model.axis_universe),
        "bucket_minimums": minimums,
        "pad_multiples": sorted(model.pad_multiples),
        "pow2_min": min(minimums + [8]),
        "small_dim_max": 256,
        "wire": {
            "header_words": _WIRE_HEADER_WORDS,
            "run_table_lanes": _WIRE_RUN_TABLE_LANES,
            "min_record_bytes": _WIRE_MIN_RECORD_BYTES,
            "max_record_bytes": _WIRE_MAX_RECORD_BYTES,
            # the padded-record base of the wire envelope = the pinned
            # bucket_size floor (autotuner-rewritten; 4096 by default)
            "pad_min": model.record_bucket_min,
        },
        "sites": sites,
    }


def _pow2s(minimum: int, cap: int = _POW2_CAP) -> List[int]:
    out = []
    p = 1
    while p < minimum:
        p *= 2
    while p <= cap:
        out.append(p)
        p *= 2
    return out


def dim_admissible(dim: int, contract: Dict[str, Any]) -> bool:
    """Whether one shape dimension is in the contract's bucket universe.

    Admissible: tiny structural constants (column counts, scalar lanes),
    bucket outputs (powers of two >= the smallest literal minimum), and
    monoblock wire lengths (header + padded * record-bytes / 4 words,
    optionally + two run-table buckets).
    """
    if dim <= int(contract.get("small_dim_max", 256)):
        return dim >= 0
    pow2_min = int(contract.get("pow2_min", 8))
    if dim >= pow2_min and _is_pow2(dim):
        return True
    wire = contract.get("wire") or {}
    header = int(wire.get("header_words", _WIRE_HEADER_WORDS))
    lanes = int(wire.get("run_table_lanes", _WIRE_RUN_TABLE_LANES))
    lo = int(wire.get("min_record_bytes", _WIRE_MIN_RECORD_BYTES))
    hi = int(wire.get("max_record_bytes", _WIRE_MAX_RECORD_BYTES))
    base = dim - header
    if base <= 0:
        return False
    pad_min = int(wire.get("pad_min", 4096))
    run_options = [0] + _pow2s(pad_min, 1 << 26)
    for padded in _pow2s(pad_min):
        if padded * lo // 4 > base:
            break
        for runs in run_options:
            words = base - lanes * runs
            if words <= 0:
                continue
            record_bytes = words * 4
            if record_bytes % padded:
                continue
            if lo <= record_bytes // padded <= hi:
                return True
    return False


# one abstract leaf of a recorded signature: dtype[d1,d2]@(axes)
_LEAF = re.compile(
    r"(?P<dtype>[A-Za-z_][A-Za-z0-9_]*)\[(?P<dims>[0-9,]*)\]"
    r"(?:@\((?P<axes>[^)]*)\))?"
)
_STATIC = re.compile(r"(\w+)=('[^']*'|\"[^\"]*\"|[^,}]+)")


def check_signatures(
    contract: Dict[str, Any], sites: Dict[str, Any]
) -> List[str]:
    """Violations of ``observed signatures ⊆ contract`` (empty == OK).

    ``sites`` is the merged registry's per-site dict (``obs efficiency
    --json``'s ``sites`` / ``xprof.merge_registries(...)["sites"]``).
    Pure stdlib — the smoke gates and external dashboards can run it on
    any host against an emitted contract file.
    """
    out: List[str] = []
    contract_sites = contract.get("sites") or {}
    universe = set(contract.get("axis_universe") or [])
    for site_name, row in sorted(sites.items()):
        signatures = row.get("signatures") or {}
        if not signatures:
            continue
        spec = contract_sites.get(site_name)
        if spec is None:
            out.append(
                f"{site_name}: site not present in the static contract "
                "(an instrument_jit site the model did not see)"
            )
            continue
        for signature in signatures:
            if signature == "(other signatures)":
                # the registry's 64-per-site overflow bucket: the exact
                # signatures are gone, so the subset check CANNOT vouch
                # for them — and >64 distinct signatures at one site is
                # itself the shape-flapping regression this gate exists
                # to catch. Lost coverage is a violation, not a pass.
                out.append(
                    f"{site_name}: signature overflow bucket present "
                    "(>64 distinct signatures at one site; per-signature "
                    "coverage lost — shape flapping)"
                )
                continue
            out.extend(_check_one(site_name, signature, spec, contract, universe))
    return out


def _check_one(
    site_name: str,
    signature: str,
    spec: Dict[str, Any],
    contract: Dict[str, Any],
    universe: Set[str],
) -> List[str]:
    out: List[str] = []
    bucketed = spec.get("dims") == "bucketed"
    # abstract leaves ---------------------------------------------------
    body, _, static_text = signature.partition("{")
    for match in _LEAF.finditer(body):
        dims = [int(d) for d in match.group("dims").split(",") if d]
        if bucketed:
            for dim in dims:
                if not dim_admissible(dim, contract):
                    out.append(
                        f"{site_name}: dim {dim} in `{signature}` is "
                        "outside the bucket/pad universe (raw unbucketed "
                        "shape reached a bucketed site)"
                    )
        axes_text = match.group("axes")
        if axes_text:
            axes = {a.strip() for a in axes_text.split("+") if a.strip()}
            # the port's per-shard tag names no axis: split over the
            # mesh's shards, whatever its axes are called
            unknown = axes - universe - {PORT_SHARDS_TAG}
            if unknown:
                out.append(
                    f"{site_name}: operand sharded over undeclared "
                    f"axis(es) {sorted(unknown)} in `{signature}`"
                )
            if axes and not spec.get("sharded"):
                out.append(
                    f"{site_name}: mesh-sharded operand observed at a "
                    f"non-shard_map site in `{signature}`"
                )
    # static values -----------------------------------------------------
    declared = set(spec.get("static_argnames") or [])
    statics = spec.get("statics") or {}
    for name, raw in _STATIC.findall(static_text):
        if declared and name not in declared:
            out.append(
                f"{site_name}: static kwarg `{name}` not among the "
                f"declared static_argnames {sorted(declared)}"
            )
            continue
        param = statics.get(name) or {"open": True, "values": []}
        raw = raw.strip()
        if not param["open"] and param["values"]:
            if raw not in param["values"]:
                out.append(
                    f"{site_name}: static `{name}={raw}` outside the "
                    f"closed literal universe {param['values']}"
                )
            continue
        # open parameter: ints are pad/bucket shapes and must obey the
        # dim grammar at bucketed sites; strings/bools pass
        if bucketed:
            if raw in ("True", "False"):
                continue
            try:
                value = int(raw)
            except ValueError:
                continue
            if not dim_admissible(value, contract):
                out.append(
                    f"{site_name}: static `{name}={raw}` is a raw "
                    "unbucketed size (outside the bucket/pad universe)"
                )
    return out
