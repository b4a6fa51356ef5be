"""scx-cost: static device-cost and transfer-discipline analysis (SCX701-705).

The port's copy of ``sctools_tpu.analysis.costcheck``: the same rule ids,
messages, JSON fields, escapes, exempt directories and model limits, with
the constructs the model recognises respelled for the port. Port rule 6
("no host syncs inside a batch's device pass") and the choke points
``ingest.upload`` / ``ingest.pull`` / ``WritebackRing.stage`` and
``collect`` are the discipline this pass enforces. The model inventories
every transfer site, every device-dispatch binding, every sync point, and
the loops and functions around them, then enforces:

- **SCX701 transfer-in-hot-loop** — an ``ingest.upload`` /
  ``ingest.pull`` / ``WritebackRing.collect`` lexically inside a ``for`` /
  ``while`` loop whose staged operand is loop-invariant (no name in it is
  assigned by the loop). The same bytes cross the link every iteration;
  hoist the transfer above the loop.
- **SCX702 redundant-device-recompute** — inside a loop, (a) a call whose
  arguments are ALL loop-invariant to a device dispatch the port binds:
  a function decorated with ``xprof.instrument_site`` (JAX's
  ``instrument_jit``), the kernel wrapper ``ops.whitelist.correct_codes``,
  or a CUDA graph replay (``<...graph>.replay()``, ``<...graphs>.run(...)``,
  the receiver counted among the arguments), or (b) a call to a helper
  that uploads a value derived only from its parameters, with no
  content-hash cache guard, where the arguments feeding that upload are
  loop-invariant (the whitelist table's cache, ``ops/whitelist.py``'s
  ``_table_cache``, is the sanctioned shape).
- **SCX703 sync-inside-overlap-window** — between a ``WritebackRing``'s
  ``stage()`` kick and its ``collect()`` / ``close()`` drain, a host
  synchronisation: ``torch.cuda.synchronize()`` or any ``.synchronize()``
  (an event, a stream), ``.item()``, ``.tolist()``, ``.cpu()``, or
  ``.numpy()`` of a ``Pulled`` other than the one the ring collects (the
  result of an ``ingest.pull``). The kick exists so the D2H runs under the
  next batch's compute; a sync inside the window serialises that overlap.
  JAX's timed transfers are not ported, so this pass has no ``timed=``
  clause.
- **SCX704 unbucketed-pad-waste** — a ``bucket_size`` / ``pad_to`` /
  ``entity_bucket`` call whose size operand is a static constant under
  HALF the applicable floor (``RECORD_BUCKET_MIN`` / ``ENTITY_BUCKET_MIN``
  of ``ops/segments.py``, or the literal ``minimum=`` / multiple).
- **SCX705 ledger-unmetered-transfer** — a choke-point transfer whose
  ``site`` is not a static string literal, or a ``record=False`` transfer
  in a function that never calls ``record_transfer`` itself (bytes that
  cross the boundary but never reach the ledger).

The runtime witness: :func:`transfer_inventory` is the statically
enumerated transfer-site set (every ``site="..."`` literal at an upload,
pull, collect or ``record_transfer`` call, with its direction), and
``chip_smoke.py``'s discipline phase asserts that the sites of the live
workers' merged ledgers are a subset of it with matching directions
(:func:`check_transfer_sites`): no phantom sites in the ledger, no transfer
path the static model missed.

Model limits (deliberate, shared with the sibling passes): call
resolution is name-based; statement order approximates control flow
(path-insensitive, textual order); loop invariance is name-granular (a
mutated attribute of an unassigned root is treated as varying only when
the exact dotted prefix is written in the loop). ``analysis/`` is pruned
as the mechanism; ``ingest/`` is modeled but exempt from findings — it
OWNS the choke points (its internal ``record_transfer`` calls carry the
caller's dynamic ``site``), the immediate-parent ownership line SCX112
draws — and so is ``parallel/collective.py``, whose gloo route stages
across the host on purpose.

Pure stdlib; imports nothing under analysis except the shared cache;
honors ``# scx-lint: disable=SCX7xx`` escapes.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions

COST_RULES = {
    "SCX701": "transfer-in-hot-loop",
    "SCX702": "redundant-device-recompute",
    "SCX703": "sync-inside-overlap-window",
    "SCX704": "unbucketed-pad-waste",
    "SCX705": "ledger-unmetered-transfer",
}

COST_MECHANISM_DIRS = ("analysis",)
COST_OWNER_DIRS = ("ingest",)
# modules exempt by (parent directory, file): the gloo route of the mesh
# collectives stages its pieces through the host on purpose
COST_OWNER_FILES = (("parallel", "collective.py"),)

# fallback bucket floors when ops/segments.py is outside the analyzed
# paths (fixture trees); the real tree's pinned constants override these
DEFAULT_RECORD_BUCKET_MIN = 4096
DEFAULT_ENTITY_BUCKET_MIN = 64

# ledger-writing callees: the calls whose `site=` literals make up the
# transfer inventory (and that SCX705 holds to static accountability)
_TRANSFER_TERMINALS = frozenset(("upload", "pull", "collect"))
# positional index of the site argument when it is not a keyword:
# upload(array, device, site), pull(value, site), collect(staged, site),
# record_transfer(direction, nbytes, seconds, site)
_SITE_POSITION = {"upload": 2, "pull": 1, "collect": 1, "record_transfer": 3}
# sync events for SCX703's overlap window: a method of any receiver
_SYNC_NAMES = frozenset(("synchronize", "item", "tolist", "cpu"))
# the kernel wrapper whose calls dispatch the hand kernel (SCX702)
_KERNEL_WRAPPERS = frozenset(("correct_codes",))


# ------------------------------------------------------------- records


@dataclass
class TransferSite:
    """One statically-inventoried ledger site occurrence."""

    site: str
    direction: str  # "h2d" | "d2h"
    module: str
    path: str
    line: int
    kind: str  # upload | pull | collect | record_transfer


@dataclass
class FuncInfo:
    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str] = None
    params: Tuple[str, ...] = ()
    # params whose values feed an UNCACHED ingest.upload inside this
    # function (the SCX702(b) summary); empty tuple entry means the
    # upload depends on no parameter at all (pure constant content)
    pure_upload_params: List[Tuple[Tuple[str, ...], int]] = field(
        default_factory=list
    )
    cache_guarded: bool = False
    # params this function forwards into a transfer call's `site=`
    # (directly, or through another forwarding helper — fixpoint): the
    # bench probe-helper shape. Accountability moves to the CALLERS,
    # whose literal arguments inventory here and whose non-literal
    # arguments are the SCX705 finding.
    site_forward_params: Dict[str, Set[str]] = field(default_factory=dict)


@dataclass
class ModInfo:
    name: str
    path: str
    is_pkg: bool
    tree: ast.Module
    exempt: bool = False
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    from_funcs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    ingest_mods: Set[str] = field(default_factory=set)
    xprof_mods: Set[str] = field(default_factory=set)
    upload_names: Set[str] = field(default_factory=set)
    pull_names: Set[str] = field(default_factory=set)
    record_transfer_names: Set[str] = field(default_factory=set)
    instrument_names: Set[str] = field(default_factory=set)
    ring_ctor_names: Set[str] = field(default_factory=set)  # WritebackRing
    bucket_fn_names: Dict[str, str] = field(default_factory=dict)
    # module-level names bound to dispatch constructions
    # (J = instrument_site(name)(fn))
    jit_bindings: Dict[str, int] = field(default_factory=dict)
    # module-level names assigned a dict literal (content-cache candidates)
    cache_dicts: Set[str] = field(default_factory=set)
    # class name -> attr names assigned WritebackRing(...) in any method
    ring_attrs: Dict[str, Set[str]] = field(default_factory=dict)
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)


class CostModel:
    """The whole-package device-cost model."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        # jit-decorated defs: qual -> line
        self.jit_defs: Dict[str, int] = {}
        self.transfer_sites: List[TransferSite] = []
        self.record_bucket_min = DEFAULT_RECORD_BUCKET_MIN
        self.entity_bucket_min = DEFAULT_ENTITY_BUCKET_MIN
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


def _end(node: ast.AST) -> int:
    return getattr(node, "end_lineno", node.lineno) or node.lineno


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _const_int(node: Optional[ast.AST]) -> Optional[int]:
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    ):
        return int(node.value)
    return None


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    root, chain = _root_chain(node)
    if root is None:
        return None
    return ".".join([root] + chain)


# ------------------------------------------------------------ the build


class _Analyzer:
    def __init__(self) -> None:
        self.model = CostModel()

    # ------------------------------------------------------- phase A

    def load(self, files: Sequence[Tuple[str, str, bool]]) -> None:
        for path, name, is_pkg in files:
            parsed = parse_cached(path)
            if parsed is None:
                continue
            _, tree = parsed
            self.model.modules[name] = ModInfo(
                name=name, path=path, is_pkg=is_pkg, tree=tree
            )
        for mod in self.model.modules.values():
            self._collect_imports(mod)
            self._index_functions(mod)
            self._collect_module_bindings(mod)
            self._collect_ring_attrs(mod)
            self._collect_segment_constants(mod)
        self._link_aliases()
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is not None and not isinstance(node, ast.Module):
                    self._summarize_uploads(mod, info, node)
        self._compute_site_forwarding()

    def _compute_site_forwarding(self) -> None:
        """Which params flow into a transfer call's ``site=``.

        Fixpoint along the call graph (the ``paired -> timed_pull ->
        pull`` bench shape needs two hops): a param is forwarding when it
        is the site argument of a transfer call, or is passed to another
        function's forwarding param.
        """
        for _ in range(5):
            changed = False
            for mod in self.model.modules.values():
                for info in mod.functions:
                    node = getattr(info, "_node", None)
                    if node is None or isinstance(node, ast.Module):
                        continue
                    if self._forwarding_round(mod, info, node):
                        changed = True
            if not changed:
                break

    def _forwarding_round(self, mod: ModInfo, info: FuncInfo, node) -> bool:
        params = set(info.params)
        if not params:
            return False
        changed = False

        def mark(param: str, directions: Set[str]) -> None:
            nonlocal changed
            have = info.site_forward_params.setdefault(param, set())
            if not directions <= have:
                have.update(directions)
                changed = True

        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            kind = self._transfer_kind(mod, sub)
            if kind is not None:
                site_node, _ = self._site_of(sub, kind)
                if isinstance(site_node, ast.Name) and (
                    site_node.id in params
                ):
                    direction = self._direction_of(sub, kind)
                    mark(
                        site_node.id,
                        {direction} if direction else {"h2d", "d2h"},
                    )
                continue
            for qual in self._resolve_call(mod, sub.func, info.cls):
                callee = self.model.functions.get(qual)
                if callee is None or not callee.site_forward_params:
                    continue
                callee_params = [
                    p for p in callee.params if p not in ("self", "cls")
                ]
                binding: Dict[str, ast.AST] = {}
                for position, arg in enumerate(sub.args):
                    if position < len(callee_params):
                        binding[callee_params[position]] = arg
                for kw in sub.keywords:
                    if kw.arg is not None:
                        binding[kw.arg] = kw.value
                for p, directions in callee.site_forward_params.items():
                    arg = binding.get(p)
                    if isinstance(arg, ast.Name) and arg.id in params:
                        mark(arg.id, set(directions))

    def _collect_imports(self, mod: ModInfo) -> None:
        known = self.model.modules
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.name in known:
                        mod.mod_aliases[alias.asname or alias.name] = (
                            alias.name
                        )
            elif isinstance(node, ast.ImportFrom):
                source = node.module or ""
                source_parts = source.split(".")
                target = self._resolve_from(mod, node)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    orig = alias.name
                    # name-keyed role bindings work even when the source
                    # module lives outside the analyzed path set
                    if orig == "upload" and "ingest" in source_parts:
                        mod.upload_names.add(bound)
                    elif orig == "pull" and (
                        "ingest" in source_parts or "wire" in source_parts
                    ):
                        mod.pull_names.add(bound)
                    elif orig == "record_transfer":
                        mod.record_transfer_names.add(bound)
                    elif orig == "instrument_site":
                        mod.instrument_names.add(bound)
                    elif orig == "WritebackRing":
                        mod.ring_ctor_names.add(bound)
                    elif orig in (
                        "bucket_size", "pad_to", "entity_bucket",
                    ):
                        mod.bucket_fn_names[bound] = orig
                    elif orig == "ingest":
                        mod.ingest_mods.add(bound)
                    elif orig == "xprof":
                        mod.xprof_mods.add(bound)
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

    def _link_aliases(self) -> None:
        """Propagate role bindings through cross-module re-imports."""
        for _ in range(3):
            changed = False
            for mod in self.model.modules.values():
                for bound, (src, attr) in mod.from_funcs.items():
                    other = self.model.modules.get(src)
                    if other is None:
                        continue
                    for role in (
                        "upload_names", "pull_names",
                        "record_transfer_names", "instrument_names",
                        "ring_ctor_names",
                    ):
                        if attr in getattr(other, role) and bound not in (
                            getattr(mod, role)
                        ):
                            getattr(mod, role).add(bound)
                            changed = True
                    if attr in other.bucket_fn_names and bound not in (
                        mod.bucket_fn_names
                    ):
                        mod.bucket_fn_names[bound] = (
                            other.bucket_fn_names[attr]
                        )
                        changed = True
            if not changed:
                break

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
                        params=params,
                    )
                    info._node = child  # type: ignore[attr-defined]
                    mod.functions.append(info)
                    mod.def_index.setdefault(child.name, []).append(qual)
                    self.model.functions[qual] = info
                    for dec in child.decorator_list:
                        if self._is_jit_construction(mod, dec):
                            self.model.jit_defs[qual] = child.lineno
                    index(child, qual, cls)
                elif isinstance(child, ast.ClassDef):
                    index(child, f"{prefix}.{child.name}", child.name)
                else:
                    index(child, prefix, cls)

        index(mod.tree, mod.name, None)
        pseudo = FuncInfo(
            qual=f"{mod.name}.<module>", module=mod.name, path=mod.path,
            name="<module>", line=1,
        )
        pseudo._node = mod.tree  # type: ignore[attr-defined]
        mod.functions.append(pseudo)
        self.model.functions[pseudo.qual] = pseudo

    # --------------------------------------------- module-level bindings

    def _is_jit_construction(self, mod: ModInfo, node: ast.AST) -> bool:
        """Whether ``node`` builds a device-dispatch callable.

        Recognizes ``@xprof.instrument_site(name)`` decorators (the port's
        ``instrument_jit``), ``instrument_site(name)(fn)`` bindings, and
        ``functools.partial`` over either (the decorator-factory idiom).
        """
        if isinstance(node, ast.Name):
            return node.id in mod.instrument_names
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        terminal = _terminal_name(func)
        if isinstance(func, ast.Name) and func.id in mod.instrument_names:
            return True
        if terminal == "instrument_site":
            return True
        if isinstance(func, ast.Call):  # instrument_site(name)(fn)
            return self._is_jit_construction(mod, func)
        if terminal == "partial" and node.args:
            return self._is_jit_construction(mod, node.args[0])
        return False

    def _collect_module_bindings(self, mod: ModInfo) -> None:
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                # _cache: dict = {} (the whitelist table cache's spelling)
                stmt = ast.Assign(targets=[stmt.target], value=stmt.value,
                                  lineno=stmt.lineno)
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                if not isinstance(target, ast.Name):
                    continue
                if isinstance(
                    stmt.value, ast.Call
                ) and self._is_jit_construction(mod, stmt.value):
                    mod.jit_bindings[target.id] = stmt.lineno
                elif isinstance(stmt.value, ast.Dict):
                    mod.cache_dicts.add(target.id)

    def _collect_ring_attrs(self, mod: ModInfo) -> None:
        """``self.X = WritebackRing(...)`` anywhere in a class' methods."""
        for info in mod.functions:
            if info.cls is None:
                continue
            node = getattr(info, "_node", None)
            if node is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                value = sub.value
                if not (
                    isinstance(value, ast.Call)
                    and self._is_ring_ctor(mod, value)
                ):
                    continue
                for target in sub.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        mod.ring_attrs.setdefault(info.cls, set()).add(
                            target.attr
                        )

    def _is_ring_ctor(self, mod: ModInfo, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in mod.ring_ctor_names
        terminal = _terminal_name(func)
        if terminal != "WritebackRing":
            return False
        root, _ = _root_chain(func)
        return root in mod.ingest_mods or root in mod.mod_aliases

    def _collect_segment_constants(self, mod: ModInfo) -> None:
        """Read the pinned floors from ops/segments.py when modeled."""
        if not mod.name.endswith("segments"):
            return
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            value = _const_int(stmt.value)
            if value is None:
                continue
            for target in stmt.targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id == "RECORD_BUCKET_MIN":
                    self.model.record_bucket_min = value
                elif target.id == "ENTITY_BUCKET_MIN":
                    self.model.entity_bucket_min = value

    # --------------------------------------------- call classification

    def _transfer_kind(self, mod: ModInfo, call: ast.Call) -> Optional[str]:
        """upload | pull | collect | record_transfer for ledger calls."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in mod.upload_names:
                return "upload"
            if func.id in mod.pull_names:
                return "pull"
            if func.id in mod.record_transfer_names:
                return "record_transfer"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        root, chain = _root_chain(func)
        terminal = func.attr
        if terminal in ("upload", "pull") and root is not None:
            if root in mod.ingest_mods or mod.mod_aliases.get(
                root, ""
            ).endswith("ingest"):
                return terminal
            return None
        if terminal == "record_transfer" and root is not None:
            if root in mod.xprof_mods or mod.mod_aliases.get(
                root, ""
            ).endswith("xprof"):
                return "record_transfer"
            return None
        if terminal == "collect":
            # only a WritebackRing's drain: require a site argument so an
            # unrelated .collect() never inventories
            if _kw(call, "site") is not None or (
                len(call.args) >= 2 and _const_str(call.args[1]) is not None
            ):
                return "collect"
        return None

    def _site_of(self, call: ast.Call, kind: str) -> Tuple[Optional[ast.AST], Optional[str]]:
        """(site argument node, literal value) of a ledger call."""
        node: Optional[ast.AST] = _kw(call, "site")
        if node is None:
            position = _SITE_POSITION[kind]
            if len(call.args) > position:
                node = call.args[position]
        return node, _const_str(node)

    def _direction_of(self, call: ast.Call, kind: str) -> Optional[str]:
        if kind == "upload":
            return "h2d"
        if kind in ("pull", "collect"):
            return "d2h"
        direction = _const_str(
            call.args[0] if call.args else _kw(call, "direction")
        )
        return direction if direction in ("h2d", "d2h") else None

    # --------------------------------------------- SCX702(b) summaries

    def _summarize_uploads(self, mod: ModInfo, info: FuncInfo, node) -> None:
        """Which params feed an uncached upload inside this function.

        A forward pass over textual order: a local assigned from an
        expression whose names all sit inside the param-derived closure
        joins it. A ``.get``/subscript/``in`` read of a module-level
        cache dict before the upload marks the function cache-guarded
        (the sanctioned whitelist-table shape).
        """
        params = set(info.params) - {"self", "cls"}
        derived: Dict[str, Set[str]] = {p: {p} for p in params}
        cache_seen_line = None
        uploads: List[Tuple[Tuple[str, ...], int]] = []
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Call, ast.Compare, ast.Subscript)):
                if self._touches_cache(mod, sub):
                    line = sub.lineno
                    if cache_seen_line is None or line < cache_seen_line:
                        cache_seen_line = line
        for stmt in ast.walk(node):
            if isinstance(stmt, ast.Assign):
                names = {
                    n.id
                    for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Name)
                }
                if names and names <= set(derived):
                    feeding: Set[str] = set()
                    for n in names:
                        feeding |= derived[n]
                    for target in stmt.targets:
                        if isinstance(target, ast.Name):
                            derived[target.id] = feeding
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            if self._transfer_kind(mod, sub) != "upload":
                continue
            if not sub.args:
                continue
            operand_names = {
                n.id
                for n in ast.walk(sub.args[0])
                if isinstance(n, ast.Name)
            }
            if operand_names and not operand_names <= set(derived):
                continue  # depends on non-param state: not provably pure
            feeding = set()
            for n in operand_names:
                feeding |= derived.get(n, set())
            guarded = (
                cache_seen_line is not None
                and cache_seen_line <= sub.lineno
            )
            if guarded:
                info.cache_guarded = True
                continue
            uploads.append((tuple(sorted(feeding & params)), sub.lineno))
        info.pure_upload_params = uploads

    def _touches_cache(self, mod: ModInfo, node: ast.AST) -> bool:
        """A read of a module-level cache dict (``C.get``/``C[k]``/
        ``k in C``)."""
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "get"
                and isinstance(func.value, ast.Name)
                and func.value.id in mod.cache_dicts
            ):
                return True
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Name) and base.id in mod.cache_dicts:
                return True
        if isinstance(node, ast.Compare):
            for op, comparator in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)) and isinstance(
                    comparator, ast.Name
                ) and comparator.id in mod.cache_dicts:
                    return True
        return False

    # --------------------------------------------------- call resolution

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
            if root == "self" and len(chain) == 1:
                if cls is not None:
                    qual = f"{mod.name}.{cls}.{chain[0]}"
                    if qual in self.model.functions:
                        return (qual,)
                quals = tuple(
                    q
                    for q in mod.def_index.get(chain[0], ())
                    if self.model.functions[q].cls is not None
                )
                return quals
            if root in mod.mod_aliases:
                qual = ".".join([mod.mod_aliases[root]] + chain)
                if qual in self.model.functions:
                    return (qual,)
        return ()

    # ---------------------------------------------------- the rule scan

    def scan_all(self) -> None:
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None:
                    continue
                _FuncScan(self, mod, info, node).run()

    def finding(
        self, mod: ModInfo, rule: str, node: ast.AST, message: str
    ) -> None:
        if mod.exempt:
            return
        self.model.findings.append(
            Finding(
                rule=rule, path=mod.path, line=node.lineno,
                message=message, end_line=_end(node),
            )
        )


class _FuncScan:
    """Ordered, path-insensitive scan of one function body.

    Maintains the loop-context stack (assigned names + written attribute
    prefixes per loop) for the invariance checks, and the open
    WritebackRing windows for SCX703 — textual statement order, the same
    line the sibling passes draw.
    """

    def __init__(self, analyzer: _Analyzer, mod: ModInfo, info: FuncInfo,
                 node) -> None:
        self.a = analyzer
        self.mod = mod
        self.info = info
        self.node = node
        # each entry: {"assigned": set[str], "attrs": set[str]}
        self.loops: List[dict] = []
        # open overlap windows: dotted ring expr -> stage line
        self.windows: Dict[str, int] = {}

    def run(self) -> None:
        body = (
            self.node.body
            if not isinstance(self.node, ast.Module)
            else [
                s
                for s in self.node.body
                if not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                )
            ]
        )
        self._stmts(body)

    # ----------------------------------------------------- statements

    def _stmts(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            self._enter_loop(stmt, stmt.body, target=stmt.target)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._scan_expr(stmt.test)
            self._enter_loop(stmt, stmt.body, target=None)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.If):
            self._scan_expr(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._with_item(item)
            self._stmts(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for handler in stmt.handlers:
                self._stmts(handler.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
        elif isinstance(stmt, ast.Match):
            self._scan_expr(stmt.subject)
            for case in stmt.cases:
                self._stmts(case.body)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs scan as their own FuncInfo
        else:
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self._scan_expr(sub)

    def _with_item(self, item: ast.withitem) -> None:
        self._scan_expr(item.context_expr)

    # -------------------------------------------------------- loops

    def _enter_loop(self, stmt, body, target) -> None:
        assigned, attrs = self._body_writes(body)
        if target is not None:
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name):
                    assigned.add(sub.id)
        self.loops.append({"assigned": assigned, "attrs": attrs})
        try:
            self._stmts(body)
        finally:
            self.loops.pop()

    def _body_writes(self, body) -> Tuple[Set[str], Set[str]]:
        """Names and dotted attribute prefixes written in a loop body."""
        assigned: Set[str] = set()
        attrs: Set[str] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                targets: List[ast.AST] = []
                if isinstance(sub, ast.Assign):
                    targets = list(sub.targets)
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    targets = [sub.target]
                elif isinstance(sub, (ast.For, ast.AsyncFor)):
                    targets = [sub.target]
                elif isinstance(sub, ast.withitem) and (
                    sub.optional_vars is not None
                ):
                    targets = [sub.optional_vars]
                for target in targets:
                    for leaf in ast.walk(target):
                        if isinstance(leaf, ast.Name):
                            assigned.add(leaf.id)
                        elif isinstance(leaf, ast.Attribute):
                            dotted = _dotted(leaf)
                            if dotted:
                                attrs.add(dotted)
                if isinstance(sub, ast.Call):
                    # x = next(it) look-aheads assign via Assign; method
                    # calls that mutate their receiver in place are out of
                    # model (documented limit)
                    continue
        return assigned, attrs

    def _loop_invariant(self, expr: ast.AST) -> bool:
        """No name/attribute in ``expr`` is written by an enclosing loop."""
        if not self.loops:
            return False
        assigned: Set[str] = set()
        attrs: Set[str] = set()
        for ctx in self.loops:
            assigned |= ctx["assigned"]
            attrs |= ctx["attrs"]
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and sub.id in assigned:
                return False
            if isinstance(sub, ast.Attribute):
                dotted = _dotted(sub)
                if dotted is not None:
                    # written exactly, or a written prefix of it
                    parts = dotted.split(".")
                    for i in range(1, len(parts) + 1):
                        if ".".join(parts[:i]) in attrs:
                            return False
        return True

    # ------------------------------------------------------ expressions

    def _scan_expr(self, expr: ast.AST) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self._call_event(sub)

    # ----------------------------------------------------- call events

    def _call_event(self, call: ast.Call) -> None:
        mod = self.mod
        kind = self.a._transfer_kind(mod, call)
        if kind is not None:
            self._transfer_event(call, kind)
        terminal = _terminal_name(call.func)

        # SCX703 window bookkeeping + sync events
        if terminal == "stage" and self._ring_expr(call.func) is not None:
            self.windows[self._ring_expr(call.func)] = call.lineno
        elif terminal in ("collect", "close"):
            ring = self._ring_expr(call.func)
            if ring is not None:
                self.windows.pop(ring, None)
        if self.windows and isinstance(call.func, ast.Attribute):
            if terminal in _SYNC_NAMES:
                self._sync_event(call, f".{terminal}()")
            elif terminal == "numpy" and self._is_pulled(call.func.value):
                self._sync_event(call, "`.numpy()` of a pulled value")

        # forwarded transfer sites: calls into site-forwarding helpers
        if kind is None:
            self._forwarding_call_event(call)

        # SCX704: statically provable >= 2x pad waste at a bucket helper
        self._bucket_event(call)

        # SCX702: loop-invariant recompute
        if self.loops:
            self._recompute_event(call)

    def _ring_expr(self, func: ast.AST) -> Optional[str]:
        """Dotted base of ``<base>.stage/collect/close`` when base is a
        known WritebackRing (local ctor var or class ring attr)."""
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        dotted = _dotted(base)
        if dotted is None:
            return None
        root, chain = _root_chain(base)
        if root == "self" and len(chain) == 1 and self.info.cls is not None:
            if chain[0] in self.mod.ring_attrs.get(self.info.cls, ()):
                return dotted
            return None
        if root is not None and not chain:
            ring_locals = getattr(self, "_ring_locals", None)
            if ring_locals is None:
                # index local WritebackRing ctor assignments once
                ring_locals = set()
                for sub in ast.walk(self.node):
                    if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call
                    ) and self.a._is_ring_ctor(self.mod, sub.value):
                        for target in sub.targets:
                            if isinstance(target, ast.Name):
                                ring_locals.add(target.id)
                self._ring_locals = ring_locals
            return dotted if root in ring_locals else None
        return None

    def _is_pulled(self, expr: ast.AST) -> bool:
        """Whether ``expr`` is an ``ingest.pull`` handle: the call itself,
        or a local name bound from one (the ring's staged handle comes from
        ``stage()``, never from a pull)."""
        if isinstance(expr, ast.Call):
            return self.a._transfer_kind(self.mod, expr) == "pull"
        if not isinstance(expr, ast.Name):
            return False
        pulled = getattr(self, "_pulled_locals", None)
        if pulled is None:
            pulled = set()
            for sub in ast.walk(self.node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ) and self.a._transfer_kind(self.mod, sub.value) == "pull":
                    for target in sub.targets:
                        if isinstance(target, ast.Name):
                            pulled.add(target.id)
            self._pulled_locals = pulled
        return expr.id in pulled

    def _sync_event(self, node: ast.AST, what: str) -> None:
        staged_at = min(self.windows.values())
        self.a.finding(
            self.mod, "SCX703", node,
            f"{what} inside the writeback overlap window (ring staged at "
            f"line {staged_at}, not yet drained) — the sync serializes "
            "the D2H the stage() kick exists to overlap; move it after "
            "collect(), or before the stage",
        )

    # ------------------------------------------------------- transfers

    def _transfer_event(self, call: ast.Call, kind: str) -> None:
        mod = self.mod
        site_node, site = self.a._site_of(call, kind)
        direction = self.a._direction_of(call, kind)
        if site is not None and direction is not None:
            self.a.model.transfer_sites.append(
                TransferSite(
                    site=site, direction=direction, module=mod.name,
                    path=mod.path, line=call.lineno, kind=kind,
                )
            )
        # SCX705(i): a ledger call the static inventory cannot account.
        # ingest/ (exempt) legitimately forwards its callers' dynamic
        # `site` variables; a helper whose own PARAMETER is the site is a
        # forwarding door — its callers carry the literals (inventoried
        # there) and a caller passing a non-literal is where the finding
        # lands. Everywhere else the site is part of the witness
        # contract. Only the non-literal-site branch is excused:
        # record=False and loop-invariance below still apply to a
        # forwarding helper's own transfer.
        forwarded_param_site = (
            isinstance(site_node, ast.Name)
            and site_node.id in self.info.site_forward_params
            and site_node.id in self.info.params
        )
        if site is None and not mod.exempt and not forwarded_param_site:
            self.a.finding(
                mod, "SCX705", call,
                f"{kind}() with a non-literal transfer site: the static "
                "inventory (and the xprof-smoke witness built on it) "
                "cannot account this crossing — pass a string literal "
                "site=",
            )
        # SCX705(ii): record=False with no adjacent record_transfer
        if kind in ("upload", "pull", "collect"):
            record = _kw(call, "record")
            if (
                isinstance(record, ast.Constant)
                and record.value is False
                and not self._function_records_transfers()
            ):
                self.a.finding(
                    mod, "SCX705", call,
                    "record=False transfer with no record_transfer() in "
                    "the enclosing function: these bytes cross the "
                    "boundary but never reach the ledger — drop "
                    "record=False, or attach an explicit timed "
                    "record_transfer (the bench-probe shape)",
                )
        # SCX701: the transfer itself sits in a loop with an invariant
        # operand (record_transfer is accounting, not a crossing)
        if kind in ("upload", "pull", "collect") and self.loops and call.args:
            operand = call.args[0]
            if self._loop_invariant(operand):
                direction_word = (
                    "upload" if kind == "upload" else "pull"
                )
                self.a.finding(
                    mod, "SCX701", call,
                    f"loop-invariant {direction_word} inside a hot loop: "
                    "the same bytes cross the link every iteration — "
                    "hoist the transfer above the loop (or cache the "
                    "device value)",
                )

    def _forwarding_call_event(self, call: ast.Call) -> None:
        for qual in self.a._resolve_call(
            self.mod, call.func, self.info.cls
        ):
            callee = self.a.model.functions.get(qual)
            if callee is None or not callee.site_forward_params:
                continue
            callee_params = [
                p for p in callee.params if p not in ("self", "cls")
            ]
            binding: Dict[str, ast.AST] = {}
            for position, arg in enumerate(call.args):
                if position < len(callee_params):
                    binding[callee_params[position]] = arg
            for kw in call.keywords:
                if kw.arg is not None:
                    binding[kw.arg] = kw.value
            for p, directions in sorted(callee.site_forward_params.items()):
                arg = binding.get(p)
                if arg is None:
                    continue
                literal = _const_str(arg)
                if literal is not None:
                    for direction in sorted(directions):
                        self.a.model.transfer_sites.append(
                            TransferSite(
                                site=literal, direction=direction,
                                module=self.mod.name, path=self.mod.path,
                                line=call.lineno, kind="forwarded",
                            )
                        )
                    continue
                if isinstance(arg, ast.Name) and (
                    arg.id in self.info.site_forward_params
                ):
                    continue  # our own callers account it
                if not self.mod.exempt:
                    self.a.finding(
                        self.mod, "SCX705", call,
                        f"non-literal transfer site passed to "
                        f"{callee.name}(): the static inventory (and the "
                        "xprof-smoke witness) cannot account this "
                        "crossing — pass a string literal",
                    )
            return

    def _function_records_transfers(self) -> bool:
        cached = getattr(self, "_records_transfers", None)
        if cached is None:
            cached = any(
                isinstance(sub, ast.Call)
                and self.a._transfer_kind(self.mod, sub) == "record_transfer"
                for sub in ast.walk(self.node)
            )
            self._records_transfers = cached
        return cached

    # --------------------------------------------------------- buckets

    def _bucket_event(self, call: ast.Call) -> None:
        canonical = self._bucket_canonical(call.func)
        if canonical is None or not call.args:
            return
        n = _const_int(call.args[0])
        if n is None or n <= 0:
            return
        model = self.a.model
        if canonical == "bucket_size":
            floor = _const_int(_kw(call, "minimum"))
            if floor is None and len(call.args) > 1:
                floor = _const_int(call.args[1])
            if floor is None:
                floor = model.record_bucket_min
            padded = floor
            while padded < n:
                padded *= 2
        elif canonical == "entity_bucket":
            floor = model.entity_bucket_min
            padded = floor
            while padded < n:
                padded *= 2
            cap = None
            if len(call.args) > 1:
                cap = _const_int(call.args[1])
            if cap is not None:
                padded = min(padded, cap)
        else:  # pad_to
            multiple = None
            if len(call.args) > 1:
                multiple = _const_int(call.args[1])
            if multiple is None:
                multiple = _const_int(_kw(call, "multiple"))
            if multiple is None or multiple <= 0:
                return
            padded = ((n + multiple - 1) // multiple) * multiple
        if padded >= 2 * n:
            self.a.finding(
                self.mod, "SCX704", call,
                f"dispatch size {n} pads to {padded} at this bucket "
                f"vocabulary ({padded / n:.1f}x provable pad waste) — "
                "use a smaller floor (the autotuner can derive one: "
                "docs/performance.md) or the entity bucket vocabulary",
            )

    def _bucket_canonical(self, func: ast.AST) -> Optional[str]:
        if isinstance(func, ast.Name):
            return self.mod.bucket_fn_names.get(func.id)
        if isinstance(func, ast.Attribute) and func.attr in (
            "bucket_size", "pad_to", "entity_bucket",
        ):
            # `seg.bucket_size(...)` through a module alias
            root, _ = _root_chain(func)
            if root in self.mod.mod_aliases:
                return func.attr
        return None

    # ------------------------------------------------------- recompute

    def _recompute_event(self, call: ast.Call) -> None:
        mod = self.mod
        func = call.func
        all_args = list(call.args) + [
            kw.value for kw in call.keywords
        ]
        # (a) a jit-bound callable invoked with all-invariant args (a graph
        # replay's receiver counts as one of them)
        if self._is_graph_replay(func):
            all_args.append(func.value)
        if self._is_jit_callable(func) or self._is_graph_replay(func):
            if all(self._loop_invariant(arg) for arg in all_args):
                self.a.finding(
                    mod, "SCX702", call,
                    "device dispatch invoked in a loop with "
                    "loop-invariant arguments: the executable recomputes "
                    "an identical result every iteration — hoist the "
                    "call, or cache the result by content hash",
                )
                return
        # (b) a callee that uploads a pure function of its params, called
        # with invariant args feeding those params
        for qual in self.a._resolve_call(mod, func, self.info.cls):
            callee = self.a.model.functions.get(qual)
            if callee is None or not callee.pure_upload_params:
                continue
            callee_params = [
                p for p in callee.params if p not in ("self", "cls")
            ]
            binding: Dict[str, ast.AST] = {}
            for position, arg in enumerate(call.args):
                if position < len(callee_params):
                    binding[callee_params[position]] = arg
            for kw in call.keywords:
                if kw.arg is not None:
                    binding[kw.arg] = kw.value
            for feeding, upload_line in callee.pure_upload_params:
                bound = [binding[p] for p in feeding if p in binding]
                if len(bound) != len(feeding):
                    continue  # defaults/unbound: not provable
                if all(self._loop_invariant(arg) for arg in bound):
                    self.a.finding(
                        mod, "SCX702", call,
                        f"{callee.name}() re-uploads a content-stable "
                        f"value (upload at {os.path.basename(callee.path)}"
                        f":{upload_line}) every loop iteration — hoist "
                        "the call, or give the callee a content-hash "
                        "device cache (the whitelist-table pattern)",
                    )
                    return

    @staticmethod
    def _is_graph_replay(func: ast.AST) -> bool:
        """``<...graph>.replay()`` (a CUDA graph) or ``<...graphs>.run(...)``
        (a ``serve.graphs.GraphSet``)."""
        if not isinstance(func, ast.Attribute) or func.attr not in (
            "replay", "run",
        ):
            return False
        root, chain = _root_chain(func.value)
        last = chain[-1] if chain else root
        if last is None:
            return False
        last = last.lower()
        if func.attr == "replay":
            return last.endswith("graph")
        return last.endswith("graphs") or last == "graph_set"

    def _is_jit_callable(self, func: ast.AST) -> bool:
        mod = self.mod
        if _terminal_name(func) in _KERNEL_WRAPPERS:
            root, _ = _root_chain(func)
            if isinstance(func, ast.Name):
                bound = mod.from_funcs.get(func.id)
                if bound is not None and bound[0].endswith("whitelist"):
                    return True
            elif root in mod.mod_aliases and mod.mod_aliases[root].endswith(
                "whitelist"
            ):
                return True
            elif root in mod.from_funcs and mod.from_funcs[root][1] == (
                "whitelist"
            ):
                return True
        if isinstance(func, ast.Name):
            if func.id in mod.jit_bindings:
                return True
            bound = mod.from_funcs.get(func.id)
            if bound is not None:
                other = self.a.model.modules.get(bound[0])
                if other is not None and bound[1] in other.jit_bindings:
                    return True
                qual = f"{bound[0]}.{bound[1]}"
                if qual in self.a.model.jit_defs:
                    return True
            for qual in self.a._resolve_call(mod, func, self.info.cls):
                if qual in self.a.model.jit_defs:
                    return True
            return False
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if root in mod.mod_aliases and chain:
                other = self.a.model.modules.get(mod.mod_aliases[root])
                if other is not None and chain[-1] in other.jit_bindings:
                    return True
                qual = ".".join([mod.mod_aliases[root]] + chain)
                if qual in self.a.model.jit_defs:
                    return True
        return False


# ------------------------------------------------------------- public API


def build_model(paths: Sequence[str]) -> CostModel:
    """Parse + analyze every ``.py`` under ``paths`` into one CostModel."""
    analyzer = _Analyzer()
    analyzer.load(collect_py_files(paths, COST_MECHANISM_DIRS))
    for mod in analyzer.model.modules.values():
        # ownership is the IMMEDIATE parent directory, the SCX112 line
        parent = os.path.basename(os.path.dirname(os.path.abspath(mod.path)))
        if parent in COST_OWNER_DIRS or (
            parent, os.path.basename(mod.path)
        ) in COST_OWNER_FILES:
            mod.exempt = True
    analyzer.scan_all()
    return analyzer.model


def check_cost(paths: Sequence[str]) -> List[Finding]:
    """Run the SCX7xx pass; returns suppression-filtered findings."""
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


def transfer_inventory(
    paths: Sequence[str], model: Optional[CostModel] = None
) -> Dict[str, Any]:
    """The statically-enumerated transfer-site universe.

    The runtime-witness contract, mirroring ``--emit-lock-graph`` /
    the other emitters: every ``site="..."`` literal at an
    upload/pull/collect/``record_transfer`` call, with its direction and
    code location(s). ``chip_smoke.py``'s discipline phase asserts a live
    run's observed ledger site set is a subset of this inventory with
    matching directions (:func:`check_transfer_sites`).
    """
    if model is None:
        model = build_model(paths)
    sites: Dict[str, Dict[str, Any]] = {}
    for ts in model.transfer_sites:
        entry = sites.setdefault(
            ts.site, {"directions": set(), "occurrences": []}
        )
        entry["directions"].add(ts.direction)
        entry["occurrences"].append(
            {
                "module": ts.module, "path": ts.path, "line": ts.line,
                "kind": ts.kind, "direction": ts.direction,
            }
        )
    return {
        "version": 1,
        "sites": {
            name: {
                "directions": sorted(entry["directions"]),
                "occurrences": sorted(
                    entry["occurrences"],
                    key=lambda o: (o["path"], o["line"]),
                ),
            }
            for name, entry in sorted(sites.items())
        },
    }


def check_transfer_sites(
    inventory: Dict[str, Any], ledger: Dict[str, Any]
) -> List[str]:
    """Violations of observed-ledger-sites ⊆ static inventory.

    ``ledger`` is the merged registry/report ledger
    (``{direction: {"by_site": {site: {...}}}}``). A site the ledger saw
    that the static inventory does not carry is a phantom — a transfer
    path the model missed (or a dynamic site SCX705 should have caught);
    a direction mismatch means the model mislabeled a crossing.
    """
    sites = inventory.get("sites") or {}
    violations: List[str] = []
    for direction, total in (ledger or {}).items():
        if direction not in ("h2d", "d2h"):
            continue
        for site in sorted((total or {}).get("by_site") or {}):
            entry = sites.get(site)
            if entry is None:
                violations.append(
                    f"{site}: observed in the {direction} ledger but "
                    "absent from the static transfer inventory (phantom "
                    "site — unmodeled transfer path)"
                )
            elif direction not in (entry.get("directions") or []):
                violations.append(
                    f"{site}: observed direction {direction} but the "
                    f"static inventory models {entry.get('directions')}"
                )
    return violations
