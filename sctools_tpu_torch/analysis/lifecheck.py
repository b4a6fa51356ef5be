"""Static frame-lifetime & aliasing analysis (SCX601-SCX605) of the port.

The port's counterpart of ``sctools_tpu.analysis.lifecheck``. The port's
ingest ring (``ingest.ring_frames``) hands consumers *views* into
recycled arena slots; it is fast because nothing is copied and sound only
while each consumer keeps to the ring's retention window. This pass
checks that over a whole-package model, sharing one parse per file with
the race pass (:mod:`.astcache`). The model holds:

1. every zero-copy **frame source** — calls whose terminal name is
   ``ring_frames`` (``ingest.ring_frames(...)``, either package's
   spelling, and the frame-iterable parameters they flow into along the
   call graph), ``ColumnArena`` constructions, arena ``.frame()`` /
   ``.column()`` views, ``np.frombuffer`` views of arena buffers;
2. the **copy discipline** vocabulary — ``copy_frame`` / ``np.copy`` /
   ``np.array`` / ``.copy()`` / ``.clone()`` launder an alias into owned
   memory; ``slice_frame`` / ``compact_frame`` / ``concat_frames``
   preserve it (``concat`` returns one side unchanged when the other is
   empty);
3. per-function **escape summaries** — parameters a function stores into
   an attribute, global, or module-level container (fixpoint along the
   call graph, so a frame passed to a helper that retains it is an
   escape at the call site);
4. the **donation inventory** — every ``instrument_jit``/``jax.jit``
   site carrying ``donate_argnums``/``donate_argnames``. PyTorch has no
   donation, so on the port's own tree this inventory is empty; the rule
   stays so that the two packages' passes agree on every input.

Rules:

- **SCX601 frame-escape** — inside a consumer loop over a frame source,
  a ring/arena frame (or a view derived from its columns) is stored into
  an attribute, global, closure, or container that outlives the loop
  iteration, or passed to a callee that does so, without an intervening
  ``copy_frame``/``np.copy``. The next slot refill rewrites the stored
  arrays in place.
- **SCX602 retention-overflow** — a consumer loop whose live-frame count
  can exceed the ring's 2-frame retention window (``ring.ring_slots``
  reserves two slots for the consumer): each look-ahead ``next()`` pull
  and each *uncopied* cross-iteration carry holds one more slot than the
  budget planned for.
- **SCX603 mutate-under-async-upload** — ``pad_in_place``/``fill`` or a
  column write on an arena slot after an ``ingest.upload`` of values
  from the same slot, with no completion barrier (``synchronize``, the
  JAX package's ``block_until_ready``) in between.
- **SCX604 use-after-donation** — an array passed at a donated position
  of a ``donate_argnums``/``donate_argnames`` jit site and then read on
  any path after the call.
- **SCX605 view-across-refill** — an ``np.frombuffer``/``.column()``
  view of an arena captured before a ``pad_in_place``/``fill`` of that
  arena and read after it: the read sees post-mutation bytes, not the
  values the view was captured for.

The runtime half is the port's frame generation witness,
:mod:`sctools_tpu_torch.ingest.framedebug` (``SCTOOLS_TPU_FRAME_DEBUG=1``):
a read of a frame whose arena slot was recycled since it was handed out
raises ``StaleFrameError``.

Model limits (deliberate, documented): call resolution is name-based
(like the race pass); statement order approximates control flow
(path-insensitive, textual order within a body); an alias returned from
an *unresolved* call is treated as laundered — the pass models the
package's own helpers, not arbitrary code; and the ``analysis``/
``ingest`` directories are exempt — the first is the mechanism, the
second is the owner of the buffer lifecycle itself (its internal
invariants are pinned by tests and the generation witness). Ownership is
the file's immediate parent directory.

Pure stdlib; imports nothing under analysis except the shared cache;
honors ``# scx-lint: disable=SCX6xx`` escapes.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .astcache import collect_py_files, parse_cached
from .findings import Finding, Suppressions

LIFE_RULES = {
    "SCX601": "frame-escape",
    "SCX602": "retention-overflow",
    "SCX603": "mutate-under-async-upload",
    "SCX604": "use-after-donation",
    "SCX605": "view-across-refill",
}

# analysis/ is the mechanism and is pruned from the walk entirely;
# ingest/ is the lifecycle OWNER (arena slot recycling, the ring's slot
# budget, the generation witness live there — its own view handling is
# the contract, not a violation) and is modeled but never reported.
# Ownership is the file's IMMEDIATE parent directory, the SCX112 line.
LIFE_MECHANISM_DIRS = ("analysis",)
LIFE_OWNER_DIRS = ("ingest",)

# the ring's consumer headroom: ring.ring_slots = depth + 1 filling +
# _CONSUMER_SLOTS held. A loop holding more live frames than this eats
# into the decode-ahead budget and, past it, reads recycled memory.
RETENTION_WINDOW = 2

# alias-laundering calls: the result owns its memory
_COPY_NAMES = frozenset(("copy_frame", "copy", "array", "ascontiguousarray"))
# tensor copies: x.clone() owns its memory as x.copy() does
_METHOD_COPY_NAMES = frozenset(("copy", "clone"))
# view-preserving frame derivations (io.packed): the result aliases input
_VIEW_NAMES = frozenset(("slice_frame", "compact_frame", "concat_frames"))
# arena mutators: a slot recycle / in-place rewrite event
_ARENA_MUTATORS = frozenset(("pad_in_place", "fill", "reclaim"))
# completion barriers for the async upload hazard: torch.cuda.synchronize(),
# an event's or a stream's synchronize(), and the JAX spelling
_BARRIER_NAMES = frozenset(("synchronize", "block_until_ready"))
# container-growing method calls that retain their argument
_RETAINING_METHODS = frozenset(
    ("append", "extend", "add", "insert", "appendleft", "setdefault", "put")
)


# ------------------------------------------------------------- records


@dataclass
class DonationSite:
    """One jit construction carrying donate_argnums/donate_argnames."""

    module: str
    line: int
    name: str  # site label for messages (fn or binding name)
    argnums: Tuple[int, ...] = ()
    argnames: Tuple[str, ...] = ()


@dataclass
class FuncInfo:
    qual: str
    module: str
    path: str
    name: str
    line: int
    cls: Optional[str] = None
    params: Tuple[str, ...] = ()
    calls: List[Tuple[Tuple[str, ...], Optional[str]]] = field(
        default_factory=list
    )
    # params that receive a frame-source ITERABLE from some caller
    frame_iter_params: Set[str] = field(default_factory=set)
    _yields: Optional[bool] = None

    @property
    def generator(self) -> bool:
        """Whether its own body yields (computed on first use)."""
        if self._yields is None:
            self._yields = _yields(self._node)  # type: ignore[attr-defined]
        return self._yields
    # param name -> human description of where it escapes (attr/global)
    escaping_params: Dict[str, str] = field(default_factory=dict)


@dataclass
class ModInfo:
    name: str
    path: str
    is_pkg: bool
    tree: ast.Module
    exempt: bool = False  # modeled but never reported (owner dirs)
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    from_funcs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    np_aliases: Set[str] = field(default_factory=set)
    jax_aliases: Set[str] = field(default_factory=set)
    ingest_mods: Set[str] = field(default_factory=set)
    ring_names: Set[str] = field(default_factory=set)  # ring_frames
    upload_names: Set[str] = field(default_factory=set)  # ingest.upload
    copy_frame_names: Set[str] = field(default_factory=set)
    view_fn_names: Set[str] = field(default_factory=set)
    arena_ctor_names: Set[str] = field(default_factory=set)  # ColumnArena
    instrument_names: Set[str] = field(default_factory=set)
    # module-level donating bindings: name -> DonationSite
    donating_bindings: Dict[str, DonationSite] = field(default_factory=dict)
    def_index: Dict[str, List[str]] = field(default_factory=dict)
    functions: List[FuncInfo] = field(default_factory=list)


class LifeModel:
    """The whole-package frame-lifetime model."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        # function quals whose donated defs: qual -> DonationSite
        self.donating_defs: Dict[str, DonationSite] = {}
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


def _yields(func: ast.AST) -> bool:
    """Whether ``func``'s own body (nested scopes pruned) yields."""
    todo = list(ast.iter_child_nodes(func))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return True
        if not isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
        ):
            todo.extend(ast.iter_child_nodes(node))
    return False


def _int_tuple(node: Optional[ast.AST]) -> Tuple[int, ...]:
    if node is None:
        return ()
    elts = (
        node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    )
    out = []
    for elt in elts:
        if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
            out.append(int(elt.value))
    return tuple(out)


def _str_tuple(node: Optional[ast.AST]) -> Tuple[str, ...]:
    if node is None:
        return ()
    elts = (
        node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    )
    return tuple(
        str(elt.value)
        for elt in elts
        if isinstance(elt, ast.Constant) and isinstance(elt.value, str)
    )


# ------------------------------------------------------- value lattice

# a variable's tracked state. Provenance strings keep messages concrete.
_CLEAN = "clean"
_FRAME = "frame"  # a zero-copy ring/arena frame (or view-derived frame)
_FRAME_ITER = "frame_iter"  # the ring_frames(...) iterable / its iter()
_ARENA = "arena"
_ARENA_VIEW = "arena_view"
_DONATED = "donated"


@dataclass
class Val:
    kind: str = _CLEAN
    root: Optional[str] = None  # arena var for views; source for frames
    epoch: int = 0  # arena refill epoch at capture (SCX605)
    origin: int = 0  # line of the defining event (messages)
    reported: bool = False

    def aliases_frame(self) -> bool:
        return self.kind == _FRAME


# ------------------------------------------------------------ the build


class _Analyzer:
    def __init__(self) -> None:
        self.model = LifeModel()

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
        self._link_aliases()
        for mod in self.model.modules.values():
            self._collect_donations(mod)

    def _collect_imports(self, mod: ModInfo) -> None:
        known = self.model.modules
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.name == "numpy":
                        mod.np_aliases.add(bound)
                    elif alias.name == "jax":
                        mod.jax_aliases.add(bound)
                    elif alias.name in known:
                        mod.mod_aliases[alias.asname or alias.name] = (
                            alias.name
                        )
            elif isinstance(node, ast.ImportFrom):
                source = node.module or ""
                target = self._resolve_from(mod, node)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    orig = alias.name
                    # name-keyed role bindings work even when the source
                    # module lives outside the analyzed path set (fixtures
                    # import the library by its installed name)
                    if orig == "ring_frames":
                        mod.ring_names.add(bound)
                    elif orig == "upload" and "ingest" in source.split("."):
                        mod.upload_names.add(bound)
                    elif orig == "copy_frame":
                        mod.copy_frame_names.add(bound)
                    elif orig in _VIEW_NAMES:
                        mod.view_fn_names.add(bound)
                    elif orig == "ColumnArena":
                        mod.arena_ctor_names.add(bound)
                    elif orig == "instrument_jit":
                        mod.instrument_names.add(bound)
                    elif orig == "ingest":
                        mod.ingest_mods.add(bound)
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
                        "ring_names", "upload_names", "copy_frame_names",
                        "view_fn_names", "arena_ctor_names",
                        "instrument_names",
                    ):
                        if attr in getattr(other, role) and bound not in (
                            getattr(mod, role)
                        ):
                            getattr(mod, role).add(bound)
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

    # ----------------------------------------------- donation inventory

    def _donation_from_call(
        self, mod: ModInfo, call: ast.Call, label: str
    ) -> Optional[DonationSite]:
        """A DonationSite when ``call`` constructs a donating jit.

        Recognizes ``instrument_jit(..., donate_*)``, ``jax.jit(...,
        donate_*)``, and ``functools.partial(instrument_jit, ...,
        donate_*)`` (the decorator idiom).
        """
        func = call.func
        terminal = _terminal_name(func)
        is_jitter = False
        if isinstance(func, ast.Name) and func.id in mod.instrument_names:
            is_jitter = True
        elif terminal in ("jit", "instrument_jit"):
            root, _ = _root_chain(func)
            if root in mod.jax_aliases or terminal == "instrument_jit":
                is_jitter = True
        elif terminal == "partial" and call.args:
            inner = call.args[0]
            if (
                isinstance(inner, ast.Name)
                and inner.id in mod.instrument_names
            ) or _terminal_name(inner) in ("jit", "instrument_jit"):
                is_jitter = True
        if not is_jitter:
            return None
        argnums = _int_tuple(_kw(call, "donate_argnums"))
        argnames = _str_tuple(_kw(call, "donate_argnames"))
        if not argnums and not argnames:
            return None
        name_kw = _kw(call, "name")
        if isinstance(name_kw, ast.Constant) and isinstance(
            name_kw.value, str
        ):
            label = name_kw.value
        return DonationSite(
            module=mod.name, line=call.lineno, name=label,
            argnums=argnums, argnames=argnames,
        )

    def _collect_donations(self, mod: ModInfo) -> None:
        # decorated defs: calls to the def donate per the decorator
        for info in mod.functions:
            node = getattr(info, "_node", None)
            if node is None or isinstance(node, ast.Module):
                continue
            for dec in getattr(node, "decorator_list", ()):
                if not isinstance(dec, ast.Call):
                    continue
                site = self._donation_from_call(mod, dec, info.name)
                if site is not None:
                    self.model.donating_defs[info.qual] = site
        # module-level bindings: J = instrument_jit(fn, donate_argnums=..)
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            if not isinstance(stmt.value, ast.Call):
                continue
            for target in stmt.targets:
                if not isinstance(target, ast.Name):
                    continue
                site = self._donation_from_call(
                    mod, stmt.value, target.id
                )
                if site is not None:
                    mod.donating_bindings[target.id] = site

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
                # inheritance split: fall back to any same-module method
                # of that name (subclasses split across class bodies)
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

    # ------------------------------------------- escape summaries (B1)

    def compute_escapes(self) -> None:
        """Which params each function stores into attr/global containers.

        Fixpoint along the call graph: a param also escapes when passed
        (still aliasing) to a callee param that escapes. Bounded rounds
        cover the package's call depth with margin.
        """
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is None or isinstance(node, ast.Module):
                    continue
                self._direct_escapes(mod, info, node)
        for _ in range(5):
            changed = False
            for mod in self.model.modules.values():
                for info in mod.functions:
                    node = getattr(info, "_node", None)
                    if node is None or isinstance(node, ast.Module):
                        continue
                    if self._transitive_escapes(mod, info, node):
                        changed = True
            if not changed:
                break

    def _direct_escapes(self, mod: ModInfo, info: FuncInfo, node) -> None:
        params = set(info.params) - {"self", "cls"}
        if not params:
            return
        globals_declared: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Global, ast.Nonlocal)):
                globals_declared.update(sub.names)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                value_names = {
                    n.id
                    for n in ast.walk(sub.value)
                    if isinstance(n, ast.Name)
                } & params
                if not value_names:
                    continue
                # direct aliasing only: f(p) results are laundered
                if isinstance(sub.value, ast.Call):
                    continue
                for target in sub.targets:
                    if isinstance(target, ast.Attribute):
                        for p in value_names:
                            info.escaping_params.setdefault(
                                p,
                                f"stored into attribute at line "
                                f"{sub.lineno}",
                            )
                    elif isinstance(target, ast.Name) and (
                        target.id in globals_declared
                    ):
                        for p in value_names:
                            info.escaping_params.setdefault(
                                p,
                                f"stored into global {target.id!r} at "
                                f"line {sub.lineno}",
                            )
            elif isinstance(sub, ast.Call):
                func = sub.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _RETAINING_METHODS
                    and isinstance(func.value, ast.Attribute)
                ):
                    # self.pending.append(p): retained beyond the call
                    for arg in sub.args:
                        if isinstance(arg, ast.Name) and arg.id in params:
                            info.escaping_params.setdefault(
                                arg.id,
                                f"retained via "
                                f"{_terminal_name(func.value)}."
                                f"{func.attr}() at line {sub.lineno}",
                            )

    def _transitive_escapes(self, mod: ModInfo, info: FuncInfo, node) -> bool:
        params = set(info.params) - {"self", "cls"}
        if not params:
            return False
        changed = False
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            targets = self._resolve_call(mod, sub.func, info.cls)
            if not targets:
                continue
            for qual in targets:
                callee = self.model.functions.get(qual)
                if callee is None or not callee.escaping_params:
                    continue
                callee_params = [
                    p for p in callee.params if p not in ("self", "cls")
                ]
                for position, arg in enumerate(sub.args):
                    if (
                        isinstance(arg, ast.Name)
                        and arg.id in params
                        and position < len(callee_params)
                        and callee_params[position] in (
                            callee.escaping_params
                        )
                    ):
                        if arg.id not in info.escaping_params:
                            info.escaping_params[arg.id] = (
                                f"passed to {callee.name}() which "
                                f"{callee.escaping_params[callee_params[position]]}"
                            )
                            changed = True
                for kw in sub.keywords:
                    if (
                        kw.arg in callee.escaping_params
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id in params
                        and kw.value.id not in info.escaping_params
                    ):
                        info.escaping_params[kw.value.id] = (
                            f"passed to {callee.name}() which "
                            f"{callee.escaping_params[kw.arg]}"
                        )
                        changed = True
        return changed

    # --------------------------------------- frame-iterable taint (B2)

    def propagate_frame_iters(self) -> None:
        """Mark callee params that receive ring_frames() iterables.

        The gatherer pattern: ``frames = ingest.ring_frames(...)`` is
        consumed by ``self._stream_device_batches(self._timed(frames),
        out)`` — the consumer loop lives in the callee, behind a
        pass-through generator, so frame-source-ness must follow the
        argument through both.
        """
        # each function's assignments and calls, walked once for all rounds
        nodes = {}
        for mod in self.model.modules.values():
            for info in mod.functions:
                node = getattr(info, "_node", None)
                if node is not None:
                    assigns, calls = nodes[info.qual] = ([], [])
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Assign):
                            assigns.append(sub)
                        elif isinstance(sub, ast.Call):
                            calls.append(sub)
        worklist = True
        rounds = 0
        while worklist and rounds < 6:
            worklist = False
            rounds += 1
            for mod in self.model.modules.values():
                for info in mod.functions:
                    if info.qual in nodes and self._spread_iters_from(
                        mod, info, *nodes[info.qual]
                    ):
                        worklist = True

    def _spread_iters_from(
        self, mod: ModInfo, info: FuncInfo, assigns, calls
    ) -> bool:
        # local vars holding a frame iterable in this function: a frame
        # source's result, or a pass-through generator's over one (a
        # fixpoint: ``it = timed(frames)`` after ``frames = ring_frames()``)
        iter_vars: Set[str] = set(info.frame_iter_params)

        def is_iter(arg: ast.AST) -> bool:
            if isinstance(arg, ast.Name):
                return arg.id in iter_vars
            return isinstance(arg, ast.Call) and self._is_frame_iter_call(
                mod, info.cls, arg, is_iter
            )

        grew = True
        while grew:
            grew = False
            for sub in assigns:
                if is_iter(sub.value):
                    for target in sub.targets:
                        if (
                            isinstance(target, ast.Name)
                            and target.id not in iter_vars
                        ):
                            iter_vars.add(target.id)
                            grew = True
        changed = False
        for sub in calls:
            positions = [i for i, a in enumerate(sub.args) if is_iter(a)]
            if not positions:
                continue
            for qual in self._resolve_call(mod, sub.func, info.cls):
                callee = self.model.functions.get(qual)
                if callee is None:
                    continue
                callee_params = [
                    p for p in callee.params if p not in ("self", "cls")
                ]
                for position in positions:
                    if position < len(callee_params):
                        p = callee_params[position]
                        if p not in callee.frame_iter_params:
                            callee.frame_iter_params.add(p)
                            changed = True
        return changed

    def _is_frame_iter_call(
        self, mod: ModInfo, cls: Optional[str], call: ast.Call, is_iter
    ) -> bool:
        """A frame source, or a call of one of the package's generators
        with a frame iterable among its arguments (``is_iter``): such a
        generator hands its input's frames on, as the port's timing
        wrappers do (``MetricGatherer._timed``), and is modeled as a
        source of the same frames."""
        if self._is_ring_frames_call(mod, call):
            return True
        if not any(is_iter(arg) for arg in call.args):
            return False
        return any(
            self.model.functions[qual].generator
            for qual in self._resolve_call(mod, call.func, cls)
        )

    def _is_ring_frames_call(self, mod: ModInfo, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in mod.ring_names
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if chain and chain[-1] == "ring_frames":
                return root in mod.ingest_mods or root in mod.mod_aliases
        return False

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

    Maintains a variable->Val scope, the async-upload pending set, and
    per-arena refill epochs, visiting statements in source order (branch
    bodies sequentially — over-approximate but deterministic, the same
    line the sibling passes draw).
    """

    def __init__(self, analyzer: _Analyzer, mod: ModInfo, info: FuncInfo,
                 node) -> None:
        self.a = analyzer
        self.mod = mod
        self.info = info
        self.node = node
        self.scope: Dict[str, Val] = {}
        self.arena_epochs: Dict[str, int] = {}
        self.pending_uploads: Dict[str, int] = {}  # arena root -> line
        # consumer-loop context stack: (loop node, loop-local names,
        # pull vars, cross-iteration alias vars)
        self.loops: List[dict] = []

    def run(self) -> None:
        for p in self.info.frame_iter_params:
            self.scope[p] = Val(_FRAME_ITER, origin=self.info.line)
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
        if isinstance(stmt, ast.Assign):
            self._reads(stmt.value)
            val = self._value_of(stmt.value)
            for target in stmt.targets:
                self._assign(target, val, stmt)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._reads(stmt.value)
                self._assign(stmt.target, self._value_of(stmt.value), stmt)
        elif isinstance(stmt, ast.AugAssign):
            self._reads(stmt.value)
            self._reads(stmt.target)
        elif isinstance(stmt, ast.Expr):
            self._reads(stmt.value)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._reads(stmt.value)
        elif isinstance(stmt, ast.For):
            self._for(stmt)
        elif isinstance(stmt, ast.While):
            self._while(stmt)
        elif isinstance(stmt, ast.If):
            self._reads(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._reads(item.context_expr)
            self._stmts(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for handler in stmt.handlers:
                self._stmts(handler.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
        elif isinstance(stmt, ast.Match):
            self._reads(stmt.subject)
            for case in stmt.cases:
                self._stmts(case.body)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: closure-escape check inside a consumer loop
            self._closure_check(stmt)
        elif isinstance(stmt, (ast.Delete, ast.Raise, ast.Assert)):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.expr):
                    self._reads(sub)
                    break

    # ---------------------------------------------------- assignments

    def _assign(self, target: ast.AST, val: Val, stmt: ast.stmt) -> None:
        if isinstance(target, ast.Name):
            # Name targets are function-local; an alias parked in one is
            # the cross-iteration accounting's job (SCX602), not an escape
            self.scope[target.id] = val
            return
        if isinstance(target, ast.Attribute):
            if val.kind in (_FRAME, _ARENA_VIEW) and self._in_consumer_loop():
                self.a.finding(
                    self.mod, "SCX601", stmt,
                    "zero-copy frame/view stored into attribute "
                    f"'{ast.unparse(target) if hasattr(ast, 'unparse') else target.attr}'"
                    " — it outlives the loop iteration and the next slot "
                    "refill rewrites it; copy_frame()/np.copy() first",
                )
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            # container[key] = alias where the container outlives the
            # iteration (not created inside the loop body)
            if val.kind in (_FRAME, _ARENA_VIEW) and self._in_consumer_loop():
                if not self._is_loop_local(base):
                    self.a.finding(
                        self.mod, "SCX601", stmt,
                        "zero-copy frame/view stored into a container "
                        "that outlives the loop iteration; "
                        "copy_frame()/np.copy() first",
                    )
            # view[...] = x is a mutation of the view's arena (SCX603)
            if isinstance(base, ast.Name):
                view = self.scope.get(base.id)
                if view is not None and view.kind == _ARENA_VIEW:
                    self._arena_mutation(view.root, stmt, base.id)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                # upload() returns (device_value, nbytes): the device
                # value is NOT a host alias — tuple unpack is laundering
                self._assign(elt, Val(), stmt)

    def _is_loop_local(self, base: ast.AST) -> bool:
        if not self.loops:
            return True
        if isinstance(base, ast.Name):
            return base.id in self.loops[-1]["locals"]
        return False  # attributes/nested containers outlive the loop

    def _in_consumer_loop(self) -> bool:
        return bool(self.loops)

    # -------------------------------------------------------- values

    def _value_of(self, expr: ast.AST) -> Val:
        """The tracked Val an assignment's RHS produces."""
        if isinstance(expr, ast.Name):
            return self.scope.get(expr.id, Val())
        if isinstance(expr, ast.Call):
            return self._call_value(expr)
        if isinstance(expr, ast.Attribute):
            # frame.cell — a column view of the frame's arena slot
            base = expr.value
            if isinstance(base, ast.Name):
                val = self.scope.get(base.id)
                if val is not None and val.kind == _FRAME:
                    return Val(
                        _FRAME, root=val.root, origin=expr.lineno
                    )
            return Val()
        if isinstance(expr, ast.Subscript):
            base = expr.value
            if isinstance(base, ast.Name):
                val = self.scope.get(base.id)
                if val is not None and val.kind in (_FRAME, _ARENA_VIEW):
                    # slicing a view is still a view of the same buffer
                    return Val(
                        val.kind, root=val.root, epoch=val.epoch,
                        origin=expr.lineno,
                    )
            return Val()
        if isinstance(expr, ast.IfExp):
            body = self._value_of(expr.body)
            if body.kind != _CLEAN:
                return body
            return self._value_of(expr.orelse)
        if isinstance(expr, (ast.Dict, ast.List, ast.Tuple, ast.Set)):
            # a container literal holding an alias IS an alias (the
            # upload column-dict pattern: cols = {"cell": a.column(...)})
            children = (
                list(expr.keys or []) + list(expr.values)
                if isinstance(expr, ast.Dict)
                else list(expr.elts)
            )
            for child in children:
                if child is None:
                    continue
                val = self._value_of(child)
                if val.kind in (_FRAME, _ARENA, _ARENA_VIEW):
                    return Val(
                        val.kind if val.kind != _ARENA else _ARENA_VIEW,
                        root=val.root
                        if val.root is not None
                        else (
                            child.id if isinstance(child, ast.Name) else None
                        ),
                        epoch=val.epoch,
                        origin=expr.lineno,
                    )
        return Val()

    def _call_value(self, call: ast.Call) -> Val:
        mod = self.mod
        func = call.func
        terminal = _terminal_name(func)

        # laundering copies
        if terminal in mod.copy_frame_names or terminal == "copy_frame":
            return Val()
        if terminal in _COPY_NAMES | _METHOD_COPY_NAMES and isinstance(
            func, ast.Attribute
        ):
            root, _ = _root_chain(func)
            if root in mod.np_aliases:
                return Val()  # np.copy/np.array/...
            if terminal in _METHOD_COPY_NAMES:
                return Val()  # x.copy(), x.clone()
        # view-preserving frame derivations keep the strongest arg alias
        if terminal in mod.view_fn_names or terminal in _VIEW_NAMES:
            for arg in call.args:
                val = self._value_of(arg)
                if val.kind in (_FRAME, _ARENA_VIEW):
                    return Val(
                        val.kind, root=val.root, epoch=val.epoch,
                        origin=call.lineno,
                    )
            return Val()
        # frame sources
        if self.a._is_frame_iter_call(
            mod, self.info.cls, call,
            lambda arg: self._value_of(arg).kind == _FRAME_ITER,
        ):
            return Val(_FRAME_ITER, origin=call.lineno)
        if terminal == "iter" and len(call.args) == 1:
            inner = self._value_of(call.args[0])
            if inner.kind == _FRAME_ITER:
                return Val(_FRAME_ITER, root=inner.root,
                           origin=call.lineno)
            return Val()
        if terminal == "next" and call.args:
            inner = self._value_of(call.args[0])
            if inner.kind == _FRAME_ITER:
                self._register_pull(call)
                return Val(_FRAME, origin=call.lineno)
            return Val()
        # arena constructions and views
        if isinstance(func, ast.Name) and func.id in mod.arena_ctor_names:
            return Val(_ARENA, origin=call.lineno)
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            base_val = self.scope.get(root or "")
            if base_val is not None and base_val.kind == _ARENA:
                if terminal in ("column", "frame"):
                    kind = _ARENA_VIEW if terminal == "column" else _FRAME
                    return Val(
                        kind, root=root,
                        epoch=self.arena_epochs.get(root or "", 0),
                        origin=call.lineno,
                    )
            if terminal == "frombuffer" and root in mod.np_aliases:
                # np.frombuffer(arena.buf, ...) — an arena view
                arena_root = self._arena_of_buffer(call)
                if arena_root is not None:
                    return Val(
                        _ARENA_VIEW, root=arena_root,
                        epoch=self.arena_epochs.get(arena_root, 0),
                        origin=call.lineno,
                    )
        return Val()

    def _arena_of_buffer(self, call: ast.Call) -> Optional[str]:
        if not call.args:
            return None
        buf = call.args[0]
        if isinstance(buf, ast.Attribute) and isinstance(
            buf.value, ast.Name
        ):
            val = self.scope.get(buf.value.id)
            if val is not None and val.kind == _ARENA:
                return buf.value.id
        if isinstance(buf, ast.Name):
            val = self.scope.get(buf.id)
            if val is not None and val.kind in (_ARENA, _ARENA_VIEW):
                return val.root or buf.id
        return None

    # -------------------------------------------------------- reads

    def _reads(self, expr: ast.AST) -> None:
        """Visit an expression: stale/donated read checks + rule events.

        Reads are checked BEFORE call events land: an operand read
        inside the donating/mutating call itself is part of the call,
        not a use "after" it — SCX604/605 flag the NEXT statement that
        touches the dead value.
        """
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                self._check_read(sub)
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self._call_event(sub)

    def _check_read(self, name: ast.Name) -> None:
        val = self.scope.get(name.id)
        if val is None or val.reported:
            return
        if val.kind == _DONATED:
            val.reported = True
            self.a.finding(
                self.mod, "SCX604", name,
                f"'{name.id}' was donated to jit site {val.root!r} at "
                f"line {val.origin} and is read afterwards — the buffer "
                "is dead after dispatch; keep the result, not the operand",
            )
        elif val.kind == _ARENA_VIEW and val.root is not None:
            if self.arena_epochs.get(val.root, 0) > val.epoch:
                val.reported = True
                self.a.finding(
                    self.mod, "SCX605", name,
                    f"view '{name.id}' was captured from arena "
                    f"'{val.root}' at line {val.origin} and read after "
                    "the arena was refilled/padded — re-derive the view "
                    "after the mutation",
                )

    # ----------------------------------------------------- call events

    def _call_event(self, call: ast.Call) -> None:
        mod = self.mod
        func = call.func
        terminal = _terminal_name(func)

        # completion barrier clears the async-upload hazard
        if terminal in _BARRIER_NAMES:
            self.pending_uploads.clear()
            return

        # arena mutators: SCX603 when an upload is pending, and a refill
        # epoch bump for SCX605
        if terminal in _ARENA_MUTATORS and isinstance(func, ast.Attribute):
            root, _ = _root_chain(func)
            if root is not None:
                base = self.scope.get(root)
                if base is not None and base.kind == _ARENA:
                    self._arena_mutation(root, call, root)
            # fall through: also scan args below

        # ingest.upload(X, ...): async H2D over any arena-aliasing value
        if self._is_upload_call(call):
            roots = self._alias_roots(call.args[0]) if call.args else set()
            for root in roots:
                self.pending_uploads[root] = call.lineno

        # donation: calls to donating defs/bindings kill donated operands
        self._donation_event(call)

        # frame/view passed to a callee whose param escapes (SCX601)
        if self._in_consumer_loop():
            self._escape_through_call(call)

    def _arena_mutation(
        self, root: Optional[str], node: ast.AST, label: str
    ) -> None:
        if root is None:
            return
        pending = self.pending_uploads.pop(root, None)
        if pending is not None:
            self.a.finding(
                self.mod, "SCX603", node,
                f"arena '{root}' mutated while the async upload from "
                f"line {pending} may still be reading it — synchronize "
                "(or release the frame) before padding/refilling the slot",
            )
        self.arena_epochs[root] = self.arena_epochs.get(root, 0) + 1

    def _is_upload_call(self, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in self.mod.upload_names
        if isinstance(func, ast.Attribute):
            root, chain = _root_chain(func)
            if chain and chain[-1] == "upload":
                return root in self.mod.ingest_mods
        return False

    def _alias_roots(self, expr: ast.AST) -> Set[str]:
        """Arena roots reachable from ``expr`` (dict/tuple literals ok)."""
        roots: Set[str] = set()
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name):
                val = self.scope.get(sub.id)
                if val is not None and val.kind in (
                    _ARENA, _ARENA_VIEW, _FRAME
                ):
                    if val.root is not None:
                        roots.add(val.root)
                    elif val.kind == _ARENA:
                        roots.add(sub.id)
        return roots

    def _donation_event(self, call: ast.Call) -> None:
        site = self._donating_site_of(call)
        if site is None:
            return
        donated_names: List[str] = []
        for position in site.argnums:
            if position < len(call.args) and isinstance(
                call.args[position], ast.Name
            ):
                donated_names.append(call.args[position].id)
        if site.argnames:
            for kw in call.keywords:
                if kw.arg in site.argnames and isinstance(
                    kw.value, ast.Name
                ):
                    donated_names.append(kw.value.id)
        for name in donated_names:
            self.scope[name] = Val(
                _DONATED, root=site.name, origin=call.lineno
            )

    def _donating_site_of(self, call: ast.Call) -> Optional[DonationSite]:
        func = call.func
        model = self.a.model
        if isinstance(func, ast.Name):
            binding = self.mod.donating_bindings.get(func.id)
            if binding is not None:
                return binding
            site = self._local_donations.get(func.id)
            if site is not None:
                return site
        for qual in self.a._resolve_call(self.mod, func, self.info.cls):
            if qual in model.donating_defs:
                return model.donating_defs[qual]
        # cross-module binding: from .kernels import STEP
        if isinstance(func, ast.Name):
            bound = self.mod.from_funcs.get(func.id)
            if bound is not None:
                other = model.modules.get(bound[0])
                if other is not None:
                    return other.donating_bindings.get(bound[1])
        return None

    # local (function-scope) donating bindings, populated by _stmt via
    # _track_local_donation
    @property
    def _local_donations(self) -> Dict[str, DonationSite]:
        cache = getattr(self, "_local_don", None)
        if cache is None:
            cache = {}
            for sub in ast.walk(self.node):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Call
                ):
                    for target in sub.targets:
                        if isinstance(target, ast.Name):
                            site = self.a._donation_from_call(
                                self.mod, sub.value, target.id
                            )
                            if site is not None:
                                cache[target.id] = site
            self._local_don = cache
        return cache

    def _escape_through_call(self, call: ast.Call) -> None:
        quals = self.a._resolve_call(self.mod, call.func, self.info.cls)
        for qual in quals:
            callee = self.a.model.functions.get(qual)
            if callee is None or not callee.escaping_params:
                continue
            callee_params = [
                p for p in callee.params if p not in ("self", "cls")
            ]
            for position, arg in enumerate(call.args):
                val = self._value_of(arg)
                if val.kind not in (_FRAME, _ARENA_VIEW):
                    continue
                if position < len(callee_params) and callee_params[
                    position
                ] in callee.escaping_params:
                    self.a.finding(
                        self.mod, "SCX601", call,
                        f"zero-copy frame/view passed to {callee.name}() "
                        f"whose parameter "
                        f"'{callee_params[position]}' is "
                        f"{callee.escaping_params[callee_params[position]]}"
                        " — it outlives the loop iteration; "
                        "copy_frame() first",
                    )
                    return
        # container.append(alias) on a container that outlives the loop
        func = call.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _RETAINING_METHODS
        ):
            for arg in call.args:
                val = self._value_of(arg)
                if val.kind in (_FRAME, _ARENA_VIEW) and not (
                    self._is_loop_local(func.value)
                ):
                    self.a.finding(
                        self.mod, "SCX601", call,
                        "zero-copy frame/view retained via "
                        f"{_terminal_name(func.value)}.{func.attr}() in a "
                        "container that outlives the loop iteration; "
                        "copy_frame()/np.copy() first",
                    )
                    return

    # ------------------------------------------------------- closures

    def _closure_check(self, stmt) -> None:
        if not self._in_consumer_loop():
            return
        captured = sorted(
            {
                sub.id
                for sub in ast.walk(stmt)
                if isinstance(sub, ast.Name)
                and isinstance(sub.ctx, ast.Load)
                and self.scope.get(sub.id, Val()).kind in (
                    _FRAME, _ARENA_VIEW
                )
            }
        )
        if captured:
            self.a.finding(
                self.mod, "SCX601", stmt,
                f"closure defined in the consumer loop captures "
                f"zero-copy frame/view {captured[0]!r} — the capture "
                "outlives the iteration; copy_frame() before capturing",
            )

    # --------------------------------------------------------- loops

    def _loop_locals(self, body: Sequence[ast.stmt]) -> Set[str]:
        names: Set[str] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign):
                    for target in sub.targets:
                        if isinstance(target, ast.Name):
                            names.add(target.id)
                elif isinstance(sub, (ast.For,)):
                    if isinstance(sub.target, ast.Name):
                        names.add(sub.target.id)
        return names

    def _register_pull(self, call: ast.Call) -> None:
        if self.loops:
            self.loops[-1]["pulls"].add(call.lineno)

    def _for(self, stmt: ast.For) -> None:
        self._reads(stmt.iter)
        iter_val = self._value_of(stmt.iter)
        is_consumer = iter_val.kind == _FRAME_ITER
        if is_consumer and isinstance(stmt.target, ast.Name):
            self.scope[stmt.target.id] = Val(_FRAME, origin=stmt.lineno)
        ctx = {
            "node": stmt,
            "locals": self._loop_locals(stmt.body),
            "pulls": set(),
            "consumer": is_consumer,
            "target": stmt.target.id
            if is_consumer and isinstance(stmt.target, ast.Name)
            else None,
        }
        # only consumer loops carry SCX601/602 semantics; non-consumer
        # loops do not open a context (an inner `while` over an already
        # held frame must not re-trigger escape checks)
        if is_consumer:
            self.loops.append(ctx)
        try:
            pre_frames = {
                name
                for name, val in self.scope.items()
                if val.kind == _FRAME
            }
            self._stmts(stmt.body)
        finally:
            if is_consumer:
                self.loops.pop()
        if is_consumer:
            self._retention_check(stmt, ctx, stmt.body, pre_frames)
        self._stmts(stmt.orelse)

    def _while(self, stmt: ast.While) -> None:
        self._reads(stmt.test)
        # the count.py shape: `frame = next(it); while frame is not None:`
        # with `following = next(it)` pulls inside — a consumer loop
        # exactly when the body pulls from a frame iterable
        pulls_inside = self._body_pulls(stmt.body)
        ctx = {
            "node": stmt,
            "locals": self._loop_locals(stmt.body),
            "pulls": set(),
            "consumer": pulls_inside,
            "target": None,
        }
        if pulls_inside:
            self.loops.append(ctx)
        try:
            pre_frames = {
                name
                for name, val in self.scope.items()
                if val.kind == _FRAME
            }
            self._stmts(stmt.body)
        finally:
            if pulls_inside:
                self.loops.pop()
        if pulls_inside:
            self._retention_check(stmt, ctx, stmt.body, pre_frames)
        self._stmts(stmt.orelse)

    def _body_pulls(self, body: Sequence[ast.stmt]) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if (
                    isinstance(sub, ast.Call)
                    and _terminal_name(sub.func) == "next"
                    and sub.args
                    and self._value_of(sub.args[0]).kind == _FRAME_ITER
                ):
                    return True
        return False

    def _retention_check(
        self,
        stmt: ast.stmt,
        ctx: dict,
        body: Sequence[ast.stmt],
        pre_frames: Set[str],
    ) -> None:
        """SCX602: live-slot accounting for one consumer loop.

        Live slots = pull vars (the loop target and every ``next()``
        look-ahead holds a distinct ring slot) + uncopied cross-iteration
        aliases (a frame var read at the loop top before its body
        reassignment still points at a previous iteration's slot).
        """
        pull_vars: Set[str] = set()
        if ctx["target"]:
            pull_vars.add(ctx["target"])
        # vars assigned from next(frame_iter) inside the body
        first_assign: Dict[str, int] = {}
        reads: Dict[str, int] = {}
        for s in body:
            for sub in ast.walk(s):
                if isinstance(sub, ast.Assign):
                    value = sub.value
                    if (
                        isinstance(value, ast.Call)
                        and _terminal_name(value.func) == "next"
                        and value.args
                        and self._value_of(value.args[0]).kind
                        == _FRAME_ITER
                    ):
                        for target in sub.targets:
                            if isinstance(target, ast.Name):
                                pull_vars.add(target.id)
                    for target in sub.targets:
                        if isinstance(target, ast.Name):
                            first_assign.setdefault(
                                target.id, sub.lineno
                            )
                elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, ast.Load
                ):
                    reads.setdefault(sub.id, sub.lineno)
        # the while-form condition reads the carried frame var at the top
        if isinstance(stmt, ast.While):
            for sub in ast.walk(stmt.test):
                if isinstance(sub, ast.Name):
                    reads.setdefault(sub.id, stmt.lineno)
        cross_iter: Set[str] = set()
        for name, val in self.scope.items():
            if val.kind != _FRAME or name in pull_vars:
                continue
            read_line = reads.get(name)
            if read_line is None:
                continue
            assigned_line = first_assign.get(name)
            if assigned_line is None or read_line <= assigned_line or (
                name in pre_frames
            ):
                # read before (re)assignment in the body, or already a
                # frame when the loop was entered: the previous
                # iteration's slot is live at the loop top
                cross_iter.add(name)
        live = len(pull_vars) + len(cross_iter)
        if live > RETENTION_WINDOW:
            held = sorted(pull_vars) + sorted(cross_iter)
            self.a.finding(
                self.mod, "SCX602", stmt,
                f"consumer loop can hold {live} live ring frames "
                f"({', '.join(held)}) — the ring reserves headroom for "
                f"{RETENTION_WINDOW}; copy_frame() the carry or drop a "
                "look-ahead",
            )


# ------------------------------------------------------------- public API


def build_model(paths: Sequence[str]) -> LifeModel:
    """Parse + analyze every ``.py`` under ``paths`` into one LifeModel."""
    analyzer = _Analyzer()
    # the analysis mechanism is pruned from the walk entirely; the ingest
    # OWNER package is modeled (its exports seed the vocabulary via
    # name-keyed import bindings) but its files are marked exempt so the
    # subsystem's own view handling never reports
    analyzer.load(collect_py_files(paths, LIFE_MECHANISM_DIRS))
    for mod in analyzer.model.modules.values():
        # ownership is the IMMEDIATE parent directory, the SCX112 line:
        # a checkout cloned under ~/ingest/ must not disable the pass
        parent = os.path.basename(os.path.dirname(os.path.abspath(mod.path)))
        if parent in LIFE_OWNER_DIRS:
            mod.exempt = True
    analyzer.compute_escapes()
    analyzer.propagate_frame_iters()
    analyzer.scan_all()
    return analyzer.model


def check_life(paths: Sequence[str]) -> List[Finding]:
    """Run the SCX6xx pass; returns suppression-filtered findings."""
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
