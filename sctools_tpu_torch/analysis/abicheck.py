"""ctypes ABI checker (rules SCX201-SCX206) for the port's native layer.

The port's counterpart of ``sctools_tpu.analysis.abicheck``. It
cross-checks the ctypes table in ``native/__init__.py`` against the
``extern "C"`` definitions in the C++ sources it binds
(``native/*.cpp``, ``native/*.h``). FFI drift — an added parameter, a
narrowed integer, a pointer that became a value — corrupts buffers or
stacks at run time with no traceback pointing at the cause; this pass
turns it into a finding with both sides of the disagreement in the
message.

Both sides are parsed textually (regex over comment-stripped C++, ast over
the Python bindings); nothing is compiled or imported, so the check runs
on hosts without a toolchain. Two Python spellings are read:

- the port's table, a dict literal ``{"scx_f": (restype, [argtypes]),
  ...}`` whose ctypes may be local aliases (``p, c_long = ctypes.c_void_p,
  ctypes.c_long`` earlier in the same function or module);
- the JAX package's ``lib.scx_f.argtypes = [...]`` / ``.restype = ...``
  assignments.

Rules:

- SCX201 binding-missing-symbol: Python binds a function no C++ source
  defines.
- SCX202 unbound-export: an ``extern "C"`` ``scx_*`` function no Python
  binding declares (dead export, or a binding someone forgot).
- SCX203 arg-count-mismatch.
- SCX204 arg-type-mismatch (position, both spellings in the message): an
  integer of another width, ``c_char_p`` for anything but ``char*``, or an
  integer argtype where C takes a pointer, or the reverse.
- SCX205 restype-mismatch (a missing restype counts as ctypes' implicit
  ``c_int`` default); restypes are exact, typed pointers included
  (``const int32_t*`` takes ``POINTER(c_int32)``).
- SCX206 not-extern-c: an ``scx_*`` definition outside ``extern "C"`` —
  it would be name-mangled and invisible to ``dlsym``.

Where the port differs from the JAX pass on purpose: an *argument* that C
types as a data pointer (``int32_t*``, ``const uint8_t*``, ``char*``
buffers...) accepts ``c_void_p``. The port passes numpy and tensor
addresses there as integers; the pointer's width is the same, and the
pointee is the callee's business. Everything else stays exact.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding, Suppressions

ABI_RULES = {
    "SCX201": "binding-missing-symbol",
    "SCX202": "unbound-export",
    "SCX203": "arg-count-mismatch",
    "SCX204": "arg-type-mismatch",
    "SCX205": "restype-mismatch",
    "SCX206": "not-extern-c",
}

# C parameter/return type -> acceptable ctypes spellings. Pointers must
# match pointee width exactly; char* accepts both the bytes-converting
# c_char_p and the raw POINTER(c_char) view; plain int accepts the two
# 32-bit spellings (LP64: int == int32).
_C_TO_CTYPES: Dict[str, Set[str]] = {
    "void*": {"c_void_p"},
    "char*": {"c_char_p", "POINTER(c_char)"},
    "int": {"c_int", "c_int32"},
    "int32_t": {"c_int32", "c_int"},
    "long": {"c_long"},
    "int64_t": {"c_int64", "c_long"},  # LP64 (the only target we build on)
    "unsigned long long": {"c_ulonglong", "c_uint64"},
    "uint64_t": {"c_uint64", "c_ulonglong"},
    "double": {"c_double"},
    "float": {"c_float"},
    "int8_t*": {"POINTER(c_int8)"},
    "uint8_t*": {"POINTER(c_uint8)"},
    "int16_t*": {"POINTER(c_int16)"},
    "uint16_t*": {"POINTER(c_uint16)"},
    "int32_t*": {"POINTER(c_int32)"},
    "uint32_t*": {"POINTER(c_uint32)"},
    "int64_t*": {"POINTER(c_int64)"},
    "uint64_t*": {"POINTER(c_uint64)"},
    "long*": {"POINTER(c_long)"},
    "double*": {"POINTER(c_double)"},
    "float*": {"POINTER(c_float)"},
    "void": {"None"},
}


@dataclass
class CFunction:
    name: str
    ret: str
    params: List[str]  # normalized C type per parameter
    path: str
    line: int


@dataclass
class Binding:
    name: str
    restype: Optional[str] = None  # normalized ctypes spelling
    restype_line: int = 0
    restype_end_line: int = 0
    argtypes: Optional[List[str]] = None
    argtypes_line: int = 0
    argtypes_end_line: int = 0
    path: str = ""


# ---------------------------------------------------------------- C side

_DEFN = re.compile(
    r"(?:^|\n)[ \t]*((?:[\w:]+[ \t\n]+)*[\w:]+[ \t\n*&]*?)"
    r"\b(scx_\w+)[ \t\n]*\(([^)]*)\)[ \t\n]*\{",
    re.S,
)


def _normalize_c_source(text: str) -> Tuple[str, str]:
    """One literal-aware pass over C++ source -> (decommented, blanked).

    ``decommented`` has comments spaced out but string/char literals
    intact (the ``extern "C"`` opener is itself a literal and must stay
    findable); ``blanked`` additionally spaces out literal *contents*, so
    brace counting and the definition regex cannot be confused by a ``{``
    inside a format string. Comments and literals are tracked in a single
    state machine — a ``//`` inside a string is not a comment, and a
    quote inside a comment is not a literal. Both outputs are
    length-preserving (newlines kept), so offsets and line numbers align
    with the original text.
    """
    decommented = list(text)
    blanked = list(text)
    n = len(text)

    def blank(index: int, both: bool) -> None:
        if text[index] != "\n":
            blanked[index] = " "
            if both:
                decommented[index] = " "

    i = 0
    while i < n:
        two = text[i:i + 2]
        if two == "//":
            while i < n and text[i] != "\n":
                blank(i, both=True)
                i += 1
        elif two == "/*":
            end = text.find("*/", i + 2)
            end = n if end < 0 else end + 2
            while i < end:
                blank(i, both=True)
                i += 1
        elif text[i] in ('"', "'"):
            quote = text[i]
            i += 1  # the quote itself stays in both outputs
            while i < n and text[i] != quote:
                blank(i, both=False)
                if text[i] == "\\" and i + 1 < n:
                    blank(i + 1, both=False)
                    i += 1
                i += 1
            i += 1  # closing quote (or EOF)
        else:
            i += 1
    return "".join(decommented), "".join(blanked)


def _normalize_c_type(tokens: str) -> str:
    """``const char *`` -> ``char*``; ``unsigned long long`` unchanged."""
    stars = tokens.count("*")
    words = [
        w for w in re.split(r"[\s*&]+", tokens)
        if w and w not in ("const", "volatile", "restrict", "struct")
    ]
    return " ".join(words) + "*" * stars


def _split_params(params: str) -> List[str]:
    params = params.strip()
    if not params or params == "void":
        return []
    out = []
    for piece in params.split(","):
        piece = piece.strip()
        # drop the trailing parameter name (always present in this codebase)
        match = re.match(r"^(.*?)([A-Za-z_]\w*)$", piece, re.S)
        type_part = match.group(1) if match else piece
        # `unsigned long long seed` — the regex eats `seed`; `long long`
        # with no name would eat `long`, but every export names its params
        out.append(_normalize_c_type(type_part))
    return out


def _extern_c_ranges(text: str, blanked: str) -> List[Tuple[int, int]]:
    """[start, end) offsets of every ``extern "C" { ... }`` block.

    Openers are located on ``text`` (literal contents intact — the "C"
    itself is a literal); braces are counted on ``blanked`` (literal
    contents spaced out so a ``{`` inside a format string cannot truncate
    the block). The two are the same length, so offsets line up.
    """
    ranges = []
    for match in re.finditer(r'extern\s+"C"\s*\{', text):
        depth = 1
        pos = match.end()
        while pos < len(blanked) and depth:
            if blanked[pos] == "{":
                depth += 1
            elif blanked[pos] == "}":
                depth -= 1
            pos += 1
        ranges.append((match.end(), pos))
    return ranges


def parse_c_exports(
    path: str,
) -> Tuple[List[CFunction], List[Finding], Suppressions]:
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    unblanked, text = _normalize_c_source(raw)
    ranges = _extern_c_ranges(unblanked, text)
    functions: List[CFunction] = []
    findings: List[Finding] = []
    for match in _DEFN.finditer(text):
        line = text.count("\n", 0, match.start(2)) + 1
        fn = CFunction(
            name=match.group(2),
            ret=_normalize_c_type(match.group(1)),
            params=_split_params(match.group(3)),
            path=path,
            line=line,
        )
        functions.append(fn)
        if not any(start <= match.start(2) < end for start, end in ranges):
            findings.append(
                Finding(
                    "SCX206", path, line,
                    f"`{fn.name}` is defined outside an extern \"C\" block; "
                    "its symbol will be C++-mangled and invisible to ctypes",
                )
            )
    supp = Suppressions.from_text(raw, "//")
    return functions, supp.apply(findings), supp


# ----------------------------------------------------------- Python side

def _render_ctype(
    node: ast.AST, aliases: Optional[Dict[str, ast.AST]] = None, depth: int = 0
) -> Optional[str]:
    """``ctypes.POINTER(ctypes.c_int32)`` -> ``POINTER(c_int32)``; a name
    bound in ``aliases`` renders as the expression it was bound to."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        bound = (aliases or {}).get(node.id)
        if bound is not None and depth < 8:
            return _render_ctype(bound, aliases, depth + 1)
        return node.id
    if isinstance(node, ast.Call):
        head = _render_ctype(node.func, aliases, depth)
        inner = [_render_ctype(a, aliases, depth) for a in node.args]
        if head is None or any(i is None for i in inner):
            return None
        return f"{head}({', '.join(i for i in inner if i is not None)})"
    return None


def _collect_aliases(tree: ast.Module) -> Dict[str, ast.AST]:
    """Names bound to ctypes spellings anywhere in the file: ``p =
    ctypes.c_void_p`` and ``p, c_int = ctypes.c_void_p, ctypes.c_int``."""
    aliases: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        pairs = [(target, value)]
        if isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple):
            pairs = list(zip(target.elts, value.elts))
        for name, expr in pairs:
            if isinstance(name, ast.Name) and isinstance(
                expr, (ast.Attribute, ast.Call)
            ):
                aliases[name.id] = expr
    return aliases


def _table_entries(node: ast.Dict):
    """(name, key node, restype node, argtypes node) of each entry of a
    ``{"scx_f": (restype, [argtypes]), ...}`` literal, else nothing."""
    entries = []
    for key, value in zip(node.keys, node.values):
        if not (
            isinstance(key, ast.Constant)
            and isinstance(key.value, str)
            and key.value.startswith("scx_")
            and isinstance(value, ast.Tuple)
            and len(value.elts) == 2
        ):
            return []
        entries.append((key.value, key, value.elts[0], value.elts[1]))
    return entries


def _argtypes(node: ast.AST, aliases) -> Optional[List[str]]:
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    rendered = [_render_ctype(e, aliases) for e in node.elts]
    return [r or "<unparsed>" for r in rendered]


def parse_bindings(path: str) -> Dict[str, Binding]:
    """Every binding in a file: the entries of ``{"scx_X": (restype,
    [argtypes])}`` tables and the ``<obj>.scx_X.argtypes/restype = ...``
    assignments."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    aliases = _collect_aliases(tree)
    bindings: Dict[str, Binding] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for name, key, restype, argtypes in _table_entries(node):
                end = argtypes.end_lineno or key.lineno
                bindings[name] = Binding(
                    name=name, path=path,
                    restype=_render_ctype(restype, aliases),
                    restype_line=key.lineno, restype_end_line=end,
                    argtypes=_argtypes(argtypes, aliases),
                    argtypes_line=key.lineno, argtypes_end_line=end,
                )
            continue
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not (
            isinstance(target, ast.Attribute)
            and target.attr in ("argtypes", "restype")
            and isinstance(target.value, ast.Attribute)
            and target.value.attr.startswith("scx_")
        ):
            continue
        name = target.value.attr
        binding = bindings.setdefault(name, Binding(name=name, path=path))
        if target.attr == "restype":
            binding.restype = _render_ctype(node.value, aliases)
            binding.restype_line = node.lineno
            binding.restype_end_line = node.end_lineno or node.lineno
        else:
            binding.argtypes = _argtypes(node.value, aliases)
            binding.argtypes_line = node.lineno
            binding.argtypes_end_line = node.end_lineno or node.lineno
    return bindings


# -------------------------------------------------------------- checker

def _compatible(
    c_type: str, ctypes_name: Optional[str], argument: bool = False
) -> bool:
    if argument and ctypes_name == "c_void_p" and c_type.endswith("*"):
        return True  # an address for a data pointer (the module docstring)
    allowed = _C_TO_CTYPES.get(c_type)
    if allowed is None:
        # unknown C type: only an exact textual twin passes (conservative,
        # surfaces the gap instead of silently allowing anything)
        return ctypes_name == c_type
    return ctypes_name in allowed


def check_abi(
    native_dir: str,
    binding_path: Optional[str] = None,
) -> List[Finding]:
    """Cross-check ``native_dir``'s sources against its ctypes bindings.

    ``binding_path`` defaults to ``native_dir/__init__.py`` (tests point it
    at a deliberately corrupted copy).
    """
    findings: List[Finding] = []
    sources = sorted(
        glob.glob(os.path.join(native_dir, "*.cpp"))
        + glob.glob(os.path.join(native_dir, "*.h"))
    )
    exports: Dict[str, CFunction] = {}
    supp_by_path: Dict[str, Suppressions] = {}
    for source in sources:
        functions, file_findings, supp = parse_c_exports(source)
        findings.extend(file_findings)
        supp_by_path[source] = supp
        for fn in functions:
            exports[fn.name] = fn

    if binding_path is None:
        binding_path = os.path.join(native_dir, "__init__.py")
    if not os.path.exists(binding_path):
        findings.append(
            Finding(
                "SCX201", binding_path, 0,
                f"ctypes binding module not found; {len(exports)} extern "
                "\"C\" export(s) are unchecked",
            )
        )
        return findings
    bindings = parse_bindings(binding_path)

    for name, binding in sorted(bindings.items()):
        fn = exports.get(name)
        anchor = binding.argtypes_line or binding.restype_line
        if fn is None:
            findings.append(
                Finding(
                    "SCX201", binding_path, anchor,
                    f"binding `{name}` has no extern \"C\" definition in "
                    f"{native_dir}/*.cpp — stale binding or renamed symbol",
                )
            )
            continue
        # restype (ctypes defaults an unset restype to c_int)
        restype = binding.restype if binding.restype is not None else "c_int"
        if not _compatible(fn.ret, restype):
            findings.append(
                Finding(
                    "SCX205", binding_path,
                    binding.restype_line or anchor,
                    f"`{name}` restype {restype} does not match C return "
                    f"type `{fn.ret}` ({os.path.basename(fn.path)}:{fn.line})",
                    binding.restype_end_line,
                )
            )
        if binding.argtypes is None:
            findings.append(
                Finding(
                    "SCX203", binding_path, anchor,
                    f"`{name}` has no (or non-literal) argtypes; the C "
                    f"definition takes {len(fn.params)} parameter(s)",
                )
            )
            continue
        if len(binding.argtypes) != len(fn.params):
            findings.append(
                Finding(
                    "SCX203", binding_path, binding.argtypes_line,
                    f"`{name}` argtypes lists {len(binding.argtypes)} "
                    f"parameter(s) but the C definition takes "
                    f"{len(fn.params)} ({os.path.basename(fn.path)}:{fn.line})",
                    binding.argtypes_end_line,
                )
            )
            continue
        for i, (c_type, py_type) in enumerate(
            zip(fn.params, binding.argtypes)
        ):
            if not _compatible(c_type, py_type, argument=True):
                findings.append(
                    Finding(
                        "SCX204", binding_path, binding.argtypes_line,
                        f"`{name}` argument {i}: ctypes {py_type} vs C "
                        f"`{c_type}` "
                        f"({os.path.basename(fn.path)}:{fn.line})",
                        binding.argtypes_end_line,
                    )
                )

    for name, fn in sorted(exports.items()):
        if name not in bindings:
            findings.append(
                Finding(
                    "SCX202", fn.path, fn.line,
                    f"extern \"C\" `{name}` has no ctypes binding in "
                    f"{os.path.basename(binding_path)}",
                )
            )

    with open(binding_path, encoding="utf-8") as f:
        supp_by_path[binding_path] = Suppressions.from_text(f.read(), "#")
    out = []
    for finding in findings:
        supp = supp_by_path.get(finding.path)
        if supp is None or supp.apply([finding]):
            out.append(finding)
    return out
