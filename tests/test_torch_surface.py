"""The port's public surface against the JAX package's, name for name and
parameter by parameter.

For every module ``sctools_tpu/<path>.py``, each public top-level name it
defines (a ``def``, a ``class`` or an assignment whose name has no leading
``_``) must be bound at the top level of ``sctools_tpu_torch/<path>.py``,
by a definition or an import. The only exceptions are the names of
``LEFT_OUT``, each with its reason, and the names of ``RENAMED``, whose
port name is checked in their place. A name left out that the port has
after all, or that JAX no longer defines, fails the check too, so the
table stays true. The name check reads both packages' syntax trees and
imports neither.

The signature check holds every public function, class (its constructor)
and public method that a JAX module defines against its port: the port's
parameters start with JAX's, with the same names, order, kinds and
defaults (equal by ``==``), and every parameter of the port's own that
follows them has a default. The only exceptions are the parameters that
``SIGNATURE_DIFFERS`` names, each with its reason; an entry whose
difference is gone fails as well. The signatures are read with
``inspect.signature`` in a child process that imports both packages, so
that no module's import touches the state of this one.

The lazy submodule access of ``sctools_tpu_torch`` is checked in a child
process too.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "sctools_tpu"
PORT = REPO / "sctools_tpu_torch"

_JAX_MACHINERY = "JAX/XLA machinery with no counterpart in PyTorch: "
_NO_RUNG = "a rung of JAX's degrade ladder; the port has no fallback to a plain route or to the CPU: "
_JAXLINT = "jaxlint, JAX's lint rules (jit, shard_map and device_put owners); the port's torchlint has its own"
_ENGINE = ("the port's engine reduces through RunBounds and the segmented scans "
           "(ops.segments.RunBounds, segmented_scan_sum, segmented_scan_min)")

# (module, name) -> why the port does not have it
LEFT_OUT = {
    **{("analysis/jaxlint.py", name): _JAXLINT for name in (
        "CONFIG_OWNERS", "DEVICE_PULL_OWNERS", "DEVICE_PULL_OWNER_DIRS", "DEVICE_PUT_OWNERS",
        "DEVICE_PUT_OWNER_DIRS", "GUARD_OWNER_DIRS", "JAX_RULES", "JIT_OWNERS", "JaxLinter",
        "SHARD_MAP_OWNERS", "STEER_OWNERS", "STEER_OWNER_DIRS", "TraceSpec", "lint_file")},
    ("analysis/meshwitness.py", "region_label"): _JAX_MACHINERY + "names a shard_map region at trace time",
    ("analysis/meshwitness.py", "tag_region"): _JAX_MACHINERY + "wraps a shard_map body at trace time",
    ("guard/__init__.py", "record_splitter"): "the midpoint cut of a pipeline with no entity constraint; "
    "every guarded port pipeline cuts at an entity boundary (guard.entity_splitter)",
    **{("guard/degrade.py", name): _NO_RUNG + "nothing to degrade to, no strike count to reach"
       for name in ("DEFAULT_THRESHOLD", "ENV_THRESHOLD", "degrade_now", "is_degraded", "threshold")},
    ("ingest/__init__.py", "mesh_sharding"): _JAX_MACHINERY + "a NamedSharding for stacked columns; "
    "the port's mesh holds one shard a device (parallel.mesh.Mesh)",
    ("ingest/__init__.py", "timed_uploads"): _JAX_MACHINERY + "forces JAX's timed=True uploads; "
    "the port's ingest.upload has no timed mode",
    ("ingest/wire.py", "timed_pulls"): _JAX_MACHINERY + "forces JAX's timed=True pulls; "
    "the port's ingest.wire.pull has no timed mode",
    ("ingest/ring.py", "ENV_NATIVE_DOWNGRADE"): _NO_RUNG + "the native decoder's downgrade to the Python decoder",
    ("ingest/ring.py", "native_downgrade_enabled"): _NO_RUNG + "the native decoder's downgrade to the Python "
    "decoder",
    ("metrics/collective.py", "P"): _JAX_MACHINERY + "jax.sharding.PartitionSpec",
    ("parallel/count.py", "P"): _JAX_MACHINERY + "jax.sharding.PartitionSpec",
    ("parallel/metrics.py", "P"): _JAX_MACHINERY + "jax.sharding.PartitionSpec",
    ("samplefastq.py", "SLIDESEQ_LINKER"): "the port's R1 rewrite is the native loop's, which holds the linker "
    "(native/fastqtools.cpp, kLinker); no Python code of the port writes it",
    ("platform.py", "shard_map"): _JAX_MACHINERY + "the version-portable jax shard_map shim",
    ("native/__init__.py", "available"): "the port's native layer has one route: a failed build raises, "
    "so there is no availability to probe",
    ("obs/__init__.py", "install_jax_hooks"): _JAX_MACHINERY + "jax.monitoring listeners",
    ("obs/__init__.py", "xla_trace"): _JAX_MACHINERY + "jax.profiler.trace",
    **{("obs/xprof.py", name): _JAX_MACHINERY + "jit call-site instrumentation and the executable store"
       for name in ("active_site", "disable_executable_store", "enable_executable_store",
                    "executable_store_dir", "executable_store_stats", "instrument_jit", "observe_event")},
    **{("ops/segments.py", name): _ENGINE
       for name in ("first_index_per_segment", "segment_count", "segment_min", "segment_sum")},
    ("ops/whitelist.py", "onehot_barcodes"): "the port's kernel packs its own int8 table "
    "(ops.whitelist.make_table, onehot_int8)",
    ("serve/manifest.py", "aot_cache_dir"): _JAX_MACHINERY + "the AOT executable cache of jax.jit",
    ("utils/cache.py", "enable_aot_cache"): _JAX_MACHINERY + "jax's persistent compilation cache",
    ("utils/cache.py", "enable_compilation_cache"): _JAX_MACHINERY + "jax's persistent compilation cache",
}

# (module, JAX name) -> the port's name for the same function
RENAMED = {
    ("native/__init__.py", "attach_barcodes_native"): "attach",
    ("native/__init__.py", "fastq_metrics_native"): "fastq_metrics",
    ("native/__init__.py", "fastqprocess_native"): "fastqprocess",
    ("native/__init__.py", "frame_from_bam_native"): "frame_from_bam",
    ("native/__init__.py", "sample_fastq_native"): "sample_fastq",
    ("native/__init__.py", "stream_frames_native"): "stream_frames",
    ("native/__init__.py", "tagsort_native"): "tagsort",
}

# the library API the port once left out: it must never go missing again
LIBRARY = {
    "bam.py": ("SubsetAlignments", "Tagger", "AlignmentSortOrder", "QueryNameSortOrder",
               "get_barcode_for_alignment"),
    "fastq.py": ("extract_barcode", "EmbeddedBarcodeGenerator", "BarcodeGeneratorWithCorrectedCellBarcodes",
                 "ReadStructureBarcodeGenerator"),
    "gtf.py": ("GTFRecord", "Reader", "extract_extended_gene_names", "extract_gene_exons",
               "_intervals_by_chromosome"),
    "fastq_metrics.py": ("PositionWeightMatrix", "FastQMetrics"),
    "io/sam.py": ("AlignmentFile",),
    "ingest/framedebug.py": ("snapshot", "dump", "_dump_at_exit"),
    "parallel/launch.py": ("process_chunks",),
    "__init__.py": ("__getattr__",),
}
# the re-exports of a package's __init__ the port must make as JAX's does
EXPORTS = {
    "utils/__init__.py": ("prefetch_depth", "prefetch_iterator"),
    "parallel/__init__.py": ("process_chunks",),
}

_UNTIMED = "the port's transfers are never timed, and a pull is a handle (ROADMAP, 'A pull is a handle')"
_PER_SHARD = ("takes the per-shard list of tensors over a parallel.mesh.Mesh and returns one a shard: "
              "the port traces no shard_map, so there is no per-shard value to name")
_SYNTAX = ("a field of the pass's syntax-tree model: the fields follow what the pass recognises in "
           "torch code, not in JAX code")
_FASTQ_LOOP = ("the inner loop of the port's FASTQ command: it takes the command's WhitelistCorrector "
               "(its table already on the device) in place of a whitelist path and every setting from "
               "the command, and returns the counts and phase seconds the command reports")

# (module, callable) -> (the parameters, JAX's or the port's, that differ on
# purpose, why); with those taken out of both, the rest must agree
SIGNATURE_DIFFERS = {
    ("ingest/__init__.py", "upload"): (
        ("value", "record", "timed", "sharding", "array", "device"),
        "the port's upload takes a numpy array and the device to put it on and always books its "
        "bytes; " + _UNTIMED + "; a mesh holds one shard a device, so there is no NamedSharding"),
    ("ingest/wire.py", "pull"): (("timed",), _UNTIMED),
    ("ingest/wire.py", "WritebackRing.collect"): (
        ("value", "staged", "timed"), "collect drains a staged Pulled handle, not a device value; " + _UNTIMED),
    **{("parallel/collective.py", name): (("x", "xs", "mesh"), _PER_SHARD)
       for name in ("pmax", "pmean", "pmin", "ppermute", "psum")},
    **{("parallel/collective.py", name): (("x", "xs", "mesh", "kwargs"), _PER_SHARD)
       for name in ("all_gather", "all_to_all")},
    ("parallel/collective.py", "axis_index"): (("mesh",), "the index of every shard of a parallel.mesh.Mesh, one "
                                               "a shard: the port traces no shard_map"),
    ("parallel/metrics.py", "reshard_by_key"): (
        ("cols", "n_shards", "shards", "mesh", "axis_name"),
        "takes the per-shard column dicts over a parallel.mesh.Mesh, whose size is the shard count, "
        "and traces no shard_map"),
    ("ops/whitelist.py", "WhitelistCorrector"): (
        ("use_pallas", "interpret"),
        "use_pallas and interpret choose JAX's Pallas or jnp route; the port has one route, its "
        "hand-written kernel on the card and the kernel's plain version on the CPU"),
    ("parallel/launch.py", "run_process_cell_metrics"): (
        ("raise_on_quarantine",),
        "not ported on purpose: the port's worker always raises sched.QuarantinedTasksError once the "
        "queue has drained with quarantined chunks"),
    ("analysis/aotcheck.py", "FuncInfo"): (("cls_qual",), _SYNTAX),
    ("analysis/aotcheck.py", "ModInfo"): (
        ("jax_aliases", "functools_aliases", "nodes", "torch_aliases", "class_index"), _SYNTAX),
    ("analysis/costcheck.py", "ModInfo"): (("jax_aliases",), _SYNTAX),
    ("analysis/lifecheck.py", "FuncInfo"): (("_yields",), _SYNTAX),
    ("analysis/meshcheck.py", "ModInfo"): (
        ("jax_aliases", "lax_aliases", "shard_map_names", "pspec_names", "distributed_mods", "control_funcs",
         "witness_mods", "mapped_names"), _SYNTAX),
    ("analysis/meshcheck.py", "SmSite"): (("label",), _SYNTAX),
    ("analysis/shardcheck.py", "JitSite"): (("spec_axes",), _SYNTAX),
    ("analysis/shardcheck.py", "ModInfo"): (
        ("jax_aliases", "lax_aliases", "np_aliases", "pspec_names", "shard_map_names", "nodes", "mapped_names",
         "witness_mods", "pull_names", "collective_mods", "collective_funcs"), _SYNTAX),
    ("analysis/shardcheck.py", "SmSite"): (("in_specs_arity", "spec_axes", "axes_known"), _SYNTAX),
    ("native/__init__.py", "attach_barcodes_native"): (
        ("whitelist", "corrector", "sample_spans", "i1", "batch_size"), _FASTQ_LOOP),
    ("native/__init__.py", "fastqprocess_native"): (
        ("whitelist", "compress_level", "corrector", "seconds", "sample_spans", "i1_files", "n_shards",
         "output_format", "sample_id", "batch_size"), _FASTQ_LOOP),
    ("native/__init__.py", "sample_fastq_native"): (("whitelist", "corrector", "seconds", "batch_size"), _FASTQ_LOOP),
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(tree: ast.Module) -> set:
    """Top-level names a module defines: def, class, assignment."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return names


def bound(tree: ast.Module) -> set:
    """Top-level names a module binds: its definitions and its imports."""
    names = defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def all_list(tree: ast.Module) -> list:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _public(module: str) -> set:
    return {n for n in defined(_tree(JAX / module)) if not n.startswith("_")}


def _port_bound(module: str) -> set:
    path = PORT / module
    return bound(_tree(path)) if path.exists() else set()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_its_port(module):
    wanted = _public(module)
    have = _port_bound(module)
    missing = sorted(n for n in wanted - have if (module, n) not in LEFT_OUT and (module, n) not in RENAMED)
    assert not missing, f"sctools_tpu_torch/{module} lacks {missing}"
    stale = sorted(n for (m, n) in LEFT_OUT if m == module and (n in have or n not in wanted))
    assert not stale, f"LEFT_OUT names {stale} of {module}, which the port has or JAX does not define"


def test_every_left_out_name_has_a_reason():
    assert LEFT_OUT and all(isinstance(r, str) and len(r) > 20 for r in LEFT_OUT.values())
    assert not set(LEFT_OUT) & set(RENAMED)
    assert {m for m, _ in LEFT_OUT} <= set(JAX_MODULES)


@pytest.mark.parametrize("key", sorted(RENAMED), ids=lambda key: key[1])
def test_renamed_names_exist_under_their_port_name(key):
    module, name = key
    assert name in _public(module) and name not in _port_bound(module)
    assert RENAMED[key] in defined(_tree(PORT / module))


@pytest.mark.parametrize("module", sorted(LIBRARY))
def test_the_library_api_is_ported(module):
    port_defined = defined(_tree(PORT / module))
    for name in LIBRARY[module]:
        assert name in port_defined, f"sctools_tpu_torch/{module} lacks {name}"
        assert name in defined(_tree(JAX / module))
        assert (module, name) not in LEFT_OUT


@pytest.mark.parametrize("module", sorted(EXPORTS))
def test_package_exports_equal_jax(module):
    port, jax = _tree(PORT / module), _tree(JAX / module)
    for name in EXPORTS[module]:
        assert name in bound(port) and name in all_list(port)
        assert name in bound(jax) and name in all_list(jax)


def test_root_package_lists_jax_s_submodules():
    assert all_list(_tree(PORT / "__init__.py")) == all_list(_tree(JAX / "__init__.py"))


_LAZY = """
import sys
import sctools_tpu_torch as port
assert "sctools_tpu_torch.bam" not in sys.modules and "torch" not in sys.modules
assert port.bam is sys.modules["sctools_tpu_torch.bam"]
assert port.gtf.Reader and port.io.sam.AlignmentFile and port.consts.CELL_BARCODE_TAG_KEY == "CB"
try:
    port.no_such_module
except AttributeError as error:
    assert "no_such_module" in str(error)
else:
    raise AssertionError("an unknown attribute resolved")
assert not [m for m in sys.modules if m == "jax" or m.split(".")[0] == "sctools_tpu"]
"""


def test_submodules_resolve_lazily():
    # PYTHONPATH is the checkout alone: no site hook may import JAX first
    subprocess.run([sys.executable, "-c", _LAZY], cwd=REPO, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))


# ------------------------------------------------------------ signatures

# the child's reader: for each module path on argv, every public callable
# the JAX module defines (functions, classes, and the public methods of a
# class that JAX's own classes define) with its port's -> JSON on stdout
_SIGNATURES = r"""
import importlib, inspect, json, sys

modules, renamed = json.loads(sys.argv[1]), json.loads(sys.argv[2])


def load(package, module):
    parts = module[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join([package, *parts]))


def parameters(obj):
    try:
        signature = inspect.signature(obj)
    except (TypeError, ValueError):
        return None  # an exception class's builtin constructor
    return [(p.name, p.kind.name, p.default is not p.empty, p.default)
            for p in signature.parameters.values()]


def equal(a, b):
    try:
        return bool(a == b)
    except Exception:
        return False


def row(jax, port):
    jax_params, port_params = parameters(jax), parameters(port)
    if jax_params is None or port_params is None:
        return None if jax_params is port_params else "one-sided"
    theirs = {name: default for name, _, has, default in port_params if has}
    return {
        "jax": [(name, kind, has, repr(default) if has else None) for name, kind, has, default in jax_params],
        "port": [(name, kind, has, repr(default) if has else None) for name, kind, has, default in port_params],
        "equal": {name: equal(default, theirs[name]) for name, _, has, default in jax_params
                  if has and name in theirs},
    }


def methods(cls):
    for name in sorted(dir(cls)):
        if name.startswith("_"):
            continue
        attr = inspect.getattr_static(cls, name)
        function = attr.__func__ if isinstance(attr, (classmethod, staticmethod)) else attr
        if inspect.isfunction(function) and function.__module__.split(".")[0] == "sctools_tpu":
            yield name


out = {}
for module in modules:
    jax_module, port_module = load("sctools_tpu", module), load("sctools_tpu_torch", module)
    rows = out[module] = {}
    for name, obj in sorted(vars(jax_module).items()):
        if name.startswith("_") or not callable(obj) or getattr(obj, "__module__", None) != jax_module.__name__:
            continue
        port = getattr(port_module, renamed.get(module + ":" + name, name), None)
        if port is None:
            continue  # the name check's business
        rows[name] = row(obj, port)
        if inspect.isclass(obj):
            for method in methods(obj):
                mine = getattr(port, method, None)
                rows[f"{name}.{method}"] = row(getattr(obj, method), mine) if mine is not None else "missing"
print(json.dumps(out))
"""

_SIGNATURE_MODULES = [m for m in JAX_MODULES if not m.endswith("__main__.py") and (PORT / m).exists()]


@pytest.fixture(scope="module")
def signatures():
    renamed = {f"{module}:{name}": port for (module, name), port in RENAMED.items()}
    done = subprocess.run(
        [sys.executable, "-c", _SIGNATURES, json.dumps(_SIGNATURE_MODULES), json.dumps(renamed)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def first_difference(row, dropped=()) -> str:
    """'' when the port's parameters start with JAX's (names, order, kinds,
    defaults by ==) and each of its own after them has a default, once the
    ``dropped`` names are taken out of both; else the first that differs."""
    if row is None:
        return ""  # neither side has a Python signature (a builtin constructor)
    if row == "missing":
        return "the port's class lacks this method"
    if row == "one-sided":
        return "only one side has a Python signature"
    jax = [p for p in row["jax"] if p[0] not in dropped]
    port = [p for p in row["port"] if p[0] not in dropped]
    for i, (name, kind, has_default, default) in enumerate(jax):
        if i >= len(port):
            return f"{name}: the port has no parameter in its place"
        theirs, their_kind, their_has, their_default = port[i]
        if theirs != name:
            return f"{name}: the port has {theirs} in its place"
        if their_kind != kind:
            return f"{name}: {kind} in JAX, {their_kind} in the port"
        if has_default != their_has or (has_default and not row["equal"][name]):
            return f"{name}: default {default if has_default else 'none'} in JAX, " \
                   f"{their_default if their_has else 'none'} in the port"
    for name, kind, has_default, _ in port[len(jax):]:
        if not has_default and kind not in ("VAR_POSITIONAL", "VAR_KEYWORD"):
            return f"{name}: the port's own parameter has no default"
    return ""


@pytest.mark.parametrize("module", _SIGNATURE_MODULES)
def test_every_signature_starts_with_jax_s(signatures, module):
    differ = []
    for name, row in signatures[module].items():
        entry = SIGNATURE_DIFFERS.get((module, name))
        difference = first_difference(row, entry[0] if entry else ())
        if difference:
            differ.append(f"{name} at {difference}")
    assert not differ, f"sctools_tpu_torch/{module} differs from JAX's: " + "; ".join(differ)


@pytest.mark.parametrize("key", sorted(SIGNATURE_DIFFERS), ids=lambda key: f"{key[0]}:{key[1]}")
def test_every_signature_difference_has_a_reason_and_still_exists(signatures, key):
    module, name = key
    dropped, reason = SIGNATURE_DIFFERS[key]
    assert isinstance(reason, str) and len(reason) > 20
    assert module in _SIGNATURE_MODULES and name in signatures[module], f"{module} defines no {name}"
    row = signatures[module][name]
    everywhere = {p[0] for p in row["jax"]} | {p[0] for p in row["port"]}
    assert dropped and set(dropped) <= everywhere, f"{name} has no parameter {sorted(set(dropped) - everywhere)}"
    assert first_difference(row), f"{module}:{name} no longer differs from JAX's: take it out of SIGNATURE_DIFFERS"
