"""``python -m sctools_tpu_torch.analysis [paths...]``: the port's static checks.

Runs its passes over the given paths (default: ``sctools_tpu_torch``) and
exits non-zero when any finding survives its suppressions:

1. lint (SCX109, SCX112-114, SCX1001) over every ``.py`` file
   (:mod:`.torchlint`);
2. ctypes ABI (SCX201-206) over the first ``native/`` package found under
   the paths, or ``--native-dir`` (:mod:`.abicheck`), and the audit of
   that package's ``tsan.supp`` (SCX301-303, :mod:`.suppaudit`);
3. concurrency (SCX401-404) over the whole-package model built from the
   same paths (:mod:`.racecheck`); ``--emit-lock-graph FILE`` writes the
   static lock inventory and acquisition-order graph that the runtime
   witness checks against (``SCTOOLS_TPU_LOCK_GRAPH``) and exits;
4. shape and sharding flow (SCX501-505, :mod:`.shardcheck`);
   ``--emit-shape-contract FILE`` writes the statically predicted
   per-site signature universe that a live run's merged registries are
   checked against (``shardcheck.check_signatures``) and exits;
   ``--retune RUN_DIR`` is its acting half (:mod:`.retune`): it rewrites
   the pinned bucket floors of the ``ops/segments.py`` under the paths
   from a traced run's registries, gated by this pass and the contract
   (``--retune-target``, ``--retune-dry-run``, ``--segments-file``;
   exit 2 without registries, 5 when a gate restores the file);
5. frame lifetime (SCX601-605) over the same model build
   (:mod:`.lifecheck`);
6. device cost and transfer discipline (SCX701-705, :mod:`.costcheck`);
   ``--emit-transfer-inventory FILE`` writes the static transfer-site
   inventory that a live run's ledger is checked against
   (``costcheck.check_transfer_sites``) and exits;
7. collective safety (SCX801-805, :mod:`.meshcheck`);
   ``--emit-collective-schedule FILE`` writes the statically predicted
   collective universe that the runtime witness checks against
   (``SCTOOLS_TPU_MESH_SCHEDULE``) and exits;
8. AOT dispatch closure of the serve path (SCX901-905,
   :mod:`.aotcheck`); ``--emit-aot-manifest FILE`` writes the certified
   manifest (``serve/graph_manifest.json`` is its output over the port)
   and exits, and ``--aot-manifest FILE`` fails the run when a committed
   manifest was hand-edited or is stale against the fresh contract.

``--race-only`` / ``--shard-only`` / ``--life-only`` / ``--cost-only`` /
``--mesh-only`` / ``--aot-only`` run just those passes (together, each
named one; lint, ABI and the audit are off), ``--no-lint`` / ``--no-abi``
/ ``--no-supp`` / ``--no-race`` / ``--no-shard`` / ``--no-life`` /
``--no-cost`` / ``--no-mesh`` / ``--no-aot`` skip one (``--no-lint`` is
the JAX CLI's ``--no-jax-lint``, named for the port's pass).
``--list-rules`` prints the rule catalog, every rule id of the passes'
tables, and exits. ``--json`` replaces the human-readable output with one
findings object covering every pass that ran; ``-q`` / ``--quiet`` prints
the findings only: no summary line, no ``wrote`` line of an ``--emit-*``
flag, no note of a skipped native pass, no manifest match line. Passes 3
to 8 share one parse per file through :mod:`.astcache`; the summary line
reports the cache's effect.

The module imports nothing heavyweight (no torch, no numpy).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .abicheck import ABI_RULES, check_abi
from .aotcheck import AOT_RULES, build_aot_manifest, check_aot, validate_manifest
from .astcache import SKIP_DIRS, collect_py_files
from .astcache import stats as parse_stats
from .costcheck import COST_RULES, check_cost, transfer_inventory
from .findings import Finding
from .lifecheck import LIFE_RULES, check_life
from .meshcheck import MESH_RULES, build_collective_schedule, check_mesh
from .racecheck import RACE_EXEMPT_DIRS, RACE_RULES, check_races, lock_graph
from .shardcheck import SHARD_RULES
from .shardcheck import build_model as build_shard_model
from .shardcheck import build_shape_contract, check_shards
from .suppaudit import SUPP_RULES, audit_suppressions
from .torchlint import TORCH_RULES, lint_file

# the rule catalog, in the JAX CLI's order and format (--list-rules)
CATALOG = (
    ("PyTorch/CUDA lint", TORCH_RULES),
    ("ctypes ABI", ABI_RULES),
    ("tsan.supp audit", SUPP_RULES),
    ("concurrency / death path", RACE_RULES),
    ("shape / sharding flow", SHARD_RULES),
    ("frame lifetime / aliasing", LIFE_RULES),
    ("device cost / transfer discipline", COST_RULES),
    ("collective safety / SPMD divergence", MESH_RULES),
    ("AOT dispatch closure / serving", AOT_RULES),
)


def _find_native_dir(paths: List[str]) -> Optional[str]:
    """First directory under ``paths`` holding native ctypes bindings."""
    for path in paths:
        if os.path.isfile(path):
            continue
        for dirpath, dirnames, _ in os.walk(path):
            dirnames[:] = [
                d for d in sorted(dirnames)
                if d not in SKIP_DIRS and not d.startswith(".")
            ]
            if os.path.basename(dirpath) == "native" and os.path.exists(
                os.path.join(dirpath, "__init__.py")
            ):
                return dirpath
    return None


def _dump_json(payload, dest: str) -> None:
    """Atomic JSON write (tmp + rename)."""
    tmp = f"{dest}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, sort_keys=True, indent=1)
        f.write("\n")
    os.replace(tmp, dest)


def _print_rules() -> None:
    print("scx-lint rule catalog (the port's passes):")
    for title, rules in CATALOG:
        print(f"  {title}:")
        for rule_id, slug in sorted(rules.items()):
            print(f"    {rule_id}  {slug}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.analysis",
        description="The port's static checks: lint, ctypes ABI, the "
        "tsan.supp audit, races, shapes and sharding, frame lifetimes, "
        "device cost, collective safety, the serve path's AOT closure. "
        "Exit 0 == clean.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["sctools_tpu_torch"],
        help="files/directories to check (default: sctools_tpu_torch)",
    )
    parser.add_argument(
        "--native-dir", default=None,
        help="native package dir for the ABI/supp passes "
        "(default: first native/ found under paths)",
    )
    parser.add_argument(
        "--no-lint", action="store_true",
        help="skip the SCX1xx lint pass (the JAX CLI's --no-jax-lint)",
    )
    parser.add_argument(
        "--no-abi", action="store_true", help="skip the SCX2xx pass"
    )
    parser.add_argument(
        "--no-supp", action="store_true", help="skip the SCX3xx pass"
    )
    parser.add_argument(
        "--race-only", action="store_true",
        help="run only the SCX4xx concurrency pass",
    )
    parser.add_argument(
        "--no-race", action="store_true", help="skip the SCX4xx pass"
    )
    parser.add_argument(
        "--shard-only", action="store_true",
        help="run only the SCX5xx shape/sharding pass",
    )
    parser.add_argument(
        "--no-shard", action="store_true", help="skip the SCX5xx pass"
    )
    parser.add_argument(
        "--life-only", action="store_true",
        help="run only the SCX6xx frame-lifetime pass",
    )
    parser.add_argument(
        "--no-life", action="store_true", help="skip the SCX6xx pass"
    )
    parser.add_argument(
        "--cost-only", action="store_true",
        help="run only the SCX7xx device-cost pass",
    )
    parser.add_argument(
        "--no-cost", action="store_true", help="skip the SCX7xx pass"
    )
    parser.add_argument(
        "--mesh-only", action="store_true",
        help="run only the SCX8xx collective-safety pass",
    )
    parser.add_argument(
        "--no-mesh", action="store_true", help="skip the SCX8xx pass"
    )
    parser.add_argument(
        "--aot-only", action="store_true",
        help="run only the SCX9xx AOT dispatch-closure pass",
    )
    parser.add_argument(
        "--no-aot", action="store_true", help="skip the SCX9xx pass"
    )
    parser.add_argument(
        "--emit-shape-contract", metavar="FILE", default=None,
        help="write the statically predicted per-site signature/sharding "
        "universe as JSON (what a live run's merged registries must stay "
        "inside) and exit",
    )
    parser.add_argument(
        "--emit-aot-manifest", metavar="FILE", default=None,
        help="write the certified AOT manifest as JSON (the content-"
        "hashed site universe reachable from the @serve_entry roots, "
        "which the serve workers load) and exit",
    )
    parser.add_argument(
        "--aot-manifest", metavar="FILE", default=None,
        help="validate a committed AOT manifest: fail (exit 1) when its "
        "embedded contract was hand-edited or its hash drifted from the "
        "freshly derived shape contract (the staleness gate)",
    )
    parser.add_argument(
        "--retune", metavar="RUN_DIR", default=None,
        help="the autotuner: read the recorded xprof registries under "
        "RUN_DIR, derive tightened bucket floors, rewrite the pinned "
        "RECORD_BUCKET_MIN/ENTITY_BUCKET_MIN in the ops/segments.py under "
        "the given paths, and gate the edit (SCX5xx must stay clean; the "
        "regenerated shape contract must cover every observed signature; "
        "exit 5 and restore on rejection). It rewrites a source file: "
        "point it at a copy of the tree to try it",
    )
    parser.add_argument(
        "--retune-target", type=float, default=0.35,
        help="occupancy target handed to the suggestion engine "
        "(default: 0.35)",
    )
    parser.add_argument(
        "--retune-dry-run", action="store_true",
        help="with --retune: derive and report the constants but write "
        "nothing",
    )
    parser.add_argument(
        "--segments-file", metavar="FILE", default=None,
        help="with --retune: the segments file holding the pinned floors "
        "(default: the ops/segments.py found under paths)",
    )
    parser.add_argument(
        "--emit-transfer-inventory", metavar="FILE", default=None,
        help="write the static transfer-site inventory as JSON (what a "
        "live run's ledger must stay inside) and exit",
    )
    parser.add_argument(
        "--emit-collective-schedule", metavar="FILE", default=None,
        help="write the statically predicted collective schedule as JSON "
        "(the SCTOOLS_TPU_MESH_SCHEDULE file of the runtime witness) and "
        "exit",
    )
    parser.add_argument(
        "--emit-lock-graph", metavar="FILE", default=None,
        help="write the static lock inventory + acquisition-order graph "
        "as JSON (the SCTOOLS_TPU_LOCK_GRAPH file of the runtime witness) "
        "and exit",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="print one machine-readable findings object instead of the "
        "human-readable lines",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="findings only, no summary line",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        _print_rules()
        return 0

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        # a gate pointed at a path that is not there must fail loudly,
        # not pass vacuously over zero files
        for path in missing:
            print(f"scx-lint: path does not exist: {path}", file=sys.stderr)
        return 2

    if args.emit_lock_graph is not None:
        graph = lock_graph(args.paths)
        _dump_json(graph, args.emit_lock_graph)
        if not args.quiet:
            print(
                f"scx-race: wrote {len(graph['locks'])} lock(s), "
                f"{len(graph['edges'])} order edge(s), "
                f"{len(graph['entries'])} thread/signal entr(ies) to "
                f"{args.emit_lock_graph}"
            )
        return 0

    if args.emit_shape_contract is not None:
        contract = build_shape_contract(args.paths)
        _dump_json(contract, args.emit_shape_contract)
        if not args.quiet:
            print(
                f"scx-shard: wrote {len(contract['sites'])} site(s), "
                f"{len(contract['axis_universe'])} axis name(s), "
                f"{len(contract['bucket_minimums'])} bucket minimum(s) to "
                f"{args.emit_shape_contract}"
            )
        return 0

    if args.emit_aot_manifest is not None:
        manifest = build_aot_manifest(args.paths)
        _dump_json(manifest, args.emit_aot_manifest)
        precompiled = sum(
            1 for entry in manifest["sites"].values() if entry["precompile"]
        )
        if not args.quiet:
            print(
                f"scx-aot: wrote {len(manifest['sites'])} site(s) "
                f"({precompiled} precompile, "
                f"{len(manifest['serve_entries'])} serve entr(ies)), "
                f"contract {manifest['contract_hash'][:12]}… to "
                f"{args.emit_aot_manifest}"
            )
        return 0

    if args.retune is not None:
        from .retune import retune

        code, _ = retune(
            args.retune,
            args.paths,
            target=args.retune_target,
            segments_file=args.segments_file,
            apply=not args.retune_dry_run,
        )
        return code

    if args.emit_transfer_inventory is not None:
        inventory = transfer_inventory(args.paths)
        _dump_json(inventory, args.emit_transfer_inventory)
        occurrences = sum(
            len(entry["occurrences"]) for entry in inventory["sites"].values()
        )
        if not args.quiet:
            print(
                f"scx-cost: wrote {len(inventory['sites'])} transfer site(s) "
                f"across {occurrences} call site(s) to "
                f"{args.emit_transfer_inventory}"
            )
        return 0

    if args.emit_collective_schedule is not None:
        schedule = build_collective_schedule(args.paths)
        _dump_json(schedule, args.emit_collective_schedule)
        if not args.quiet:
            print(
                f"scx-mesh: wrote {len(schedule['collectives'])} collective "
                f"pair(s) across {len(schedule['computations'])} "
                f"computation(s), {len(schedule['regions'])} mapped region(s) "
                f"to {args.emit_collective_schedule}"
            )
        return 0

    only = (
        args.race_only or args.shard_only or args.life_only or args.cost_only
        or args.mesh_only or args.aot_only
    )
    run_lint = not (only or args.no_lint)
    run_abi = not (only or args.no_abi)
    run_supp = not (only or args.no_supp)
    run_race = args.race_only if only else not args.no_race
    run_shard = args.shard_only if only else not args.no_shard
    run_life = args.life_only if only else not args.no_life
    run_cost = args.cost_only if only else not args.no_cost
    run_mesh = args.mesh_only if only else not args.no_mesh
    run_aot = args.aot_only if only else not args.no_aot

    # the lint pass reads every file; the model passes leave analysis/ out
    files = [
        path for path, _, _ in
        collect_py_files(args.paths, () if run_lint else RACE_EXEMPT_DIRS)
    ]
    findings: List[Finding] = []
    if run_lint:
        for path in files:
            findings.extend(lint_file(path))
    if run_abi or run_supp:
        native_dir = args.native_dir or _find_native_dir(args.paths)
        if native_dir is None:
            run_abi = run_supp = False
            if not args.quiet:
                print(
                    "scx-lint: no native/ package under the given paths; "
                    "ABI + suppression passes skipped",
                    file=sys.stderr,
                )
        if run_abi:
            findings.extend(check_abi(native_dir))
        if run_supp:
            findings.extend(
                audit_suppressions(os.path.join(native_dir, "tsan.supp"), native_dir)
            )
    if run_race:
        findings.extend(check_races(args.paths))
    # one shard model serves the SCX5xx pass, the contract SCX9xx reads and
    # the manifest's staleness gate
    shard_model = (
        build_shard_model(args.paths) if run_shard or run_aot else None
    )
    contract = (
        build_shape_contract(args.paths, shard_model) if run_aot else None
    )
    if run_shard:
        findings.extend(check_shards(args.paths, shard_model))
    if run_life:
        findings.extend(check_life(args.paths))
    if run_cost:
        findings.extend(check_cost(args.paths))
    if run_mesh:
        findings.extend(check_mesh(args.paths))
    if run_aot:
        findings.extend(check_aot(args.paths, contract))
    manifest_stale = False
    if args.aot_manifest is not None:
        # the staleness gate: a committed manifest whose contract drifted
        # from the live tree certifies graphs for code that no longer exists
        try:
            with open(args.aot_manifest, "r", encoding="utf-8") as f:
                committed = json.load(f)
        except (OSError, ValueError) as exc:
            print(
                f"scx-aot: cannot read manifest {args.aot_manifest}: {exc}",
                file=sys.stderr,
            )
            manifest_stale = True
        else:
            problems = validate_manifest(committed, args.paths, contract)
            for problem in problems:
                print(f"scx-aot: {problem}", file=sys.stderr)
            manifest_stale = bool(problems)
            if not problems and not (args.json or args.quiet):
                print(
                    f"scx-aot: manifest {args.aot_manifest} matches the "
                    f"fresh shape contract "
                    f"({str(committed.get('contract_hash', ''))[:12]}…)"
                )

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if args.json:
        json.dump(
            {
                "findings": [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "line": f.line,
                        "message": f.message,
                    }
                    for f in findings
                ],
                "checked_files": len(files),
            },
            sys.stdout,
            indent=1,
            sort_keys=True,
        )
        print()
        return 1 if (findings or manifest_stale) else 0
    for finding in findings:
        print(finding.render())
    if args.quiet:
        return 1 if (findings or manifest_stale) else 0
    passes = [
        name
        for name, ran in (
            ("lint", run_lint), ("abi", run_abi), ("supp", run_supp),
            ("race", run_race), ("shard", run_shard), ("life", run_life),
            ("cost", run_cost), ("mesh", run_mesh), ("aot", run_aot),
        )
        if ran
    ]
    cache_note = ""
    if parse_stats["parsed"] or parse_stats["disk_hits"]:
        cache_note = (
            f"; parse cache: {parse_stats['parsed']} parsed, "
            f"{parse_stats['disk_hits']} disk hit(s), "
            f"{parse_stats['memory_hits']} in-memory hit(s)"
        )
    print(
        f"scx-lint: {len(findings)} finding(s) across {len(files)} "
        f"python file(s); passes: {', '.join(passes) or 'none'}"
        + cache_note
    )
    return 1 if (findings or manifest_stale) else 0
