"""``python -m sctools_tpu_torch.analysis [paths...]``: the port's static checks.

Runs four passes over the given paths (default: ``sctools_tpu_torch``) and
exits non-zero when any finding survives its suppressions:

1. lint (SCX109, SCX112) over every ``.py`` file (:mod:`.torchlint`);
2. ctypes ABI (SCX201-206) over the first ``native/`` package found under
   the paths, or ``--native-dir`` (:mod:`.abicheck`);
3. concurrency (SCX401-404) over the whole-package model built from the
   same paths (:mod:`.racecheck`); ``--emit-lock-graph FILE`` writes the
   static lock inventory and acquisition-order graph that the runtime
   witness checks against (``SCTOOLS_TPU_LOCK_GRAPH``) and exits;
4. frame lifetime (SCX601-605) over the same model build
   (:mod:`.lifecheck`);
5. device cost and transfer discipline (SCX701-705, :mod:`.costcheck`);
   ``--emit-transfer-inventory FILE`` writes the static transfer-site
   inventory that a live run's ledger is checked against
   (``costcheck.check_transfer_sites``) and exits;
6. collective safety (SCX801-805, :mod:`.meshcheck`);
   ``--emit-collective-schedule FILE`` writes the statically predicted
   collective universe that the runtime witness checks against
   (``SCTOOLS_TPU_MESH_SCHEDULE``) and exits.

``--race-only`` / ``--life-only`` / ``--cost-only`` / ``--mesh-only`` run
just those passes (together, each named one), ``--no-race`` /
``--no-life`` / ``--no-cost`` / ``--no-mesh`` skip one. ``--json``
replaces the human-readable output with one findings object covering
every pass that ran. Passes 3 to 6 share one parse per file through
:mod:`.astcache`; the summary line reports the cache's effect.

The module imports nothing heavyweight (no torch, no numpy).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .abicheck import check_abi
from .astcache import SKIP_DIRS, collect_py_files
from .astcache import stats as parse_stats
from .costcheck import check_cost, transfer_inventory
from .findings import Finding
from .lifecheck import check_life
from .meshcheck import build_collective_schedule, check_mesh
from .racecheck import RACE_EXEMPT_DIRS, check_races, lock_graph
from .torchlint import lint_file


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


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sctools_tpu_torch.analysis",
        description="The port's static checks: lint, ctypes ABI, races, "
        "frame lifetimes, device cost, collective safety. Exit 0 == clean.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["sctools_tpu_torch"],
        help="files/directories to check (default: sctools_tpu_torch)",
    )
    parser.add_argument(
        "--native-dir", default=None,
        help="native package dir for the ABI pass "
        "(default: first native/ found under paths)",
    )
    parser.add_argument(
        "--race-only", action="store_true",
        help="run only the SCX4xx concurrency pass",
    )
    parser.add_argument(
        "--no-race", action="store_true", help="skip the SCX4xx pass"
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
    args = parser.parse_args(argv)

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
        print(
            f"scx-race: wrote {len(graph['locks'])} lock(s), "
            f"{len(graph['edges'])} order edge(s), "
            f"{len(graph['entries'])} thread/signal entr(ies) to "
            f"{args.emit_lock_graph}"
        )
        return 0

    if args.emit_transfer_inventory is not None:
        inventory = transfer_inventory(args.paths)
        _dump_json(inventory, args.emit_transfer_inventory)
        occurrences = sum(
            len(entry["occurrences"]) for entry in inventory["sites"].values()
        )
        print(
            f"scx-cost: wrote {len(inventory['sites'])} transfer site(s) "
            f"across {occurrences} call site(s) to "
            f"{args.emit_transfer_inventory}"
        )
        return 0

    if args.emit_collective_schedule is not None:
        schedule = build_collective_schedule(args.paths)
        _dump_json(schedule, args.emit_collective_schedule)
        print(
            f"scx-mesh: wrote {len(schedule['collectives'])} collective "
            f"pair(s) across {len(schedule['computations'])} "
            f"computation(s), {len(schedule['regions'])} mapped region(s) "
            f"to {args.emit_collective_schedule}"
        )
        return 0

    only = args.race_only or args.life_only or args.cost_only or args.mesh_only
    run_lint = run_abi = not only
    run_race = args.race_only if only else not args.no_race
    run_life = args.life_only if only else not args.no_life
    run_cost = args.cost_only if only else not args.no_cost
    run_mesh = args.mesh_only if only else not args.no_mesh

    # the lint pass reads every file; the model passes leave analysis/ out
    files = [
        path for path, _, _ in
        collect_py_files(args.paths, () if run_lint else RACE_EXEMPT_DIRS)
    ]
    findings: List[Finding] = []
    if run_lint:
        for path in files:
            findings.extend(lint_file(path))
    if run_abi:
        native_dir = args.native_dir or _find_native_dir(args.paths)
        if native_dir is not None:
            findings.extend(check_abi(native_dir))
        else:
            run_abi = False
            print(
                "scx-lint: no native/ package under the given paths; "
                "ABI pass skipped",
                file=sys.stderr,
            )
    if run_race:
        findings.extend(check_races(args.paths))
    if run_life:
        findings.extend(check_life(args.paths))
    if run_cost:
        findings.extend(check_cost(args.paths))
    if run_mesh:
        findings.extend(check_mesh(args.paths))

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
        return 1 if findings else 0
    for finding in findings:
        print(finding.render())
    passes = [
        name
        for name, ran in (
            ("lint", run_lint), ("abi", run_abi),
            ("race", run_race), ("life", run_life),
            ("cost", run_cost), ("mesh", run_mesh),
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
    return 1 if findings else 0
