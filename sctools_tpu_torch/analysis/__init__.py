"""The port's static checks (scx-lint) and its runtime lock witness.

The counterpart of ``sctools_tpu.analysis`` for ``sctools_tpu_torch``,
with the passes whose bug class exists in the port. One CLI (``python -m
sctools_tpu_torch.analysis [paths]``, default ``sctools_tpu_torch``) runs
them all and exits 0 only on a clean tree. All pure stdlib: nothing here
imports torch, numpy, JAX or the code under analysis.

- :mod:`.torchlint` — SCX109 (wall clock for durations), SCX112
  (host->device crossing outside ``ingest/`` and
  ``parallel/collective.py``), SCX113 (a broad handler swallowing a
  device-boundary failure), SCX114 (a device value pulled outside the
  seam) and SCX1001 (a steering knob written outside ``steer/``);
- :mod:`.abicheck` — the ctypes table of ``native/__init__.py`` against
  the ``extern "C"`` C++ it binds, rules SCX201-SCX206;
- :mod:`.suppaudit` — the native layer's ``tsan.supp`` (the suppressions
  of ``native.sanitize``'s TSan leg) against its sources, rules
  SCX301-SCX303;
- :mod:`.racecheck` — whole-package concurrency model (lock inventory,
  locksets, acquisition-order graph, thread and signal entries), rules
  SCX401-SCX404, paired with the runtime lock witness (:mod:`.witness`,
  ``SCTOOLS_TPU_LOCK_DEBUG=1``) that checks the static model against live
  runs;
- :mod:`.shardcheck` — whole-package shape and sharding model (device
  sites, mapped regions, the bucket vocabulary, the axis universe), rules
  SCX501-SCX505, paired with the shape contract a live run's merged
  registries are checked against (``check_signatures``), whose
  ``dim_admissible`` the serve worker and the steering controller use;
  :mod:`.retune` is its acting half, the bucket-floor autotuner;
- :mod:`.aotcheck` — the serve path's dispatch closure, rules
  SCX901-SCX905, and the manifest it certifies
  (``serve/graph_manifest.json``);
- :mod:`.lifecheck` — whole-package frame-lifetime model (zero-copy ring
  frames, copy/view discipline, escape summaries), rules SCX601-SCX605,
  paired with the runtime generation witness
  (:mod:`sctools_tpu_torch.ingest.framedebug`,
  ``SCTOOLS_TPU_FRAME_DEBUG=1``);
- :mod:`.costcheck` — whole-package device-cost and transfer-discipline
  model (the ``ingest`` choke points, the writeback ring's overlap window,
  the bucket vocabulary), rules SCX701-SCX705, paired with the static
  transfer inventory that a live run's ledger is checked against;
- :mod:`.meshcheck` — whole-package collective-safety model (mapped
  regions, the ``parallel.collective`` wrappers and the control group's
  calls), rules SCX801-SCX805, paired with the runtime collective-schedule
  witness (:mod:`.meshwitness`, ``SCTOOLS_TPU_MESH_DEBUG=1``).

Findings carry the JAX package's rule ids and honor inline ``#
scx-lint: disable=SCXNNN -- reason`` escape hatches (:mod:`.findings`).
The model passes share one parse per file (:mod:`.astcache`).
"""

# Re-exports resolve lazily (PEP 562): library modules import
# .analysis.witness for its lock factories, which executes this package
# __init__ — importing the passes here would make every process pay
# their parse cost for a facility that is off by default.
_EXPORTS = {
    "ABI_RULES": "abicheck",
    "check_abi": "abicheck",
    "COST_RULES": "costcheck",
    "check_cost": "costcheck",
    "check_transfer_sites": "costcheck",
    "transfer_inventory": "costcheck",
    "MESH_RULES": "meshcheck",
    "build_collective_schedule": "meshcheck",
    "check_mesh": "meshcheck",
    "AOT_RULES": "aotcheck",
    "build_aot_manifest": "aotcheck",
    "check_aot": "aotcheck",
    "contract_hash": "aotcheck",
    "validate_manifest": "aotcheck",
    "SHARD_RULES": "shardcheck",
    "build_shape_contract": "shardcheck",
    "check_shards": "shardcheck",
    "check_signatures": "shardcheck",
    "dim_admissible": "shardcheck",
    "Finding": "findings",
    "Suppressions": "findings",
    "LIFE_RULES": "lifecheck",
    "check_life": "lifecheck",
    "RACE_RULES": "racecheck",
    "check_races": "racecheck",
    "lock_graph": "racecheck",
    "SUPP_RULES": "suppaudit",
    "audit_suppressions": "suppaudit",
    "TORCH_RULES": "torchlint",
    "lint_file": "torchlint",
    "make_lock": "witness",
    "make_rlock": "witness",
}

_SUBMODULES = frozenset(
    {"abicheck", "aotcheck", "astcache", "cli", "costcheck", "findings",
     "lifecheck", "meshcheck", "meshwitness", "racecheck", "retune",
     "shardcheck", "suppaudit", "torchlint", "witness"}
)


def __getattr__(name):
    import importlib

    submodule = _EXPORTS.get(name)
    if submodule is not None:
        value = getattr(
            importlib.import_module(f".{submodule}", __name__), name
        )
        globals()[name] = value
        return value
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = sorted(_EXPORTS)
