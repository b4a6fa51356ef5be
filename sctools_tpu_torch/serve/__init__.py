"""sctools_tpu_torch.serve: the resident serving plane on the card.

The port of ``sctools_tpu.serve``: a long-lived, multi-tenant metrics
service over the scheduler (:mod:`sctools_tpu_torch.sched`):

- **Queue/API** — jobs ride the scheduler journal
  (:data:`~.api.SERVE_TASK_KIND`); lease, steal and quarantine give tenant
  isolation and crash recovery. The journal is the JAX package's, event
  for event.
- **Warmup** — :class:`~.engine.ServeWorker` captures the CUDA graph of
  every engine signature a calibration job reaches (:mod:`.graphs`)
  before it admits work, so a fresh replica answers its first request hot.
- **Packing** — chunks from different tenants pack into shared padded
  record buckets (:mod:`.packer`), with per-tenant round-robin fairness
  and an admission depth on top (:class:`~.api.AdmissionController`).
- **CLI** — ``python -m sctools_tpu_torch.serve worker|submit``
  (:mod:`.cli`); ``python -m sctools_tpu_torch.sched status`` shows the
  serve view.

Lazy attribute exports keep ``import sctools_tpu_torch.serve`` light (the
engine pulls in torch; the api half is standard library only). The JAX
package's AOT manifest is not ported (ROADMAP, "Where the port differs on
purpose").
"""

from typing import Any

_EXPORTS = {
    "AdmissionController": "api",
    "DEFAULT_ADMISSION_DEPTH": "api",
    "SERVE_TASK_KIND": "api",
    "ServeJob": "api",
    "group_open_jobs": "api",
    "serve_entry": "api",
    "warmup_step": "api",
    "ServeWorker": "engine",
    "run_serve_task": "engine",
    "PackPlan": "packer",
    "plan_packs": "packer",
    "run_packed": "packer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'sctools_tpu_torch.serve' has no {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__() -> list:
    return sorted(set(globals()) | set(__all__))
