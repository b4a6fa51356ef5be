"""Task-kind -> runner resolution for ``python -m sctools_tpu_torch.sched resume``.

A journal outlives the process that created it, so resuming from the CLI
needs a way to turn a task spec back into executable work. Runners are
registered by task ``kind`` as ``"module:function"`` strings and imported
lazily, so the CLI stays importable (and ``status`` instant) on hosts
without a GPU.

A runner has the signature ``run(task, device=None) -> Optional[str]``
(the committed artifact path; ``device`` is ``cuda`` unless the caller asks
for ``cpu``), and must publish its artifact atomically like any other
task body. Payloads must carry everything the runner needs (journal
module docs).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional

RUNNERS: Dict[str, str] = {
    "cell_metrics": "sctools_tpu_torch.parallel.launch:run_cell_metrics_task",
    "serve_cell_metrics": "sctools_tpu_torch.serve.engine:run_serve_task",
}


def resolve(kind: str) -> Callable[..., Optional[str]]:
    """The runner callable for ``kind``; raises KeyError when unknown."""
    try:
        target = RUNNERS[kind]
    except KeyError:
        raise KeyError(
            f"no runner registered for task kind {kind!r}; known kinds: "
            f"{sorted(RUNNERS)}"
        ) from None
    module_name, _, attr = target.partition(":")
    module = importlib.import_module(module_name)
    return getattr(module, attr)
