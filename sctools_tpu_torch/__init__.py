"""sctools_tpu_torch: the PyTorch/CUDA port of ``sctools_tpu`` for NVIDIA Hopper.

The JAX package ``sctools_tpu`` stays the reference; this package sits beside
it, imports ``torch`` and never ``jax``, and keeps its own copies of the host
code it needs. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``sctools_tpu_torch.device.resolve``).

Every console entry point of the JAX package has its classmethod of the
same name in ``platform``; the whitelist correction runs on a hand-written
CUDA kernel (``csrc/whitelist_correct.cu``), the metrics and count passes
on PyTorch ops on the device, and the sorts, splits, merges and QC
aggregation on the host. ``--devices N > 1`` runs the metrics, count and
merge commands on a mesh of N devices driven by one process
(``parallel``). ``sched`` runs chunked metrics in worker processes over a
shared journal, and ``serve`` is the resident multi-tenant metrics service
on that journal (``python -m sctools_tpu_torch.serve``). ``obs`` is the
observability layer (spans, counters, pulse heartbeat rings, slo traces,
run profiles) behind ``SCTOOLS_TPU_TRACE`` and ``SCTOOLS_TPU_PULSE``, read
back with ``python -m sctools_tpu_torch.obs``.
"""

import importlib

# submodules resolved on first access (``sctools_tpu_torch.bam``), so
# ``import sctools_tpu_torch`` stays light: no torch import
__all__ = [
    "bam",
    "barcode",
    "consts",
    "count",
    "encodings",
    "fastq",
    "groups",
    "gtf",
    "ingest",
    "io",
    "metrics",
    "obs",
    "ops",
    "parallel",
    "platform",
    "reader",
    "stats",
    "utils",
]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
