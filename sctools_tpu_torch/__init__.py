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
on that journal (``python -m sctools_tpu_torch.serve``).
"""
