"""sctools_tpu_torch: the PyTorch/CUDA port of ``sctools_tpu`` for NVIDIA Hopper.

The JAX package ``sctools_tpu`` stays the reference; this package sits beside
it, imports ``torch`` and never ``jax``, and keeps its own copies of the host
code it needs. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``sctools_tpu_torch.device.resolve``).

Ported so far: the barcode-attach path (``platform.TenXV2.attach_barcodes``,
``platform.BarcodePlatform.attach_barcodes``) with whitelist correction on a
hand-written CUDA kernel (``csrc/whitelist_correct.cu``).
"""
