"""The benchmark of the PyTorch and CUDA port (``sctools_tpu_torch``); see README.md."""
