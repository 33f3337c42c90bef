"""Sub-package of the PyTorch/CUDA port (see veles_tpu_torch/__init__.py)."""
