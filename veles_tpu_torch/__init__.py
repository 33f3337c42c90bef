"""veles_tpu_torch: the PyTorch/CUDA port of veles_tpu.

The JAX package (``veles_tpu``) is the reference; this package computes
the same functions with PyTorch on one NVIDIA H100, and every kernel
the reference wrote in Pallas for the TPU is a kernel written by hand
for Hopper (``csrc/``).  It imports ``torch`` and never ``jax`` or
anything of ``veles_tpu``: where it needs one of the reference's
framework-free modules (config, forge, packaging) it keeps its own
trimmed copy.

It trains (``python -m veles_tpu_torch WORKFLOW.py``, the reference's
fused step), serves (``python -m veles_tpu_torch --serve-models
NAME=PKG.vpkg``), tunes with the GA (``--optimize POP:GEN``, genomes of
one shape signature trained as one population-batched cohort) and
trains and tests ensembles (``--ensemble-train N``, ``--ensemble-test``).
"""

__version__ = "0.1.0"
