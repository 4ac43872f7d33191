"""uniir_tpu_torch: the PyTorch / CUDA port of uniir_tpu for one NVIDIA H100.

The JAX package `uniir_tpu` stays the reference; this package computes the
same functions with plain PyTorch around hand-written Hopper kernels
(`csrc/`, built at first use by `_build`).  It imports neither JAX nor the
JAX package on its serving path.
"""

__version__ = "0.1.0"
