"""gpitch_tpu_torch: the PyTorch/CUDA port of gpitch_tpu.

It imports torch, numpy and scipy, never JAX or the JAX package, and
changes no global torch state when imported.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.  The hand-written CUDA
kernels (csrc/) are built with nvcc at first use.
"""

__version__ = "0.1.0"
