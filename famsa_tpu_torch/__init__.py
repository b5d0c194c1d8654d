"""famsa_tpu_torch - the PyTorch + CUDA port of famsa_tpu.

Progressive multiple sequence alignment with the capabilities of the
famsa_tpu package's default path (MST-Prim guide tree on the
indel075_div_lcs distance, progressive profile alignment, iterative
refinement, FAMSA-compatible CLI and outputs), with hand-written CUDA
kernels for the bit-parallel LCS (csrc/lcs.cu) and the batched profile DP
(csrc/dp_wide.cu).  Imports torch, never jax or the famsa_tpu package.
"""

__version__ = "0.1.0"
