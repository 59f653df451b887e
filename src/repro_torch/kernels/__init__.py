"""Hand-written Hopper kernels for the port's hot spots.

dampen — fused select/beta/multiply (the Dampening IP), f32/bf16, CUDA C++
         for sm_90a (``csrc/dampen.cu``), with its plain PyTorch version
         ``dampen_ref`` beside it.

``ops`` holds the public wrappers. The other Pallas kernels of the JAX
package (fimd, gemm_fisher, the int8 variants) come with later slices.
"""
from . import dampen, ops  # noqa: F401
