"""Hand-written Hopper kernels for the port's hot spots.

dampen — fused select/beta/multiply (the Dampening IP), CUDA C++ for
         sm_90a (``csrc/dampen.cu``): on f32/bf16 weights (``dampen_cuda``,
         plain version ``dampen_ref``) and on int8 weight codes for the
         ``precision="int8"`` path (``dampen_int8_cuda``, plain version
         ``dampen_int8_ref``).

``ops`` holds the public wrappers. The other Pallas kernels of the JAX
package (fimd, gemm_fisher, gemm_fisher_int8, dampen_int8_rowscale) come
with later slices.
"""
from . import dampen, ops  # noqa: F401
