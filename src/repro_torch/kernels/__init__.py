"""Hand-written Hopper kernels for the port: one for every Pallas kernel of
the JAX package, CUDA C++ for sm_90a in ``csrc/``, built and loaded by
``build``.

dampen        — fused select/beta/multiply (the Dampening IP),
                ``csrc/dampen.cu``: on f32/bf16 weights and on int8 weight
                codes for the ``precision="int8"`` path, one launch over a
                table of leaves with the selection count from the same pass
                (``dampen_group_cuda``, ``dampen_int8_group_cuda``; the
                per-leaf ``dampen_cuda``, ``dampen_int8_cuda`` are tables of
                one), and on int8 codes against a quant-domain forget Fisher
                (``dampen_int8_rowscale_cuda``).
fimd          — the FIMD IP, sum over B of g², ``csrc/fimd.cu``.
gemm_fisher   — dW = Aᵀ·G with the dW² epilogue, f32/bf16,
                ``csrc/gemm_fisher.cu``.
gemm_fisher_int8 — the same on int8 codes, exact int32 accumulate and a
                per-channel rescale, ``csrc/gemm_fisher_int8.cu``.

``ops`` holds the public wrappers (the reference's ``kernels.ops``), ``ref``
the plain versions under the reference's names. The forget request reaches
``dampen`` and ``dampen_int8``, once per layer through ``ops.dampen_group``
and ``ops.dampen_int8_group``; the other four are reached through ``ops``,
as in the JAX package.
"""
from . import dampen, fimd, gemm_fisher, gemm_fisher_int8, ops  # noqa: F401
