"""The plain PyTorch version of every kernel, under the reference's names
(the counterpart of ``repro.kernels.ref``). Each lives beside its kernel;
the wrappers in ``kernels.ops`` take it for a tensor on the CPU, and
chip_smoke.py holds each kernel against it on the card.

The dampen versions take ``alpha``/``lam`` already rounded to f32 (as
``ops`` passes them) and also return the selection mask where the kernel
writes one.
"""
from .dampen import (dampen_int8_ref, dampen_int8_rowscale_ref,  # noqa: F401
                     dampen_ref)
from .fimd import fimd_ref  # noqa: F401
from .gemm_fisher import gemm_fisher_ref  # noqa: F401
from .gemm_fisher_int8 import gemm_fisher_int8_ref  # noqa: F401
