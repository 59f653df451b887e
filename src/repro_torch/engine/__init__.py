"""Unlearning engine: fused per-layer step + cross-request step cache."""
from .fused import (build_fused_step, grad_fisher_chunks,  # noqa: F401
                    shape_signature)
from .programs import ProgramCache  # noqa: F401
from .session import UnlearnSession  # noqa: F401
