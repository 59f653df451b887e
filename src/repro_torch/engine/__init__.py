"""Unlearning engine: fused per-layer step + cross-request step cache + the
scanned whole-sweep program + the streamed Fisher refresh."""
from .fisher_stream import (FisherStream, RefreshPolicy,  # noqa: F401
                            build_refresh_step, tree_rel_err)
from .fused import (TRACE_LOG, build_fused_step,  # noqa: F401
                    grad_fisher_chunks, shape_signature)
from .programs import ProgramCache  # noqa: F401
from .session import UnlearnSession  # noqa: F401
from .sweep import (SweepPlan, build_sweep_program,  # noqa: F401
                    effective_tau32, plan_scanned_sweep)
