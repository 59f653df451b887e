"""FiCABU core: Fisher-based, context-adaptive, balanced unlearning."""
from . import adapters, cau, fisher, metrics, schedule, ssd  # noqa: F401
from .cau import (ModelAdapter, UnlearnConfig,  # noqa: F401
                  context_adaptive_unlearn)
