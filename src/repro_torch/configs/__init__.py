"""Model configurations of the port: the paper's vision models, and the
registry of LM archs (``get("gemma3-1b")`` / ``all_archs()``; only the
archs the port builds are registered: gemma3-1b, recurrentgemma-9b and
xlstm-125m)."""
from .base import SHAPES, ArchSpec, ShapeCell, all_archs, get  # noqa: F401
from .ficabu_vision import (RESNET18_CIFAR20, RESNET18_SMALL,  # noqa: F401
                            VIT_CIFAR20, VIT_SMALL)


def _load_all():
    from . import gemma3_1b, recurrentgemma_9b, xlstm_125m  # noqa: F401
