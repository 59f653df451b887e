"""Model configurations of the port: the paper's vision models, and the
registry of LM archs (``get("gemma3-1b")`` / ``all_archs()``; only the
archs the port builds are registered: gemma3-1b, qwen1.5-32b,
recurrentgemma-9b, xlstm-125m, yi-6b and yi-9b)."""
from .base import SHAPES, ArchSpec, ShapeCell, all_archs, get  # noqa: F401
from .ficabu_vision import (RESNET18_CIFAR20, RESNET18_SMALL,  # noqa: F401
                            VIT_CIFAR20, VIT_SMALL)


def _load_all():
    from . import (gemma3_1b, qwen1_5_32b, recurrentgemma_9b,  # noqa: F401
                   xlstm_125m, yi_6b, yi_9b)
