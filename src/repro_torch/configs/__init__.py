"""Model configurations of the port: the paper's vision models, and the
registry of the LM and encoder-decoder archs (``get("gemma3-1b")`` /
``all_archs()``: gemma3-1b, internvl2-1b, kimi-k2-1t-a32b,
llama4-scout-17b-a16e, qwen1.5-32b, recurrentgemma-9b, whisper-tiny,
xlstm-125m, yi-6b and yi-9b)."""
from .base import SHAPES, ArchSpec, ShapeCell, all_archs, get  # noqa: F401
from .ficabu_vision import (RESNET18_CIFAR20, RESNET18_SMALL,  # noqa: F401
                            VIT_CIFAR20, VIT_SMALL)


def _load_all():
    from . import (gemma3_1b, internvl2_1b, kimi_k2_1t_a32b,  # noqa: F401
                   llama4_scout_17b_a16e, qwen1_5_32b, recurrentgemma_9b,
                   whisper_tiny, xlstm_125m, yi_6b, yi_9b)
